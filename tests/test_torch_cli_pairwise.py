"""`python -m paml_tpu_torch yn00 | pamp | chi2 | evolver ... --device cpu`
and codeml `runmode = -2 / -3` against `python -m paml_tpu` on the same
files, each program run in a temporary directory of its own: yn00's `yn`
(every line but the program's name), `2YN.*` and `2NG.*` byte for byte,
with and without the weighting and with `ndata = 2`; pamp's `mp`; chi2's
standard output; codeml's pairwise `mlc` (its numbers to the printed
precision) and `2ML.*`; evolver's files by shape (the streams differ:
tests/test_torch_evolver.py holds the sampler) and mode 11's
`evolver.out` byte for byte.  Also the device rule for the new
programs."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from paml_tpu import __main__ as jax_cli
from paml_tpu.apps import evolver as jax_evolver
from paml_tpu.io import seqio as jax_seqio
from paml_tpu_torch import __main__ as cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")

CODEML_CTL = """      seqfile = seq.txt
      outfile = mlc
      runmode = {runmode}
      seqtype = 1
    CodonFreq = 2
        model = 0
      NSsites = 0
        icode = 0
    fix_kappa = {fix_kappa}
        kappa = 2
    fix_omega = 0
        omega = .4
    cleandata = 1
"""


def setup_dirs(tmp_path, files, ctl_name=None, ctl=None):
    """Two directories, jax/ and torch/, each with copies of `files` (names
    in tests/data or (name, text) pairs) and the control file."""
    dirs = []
    for tag in ("jax", "torch"):
        d = tmp_path / tag
        d.mkdir()
        for f in files:
            if isinstance(f, tuple):
                (d / f[0]).write_text(f[1])
            else:
                shutil.copy(os.path.join(DATA, f), d / f)
        if ctl is not None:
            (d / ctl_name).write_text(ctl)
        dirs.append(d)
    return dirs


def run_pair(monkeypatch, dj, dt, jax_fn, argv):
    monkeypatch.chdir(dj)
    jax_fn()
    monkeypatch.chdir(dt)
    return cli.main(argv + ["--device", "cpu"])


def body(path, skip=1):
    return path.read_text().splitlines()[skip:]


@pytest.mark.parametrize("weighting,common", [(1, 0), (0, 1)])
def test_yn00_matches_jax_cli(tmp_path, monkeypatch, weighting, common):
    ctl = (f"seqfile = clock56.codon\noutfile = yn\nverbose = 0\n"
           f"icode = 0\nweighting = {weighting}\ncommonf3x4 = {common}\n")
    dj, dt = setup_dirs(tmp_path, ["clock56.codon"], "yn00.ctl", ctl)
    out = run_pair(monkeypatch, dj, dt,
                   lambda: jax_cli.run_yn00("yn00.ctl"), ["yn00", "yn00.ctl"])
    assert len(out["pairs"]) == 15
    assert body(dt / "yn") == body(dj / "yn")
    assert (dt / "yn").read_text().startswith("YN00 (paml_tpu_torch)")
    for pre in ("2YN", "2NG"):
        for q in ("dS", "dN", "t"):
            assert (dt / f"{pre}.{q}").read_bytes() == \
                (dj / f"{pre}.{q}").read_bytes(), f"{pre}.{q}"


def test_yn00_ndata_matches_jax_cli(tmp_path, monkeypatch):
    text = open(os.path.join(DATA, "clock56.codon")).read()
    ctl = ("seqfile = two.codon\noutfile = yn\nweighting = 1\n"
           "ndata = 2\n")
    dj, dt = setup_dirs(tmp_path, [("two.codon", text + "\n" + text)],
                        "yn00.ctl", ctl)
    out = run_pair(monkeypatch, dj, dt,
                   lambda: jax_cli.run_yn00("yn00.ctl"), ["yn00", "yn00.ctl"])
    assert len(out["datasets"]) == 2
    assert body(dt / "yn") == body(dj / "yn")


def test_pamp_matches_jax_cli(tmp_path, monkeypatch):
    ctl = ("seqfile = clock56.nuc\ntreefile = clock56.trees\noutfile = mp\n"
           "ncatG = 4\n")
    dj, dt = setup_dirs(tmp_path, ["clock56.nuc", "clock56.trees"],
                        "pamp.ctl", ctl)
    out = run_pair(monkeypatch, dj, dt,
                   lambda: jax_cli.run_pamp("pamp.ctl"), ["pamp", "pamp.ctl"])
    assert out["result"].pattern_matrix.shape == (4, 4)
    assert body(dt / "mp") == body(dj / "mp")


@pytest.mark.parametrize("args", [["1", "3.84"], ["2", "10.5"], []])
def test_chi2_matches_jax_cli(capsys, args):
    jax_cli.run_chi2(args)
    want = capsys.readouterr().out
    cli.main(["chi2"] + args)
    assert capsys.readouterr().out == want


def codeml_problem(ns):
    rows = open(os.path.join(DATA, "clock56.codon")).read().splitlines()
    head, seqs = rows[0].split(), [r for r in rows[1:] if r.strip()]
    return (f"{ns} {head[1]}\n" + "\n".join(seqs[:ns]) + "\n")


def mlc_table(path):
    return np.array([[float(v) for v in line.split()]
                     for line in body(path, 2)])


@pytest.mark.parametrize("fix_kappa", [0, 1])
def test_codeml_pairwise_ml_matches_jax_cli(tmp_path, monkeypatch, fix_kappa):
    ctl = CODEML_CTL.format(runmode=-2, fix_kappa=fix_kappa)
    dj, dt = setup_dirs(tmp_path, [("seq.txt", codeml_problem(4))],
                        "codeml.ctl", ctl)
    out = run_pair(monkeypatch, dj, dt,
                   lambda: jax_cli.run_codeml("codeml.ctl"),
                   ["codeml", "codeml.ctl"])
    assert len(out["pairs"]) == 6
    tj, tt = mlc_table(dj / "mlc"), mlc_table(dt / "mlc")
    assert tt.shape == (6, 7)
    np.testing.assert_array_equal(tt[:, :2], tj[:, :2])
    np.testing.assert_allclose(tt[:, 2:], tj[:, 2:], rtol=0, atol=1.01e-4)
    for q in ("t", "dS", "dN"):
        assert (dt / f"2ML.{q}").read_bytes() == \
            (dj / f"2ML.{q}").read_bytes(), q
    assert (dt / "rub").stat().st_size > 0


def test_codeml_pairwise_bayes_matches_jax_cli(tmp_path, monkeypatch):
    """runmode -3: the kappa column and the zero dN / dS columns as the JAX
    program writes them; the t and omega columns hold the posterior means
    (the JAX program writes 0 there, ROADMAP C)."""
    ctl = CODEML_CTL.format(runmode=-3, fix_kappa=0)
    dj, dt = setup_dirs(tmp_path, [("seq.txt", codeml_problem(2))],
                        "codeml.ctl", ctl)
    out = run_pair(monkeypatch, dj, dt,
                   lambda: jax_cli.run_codeml("codeml.ctl"),
                   ["codeml", "codeml.ctl"])
    tj, tt = mlc_table(dj / "mlc"), mlc_table(dt / "mlc")
    assert tt.shape == (1, 7)
    np.testing.assert_array_equal(tt[:, [0, 1, 5, 6]], tj[:, [0, 1, 5, 6]])
    np.testing.assert_allclose(tt[:, 3], tj[:, 3], rtol=0, atol=1.01e-4)
    np.testing.assert_allclose(tt[:, 2], [p.E_t for p in out["pairs"]],
                               atol=5.01e-5)
    np.testing.assert_allclose(tt[:, 4], [p.E_w for p in out["pairs"]],
                               atol=5.01e-5)
    assert (tj[:, [2, 4]] == 0).all()
    for q in ("dS", "dN"):
        assert (dt / f"2ML.{q}").read_bytes() == \
            (dj / f"2ML.{q}").read_bytes(), q


NUC_DAT = """0
123
4 500 2
-1
((a: 0.1, b: 0.2): 0.12, c: 0.3, d: 0.4);
4
5.0
0.5 4
0.2 0.3 0.35 0.15
"""


@pytest.mark.parametrize("mode", ["5", "6"])
def test_evolver_matches_jax_cli_by_shape(tmp_path, monkeypatch, mode):
    if mode == "5":
        dat = NUC_DAT
    else:
        freqs = "\n".join(" ".join(["0.015625"] * 4) for _ in range(16))
        dat = ("0\n13147\n4 200 2\n-1\n((a: 0.1, b: 0.2): 0.12, c: 0.3, "
               f"d: 0.4);\n3\n0.6 0.3 0.1\n0.1 1 3\n4.0\n{freqs}\n0\n")
    dj, dt = setup_dirs(tmp_path, [("mc.dat", dat)])
    run_pair(monkeypatch, dj, dt,
             lambda: jax_evolver.main([mode, "mc.dat"]),
             ["evolver", mode, "mc.dat"])
    seqtype = jax_seqio.BASE_SEQ if mode == "5" else jax_seqio.CODON_SEQ
    aj = jax_seqio.read_alignments(str(dj / "mc.paml"), seqtype, 2)
    at = jax_seqio.read_alignments(str(dt / "mc.paml"), seqtype, 2)
    assert [(a.names, a.ls) for a in at] == [(a.names, a.ls) for a in aj]
    assert at[0].rows != at[1].rows
    if mode == "6":
        for name in ("siterates.txt", "ancestral.txt"):
            lj, lt = body(dj / name, 0), body(dt / name, 0)
            assert len(lt) == len(lj)
            assert [len(v) for v in lt] == [len(v) for v in lj]
            assert [v.split()[0] for v in lt if v[:1].isalpha()] == \
                [v.split()[0] for v in lj if v[:1].isalpha()]


def test_evolver_label_clades_matches_jax_cli(tmp_path, monkeypatch):
    tree = ("t.tree", "((A1,A2),(B1,(B2,B3)),C);\n")
    dj, dt = setup_dirs(tmp_path, [tree])
    run_pair(monkeypatch, dj, dt,
             lambda: jax_evolver.main(["11", "t.tree", "A", "B", "C"]),
             ["evolver", "11", "t.tree", "A", "B", "C"])
    assert (dt / "evolver.out").read_bytes() == \
        (dj / "evolver.out").read_bytes()


@pytest.mark.parametrize("argv", [["yn00", "yn00.ctl"], ["pamp", "pamp.ctl"],
                                  ["evolver", "5", "mc.dat"]])
def test_new_programs_run_on_the_card_unless_asked(tmp_path, argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run(
        [sys.executable, "-m", "paml_tpu_torch"] + argv,
        cwd=str(tmp_path), env={**env, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 2 and "no CUDA device" in run.stderr
    assert os.listdir(tmp_path) == []
