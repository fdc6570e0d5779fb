"""`python -m paml_tpu_torch mcmctree | infinitesites | ds | bfdriver |
multiruns` and baseml at `clock = 5` (with `--device cpu` where the
program takes a device) against `python -m paml_tpu` on the same files,
each program run in a directory of its own: mcmctree's mcmc.txt, out.txt
and FigTree.tre (numbers to the printed precision) at usedata 0, 1 and 2
(the latter from an in.BV the port's usedata = 3 wrote), a checkpointed
and a resumed chain, `--combine` of files and of a directory; the
standard output of infinitesites and ds; bfdriver's and multiruns' files;
baseml's mlb at clock 5.  Also the device rule: mcmctree stops without a
card unless asked for the CPU, and the host programs need no card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_mcmctree as td
from paml_tpu import __main__ as jax_cli
from paml_tpu.apps import mcmctree as jax_mcmctree
from paml_tpu_torch import __main__ as cli
from paml_tpu_torch.apps import mcmctree
from paml_tpu_torch.apps.mcmcutils import write_mcmc_txt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def make_dirs(tmp_path, files):
    dirs = []
    for tag in ("jax", "torch"):
        d = tmp_path / tag
        d.mkdir()
        for name, text in files.items():
            (d / name).write_text(text)
        dirs.append(d)
    return dirs


def numbers(path):
    """Every number in a file, and the text with the numbers (and the
    program's package name) taken out."""
    import re
    text = path.read_text().replace("paml_tpu_torch", "paml_tpu")
    return (np.array([float(v) for v in re.findall(
        r"-?\d+\.\d+(?:e[-+]\d+)?", text)]),
        re.sub(r"-?\d+\.\d+(?:e[-+]\d+)?", "#", text))


def same_files(dj, dt, names, atol=2e-6):
    for name in names:
        a, ta = numbers(dj / name)
        b, tb = numbers(dt / name)
        assert tb == ta, name
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=atol, err_msg=name)


def run_both(monkeypatch, dj, dt, argv):
    monkeypatch.setattr(jax_cli, "_init_jax_backend", lambda **kw: None)
    monkeypatch.chdir(dj)
    jax_cli.main(argv)
    monkeypatch.chdir(dt)
    return cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("usedata,clock,extra", [
    (0, 1, {}), (1, 2, {}), (1, 3, {"checkpoint": "1"})])
def test_mcmctree_matches_jax_cli(tmp_path, monkeypatch, usedata, clock,
                                  extra):
    files = {"seq.txt": td.seq_text(lengths=(100, 80)),
             "tree.nwk": f"6 1\n\n{td.NWK}\n",
             "mcmctree.ctl": td.mcmc_ctl(usedata=usedata, clock=clock,
                                         burnin=3, nsample=8, **extra)}
    dj, dt = make_dirs(tmp_path, files)
    summ = run_both(monkeypatch, dj, dt, ["mcmctree", "mcmctree.ctl"])
    assert "t_n6" in summ
    same_files(dj, dt, ["mcmc.txt", "out.txt", "FigTree.tre"])
    if extra:
        # resume from the checkpoint in both packages: the same chain
        for d in (dj, dt):
            text = (d / "mcmctree.ctl").read_text()
            (d / "mcmctree.ctl").write_text(
                text.replace("checkpoint = 1", "checkpoint = 2"))
        run_both(monkeypatch, dj, dt, ["mcmctree", "mcmctree.ctl"])
        same_files(dj, dt, ["mcmc.txt", "out.txt"])


def test_usedata3_then_2(tmp_path, monkeypatch):
    """usedata = 3 writes out.BV (the port's fits, in the reference's
    branch order); both programs then run usedata = 2 from it."""
    files = {"seq.txt": td.seq_text(lengths=(100, 80)),
             "tree.nwk": f"6 1\n\n{td.NWK}\n",
             "mcmctree.ctl": td.mcmc_ctl(usedata=3, clock=2)}
    dj, dt = make_dirs(tmp_path, files)
    monkeypatch.chdir(dt)
    assert cli.main(["mcmctree", "mcmctree.ctl", "--device", "cpu"]) is None
    for d in (dj, dt):
        (d / "in.BV").write_text((dt / "out.BV").read_text())
        (d / "mcmctree.ctl").write_text(td.mcmc_ctl(
            usedata="2 in.BV", clock=2, burnin=3, nsample=8))
    loci = mcmctree.read_BV(str(dt / "in.BV"), 2, transform="none")
    jloci = jax_mcmctree.read_BV(str(dj / "in.BV"), 2, transform="none")
    for a, b in zip(loci, jloci):
        np.testing.assert_array_equal(a.hessian, b.hessian)
    run_both(monkeypatch, dj, dt, ["mcmctree", "mcmctree.ctl"])
    same_files(dj, dt, ["mcmc.txt", "out.txt", "FigTree.tre"])


def test_combine_matches_jax_cli(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    src = tmp_path / "chains"
    src.mkdir()
    for k in (1, 3, 21):
        rows = [dict(t_n7=rng.random(), mu1=rng.random(),
                     lnL=-rng.random()) for _ in range(10)]
        write_mcmc_txt(rows, str(src / f"mcmc_{k}.txt"))
    dj, dt = make_dirs(tmp_path, {})
    paths = [str(src / f"mcmc_{k}.txt") for k in (1, 21)]
    run_both(monkeypatch, dj, dt, ["mcmctree", "--combine", "c.txt"] + paths)
    run_both(monkeypatch, dj, dt, ["mcmctree", "--combine", str(src)])
    for name in ("c.txt", "mcmc_combined.txt"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes()


def test_host_programs_match_jax_cli(tmp_path, monkeypatch, capsys):
    """infinitesites (clock 1 and 2), ds, bfdriver and multiruns: the
    same standard output and files."""
    from test_torch_infinitesites import write_fixed_ds, trees

    monkeypatch.setattr(jax_cli, "_init_jax_backend", lambda **kw: None)
    d = tmp_path
    write_fixed_ds(d, trees()[1])
    (d / "tree.nwk").write_text(f"6 1\n\n{td.NWK}\n")
    rng = np.random.default_rng(1)
    rows = [dict(t_n7=rng.random(), mu1=rng.random()) for _ in range(50)]
    write_mcmc_txt(rows, str(d / "mcmc.txt"))
    for k in range(2):
        (d / f"r{k}.txt").write_text("".join(
            f"{i} {rng.random():.3f} {-10 - rng.random():.5f}\n"
            for i in range(5)))
    (d / "m.ctl").write_text("seqfile = x\nusedata = 2\n")
    monkeypatch.chdir(d)
    outs = {}
    for clock in (1, 2):
        (d / f"is{clock}.ctl").write_text(
            f"seed = 5\ntreefile = tree.nwk\nndata = 2\nclock = {clock}\n"
            "burnin = 20\nsampfreq = 2\nnsample = 30\n"
            "rgene_gamma = 2 4 1\nBDparas = 1 1 0.1\n")
    for argv in (["infinitesites", "is1.ctl"], ["infinitesites", "is2.ctl"],
                 ["ds", "mcmc.txt"], ["multiruns", "best.txt", "r0.txt",
                                      "r1.txt"]):
        jax_cli.main(argv)
        want = capsys.readouterr().out
        best_j = (d / "best.txt").read_text() if argv[0] == "multiruns" \
            else None
        cli.main(argv)
        got = capsys.readouterr().out
        assert got == want, argv
        if best_j is not None:
            assert (d / "best.txt").read_text() == best_j
        outs[argv[0]] = got
    assert "Posterior root age" in outs["infinitesites"] or \
        "t_n7" in outs["infinitesites"]
    os.makedirs(d / "j")
    os.makedirs(d / "t")
    monkeypatch.chdir(d / "j")
    jax_cli.main(["bfdriver", str(d / "m.ctl"), "4"])
    monkeypatch.chdir(d / "t")
    cli.main(["bfdriver", str(d / "m.ctl"), "4"])
    assert capsys.readouterr().out.count("wrote 4 per-beta") == 2
    for k in range(1, 5):
        assert (d / "t" / "bf" / f"b{k}" / "mcmctree.ctl").read_text() == \
            (d / "j" / "bf" / f"b{k}" / "mcmctree.ctl").read_text()
    assert (d / "t" / "bf" / "runbf.sh").read_text() == (
        d / "j" / "bf" / "runbf.sh").read_text().replace(
            "-m paml_tpu ", "-m paml_tpu_torch ")


def test_baseml_clock5_matches_jax_cli(tmp_path, monkeypatch):
    ctl = """seqfile = seq.txt
treefile = tree.txt
outfile = mlb
ndata = 2
clock = 5
model = 4
fix_kappa = 0
kappa = 2
fix_alpha = 1
alpha = 0
ncatG = 1
cleandata = 0
"""
    files = {"seq.txt": open(os.path.join(DATA, "clock56.nuc")).read(),
             "tree.txt": open(os.path.join(DATA, "clock56.trees")).read(),
             "baseml.ctl": ctl}
    dj, dt = make_dirs(tmp_path, files)
    monkeypatch.chdir(dj)
    jax_cli.run_baseml("baseml.ctl")
    monkeypatch.chdir(dt)
    out = cli.main(["baseml", "baseml.ctl", "--device", "cpu"])
    assert out["result"].np == 8
    same_files(dj, dt, ["mlb"], atol=2e-5)


@pytest.mark.parametrize("argv,code", [
    (["mcmctree", "mcmctree.ctl"], 2), (["ds", "mcmc.txt"], 0),
    (["mcmctree", "--combine", "c.txt", "mcmc.txt"], 0)])
def test_device_rule(tmp_path, argv, code):
    """mcmctree runs on the card unless asked for the CPU; ds and
    --combine are host programs and run without a card."""
    write_mcmc_txt([dict(t=0.1 * i, u=0.2) for i in range(5)],
                   str(tmp_path / "mcmc.txt"))
    (tmp_path / "mcmctree.ctl").write_text("seqfile = x\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run(
        [sys.executable, "-m", "paml_tpu_torch"] + argv,
        cwd=str(tmp_path), env={**env, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == code, run.stderr
    if code:
        assert "no CUDA device" in run.stderr
