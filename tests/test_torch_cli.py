"""`python -m paml_tpu_torch codeml <ctl> --device cpu` end to end against
`python -m paml_tpu codeml` on the same files: a 6-taxon alignment
simulated under site classes (omega 0.1 / 1 / 3), `NSsites = 0 7 8`, each
program run in a temporary directory of its own.  Compared: the lnL lines
of `mlc` (1e-6), `rst1`, `lnf`, the BEB site list and its posteriors, the
NEB posteriors (both with `RateAncestor = 1`, which switches the NEB table
on).  Also codeml's marginal reconstruction of codons (RateAncestor)
against the JAX program's, the device rule, tree search (runmode 2 and
3) and evolver's random trees against the JAX program, and the one
setting that still raises (ROADMAP C).
`tests/test_torch_cli_more.py` holds the standard errors, FASTA input,
several trees and `ndata`."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from paml_tpu import __main__ as jax_cli
from paml_tpu.io import outputs as jax_outputs
from paml_tpu_torch import __main__ as cli
from paml_tpu_torch.io import outputs

# tiny shapes on a shared machine: one thread beats eight contending
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CTL = """      seqfile = {seq}
     treefile = {tree}
      outfile = mlc
        noisy = 0   * comment
      runmode = {runmode}
      seqtype = {seqtype}
    CodonFreq = 2
        model = 0
      NSsites = {nssites}
        icode = 0
    fix_kappa = 0
        kappa = 2
    fix_omega = 0
        omega = .4
        ncatG = 4
        getSE = {getSE}
 RateAncestor = {rateancestor}
    cleandata = 0
        ndata = {ndata}
"""


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(20240601)
    names, rows, nwk, cls = chip_smoke.simulate_site_classes(
        torch, rng, 6, 150, "cpu", shape="trifurcating")
    return names, rows, nwk, cls


def write_problem(d, names, rows, trees, fasta=False, **kw):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "seq.txt"), "w") as f:
        if fasta:
            for nm, row in zip(names, rows):
                f.write(f">{nm}\n{row}\n")
        else:
            f.write(f"{len(names)} {len(rows[0])}\n")
            for nm, row in zip(names, rows):
                f.write(f"{nm}  {row}\n")
    with open(os.path.join(d, "trees.txt"), "w") as f:
        f.write("\n".join(trees) + "\n")
    opts = dict(seq="seq.txt", tree="trees.txt", runmode=0, seqtype=1,
                nssites="0", getSE=0, rateancestor=0, ndata=1)
    opts.update(kw)
    ctl = os.path.join(d, "codeml.ctl")
    with open(ctl, "w") as f:
        f.write(CTL.format(**opts))
    return ctl


def run_both(tmp_path, monkeypatch, names, rows, trees, jax_kw=None, **kw):
    """Run both programs, each in its own directory; returns the two
    directories and the port's summary."""
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    ctl_j = write_problem(dj, names, rows, trees, **{**kw, **(jax_kw or {})})
    ctl_t = write_problem(dt, names, rows, trees, **kw)
    monkeypatch.chdir(dj)
    jax_cli.run_codeml(ctl_j)
    monkeypatch.chdir(dt)
    out = cli.main(["codeml", ctl_t, "--device", "cpu"])
    return dj, dt, out


def lnl_lines(d):
    text = open(os.path.join(d, "mlc")).read()
    return [float(v) for v in re.findall(r"lnL\(ntime:.*\): *(-?[0-9.]+)",
                                         text)]


def rst1_rows(d):
    return [np.array([float(v) for v in line.split("\t")])
            for line in open(os.path.join(d, "rst1"))]


def beb_list(d):
    """The BEB lines of mlc: (site, P, mean w, sd)."""
    text = open(os.path.join(d, "mlc")).read()
    return [(int(m[0]), float(m[1]), float(m[2]), float(m[3]))
            for m in re.findall(
                r"^ +(\d+)  ([0-9.]+)\** * ([0-9.]+) \+- ([0-9.]+)$", text,
                re.M)]


def neb_tables(d):
    """The NEB tables of rst, one [sites, K + 1] array per model."""
    text = open(os.path.join(d, "rst")).read()
    tables = []
    for block in text.split("Naive Empirical Bayes")[1:]:
        rows = []
        for line in block.splitlines()[3:]:
            toks = line.split()
            if not toks or not toks[0].isdigit():
                break
            rows.append([float(v) for v in toks[1:]])
        tables.append(np.array(rows))
    return tables


def reconstruction(d):
    """The first marginal reconstruction table of rst: (states [sites,
    nodes], probabilities [sites, nodes])."""
    text = open(os.path.join(d, "rst")).read()
    block = text.split("Marginal reconstruction of ancestral sequences")[1]
    cells = []
    for line in block.split("node#", 1)[1].splitlines()[1:]:
        m = re.match(r"^ *\d+  (.*)$", line)
        if not m:
            break
        cells.append(m.group(1))
    st = [re.findall(r"(\w+)\(", line) for line in cells]
    pr = [[float(v) for v in re.findall(r"\(([0-9.]+)\)", line)]
          for line in cells]
    return np.array(st), np.array(pr)


def test_site_models_match_jax_cli(problem, tmp_path, monkeypatch):
    names, rows, nwk, cls = problem
    dj, dt, out = run_both(tmp_path, monkeypatch, names, rows, [nwk],
                           nssites="0 7 8", rateancestor=1)
    for name in ("mlc", "rst", "rst1", "lnf", "rub"):
        assert os.path.getsize(os.path.join(dt, name)) > 0, name
    lj, lt = lnl_lines(dj), lnl_lines(dt)
    assert len(lt) == 3
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    # rst1: lnL and the parameter vector of each model
    for a, b in zip(rst1_rows(dt), rst1_rows(dj)):
        assert len(a) == len(b)
        assert abs(a[0] - b[0]) <= 1e-6 * abs(b[0])
    # lnf: the per-pattern log likelihoods of the first model
    ls_t, fp_t, lnf_t = outputs.read_lnf(os.path.join(dt, "lnf"))
    ls_j, fp_j, lnf_j = jax_outputs.read_lnf(os.path.join(dj, "lnf"))
    assert ls_t == ls_j
    np.testing.assert_array_equal(fp_t, fp_j)
    np.testing.assert_allclose(lnf_t, lnf_j, atol=1e-5)
    # the BEB list of M8 and the NEB posteriors of M7 and M8
    bj, bt = beb_list(dj), beb_list(dt)
    assert bt and [b[0] for b in bt] == [b[0] for b in bj]
    np.testing.assert_allclose(np.array(bt)[:, 1:], np.array(bj)[:, 1:],
                               atol=2e-3)
    nj, nt = neb_tables(dj), neb_tables(dt)
    assert len(nt) == len(nj) == 2
    for a, b in zip(nt, nj):
        np.testing.assert_allclose(a, b, atol=2e-4)
    # the summary the entry point returns carries the same fits
    assert [r["NSsites"] for r in out["runs"]] == [0, 7, 8]
    assert out["runs"][2]["beb"].class_post.shape == (2, out["data"].npatt)


@pytest.mark.parametrize("kw,item", [
    (dict(runmode=2), "A14"), (dict(evolver="1"), "A14"),
    (dict(runmode=3), "A14"), (dict(runmode=-2, seqtype=3), "C")])
def test_unported_settings_raise(problem, tmp_path, monkeypatch, kw, item):
    """Tree search (runmode 2 and 3) and evolver's random trees, which
    raised naming ROADMAP A14 until tree search was ported, now run: the
    port's program against the JAX program on the same files (mlc's best
    lnL and tree, on 4 taxa for the star decomposition's 7 fits and on 5
    for stepwise addition's 8; evolver.out's bytes).  codeml's pairwise
    runmodes on amino-acid data still raise, naming ROADMAP C."""
    from paml_tpu.apps import evolver as jax_evolver

    names, rows, nwk, cls = problem
    if item == "C":
        monkeypatch.chdir(tmp_path)
        argv = ["codeml", write_problem(str(tmp_path), names, rows, [nwk],
                                        **kw)]
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            cli.main(argv + ["--device", "cpu"])
        return
    if "evolver" in kw:
        argv = [kw["evolver"], "7", "4", "5"]
        monkeypatch.chdir(tmp_path)
        jax_evolver.main(argv)
        want = (tmp_path / "evolver.out").read_text()
        (tmp_path / "evolver.out").unlink()
        assert cli.main(["evolver"] + argv + ["--device", "cpu"]) is None
        assert (tmp_path / "evolver.out").read_text() == want
        assert want.count(";") == 4
        return
    k = 4 if kw["runmode"] == 2 else 5
    dj, dt, out = run_both(tmp_path, monkeypatch, names[:k], rows[:k], [nwk],
                           **kw)
    mj, mt = (open(os.path.join(d, "mlc")).read().splitlines()
              for d in (dj, dt))
    assert mt[0] == f"CODEML (paml_tpu_torch) tree search runmode " \
        f"{kw['runmode']}"
    assert mt[1:] == mj[1:]
    assert abs(out["lnL"] - float(mj[1].split()[-1])) <= 5e-7
    assert len(out["fits"]) == (7 if k == 4 else 8)
    assert out["tree"] is not None and out["data"].ns == k


def test_rate_ancestor_matches_jax_cli(problem, tmp_path, monkeypatch):
    """codeml with RateAncestor = 1: the marginal reconstruction of the
    codons in rst, and the NEB table, as the JAX program writes them."""
    names, rows, nwk, cls = problem
    dj, dt, out = run_both(tmp_path, monkeypatch, names, rows, [nwk],
                           nssites="0 2", rateancestor=1)
    st_t, pr_t = reconstruction(dt)
    st_j, pr_j = reconstruction(dj)
    assert st_t.shape == (150, 4) and len(st_t[0][0]) == 3
    np.testing.assert_array_equal(st_t, st_j)
    np.testing.assert_allclose(pr_t, pr_j, atol=1.01e-3)
    text_t, text_j = (open(os.path.join(d, "rst")).read() for d in (dt, dj))
    assert text_t.count("Marginal reconstruction") == \
        text_j.count("Marginal reconstruction") == 2
    assert text_t.count("Naive Empirical Bayes") == \
        text_j.count("Naive Empirical Bayes") == 1
    assert out["runs"][0]["ancestral"][0].shape == (4, out["data"].npatt)


def test_runs_on_the_card_unless_asked(problem, tmp_path):
    """Without a card and without `--device cpu` the program stops; it
    does not carry on on the CPU."""
    names, rows, nwk, cls = problem
    ctl = write_problem(str(tmp_path), names, rows, [nwk])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run(
        [sys.executable, "-m", "paml_tpu_torch", "codeml", ctl],
        cwd=str(tmp_path), env={**env, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 2 and "no CUDA device" in run.stderr
    assert not os.path.exists(tmp_path / "mlc")
