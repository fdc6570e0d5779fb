"""`python -m paml_tpu_torch baseml|basemlg <ctl> --device cpu` against
`python -m paml_tpu baseml|basemlg` on `tests/data/clock56.nuc` (6 taxa)
with the tree's root removed, each program in a temporary directory of
its own: the lnL lines, the MLEs (`rst1`), the marginal reconstruction in
`rst`, `lnf` and `rates`, to 1e-6 (the reconstruction's probabilities to
the file's three decimals).  HKY85 + G5 with `RateAncestor = 1` and
`getSE = 1`; nhomo = 1; basemlg; two trees (the RELL / KH / SH table).
basemlg runs on 6 taxa x 700 sites simulated under REV + G5
(`chip_smoke.simulate_nuc`), as clock56.nuc has no rate variation for
its alpha to find.  The JAX program stops on two of these settings, so
there the port is held otherwise: with `getSE = 1` and gamma rates `jax.hessian` cannot
differentiate the incomplete gamma twice (the JAX run takes `getSE = 0`,
the port's SEs are checked finite and positive; its Hessian is held by
central differences in tests/test_torch_baseml_fit.py), and with nhomo it
cannot format its 2-D rate parameters (the port's report is held against
the JAX package's `fit_packed`).  Also the device rule, the settings that
still raise (runmode 2-5) and the wiring of clock 5 / 6."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp

from paml_tpu import __main__ as jax_cli
from paml_tpu.apps import baseml as jax_baseml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import __main__ as cli
from paml_tpu_torch.io import outputs
from test_torch_cli import reconstruction, rst1_rows

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
TREES = ["(((A, B), C), (D, E), F);", "(((A, C), B), (D, E), F);"]

CTL = """      seqfile = seq.txt
     treefile = trees.txt
      outfile = mlb
        noisy = 0   * comment
      runmode = {runmode}
        model = {model}
        clock = {clock}
    fix_kappa = 0
        kappa = 5
    fix_alpha = {fix_alpha}
        alpha = {alpha}
        ncatG = {ncatG}
        nhomo = {nhomo}
        getSE = {getSE}
 RateAncestor = {rateancestor}
    cleandata = 0
"""


def write_baseml(d, trees, aln=None, **kw):
    """clock56.nuc, or `aln` (names, rows), the trees and a baseml.ctl in
    directory d."""
    os.makedirs(d, exist_ok=True)
    if aln is None:
        shutil.copy(os.path.join(DATA, "clock56.nuc"),
                    os.path.join(d, "seq.txt"))
    else:
        with open(os.path.join(d, "seq.txt"), "w") as f:
            f.write(f"{len(aln[0])} {len(aln[1][0])}\n")
            for nm, row in zip(*aln):
                f.write(f"{nm}  {row}\n")
    with open(os.path.join(d, "trees.txt"), "w") as f:
        f.write("\n".join(trees) + "\n")
    opts = dict(runmode=0, model=4, clock=0, fix_alpha=1, alpha=0, ncatG=1,
                nhomo=0, getSE=0, rateancestor=0)
    opts.update(kw)
    ctl = os.path.join(d, "baseml.ctl")
    with open(ctl, "w") as f:
        f.write(CTL.format(**opts))
    return ctl


def run_baseml_both(tmp_path, monkeypatch, prog, trees, jax_kw=None, **kw):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    ctl_j = write_baseml(dj, trees, **{**kw, **(jax_kw or {})})
    ctl_t = write_baseml(dt, trees, **kw)
    monkeypatch.chdir(dj)
    getattr(jax_cli, f"run_{prog}")(ctl_j)
    monkeypatch.chdir(dt)
    out = cli.main([prog, ctl_t, "--device", "cpu"])
    return dj, dt, out


def lnl_of(d):
    text = open(os.path.join(d, "mlb")).read()
    return [float(v) for v in re.findall(r"lnL\(ntime:.*\): *(-?[0-9.]+)",
                                         text)]


def rates_table(d):
    rows = re.findall(r"^ *(\d+) +(\d+) +([0-9.]+) +(\d+)$",
                      open(os.path.join(d, "rates")).read(), re.M)
    return np.array(rows, dtype=float)


def test_hky_gamma_rate_ancestor_matches_jax_cli(tmp_path, monkeypatch):
    dj, dt, out = run_baseml_both(
        tmp_path, monkeypatch, "baseml", TREES[:1], jax_kw=dict(getSE=0),
        fix_alpha=0, alpha=0.5, ncatG=5, getSE=1, rateancestor=1)
    for name in ("mlb", "rst", "rst1", "lnf", "rates"):
        assert os.path.getsize(os.path.join(dt, name)) > 0, name
    np.testing.assert_allclose(lnl_of(dt), lnl_of(dj), rtol=1e-6)
    for a, b in zip(rst1_rows(dt), rst1_rows(dj)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    ls_t, fp_t, lnf_t = outputs.read_lnf(os.path.join(dt, "lnf"))
    ls_j, fp_j, lnf_j = outputs.read_lnf(os.path.join(dj, "lnf"))
    assert ls_t == ls_j
    np.testing.assert_array_equal(fp_t, fp_j)
    np.testing.assert_allclose(lnf_t, lnf_j, atol=1e-6)
    st_t, pr_t = reconstruction(dt)
    st_j, pr_j = reconstruction(dj)
    assert st_t.shape == (700, 4)
    np.testing.assert_array_equal(st_t, st_j)
    np.testing.assert_allclose(pr_t, pr_j, atol=1.01e-3)
    rt, rj = rates_table(dt), rates_table(dj)
    assert rt.shape == (700, 4)
    np.testing.assert_array_equal(rt[:, [0, 1, 3]], rj[:, [0, 1, 3]])
    np.testing.assert_allclose(rt[:, 2], rj[:, 2], atol=1.01e-4)
    # the SEs: finite and positive, one per parameter
    res = out["runs"][0]["res"]
    line = open(os.path.join(dt, "mlb")).read().split("SEs: ")[1]
    ses = np.array([float(v) for v in line.splitlines()[0].split()])
    assert len(ses) == res.np and np.all(np.isfinite(ses)) and (ses > 0).all()
    np.testing.assert_allclose(ses, res.SEs, atol=1e-6)
    best, prob = out["runs"][0]["ancestral"]
    assert best.shape == (4, out["data"].npatt)


def test_nhomo_matches_jax_fit(tmp_path, monkeypatch):
    ctl = write_baseml(str(tmp_path), TREES[:1], nhomo=1)
    monkeypatch.chdir(tmp_path)
    out = cli.main(["baseml", ctl, "--device", "cpu"])
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.nuc"),
                                   jax_seqio.BASE_SEQ)
    data_j = jax_seqio.pack(aln)
    topo_j = jax_from_treenode(jax_treeio.parse_newick(TREES[0]),
                               data_j.names)
    res_j = jax_baseml.fit_packed(
        data_j, topo_j, jax_baseml.BasemlSpec(model="HKY85", kappa=5.0,
                                              ncatG=1, nhomo=1),
        dtype=jnp.float64)
    np.testing.assert_allclose(lnl_of(str(tmp_path)), [res_j.lnL], rtol=1e-6)
    row = rst1_rows(str(tmp_path))[0]
    assert abs(row[0] - res_j.lnL) <= 1e-6 * abs(res_j.lnL)
    np.testing.assert_allclose(row[1:], res_j.x, rtol=1e-3, atol=1e-4)
    text = open(tmp_path / "mlb").read()
    sets = re.findall(r"set 1: (.*)", text)
    np.testing.assert_allclose([float(v) for v in sets[0].split()],
                               np.ravel(res_j.pi), atol=2e-5)
    assert out["runs"][0]["res"].pi.shape == (1, 4)


def test_basemlg_matches_jax_cli(tmp_path, monkeypatch):
    # rates that vary: 6 taxa x 700 sites simulated under REV + G5 (alpha
    # 0.5), fitted under K80 with continuous gamma
    names, rows, nwk, _, _ = chip_smoke.simulate_nuc(
        torch, np.random.default_rng(3), 6, 700, "cpu")
    dj, dt, out = run_baseml_both(tmp_path, monkeypatch, "basemlg", [nwk],
                                  aln=(names, rows), model=1, rateancestor=1)
    np.testing.assert_allclose(lnl_of(dt), lnl_of(dj), rtol=1e-6)

    def numbers(d, key):
        text = open(os.path.join(d, "mlb")).read()
        return [float(v) for v in re.findall(key + r" (-?[0-9.]+)", text)]
    for key in (r"alpha \(continuous gamma\) =", "Vr", "PEV", "RHO"):
        np.testing.assert_allclose(numbers(dt, key), numbers(dj, key),
                                   rtol=1e-4, atol=1e-6)

    def site_rates(d):
        return np.array(re.findall(r"^ *\d+ +([0-9.]+)$",
                                   open(os.path.join(d, "rates")).read(),
                                   re.M), dtype=float)
    rt, rj = site_rates(dt), site_rates(dj)
    assert rt.shape == (700,)
    np.testing.assert_allclose(rt, rj, atol=1.01e-5)
    assert out["runs"][0]["spec"].continuous_gamma


def test_two_trees_match_jax_cli(tmp_path, monkeypatch):
    dj, dt, out = run_baseml_both(tmp_path, monkeypatch, "baseml", TREES)
    lt = lnl_of(dt)
    assert len(lt) == 2
    np.testing.assert_allclose(lt, lnl_of(dj), rtol=1e-6)
    ls_t, _, lnf_t = outputs.read_lnf(os.path.join(dt, "lnf"))
    _, _, lnf_j = outputs.read_lnf(os.path.join(dj, "lnf"))
    assert lnf_t.shape[0] == 2
    np.testing.assert_allclose(lnf_t, lnf_j, atol=1e-6)

    def table(d):
        text = open(os.path.join(d, "mlb")).read()
        block = text.split("pSH\n")[1]
        return np.array([[float(v) for v in line.split()]
                         for line in block.splitlines()[:2]])
    np.testing.assert_allclose(table(dt), table(dj), atol=1e-3)


@pytest.mark.parametrize("kw,item", [
    (dict(clock=5), "A12"), (dict(clock=6), "A12"),
    (dict(runmode=2), "A14"), (dict(runmode=3), "A14")])
def test_unported_settings_raise(tmp_path, monkeypatch, kw, item):
    """runmode 2-5 (tree search) raise naming ROADMAP A14.  clock = 5 / 6,
    which raised naming A12 before the dating module was ported, now run:
    the program's mlb holds the lnL and the node ages of `clock56.fit` on
    the same files (tests/test_torch_cli_mcmctree.py and
    tests/test_torch_clock56*.py hold them against the JAX package)."""
    from paml_tpu_torch.apps import clock56

    if item == "A12":
        trees = [open(os.path.join(DATA, "clock56.trees")).read()]
        ctl = write_baseml(str(tmp_path), trees, **kw)
        monkeypatch.chdir(tmp_path)
        out = cli.main(["baseml", ctl, "--device", "cpu"])
        res = clock56.fit(str(tmp_path / "trees.txt"),
                          str(tmp_path / "seq.txt"), 1,
                          clock56.Clock56Spec(model="HKY85", clock=kw["clock"],
                                              kappa=[5.0], alpha=[0.0],
                                              ncatG=1), device="cpu")
        mlb = (tmp_path / "mlb").read_text()
        assert f"clock = {kw['clock']}" in mlb
        assert f"lnL = {res.lnL:.6f}   np = {res.np}" in mlb
        assert out["result"].lnL == res.lnL
        for n in range(res.sp_topo.ns, res.sp_topo.nnode):
            assert f"node {n + 1}: {res.ages[n]:.6f}" in mlb
        return
    ctl = write_baseml(str(tmp_path), TREES[:1], **kw)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cli.main(["baseml", ctl, "--device", "cpu"])


@pytest.mark.parametrize("prog", ["baseml", "basemlg"])
def test_runs_on_the_card_unless_asked(tmp_path, prog):
    """Without a card and without `--device cpu` the programs stop; they
    do not carry on on the CPU."""
    ctl = write_baseml(str(tmp_path), TREES[:1])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run(
        [sys.executable, "-m", "paml_tpu_torch", prog, ctl],
        cwd=str(tmp_path), env={**env, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 2 and "no CUDA device" in run.stderr
    assert not os.path.exists(tmp_path / "mlb")
