"""paml_tpu_torch's infinitesites against paml_tpu's: the FixedDs readers,
the clock 1 and clock 2 / 3 log-densities (1e-12 relative) and chains
draw for draw (1e-9), and `run_ctl` on a control file."""
import numpy as np
import pytest

import test_torch_mcmctree as td
from paml_tpu.apps import infinitesites as JI
from paml_tpu.apps import mcmctree as J
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch.apps import infinitesites as TI
from paml_tpu_torch.apps import mcmctree as T
from paml_tpu_torch.io import treeio

# true ages of the internal nodes of td.NWK (preorder: root first) and the
# two loci's rates
AGES = {6: 1.0, 7: 0.6, 8: 0.3, 9: 0.15, 10: 0.25}
RATES = (0.4, 0.7)


def trees():
    sj = J.build_species_tree(jax_treeio.parse_newick(td.NWK), td.NAMES)
    st = T.build_species_tree(treeio.parse_newick(td.NWK), td.NAMES)
    return sj, st


def write_fixed_ds(d, st):
    topo = st.topo
    ages = np.zeros(topo.nnode)
    for n, a in AGES.items():
        ages[n] = a
    s = topo.ns
    (d / "FixedDsClock1.txt").write_text(
        f"{s}\n" + " ".join(f"{ages[j] * RATES[0]:.6f}"
                            for j in range(s, topo.nnode))
        + f"\n{ages[topo.root] * RATES[1]:.6f}\n")
    par = np.where(topo.parent >= 0, topo.parent, topo.root)
    rng = np.random.default_rng(4)
    lines = [f"{s}"]
    for r in RATES:
        bl = (ages[par] - ages) * r * np.exp(0.2 * rng.normal(
            size=topo.nnode))

        def build(i):
            kids = [c for c in topo.children[i] if c >= 0]
            lab = (td.NAMES[i] if not kids else
                   "(" + ", ".join(build(c) for c in kids) + ")")
            return lab + (f": {bl[i]:.6f}" if i != topo.root else "")
        lines.append(build(topo.root) + ";")
    (d / "FixedDsClock23.txt").write_text("\n".join(lines) + "\n")


def test_fixed_ds_readers_and_densities(tmp_path):
    sj, st = trees()
    write_fixed_ds(tmp_path, st)
    dj = JI.read_fixed_ds_clock1(str(tmp_path / "FixedDsClock1.txt"), 6, 2)
    dt = TI.read_fixed_ds_clock1(str(tmp_path / "FixedDsClock1.txt"), 6, 2)
    np.testing.assert_array_equal(dt, dj)
    for t1 in (0.8, 1.0, 1.3):
        a, b = TI.ln_pdf_clock1(t1, dt, st, (2, 4, 1)), \
            JI.ln_pdf_clock1(t1, dj, sj, (2, 4, 1))
        assert a[0] == pytest.approx(b[0], rel=1e-12)
        np.testing.assert_array_equal(a[1], b[1])
    bj = JI.read_fixed_ds_clock23(str(tmp_path / "FixedDsClock23.txt"), sj,
                                  td.NAMES)
    bt = TI.read_fixed_ds_clock23(str(tmp_path / "FixedDsClock23.txt"), st,
                                  td.NAMES)
    np.testing.assert_array_equal(bt, bj)
    ages = JI._initial_ages(sj, bj)
    np.testing.assert_array_equal(TI._initial_ages(st, bt), ages)
    for clock in (2, 3):
        kw = dict(ages=ages.copy(), mu=np.array([0.3, 0.5]),
                  sigma2=np.array([0.1, 0.2]), r0=bj[:, 8] / 1.5)
        a = TI.ln_pdf_clock23(st, TI.ISState(**kw), bt, clock, (2, 4, 1),
                              (1, 10, 1))
        b = JI.ln_pdf_clock23(sj, JI.ISState(**kw), bj, clock, (2, 4, 1),
                              (1, 10, 1))
        assert a == pytest.approx(b, rel=1e-12)


def test_clock1_chain_matches_jax(tmp_path):
    sj, st = trees()
    write_fixed_ds(tmp_path, st)
    ds = JI.read_fixed_ds_clock1(str(tmp_path / "FixedDsClock1.txt"), 6, 2)
    kw = dict(burnin=200, nsample=300, sampfreq=2, seed=9)
    oj = JI.run_clock1(sj, ds, (2, 4, 1), **kw)
    ot = TI.run_clock1(st, ds.copy(), (2, 4, 1), **kw)
    np.testing.assert_allclose(ot["t0"], oj["t0"], rtol=1e-9, atol=0)
    assert ot["t0_CI"] == pytest.approx(oj["t0_CI"], rel=1e-9)
    for lab in ("mean", "low", "high"):
        np.testing.assert_allclose(ot["times"][lab], oj["times"][lab],
                                   rtol=1e-9)


@pytest.mark.parametrize("clock", [2, 3])
def test_clock23_chain_matches_jax(tmp_path, clock):
    sj, st = trees()
    write_fixed_ds(tmp_path, st)
    b = JI.read_fixed_ds_clock23(str(tmp_path / "FixedDsClock23.txt"), sj,
                                 td.NAMES)
    kw = dict(clock=clock, rgene_para=(2, 4, 1), sigma2_para=(1, 10, 1),
              burnin=40, nsample=40, sampfreq=2, seed=3)
    sj_, st_ = JI.run_clock23(sj, b, **kw), TI.run_clock23(st, b.copy(), **kw)
    keys = list(sj_[0])
    assert list(st_[0]) == keys
    np.testing.assert_allclose([[r[k] for k in keys] for r in st_],
                               [[r[k] for k in keys] for r in sj_],
                               rtol=1e-9, atol=0)


@pytest.mark.parametrize("clock", [1, 2])
def test_run_ctl_matches_jax(tmp_path, clock):
    sj, st = trees()
    write_fixed_ds(tmp_path, st)
    (tmp_path / "species.trees").write_text(f"6 1\n\n{td.NWK}\n")
    opts = {"treefile": "species.trees", "clock": clock, "ndata": 2,
            "burnin": 30, "nsample": 30, "sampfreq": 2, "seed": 3,
            "rgene_gamma": "2 4 1", "BDparas": "1 1 0.1"}
    ctl = str(tmp_path / "mcmctree.ctl")
    oj = JI.run_ctl(dict(opts), ctl, progress=False)
    ot = TI.run_ctl(dict(opts), ctl, progress=False)
    if clock == 1:
        np.testing.assert_allclose(ot["t0"], oj["t0"], rtol=1e-9)
    else:
        keys = list(oj[0])
        np.testing.assert_allclose([[r[k] for k in keys] for r in ot],
                                   [[r[k] for k in keys] for r in oj],
                                   rtol=1e-9)
