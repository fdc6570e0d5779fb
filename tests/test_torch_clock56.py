"""paml_tpu_torch's clock 5 (ML dating of heterogeneous multi-locus data)
against paml_tpu's on tests/data/clock56.*: the gene trees pruned from the
species tree, the node-age transform, the step-3 objective's value and
gradient (1e-10), the AHRS smoothing objective, and the clock-5 fits of
nucleotide and codon loci (lnL to 1e-6; tests/golden_clock56.json as
tests/test_clock56.py holds it)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paml_tpu.apps import clock56 as J
from paml_tpu_torch import interop
from paml_tpu_torch.apps import clock56 as T

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
DATA = os.path.join(HERE, "data")
GOLD = json.load(open(os.path.join(HERE, "golden_clock56.json")))


def hetero(seqtype):
    name = "clock56.nuc" if seqtype == 0 else "clock56.codon"
    args = (os.path.join(DATA, "clock56.trees"), os.path.join(DATA, name), 2)
    return (J.read_tree_seqs(*args, seqtype=seqtype),
            T.read_tree_seqs(*args, seqtype=seqtype))


@pytest.mark.parametrize("seqtype", [0, 1])
def test_read_tree_seqs_matches(seqtype):
    hj, ht = hetero(seqtype)
    assert ht.fixed_ages == hj.fixed_ages
    ref = interop.hetero_data_from(hj)
    for a, b in zip(ht.loci, ref.loci):
        np.testing.assert_array_equal(a.ipop, b.ipop)
        for f in ("parent", "children", "postorder"):
            np.testing.assert_array_equal(getattr(a.topo, f),
                                          getattr(b.topo, f))
        assert a.data.names == b.data.names
        np.testing.assert_array_equal(a.data.tip_partials,
                                      b.data.tip_partials)


def test_ages_fn_matches():
    hj, ht = hetero(0)
    fj, x0j, bj, freej = J.make_ages_fn(hj.sp_topo, hj.fixed_ages)
    ft, x0t, bt, freet = T.make_ages_fn(ht.sp_topo, ht.fixed_ages)
    np.testing.assert_array_equal(x0t, x0j)
    assert bt == bj and freet == freej
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = np.concatenate([[rng.uniform(0.6, 2)],
                            rng.uniform(0.05, 0.95, len(x0j) - 1)])
        np.testing.assert_allclose(ft(torch.tensor(x)).numpy(),
                                   np.asarray(fj(jnp.asarray(x))),
                                   rtol=1e-14)


def random_x(x0, bounds, rng):
    lo = np.array([b[0] for b in bounds])
    hi = np.minimum([b[1] for b in bounds], 5.0)
    return np.clip(x0 * rng.uniform(0.8, 1.2, len(x0)), lo + 1e-3,
                   hi - 1e-3)


@pytest.mark.parametrize("seqtype,kw", [
    (0, dict(model="TN93", ncatG=4, fix_alpha=False, alpha=0.5))])
def test_step3_objective_matches(seqtype, kw):
    """TN93 + estimated gamma, two rate groups per locus (HKY85 and codon
    loci are held through the fits below)."""
    hj, ht = hetero(seqtype)
    labels = [np.arange(gt.topo.nnode) % 2 for gt in hj.loci]
    for lab, gt in zip(labels, hj.loci):
        lab[gt.topo.root] = 0
    spec = dict(clock=5, seqtype=seqtype, **kw)
    negj, _, (xa0, xab), dims = J.make_step3_objective(
        hj, J.Clock56Spec(**spec), labels, [2, 2])
    negt, _, (xa0t, _), dims_t = T.make_step3_objective(
        ht, T.Clock56Spec(**spec), labels, [2, 2], device="cpu")
    assert dims_t == dims
    np.testing.assert_array_equal(xa0t, xa0)
    nxa, ntot_r, nr1, nw, G, est_alpha = dims
    rng = np.random.default_rng(1)
    n = nxa + ntot_r + nr1 * G + nw * G + (G if est_alpha else 0)
    x = np.concatenate([random_x(xa0, xab, rng),
                        rng.uniform(0.05, 0.3, n - nxa)])
    x[nxa + ntot_r:] = rng.uniform(0.3, 3.0, n - nxa - ntot_r)
    vj, gj = jax.jit(jax.value_and_grad(negj))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    v = negt(xt)
    (g,) = torch.autograd.grad(v, xt)
    assert float(v.detach()) == pytest.approx(float(vj), rel=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(gj)).max())


def test_ahrs_objective_matches():
    hj, ht = hetero(0)
    rng = np.random.default_rng(2)
    step1 = []
    for gt in hj.loci:
        nn = gt.topo.nnode
        step1.append((rng.uniform(0.02, 0.2, nn), rng.uniform(1e-4, 1e-2, nn),
                      0.0, None, None))
    negj, _, (xa0, xab), nrates, offs = J.make_ahrs_objective(hj, step1,
                                                              0.001)
    negt, _, _, nrates_t, offs_t = T.make_ahrs_objective(ht, step1, 0.001,
                                                         device="cpu")
    assert (nrates_t, offs_t) == (nrates, offs)
    x = np.concatenate([random_x(xa0, xab, rng),
                        rng.uniform(0.05, 0.3, nrates),
                        rng.uniform(0.01, 0.1, len(hj.loci))])
    vj, gj = jax.jit(jax.value_and_grad(negj))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    v = negt(xt)
    (g,) = torch.autograd.grad(v, xt)
    assert float(v.detach()) == pytest.approx(float(vj), rel=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(gj)).max())


def test_clock5_matches_jax_and_golden():
    hj, ht = hetero(0)
    spec = dict(clock=5, model="HKY85", ncatG=1)
    rj = J.fit_clock5(hj, J.Clock56Spec(**spec))
    rt = T.fit_clock5(ht, T.Clock56Spec(**spec), device="cpu")
    assert rt.lnL == pytest.approx(rj.lnL, abs=1e-6)
    assert rt.np == rj.np
    np.testing.assert_allclose(rt.ages, rj.ages, rtol=1e-5, atol=1e-6)
    ref = GOLD["clock5"]
    assert rt.lnL == pytest.approx(ref["lnL"], abs=2e-4)
    assert rt.np == ref["np"]
    np.testing.assert_allclose([r[0] for r in rt.rates],
                               [r[0] for r in ref["rates"]], atol=2e-4)
    np.testing.assert_allclose(rt.kappa.ravel(), ref["kappa"], atol=2e-3)


def test_codon_clock5_matches_jax():
    hj, ht = hetero(1)
    spec = dict(clock=5, seqtype=1, codonf="F3x4", ncatG=1)
    rj = J.fit_clock5(hj, J.Clock56Spec(**spec))
    rt = T.fit_clock5(ht, T.Clock56Spec(**spec), device="cpu")
    assert rt.lnL == pytest.approx(rj.lnL, abs=1e-6)
    np.testing.assert_allclose(rt.omega, rj.omega, rtol=1e-4)
    np.testing.assert_allclose(rt.kappa, rj.kappa, rtol=1e-4)
