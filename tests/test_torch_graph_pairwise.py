"""The pairwise programs' slot and clock 5 / 6's capturable objectives
against paml_tpu on the CPU in float64, the same inputs from one numpy
seed:

- codeml -2's codon objective (F3x4; and on 4 taxa with `fix_kappa` and
  with F1x4MG) and aaml -2's amino-acid objective, the program's one slot
  loaded pair after pair, against the objectives `paml_tpu.apps.pairwise`
  builds for each pair of a 6-taxon alignment (each program's optimizer
  stubbed to evaluate them): value 1e-10 relative, gradient 1e-8 of its
  largest component;
- a refilled slot gives the same bits as a slot built for that pair, and
  a padded pair agrees with the unpadded objective within 1e-13;
- clock 5's step-3 objective and clock 6's AHRS objective under
  `no_host_reads` (tests/test_torch_graphs.py's guard) against
  `paml_tpu.apps.clock56`'s: 1e-10 and 1e-8;
- `optim.maximize` handed a graph cache on the CPU makes no capture.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paml_tpu.apps import clock56 as J
from paml_tpu.apps import pairwise as jax_pw
from paml_tpu_torch import interop
from paml_tpu_torch.apps import clock56 as T
from paml_tpu_torch.apps import pairwise
from paml_tpu_torch.core import optim
from paml_tpu_torch.models import codon

from test_torch_clock56 import hetero, random_x
from test_torch_graphs import guarded_value_grad
from test_torch_pairwise import clock56, clock56_aa

torch.set_num_threads(1)


def torch_value_grad(neg, x):
    xt = torch.tensor(x, requires_grad=True)
    v = neg(xt)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.numpy()


def jax_value_grad(neg, x):
    v, g = jax.value_and_grad(neg)(jnp.asarray(x))
    return float(v), np.asarray(g)


def recorder(out, points, value_grad):
    """A stand-in for a program's `maximize`: it records the value and
    gradient of the objective it is handed at the next point, at once
    (the port's slot holds the pair then, and the JAX package's closures
    read the pair's frequencies from their enclosing loop), and returns
    the start as the optimum."""
    def maximize(neg, x0, bounds=None, **kw):
        out.append(value_grad(neg, points[len(out)]))
        return types.SimpleNamespace(x=np.asarray(x0, np.float64), lnL=0.0)
    return maximize


def run_both(monkeypatch, points, run_jax, run_torch):
    """The value and gradient at each point of each pair's objective, the
    JAX package's and the port's, held to 1e-10 and 1e-8."""
    got, ref = [], []
    monkeypatch.setattr(jax_pw, "maximize",
                        recorder(ref, points, jax_value_grad))
    run_jax()
    monkeypatch.setattr(pairwise, "maximize",
                        recorder(got, points, torch_value_grad))
    run_torch()
    assert len(got) == len(ref) == len(points)
    for (v, g), (vj, gj) in zip(got, ref):
        assert abs(v - vj) <= 1e-10 * abs(vj)
        assert np.abs(g - gj).max() <= 1e-8 * np.abs(gj).max()


@pytest.mark.parametrize("codonf,fix_kappa,ns", [
    ("F3x4", False, 6), ("F3x4", True, 4), ("F1x4MG", False, 4)])
def test_codon_slot_matches_jax_pairs(codonf, fix_kappa, ns, monkeypatch):
    """Every pair of 6 taxa; `fix_kappa` and the Muse-Gaut divisors on 4
    (the JAX side evaluates op by op, about a second a pair)."""
    data = clock56(ns)
    rng = np.random.default_rng(18)
    points = [np.array([rng.uniform(0.05, 1.5)]
                       + ([] if fix_kappa else [rng.uniform(0.5, 6.0)])
                       + [rng.uniform(0.05, 2.0)])
              for _ in range(ns * (ns - 1) // 2)]
    run_both(monkeypatch, points,
             lambda: jax_pw.pairwise_codon(data, codonf=codonf,
                                           fix_kappa=fix_kappa, kappa0=2.5),
             lambda: pairwise.pairwise_codon(
                 interop.packed_from(data), codonf=codonf,
                 fix_kappa=fix_kappa, kappa0=2.5, device="cpu"))


def test_aa_slot_matches_jax_pairs(monkeypatch):
    data = clock56_aa(6)
    rng = np.random.default_rng(19)
    points = [np.array([rng.uniform(0.02, 2.0)]) for _ in range(15)]
    run_both(monkeypatch, points, lambda: jax_pw.pairwise_aa(data),
             lambda: pairwise.pairwise_aa(interop.packed_from(data),
                                          device="cpu"))


def slot_value_grad(cp, x):
    xt = torch.tensor(x, requires_grad=True)
    v = cp.loglik(xt[0], xt[1], xt[2])
    (g,) = torch.autograd.grad(v, xt)
    return v.detach(), g


def test_refilled_slot_same_bits_and_padding():
    """A slot refilled with a pair gives the bits of a slot built for it
    (at the same length); a pair padded with weight-0 patterns agrees
    with its unpadded objective within 1e-13."""
    data = interop.packed_from(clock56(6))
    G, graph = codon.pair_tables(0, "cpu"), codon.codon_graph(0)
    pairs = [(i, j) for i in range(6) for j in range(i)]
    hmax = pairwise._max_patterns(data, pairs)
    x = np.array([0.4, 2.2, 0.3])
    slot = pairwise._CodonPair(data, 1, 0, "F3x4", G, graph, "cpu", False,
                               hmax=hmax)
    for i, j in [(5, 2), (3, 1), (2, 0)]:
        slot.load(data, i, j)
        fresh = pairwise._CodonPair(data, i, j, "F3x4", G, graph, "cpu",
                                    False, hmax=hmax)
        v, g = slot_value_grad(slot, x)
        vf, gf = slot_value_grad(fresh, x)
        assert torch.equal(v, vf) and torch.equal(g, gf)
        own = pairwise._CodonPair(data, i, j, "F3x4", G, graph, "cpu", False)
        assert own.hmax == len(own.w) < hmax
        vo, go = slot_value_grad(own, x)
        assert abs(float(v - vo)) <= 1e-13 * abs(float(vo))
        assert float((g - go).abs().max()) <= 1e-13 * float(go.abs().max())


def assert_guarded_matches(neg_t, neg_j, x, monkeypatch):
    assert neg_t.capturable is True
    v, g, read = guarded_value_grad(neg_t, x, monkeypatch)
    assert read is None, read
    vj, gj = jax.jit(jax.value_and_grad(neg_j))(jnp.asarray(x))
    vj, gj = float(vj), np.asarray(gj)
    assert float(v.detach()) == pytest.approx(vj, rel=1e-10)
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-8,
                               atol=1e-8 * np.abs(gj).max())


@pytest.mark.parametrize("kw", [
    dict(model="TN93", ncatG=4, fix_alpha=False, alpha=0.5),
    dict(model="HKY85", fix_kappa=True, kappa=[3.0, 1.5])])
def test_step3_objective_guarded_matches_jax(kw, monkeypatch):
    """The step-3 objective of clock 5 / 6 (two rate groups per locus)
    under the host-read guard, its gamma quantiles on the card's route
    (E2's plain versions), against the JAX package's."""
    hj, ht = hetero(0)
    labels = [np.arange(gt.topo.nnode) % 2 for gt in hj.loci]
    for lab, gt in zip(labels, hj.loci):
        lab[gt.topo.root] = 0
    spec = dict(clock=5, **kw)
    negj, _, (xa0, xab), dims = J.make_step3_objective(
        hj, J.Clock56Spec(**spec), labels, [2, 2])
    negt, _, _, dims_t = T.make_step3_objective(
        ht, T.Clock56Spec(**spec), labels, [2, 2], device="cpu")
    assert dims_t == dims
    nxa, ntot_r, nr1, nw, G, est_alpha = dims
    rng = np.random.default_rng(20)
    n = nxa + ntot_r + nr1 * G + nw * G + (G if est_alpha else 0)
    x = np.concatenate([random_x(xa0, xab, rng),
                        rng.uniform(0.05, 0.3, ntot_r),
                        rng.uniform(0.3, 3.0, n - nxa - ntot_r)])
    assert_guarded_matches(negt, negj, x, monkeypatch)


def test_ahrs_objective_guarded_matches_jax(monkeypatch):
    hj, ht = hetero(0)
    rng = np.random.default_rng(21)
    step1 = [(rng.uniform(0.02, 0.2, gt.topo.nnode),
              rng.uniform(1e-4, 1e-2, gt.topo.nnode), 0.0, None, None)
             for gt in hj.loci]
    negj, _, (xa0, xab), nrates, _ = J.make_ahrs_objective(hj, step1, 0.001)
    negt = T.make_ahrs_objective(ht, step1, 0.001, device="cpu")[0]
    x = np.concatenate([random_x(xa0, xab, rng),
                        rng.uniform(0.05, 0.3, nrates),
                        rng.uniform(0.01, 0.1, len(hj.loci))])
    assert_guarded_matches(negt, negj, x, monkeypatch)


def test_maximize_with_a_cache_on_cpu_makes_no_capture():
    def neg(x):
        return ((x - torch.arange(3, dtype=x.dtype)) ** 2).sum()
    neg.capturable = True
    optim.GRAPHS.update(dict.fromkeys(optim.GRAPHS, 0))
    with optim.GraphCache() as cache:
        for start in (5.0, -3.0):
            res = optim.maximize(neg, np.full(3, start), device="cpu",
                                 cache=cache)
            np.testing.assert_allclose(res.x, [0.0, 1.0, 2.0], atol=1e-6)
        assert len(cache) == 0
    assert optim.GRAPHS["captures"] == 0
    assert optim.GRAPHS["graphed_evals"] == 0
    assert optim.GRAPHS["eager_evals"] > 0
    with pytest.raises(ValueError, match="CUDA"):
        optim.GraphCache().get(neg, np.zeros(3), "cpu")
