"""paml_tpu_torch pairwise (codeml runmode -2 / -3) against paml_tpu on
the CPU in float64: the codon and amino-acid pair objectives' value and
gradient at random points (1e-10 relative), `pairwise_codon` with F3x4,
F1x4, Fcodon and `fix_kappa` and `pairwise_aa` (lnL to 1e-8, MLEs to
1e-5), `bayes_pairwise_codon` on pairs that take each branch of the
saturation gate (E_t, E_w, SEs and P(w > 1) to 1e-6), the sliding-window
scan and the closed-form nucleotide distances.  Data: the first taxa of
`tests/data/clock56.{codon,nuc}` and codon pairs made from a seed with
numpy."""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import pairwise as jax_pw
from paml_tpu.constants import codon_string, sense_codons
from paml_tpu.core.pmat import pmat_rev as jax_pmat_rev
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.models import aa as jax_aa
from paml_tpu.models import codon as jax_codon
from paml_tpu_torch import interop
from paml_tpu_torch.apps import pairwise
from paml_tpu_torch.models import codon

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
BAYES_FIELDS = ("E_t", "E_w", "SE_t", "SE_w", "cov_tw", "corr_tw",
                "p_w_gt1", "t_center", "w_center")


def clock56(ns):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    aln = dataclasses.replace(aln, names=aln.names[:ns], rows=aln.rows[:ns])
    return jax_seqio.pack(aln, cleandata=True)


def clock56_aa(ns):
    """The first taxa of clock56.codon, translated."""
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    rows = jax_seqio.translate_codon_rows(aln.rows[:ns])
    return jax_seqio.pack(jax_seqio.Alignment(aln.names[:ns], rows,
                                              jax_seqio.AA_SEQ),
                          cleandata=True)


def codon_pair(rng, ncod, rate, syn_only=False):
    """A packed pair: random sense codons, and a copy with a share `rate`
    of them redrawn (or, with `syn_only`, one in six codons turned into
    a synonym)."""
    sense = sense_codons(0)
    g = jax_codon.codon_graph(0)
    a = rng.choice(sense, ncod)
    b = a.copy()
    hit = rng.random(ncod) < rate
    b[hit] = rng.choice(sense, int(hit.sum()))
    if syn_only:
        aa = dict(zip(g.sense, g.aa))
        for k in range(0, ncod, 6):
            syn = [c for c in sense if aa[c] == aa[a[k]] and c != a[k]]
            b[k] = syn[0] if syn else a[k]
    rows = ["".join(codon_string(int(v)) for v in r) for r in (a, b)]
    return jax_seqio.pack(jax_seqio.Alignment(["a", "b"], rows,
                                              jax_seqio.CODON_SEQ),
                          cleandata=True)


def jax_codon_loglik(data, i, j, codonf):
    """The JAX package's pair log-likelihood (its `pairwise_codon`
    closure, rebuilt from the same calls) as a function of (t, kappa,
    omega)."""
    graph = jax_codon.codon_graph(0)
    fcodon, f3x4, f1x4 = jax_codon.count_codon_freqs(
        data.tip_partials[[i, j]], data.fpatt, graph, None)
    pi = jnp.asarray(jax_codon.codon_pi(codonf, fcodon, f3x4, f1x4, graph))
    pf3x4 = jax_codon.mg_pf3x4(codonf, f3x4, f1x4)
    a, b, w = jax_pw._pair_patterns(data, i, j)

    def f(x):
        s = jax_codon.mutation_part(graph, x[1], pf3x4)
        Q = jax_codon.build_Q(graph, s, x[2], pi)
        mr = jax_codon.mean_rate(graph, s, x[2], pi)
        P = jax_pmat_rev(Q / mr, pi, x[0][None])[0]
        return jnp.sum(w * (jnp.log(jnp.maximum(pi, 1e-300))[a]
                            + jnp.log(jnp.maximum(P[a, b], 1e-300))))
    return jax.jit(jax.value_and_grad(f))


@pytest.mark.parametrize("codonf", ["F3x4", "F1x4", "Fcodon", "F3x4MG"])
def test_codon_objective_matches_jax(codonf):
    data = clock56(3)
    rng = np.random.default_rng(11)
    G, graph = codon.pair_tables(0, "cpu"), codon.codon_graph(0)
    for i, j in ((1, 0), (2, 1)):
        cp = pairwise._CodonPair(interop.packed_from(data), i, j, codonf, G,
                                 graph, "cpu", False)
        vg = jax_codon_loglik(data, i, j, codonf)
        for _ in range(3):
            x = np.array([rng.uniform(0.01, 2.0), rng.uniform(0.5, 8.0),
                          rng.uniform(0.05, 3.0)])
            xt = torch.tensor(x, requires_grad=True)
            v = cp.loglik(xt[0], xt[1], xt[2])
            (g,) = torch.autograd.grad(v, xt)
            vj, gj = vg(jnp.asarray(x))
            v, vj = float(v.detach()), float(vj)
            assert abs(v - vj) <= 1e-10 * abs(vj)
            np.testing.assert_allclose(g.numpy(), np.asarray(gj),
                                       rtol=1e-10, atol=1e-10 * abs(vj))


def test_aa_objective_matches_jax():
    data = clock56_aa(3)
    S, pi = jax_aa.model_S_pi("Empirical_F", None, data.base_freqs)
    Qj = jnp.asarray(np.asarray(jax_aa.build_aa_Q(S, pi)))
    a, b, w = jax_pw._pair_patterns(data, 2, 0)

    def f(x):
        P = jax_pmat_rev(Qj, jnp.asarray(pi), x[0][None])[0]
        return jnp.sum(w * (jnp.log(jnp.asarray(pi))[a]
                            + jnp.log(jnp.maximum(P[a, b], 1e-300))))
    from paml_tpu_torch.models import aa
    Qt = aa.build_aa_Q(torch.as_tensor(S), torch.as_tensor(pi))
    for t in (0.05, 0.4, 1.7):
        xt = torch.tensor([t], dtype=torch.float64, requires_grad=True)
        P = pairwise.pmat_rev(Qt, torch.as_tensor(pi), xt[0][None])[0]
        v = torch.sum(torch.as_tensor(w) * (torch.log(torch.as_tensor(pi))[a]
                                            + torch.log(P[a, b])))
        (g,) = torch.autograd.grad(v, xt)
        vj, gj = jax.value_and_grad(f)(jnp.asarray([t]))
        assert abs(float(v.detach()) - float(vj)) <= 1e-10 * abs(float(vj))
        assert abs(float(g[0]) - float(gj[0])) <= 1e-10 * abs(float(vj))


def assert_ml_pairs(rt, rj):
    assert [(r.i, r.j) for r in rt] == [(r.i, r.j) for r in rj]
    for a, b in zip(rt, rj):
        assert abs(a.lnL - b.lnL) <= 1e-8 * abs(b.lnL)
        for f in ("t", "kappa", "omega", "dS", "dN", "S", "N"):
            u, v = getattr(a, f), getattr(b, f)
            assert abs(u - v) <= 1e-5 * max(abs(v), 1.0), (a.i, a.j, f)


@pytest.mark.parametrize("codonf,fix_kappa", [
    ("F3x4", False), ("F1x4", False), ("Fcodon", False), ("F3x4", True)])
def test_pairwise_codon_matches_jax(codonf, fix_kappa):
    data = clock56(3)
    rj = jax_pw.pairwise_codon(data, codonf=codonf, fix_kappa=fix_kappa)
    rt = pairwise.pairwise_codon(interop.packed_from(data), codonf=codonf,
                                 fix_kappa=fix_kappa, device="cpu")
    assert_ml_pairs(rt, rj)


def test_pairwise_aa_matches_jax():
    data = clock56_aa(3)
    rj = jax_pw.pairwise_aa(data)
    rt = pairwise.pairwise_aa(interop.packed_from(data), device="cpu")
    assert_ml_pairs(rt, rj)


def gate_problem(kind):
    rng = np.random.default_rng(2024)
    if kind == "moderate":        # 0 < pS, pN < 0.74: the MLE-centred grid
        return codon_pair(rng, 120, 0.15, syn_only=True)
    if kind == "identical":       # the MAP start at a_w / b_w, kappa 2
        return codon_pair(rng, 120, 0.0)
    return codon_pair(rng, 120, 1.0)   # saturated: pS >= 0.74, the MAP


def assert_bayes(rt, rj, tol=1e-6):
    for a, b in zip(rt, rj):
        assert (a.i, a.j) == (b.i, b.j)
        assert abs(a.lnL - b.lnL) <= 1e-8 * abs(b.lnL)
        assert abs(a.kappa - b.kappa) <= 1e-5 * max(abs(b.kappa), 1.0)
        for f in BAYES_FIELDS:
            u, v = getattr(a, f), getattr(b, f)
            assert abs(u - v) <= tol * max(abs(v), 1.0), (f, u, v)


@pytest.mark.parametrize("kind", ["moderate", "identical", "saturated"])
def test_bayes_gate_matches_jax(kind):
    from paml_tpu.apps.yn00 import _path_tables, _tables

    data = gate_problem(kind)
    a, b, w = jax_pw._pair_patterns(data, 1, 0)
    T, PT = _tables(0), _path_tables(0)
    Sng = ((T["ng_syn"][a] + T["ng_syn"][b]) * 3.0 / 18.0) @ w
    pS = (PT["ng_sd"][a, b] @ w) / Sng
    assert {"moderate": 0 < pS < 0.74, "identical": pS == 0,
            "saturated": pS >= 0.74}[kind], pS
    rj = jax_pw.bayes_pairwise_codon(data)
    rt = pairwise.bayes_pairwise_codon(interop.packed_from(data),
                                       device="cpu")
    assert_bayes(rt, rj)
    if kind == "identical":
        assert rt[0].kappa == 2.0
    if kind == "moderate":
        # the grid is centred on the MLE
        ml = pairwise.pairwise_codon(interop.packed_from(data),
                                     device="cpu")[0]
        assert abs(rt[0].t_center - ml.t) <= 1e-5 * ml.t


def test_bayes_unit_scale_fallback(monkeypatch):
    """Curvature that is not positive definite: both packages fall back
    to unit scales on the diagonal (forced here through each package's
    Hessian call)."""
    H = np.array([[-3.0, 0.5], [0.5, 2.0]])
    monkeypatch.setattr(jax_pw, "jax", types.SimpleNamespace(
        hessian=lambda f: (lambda x: jnp.asarray(H)), vmap=jax.vmap))
    monkeypatch.setattr(torch.autograd.functional, "hessian",
                        lambda f, x: torch.as_tensor(H))
    data = gate_problem("moderate")
    rj = jax_pw.bayes_pairwise_codon(data)
    rt = pairwise.bayes_pairwise_codon(interop.packed_from(data),
                                       device="cpu")
    assert_bayes(rt, rj)


def test_sliding_window_matches_jax():
    data = clock56(2)
    rj, pj = jax_pw.sliding_window_codon(data, 100, 100)
    rt, pt = pairwise.sliding_window_codon(interop.packed_from(data), 100,
                                           100, device="cpu")
    assert pt == pj and len(rt) == len(rj) == 3
    for a, b in zip(rt, rj):
        assert (a.start, a.length, a.significant) == \
            (b.start, b.length, b.significant)
        for f in ("lnL0", "lnL1"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-8 * abs(
                getattr(b, f))
        for f in ("omega", "t"):
            assert abs(getattr(a, f) - getattr(b, f)) <= 1e-5 * max(
                abs(getattr(b, f)), 1.0)


@pytest.mark.parametrize("model", ["JC69", "K80", "F81", "F84", "HKY85",
                                   "TN93"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_nuc_distance_matches_jax(model, alpha):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.nuc"),
                                   jax_seqio.BASE_SEQ)
    data = jax_seqio.pack(aln, cleandata=True)
    Dj = jax_pw.distance_matrix(data, model, alpha)
    Dt = pairwise.distance_matrix(interop.packed_from(data), model, alpha)
    np.testing.assert_allclose(Dt, Dj, rtol=1e-12)
    for i, j in ((1, 0), (5, 2)):
        kt = pairwise.nuc_distance(interop.packed_from(data), i, j, model,
                                   alpha)[1]
        kj = jax_pw.nuc_distance(data, i, j, model, alpha)[1]
        assert (kt is None and kj is None) or abs(kt - kj) <= 1e-12 * abs(kj)
