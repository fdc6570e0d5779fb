"""paml_tpu_torch codon Q, pi and flux scalars against paml_tpu (float64,
1e-12): Fequal/F1x4/F3x4/Fcodon (F61) under icode 0 and 1, plus the
hkyREV and Muse-Gaut exchangeabilities."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paml_tpu.models import codon as jax_codon
from paml_tpu_torch.models import codon

OMEGAS = [0.07, 1.0, 2.5]


def _data_freqs(graph, seed):
    """Codon frequencies counted from random clean data (some codons
    unobserved, so Fcodon has zero-frequency states)."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, graph.n - 5, size=(6, 40))
    fpatt = rng.integers(1, 4, size=40).astype(float)
    got = codon.count_codon_freqs(states, fpatt, graph)
    ref = jax_codon.count_codon_freqs(states, fpatt, graph)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("icode", [0, 1])
@pytest.mark.parametrize("codonf", ["Fequal", "F1x4", "F3x4", "Fcodon"])
def test_Q_pi_flux_match(icode, codonf):
    graph_j = jax_codon.codon_graph(icode)
    graph = codon.codon_graph(icode)
    np.testing.assert_array_equal(graph.pi_idx, graph_j.pi_idx)
    np.testing.assert_array_equal(graph.is_syn, graph_j.is_syn)
    fcodon, f3x4, f1x4 = _data_freqs(graph, seed=icode)
    pi = codon.codon_pi(codonf, fcodon, f3x4, f1x4, graph)
    np.testing.assert_array_equal(
        pi, jax_codon.codon_pi(codonf, fcodon, f3x4, f1x4, graph_j))
    T = codon.dense_tables(icode, "cpu")
    kappa = 2.7
    s = codon.mutation_dense(T, torch.tensor([kappa], dtype=torch.float64))
    s_j = jax_codon.mutation_dense(graph_j, kappa, None, False, jnp.float64)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-12,
                               atol=1e-12)
    pit = torch.tensor(pi)
    Q = codon.build_Q_dense(T, s, torch.tensor(OMEGAS, dtype=torch.float64),
                            pit)
    for k, w in enumerate(OMEGAS):
        Qj = jax_codon.build_Q_dense(graph_j, s_j, w, jnp.asarray(pi))
        np.testing.assert_allclose(Q[k].numpy(), np.asarray(Qj), rtol=1e-12,
                                   atol=1e-12)
    rs, ra = codon.flux_dense(T, s, pit)
    rs_j, ra_j = jax_codon.flux_dense(graph_j, s_j, jnp.asarray(pi))
    np.testing.assert_allclose([float(rs), float(ra)],
                               [float(rs_j), float(ra_j)], rtol=1e-12)


@pytest.mark.parametrize("hkyrev,codonf", [(True, "F3x4"), (False, "F3x4MG"),
                                           (True, "F1x4MG")])
def test_mutation_dense_variants_match(hkyrev, codonf):
    graph_j = jax_codon.codon_graph(0)
    graph = codon.codon_graph(0)
    fcodon, f3x4, f1x4 = _data_freqs(graph, seed=7)
    pf = codon.mg_pf3x4(codonf, f3x4, f1x4)
    kappa = np.array([2.0, 0.5, 1.3, 0.8, 1.7]) if hkyrev else np.array([3.1])
    s = codon.mutation_dense(codon.dense_tables(0, "cpu"),
                             torch.tensor(kappa), pf, hkyrev)
    s_j = jax_codon.mutation_dense(graph_j, kappa if hkyrev else kappa[0],
                                   pf, hkyrev, jnp.float64)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-12,
                               atol=1e-12)


# --- the pair form and the mutation-selection models ---------------------

def t64(v, grad=False):
    return torch.tensor(np.asarray(v, dtype=np.float64), requires_grad=grad)


@pytest.mark.parametrize("icode", [0, 1])
@pytest.mark.parametrize("hkyrev,mg", [(False, False), (True, False),
                                       (False, True)])
def test_pair_form_matches(icode, hkyrev, mg):
    graph_j = jax_codon.codon_graph(icode)
    graph = codon.codon_graph(icode)
    G = codon.pair_tables(icode, "cpu")
    fcodon, f3x4, f1x4 = _data_freqs(graph, seed=3)
    pi = codon.codon_pi("F3x4", fcodon, f3x4, f1x4, graph)
    kappa = np.array([2.0, 0.5, 1.3, 0.8, 1.7]) if hkyrev else np.array([3.1])
    pf = f3x4 if mg else None
    s = codon.mutation_part(G, t64(kappa), pf, hkyrev)
    s_j = jax_codon.mutation_part(graph_j, kappa if hkyrev else kappa[0],
                                  pf, hkyrev)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-13)
    rs, ra = codon.flux(G, s, t64(pi))
    rs_j, ra_j = jax_codon.flux(graph_j, s_j, jnp.asarray(pi))
    np.testing.assert_allclose([float(rs), float(ra)],
                               [float(rs_j), float(ra_j)], rtol=1e-13)
    Q = codon.build_Q(G, s, t64(OMEGAS), t64(pi))
    for k, w in enumerate(OMEGAS):
        Qj = jax_codon.build_Q(graph_j, s_j, w, jnp.asarray(pi))
        np.testing.assert_allclose(Q[k].numpy(), np.asarray(Qj), rtol=1e-13,
                                   atol=1e-15)
    # the pair form and the dense form build the same Q
    T = codon.dense_tables(icode, "cpu")
    Qd = codon.build_Q_dense(
        T, codon.mutation_dense(T, t64(kappa), pf, hkyrev), t64(OMEGAS),
        t64(pi))
    np.testing.assert_allclose(Q.numpy(), Qd.numpy(), rtol=1e-13, atol=1e-15)
    # dN and dS of a branch from the flux scalars
    for w, t in ((0.3, 0.2), (1.7, 0.0)):
        got = codon.branch_dnds(float(rs), float(ra), w, t, 300)
        ref = jax_codon.branch_dnds(graph_j, s_j, jnp.asarray(pi), w, t, 300)
        assert got.keys() == ref.keys()
        for key in ref:
            assert got[key] == pytest.approx(ref[key], rel=1e-12)


@pytest.mark.parametrize("codonf,est", [("FMutSel0", False),
                                        ("FMutSel0", True),
                                        ("FMutSel", False), ("FMutSel", True)])
def test_fmutsel_matches(codonf, est):
    import jax
    graph_j = jax_codon.codon_graph(0)
    graph = codon.codon_graph(0)
    G = codon.pair_tables(0, "cpu")
    fcodon, _, _ = _data_freqs(graph, seed=5)
    rng = np.random.default_rng(9)
    pf = rng.dirichlet(np.full(4, 6.0))
    nfit = (19 if codonf == "FMutSel0" else graph.n - 1) if est else 0
    fit = rng.normal(0.0, 0.7, size=nfit)
    np.testing.assert_array_equal(codon.observed_piAA(fcodon, graph),
                                  jax_codon.observed_piAA(fcodon, graph_j))

    def jax_all(pf, fit):
        pi = jax_codon.fmutsel_pi(codonf, pf, fit if est else None, fcodon,
                                  graph_j)
        return pi, jax_codon.fmutsel_multiplier(graph_j, pf, pi, 300)

    def torch_all(pf, fit):
        pi = codon.fmutsel_pi(codonf, pf, fit if est else None, fcodon, G)
        return pi, codon.fmutsel_multiplier(G, pf, pi, 300)

    pi_j, m_j = jax_all(jnp.asarray(pf), jnp.asarray(fit))
    pft, fitt = t64(pf, True), t64(fit, True)
    pi, m = torch_all(pft, fitt)
    np.testing.assert_allclose(pi.detach().numpy(), np.asarray(pi_j),
                               rtol=1e-13)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(m_j),
                               rtol=1e-12)
    # gradients in the mutation bias and the fitnesses
    w_pi, w_m = rng.normal(size=graph.n), rng.normal(size=len(m_j))
    gj = jax.grad(lambda a, b: (jax_all(a, b)[0] * w_pi).sum()
                  + (jax_all(a, b)[1] * w_m).sum(), argnums=(0, 1))(
        jnp.asarray(pf), jnp.asarray(fit))
    g = torch.autograd.grad((pi * t64(w_pi)).sum() + (m * t64(w_m)).sum(),
                            (pft, fitt), allow_unused=True)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(gj[0]), rtol=1e-9,
                               atol=1e-12)
    if est:
        np.testing.assert_allclose(g[1].numpy(), np.asarray(gj[1]),
                                   rtol=1e-9, atol=1e-12)
