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
