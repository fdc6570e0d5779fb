"""paml_tpu_torch P(t) against paml_tpu (float64): values and gradients in
Q, pi and t to 1e-8 relative, on a codon Q, a degenerate spectrum (Fequal
at kappa = omega = 1) and a Q with zero-frequency states, plus gradcheck
of the Daleckii-Krein backward."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.core import pmat as jax_pmat
from paml_tpu.models import codon as jax_codon
from paml_tpu_torch.core import pmat
from paml_tpu_torch.models import codon


def _codon_case(pi, kappa, omegas):
    T = codon.dense_tables(0, "cpu")
    s = codon.mutation_dense(T, torch.tensor([kappa], dtype=torch.float64))
    return codon.build_Q_dense(T, s, torch.tensor(omegas,
                                                  dtype=torch.float64),
                               torch.tensor(pi))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _fequal():
    return np.full(61, 1 / 61)


def _f3x4():
    rng = np.random.default_rng(0)
    f3 = rng.dirichlet(np.full(4, 5.0), size=3)
    g = jax_codon.codon_graph(0)
    return codon.codon_pi("F3x4", None, f3, f3.mean(0), g)


def _zero_pi():
    pi = np.random.default_rng(1).dirichlet(np.ones(61))
    pi[[0, 7, 30]] = 0.0
    return pi / pi.sum()


@pytest.mark.parametrize("name,pi_fn,kappa,omegas", [
    ("codon", _f3x4, 2.3, [0.05, 1.0, 3.0]),
    ("degenerate", _fequal, 1.0, [1.0]),
    ("zero_pi", _zero_pi, 1.8, [0.3, 2.0]),
])
def test_pmat_values_and_grads_match(name, pi_fn, kappa, omegas):
    pi = pi_fn()
    Q = _codon_case(pi, kappa, omegas)
    G = Q.shape[0]
    rng = np.random.default_rng(2)
    ts = rng.uniform(0.001, 1.5, size=(7, G))
    W = rng.normal(size=(7, G, 61, 61))

    Qt = Q.clone().requires_grad_(True)
    pit = torch.tensor(pi, requires_grad=True)
    tst = torch.tensor(ts, requires_grad=True)
    P = pmat.pmat_rev_multi(Qt, pit, tst)
    (P * torch.tensor(W)).sum().backward()

    Qj, pij, tsj = jnp.asarray(Q.numpy()), jnp.asarray(pi), jnp.asarray(ts)
    Pj = jax.jit(jax_pmat.pmat_rev_multi)(Qj, pij, tsj)
    assert _rel(P.detach().numpy(), Pj) < 1e-8

    def f(Q_, pi_, ts_):
        return jnp.sum(jnp.asarray(W) * jax_pmat.pmat_rev_multi(Q_, pi_, ts_))
    gQ, gpi, gt = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(Qj, pij, tsj)
    assert np.isfinite(Qt.grad.numpy()).all()
    assert _rel(Qt.grad.numpy(), gQ) < 1e-8
    assert _rel(tst.grad.numpy(), gt) < 1e-8
    mask = pi > pmat.PI_FLOOR
    assert _rel(pit.grad.numpy()[mask], np.asarray(gpi)[mask]) < 1e-8
    assert (pit.grad.numpy()[~mask] == 0).all()


def test_pmat_gradcheck():
    rng = np.random.default_rng(3)
    n, G = 6, 2
    pi = rng.dirichlet(np.full(n, 3.0), size=G)
    Qs = []
    for g in range(G):
        R = rng.uniform(0.2, 2.0, size=(n, n))
        R = R + R.T
        Q = R * pi[g][None, :]
        np.fill_diagonal(Q, 0.0)
        Qs.append(Q - np.diag(Q.sum(1)))
    Qt = torch.tensor(np.stack(Qs), requires_grad=True)
    pit = torch.tensor(pi, requires_grad=True)
    ts = torch.tensor(rng.uniform(0.05, 0.8, size=(3, G)),
                      requires_grad=True)
    assert torch.autograd.gradcheck(pmat.pmat_rev_multi, (Qt, pit, ts),
                                    eps=1e-6, atol=1e-7, rtol=1e-5)


def test_pmat_zero_branch_is_identity():
    Q = _codon_case(_zero_pi(), 2.0, [0.4, 1.5])
    P = pmat.pmat_rev_multi(Q, torch.tensor(_zero_pi()),
                            torch.zeros(1, 2, dtype=torch.float64))
    np.testing.assert_allclose(P[0].numpy(), np.broadcast_to(np.eye(61),
                                                             (2, 61, 61)),
                               atol=1e-12)


def test_pmat_float32_raises():
    """The float32 refusal is gone: float32 takes the uniformization path
    (held against the JAX package's in tests/test_torch_f32.py) and agrees
    with float64 to 2e-6; a dtype other than float32 and float64 raises."""
    Q = _codon_case(_fequal(), 2.0, [0.5])
    pi, t = torch.tensor(_fequal()), torch.ones(2, 1, dtype=torch.float64)
    P32 = pmat.pmat_rev_multi(Q.float(), pi.float(), t.float())
    assert P32.dtype == torch.float32
    np.testing.assert_allclose(P32.numpy(),
                               pmat.pmat_rev_multi(Q, pi, t).numpy(),
                               rtol=0, atol=2e-6)
    with pytest.raises(TypeError, match="float32 or float64"):
        pmat.pmat_rev_multi(Q.half(), pi.half(), t.half())
