"""paml_tpu_torch rate HMM against paml_tpu: `hmm_lnL`'s pairwise tree
reduction over the sites against both of the JAX package's forms (the
sequential `lax.scan` and the log-scaled `associative_scan`) at L = 1, 2,
3, 1000 and 4097 sites, value to 1e-12 relative and gradient in the site
log-likelihoods, the transition matrix and the class frequencies to 1e-10
of the largest component (L = 1 against the sequential form alone: the
JAX associative form has no matrix to scan there and raises); the same
value on a CPU tensor twice, bit for bit; `binormal_cdf` and
`autod_gamma` with their gradients in alpha and rho."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.core import hmm as jax_hmm
from paml_tpu_torch.core import hmm

torch.set_num_threads(1)


def problem(L, K=4, seed=0):
    rng = np.random.default_rng(seed + L)
    lnf = rng.normal(-8.0, 3.0, size=(K, L))
    M = rng.dirichlet(np.full(K, 2.0), size=K)
    w = rng.dirichlet(np.full(K, 3.0))
    return lnf, M, w


@pytest.mark.parametrize("L", [1, 2, 3, 1000, 4097])
def test_hmm_lnL_matches_jax(L):
    lnf, M, w = problem(L)
    args = [torch.tensor(v, requires_grad=True) for v in (lnf, M, w)]
    v = hmm.hmm_lnL(*args)
    # one site reads no transition matrix
    g = [torch.zeros_like(x) if d is None else d for x, d in zip(
        args, torch.autograd.grad(v, args, allow_unused=True))]
    forms = [False] if L == 1 else [False, True]
    for assoc in forms:
        vj, gj = jax.jit(jax.value_and_grad(
            lambda a, b, c: jax_hmm.hmm_lnL(a, b, c, use_associative=assoc),
            argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (lnf, M, w)))
        assert abs(v.item() - float(vj)) <= 1e-12 * abs(float(vj))
        for a, b in zip(g, gj):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-10 * np.abs(b).max())
    # a fixed order of products: the same bits again
    assert hmm.hmm_lnL(*(torch.tensor(x) for x in (lnf, M, w))).item() \
        == v.item()


@pytest.mark.parametrize("h,k,r", [(0.3, -0.5, 0.6), (-1.2, -0.7, -0.15),
                                   (1.8, 2.5, 0.95), (0.0, 0.0, 0.0)])
def test_binormal_cdf_matches_jax(h, k, r):
    args = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for v in (h, k, r)]
    v = hmm.binormal_cdf(*args)
    g = torch.autograd.grad(v, args)
    vj, gj = jax.value_and_grad(jax_hmm.binormal_cdf, argnums=(0, 1, 2))(
        *(jnp.asarray(float(x)) for x in (h, k, r)))
    assert abs(v.item() - float(vj)) <= 1e-13
    np.testing.assert_allclose([x.item() for x in g],
                               [float(x) for x in gj], rtol=1e-11,
                               atol=1e-13)


@pytest.mark.parametrize("K,alpha,rho", [(4, 0.5, 0.3), (5, 1.7, -0.1),
                                         (3, 0.8, 0.9)])
def test_autod_gamma_matches_jax(K, alpha, rho):
    a, p = (torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for v in (alpha, rho))
    r, w, M = hmm.autod_gamma(a, p, K)
    C = np.random.default_rng(K).normal(size=(K, K))

    def functional(al, rh):
        r_j, w_j, M_j = jax_hmm.autod_gamma(al, rh, K)
        return jnp.sum(M_j * C) + jnp.sum(r_j) ** 2, (r_j, w_j, M_j)
    (_, outs_j), gj = jax.jit(jax.value_and_grad(
        functional, argnums=(0, 1), has_aux=True))(jnp.asarray(alpha),
                                                   jnp.asarray(rho))
    for x, y in zip((r, w, M), outs_j):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(M.detach().sum(1).numpy(), 1.0, atol=1e-14)
    g = torch.autograd.grad((M * torch.as_tensor(C)).sum() + r.sum() ** 2,
                            (a, p))
    np.testing.assert_allclose([x.item() for x in g],
                               [float(x) for x in gj], rtol=1e-9, atol=1e-12)


def test_gauss_laguerre_matches_jax():
    """basemlg's Gauss-Laguerre rule and the gamma expectation built on it
    (E[r^2] of Gamma(alpha, alpha) is 1 + 1 / alpha)."""
    from paml_tpu.core import dgamma as jax_dgamma
    from paml_tpu_torch.core import dgamma

    for n in (8, 32):
        for a, b in zip(dgamma.gauss_laguerre(n),
                        jax_dgamma.gauss_laguerre(n)):
            np.testing.assert_array_equal(a, b)
    for alpha in (0.7, 2.5):
        got = dgamma.gamma_expectation_gl(lambda r: r * r, alpha, n=64)
        assert got == jax_dgamma.gamma_expectation_gl(lambda r: r * r,
                                                      alpha, n=64)
        assert abs(got - (1 + 1 / alpha)) < 1e-3 * (1 + 1 / alpha)
