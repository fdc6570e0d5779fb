"""paml_tpu_torch.core.dgamma against paml_tpu.core.dgamma on the same
numpy inputs, float64: values to 1e-10 relative, gradients to 1e-7 against
`jax.grad`, at small p, q (0.05, where M7/M8 optima sit) too; the
incomplete gamma's derivative in its shape against
`jax.scipy.special.gammainc`'s; second derivatives of the beta quantiles
(the Hessian route) against `jax.hessian`; and the two slower kinds of
number behind the fast path (numpy duals, tensors under autograd)
against each other."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import gammainc as jax_gammainc

from paml_tpu.core import dgamma as jax_dgamma
from paml_tpu_torch.core import dgamma

torch.set_num_threads(1)

PQ = [(0.05, 0.05), (0.05, 2.0), (0.5, 1.2), (2.0, 3.0), (30.0, 0.3)]
ALPHAS = [0.02, 0.6, 1.0, 5.0, 49.0]
YS = (np.arange(10) + 0.5) / 10


def t64(v, grad=True):
    return torch.tensor(v, dtype=torch.float64, requires_grad=grad)


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("p,q", PQ)
def test_betainc_matches_jax(p, q):
    x = np.random.default_rng(3).uniform(0.001, 0.999, 9)
    vj = jax_dgamma.betainc(p, q, jnp.asarray(x))
    gj = jax.grad(lambda a, b, x: jax_dgamma.betainc(a, b, x).sum(),
                  argnums=(0, 1, 2))(p, q, jnp.asarray(x))
    a, b, xt = t64(p), t64(q), t64(x)
    v = dgamma.betainc(a, b, xt)
    g = torch.autograd.grad(v.sum(), (a, b, xt))
    assert rel(v.detach(), vj) < 1e-10
    for got, want in zip(g, gj):
        assert rel(got, want) < 1e-7


@pytest.mark.parametrize("p,q", PQ)
def test_betaincinv_matches_jax(p, q):
    w = np.arange(1.0, 11.0)
    vj = jax_dgamma.betaincinv(p, q, jnp.asarray(YS))
    gj = jax.grad(lambda a, b, y: (jax_dgamma.betaincinv(a, b, y)
                                   * w).sum(), argnums=(0, 1, 2))(
        p, q, jnp.asarray(YS))
    a, b, y = t64(p), t64(q), t64(YS)
    v = dgamma.betaincinv(a, b, y)
    g = torch.autograd.grad((v * torch.tensor(w)).sum(), (a, b, y))
    assert rel(v.detach(), vj) < 1e-10
    for got, want in zip(g, gj):
        assert rel(got, want) < 1e-7


@pytest.mark.parametrize("p,q", [(0.05, 0.05), (0.5, 1.2)])
def test_betaincinv_second_derivatives_match_jax(p, q):
    w = np.arange(1.0, 11.0)
    hj = jax.hessian(lambda ab: (jax_dgamma.betaincinv(
        ab[0], ab[1], jnp.asarray(YS)) * w).sum())(jnp.asarray([p, q]))
    a, b = t64(p), t64(q)
    v = (dgamma.betaincinv(a, b, torch.tensor(YS)) * torch.tensor(w)).sum()
    g = torch.autograd.grad(v, (a, b), create_graph=True)
    h = np.array([[float(z) for z in torch.autograd.grad(
        gi, (a, b), retain_graph=True)] for gi in g])
    np.testing.assert_allclose(h, np.asarray(hj), rtol=1e-7)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_gammainc_matches_jax(alpha):
    x = np.array([1e-5, 0.01, 0.3, 1.0, 3.0, alpha, alpha + 1.5,
                  4 * alpha + 2, 60.0])
    vj = jax_gammainc(alpha, jnp.asarray(x))
    gj = jax.grad(lambda a, x: jax_gammainc(a, x).sum(), argnums=(0, 1))(
        alpha, jnp.asarray(x))
    a, xt = t64(alpha), t64(x)
    v = dgamma.gammainc(a, xt)
    g = torch.autograd.grad(v.sum(), (a, xt))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(vj),
                               rtol=1e-10, atol=1e-300)
    assert rel(g[0], gj[0]) < 1e-7                  # d/da
    np.testing.assert_allclose(g[1].numpy(), np.asarray(gj[1]), rtol=1e-7,
                               atol=1e-12)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_gammaincinv_matches_jax(alpha):
    vj = jax_dgamma.gammaincinv(alpha, jnp.asarray(YS))
    gj = jax.grad(lambda a: jax_dgamma.gammaincinv(
        a, jnp.asarray(YS)).sum())(alpha)
    a = t64(alpha)
    v = dgamma.gammaincinv(a, torch.tensor(YS))
    (g,) = torch.autograd.grad(v.sum(), a)
    assert rel(v.detach(), vj) < 1e-10
    assert rel(g, gj) < 1e-7


@pytest.mark.parametrize("K,alpha,median", [
    (3, 0.3, False), (5, 2.0, False), (4, 0.3, True), (8, 2.0, True)])
def test_discrete_gamma_and_beta_match_jax(K, alpha, median):
    rj, fj = jax_dgamma.discrete_gamma(alpha, K, use_median=median)
    gj = jax.grad(lambda a: (jax_dgamma.discrete_gamma(
        a, K, use_median=median)[0] ** 2).sum())(alpha)
    a = t64(alpha)
    r, f = dgamma.discrete_gamma(a, K, use_median=median)
    (g,) = torch.autograd.grad((r ** 2).sum(), a)
    assert rel(r.detach(), rj) < 1e-10 and rel(f, fj) < 1e-14
    assert rel(g, gj) < 1e-7
    q = 1.3
    bj, _ = jax_dgamma.discrete_beta(alpha, q, K, use_median=median)
    gj = jax.grad(lambda p, q: (jax_dgamma.discrete_beta(
        p, q, K, use_median=median)[0] ** 2).sum(), argnums=(0, 1))(alpha, q)
    p, qt = t64(alpha), t64(q)
    bt, _ = dgamma.discrete_beta(p, qt, K, use_median=median)
    g = torch.autograd.grad((bt ** 2).sum(), (p, qt))
    assert rel(bt.detach(), bj) < 1e-10
    for got, want in zip(g, gj):
        assert rel(got, want) < 1e-7


@pytest.mark.parametrize("fn,args", [
    (dgamma._betainc_any, ([0.05, 2.0, 30.0], [0.05, 3.0, 0.3],
                           [0.3, 0.9, 0.99])),
    (dgamma._gammainc_any, ([0.02, 5.0, 49.0], [1e-3, 7.5, 40.0]))])
def test_duals_match_autograd(fn, args):
    # the gradient's route (numpy duals, one pass) against the Hessian
    # route's (the same loop in tensor operations under autograd)
    args = [np.asarray(a) for a in args]
    parts = dgamma._partials_np(fn, args)
    ts = [t64(a) for a in args]
    with torch.enable_grad():
        auto = dgamma._partials_t(fn, ts, [True] * len(ts))
    for got, want in zip(parts, auto):
        np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-10)


def test_results_return_to_the_arguments_device():
    # the functions compute on the host and hand the result back; on a CPU
    # tensor that is the identity, and scalars broadcast against vectors
    v = dgamma.betainc(t64(0.5), 1.2, torch.tensor(YS))
    assert v.shape == (10,) and v.device.type == "cpu" and v.requires_grad
    assert dgamma.SECONDS["host"] > 0
