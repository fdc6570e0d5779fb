"""E2's plain versions (`paml_tpu_torch/core/cuda_quantile.py`: the
incomplete beta and gamma functions with their partials, their inverses
and the NSsites mixtures' median quantiles) against paml_tpu.core.dgamma
and paml_tpu.apps.codeml on the same numpy inputs, float64, on the CPU:

- values within 1e-10 relative of the JAX package, first partials within
  1e-7 of `jax.grad`, second partials of the beta quantiles within 1e-6
  of JAX's nested derivatives (of the largest entry of each), those of
  the gamma quantiles (which JAX cannot differentiate twice in the shape)
  within 1e-6 of central differences of `jax.grad`; at
  tests/test_torch_dgamma.py's PQ and ALPHAS grids and at the models'
  bounds (p, q = 0.005 and 99; alpha = 0.02 and 49);
- values and first partials within 1e-12 relative of the host route
  (`core/dgamma.py` on CPU tensors), second partials within 1e-9, through
  dgamma's autograd functions on the card route (`dgamma._e2` sent to the
  plain versions);
- the mixture bracket plus the two Newton steps for M6 and M9-M13 against
  `paml_tpu.apps.codeml.cdf_quantiles` at each model's x0 and three
  seeded theta within its bounds (values 1e-9 relative, gradients 1e-6 of
  the largest component; where JAX's gradient is NaN, as M10's is at some
  theta, the port's must be finite), and with 40 quantiles at x0; M10 at
  five quantiles and x0, a target on a point of zero density: values
  1e-12 of the JAX package's, a finite Jacobian at the port's own central
  differences; M12 and M13 with modes far apart: the bracket as narrow as
  the first design's (33-section rounds) and its midpoint the same, and
  NOCONV where it is cut short;
- the status words (1 on a NaN input), a failed status raising through
  dgamma, a third derivative raising, and the kernels refusing CPU
  tensors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import gammainc as jax_gammainc

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core import dgamma as jax_dgamma
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.core import cuda_quantile as cq
from paml_tpu_torch.core import dgamma, graphs

torch.set_num_threads(1)

PQ = [(0.05, 0.05), (0.05, 2.0), (0.5, 1.2), (2.0, 3.0), (30.0, 0.3),
      (0.005, 0.005), (0.005, 99.0), (99.0, 0.005)]
ALPHAS = [0.02, 0.6, 1.0, 5.0, 49.0]
YS = (np.arange(10) + 0.5) / 10


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def close_of_largest(got, want, tol):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def close_or_tiny(got, want, tol):
    """Within tol relative, or within tol of the largest entry: where I_x
    rounds to 1.0 exactly (at (0.005, 99), partials below 1e-58) JAX's
    clip halves the partial at its tie."""
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want),
                               rtol=tol, atol=tol * np.abs(want).max())


def grid(pairs, xs):
    p = np.repeat([a for a, _ in pairs], len(xs))
    q = np.repeat([b for _, b in pairs], len(xs))
    return p, q, np.tile(xs, len(pairs))


def t64(*vs):
    return [torch.tensor(v, dtype=torch.float64) for v in vs]


# --- against the JAX package ---------------------------------------------


def test_beta_against_jax():
    xs = np.random.default_rng(3).uniform(0.001, 0.999, 9)
    p, q, x = grid(PQ, xs)
    v, d1, _, info = cq.inc_plain(cq.BETA, *t64(p, q, x))
    f = jax.jit(jax_dgamma.betainc)
    g = jax.jit(jax.grad(lambda a, b, x: jax_dgamma.betainc(a, b, x).sum(),
                         argnums=(0, 1, 2)))
    assert (info[:, 0] == 0).all()
    assert rel(v, f(p, q, x)) < 1e-10
    for j, gj in enumerate(g(p, q, x)):
        close_or_tiny(d1[:, j], gj, 1e-7)


def _jax_inv_derivs(fn, p, q, y):
    """x, its first partials in (p, q) and its second partials pp, pq, qq
    (elementwise: each root depends on its own arguments alone)."""
    def s(p, q):
        return fn(p, q, y).sum()
    gp = jax.grad(s, 0)
    gq = jax.grad(s, 1)
    return (fn(p, q, y), gp(p, q), gq(p, q),
            jax.grad(lambda p, q: gp(p, q).sum(), 0)(p, q),
            jax.grad(lambda p, q: gp(p, q).sum(), 1)(p, q),
            jax.grad(lambda p, q: gq(p, q).sum(), 1)(p, q))


def test_beta_inverse_against_jax():
    p, q, y = grid(PQ, YS)
    x, d1, d2, info = cq.inc_inv_plain(cq.BETA, *t64(p, q, y), order=2)
    assert (info[:, 0] == 0).all()
    xj, gp, gq, hpp, hpq, hqq = jax.jit(
        lambda p, q, y: _jax_inv_derivs(jax_dgamma.betaincinv, p, q, y))(
        p, q, y)
    gy = jax.jit(jax.grad(lambda y: jax_dgamma.betaincinv(p, q, y).sum()))(y)
    assert rel(x, xj) < 1e-10
    close_of_largest(d1[:, 0], gp, 1e-7)
    close_of_largest(d1[:, 1], gq, 1e-7)
    close_of_largest(d1[:, 2], gy, 1e-7)
    for (i, j), hj in zip(((0, 0), (0, 1), (1, 1)), (hpp, hpq, hqq)):
        close_of_largest(d2[:, i, j], hj, 1e-6)


def test_gamma_against_jax():
    a = np.repeat(ALPHAS, 9)
    x = np.concatenate([[1e-5, 0.01, 0.3, 1.0, 3.0, al, al + 1.5,
                         4 * al + 2, 60.0] for al in ALPHAS])
    v, d1, _, info = cq.inc_plain(cq.GAMMA, *t64(a, np.ones_like(a), x))
    assert (info[:, 0] == 0).all()
    np.testing.assert_allclose(v, jax_gammainc(a, x), rtol=1e-10,
                               atol=1e-300)
    ga, gx = jax.grad(lambda a, x: jax_gammainc(a, x).sum(),
                      argnums=(0, 1))(a, x)
    assert rel(d1[:, 0], ga) < 1e-7
    np.testing.assert_allclose(d1[:, 2], gx, rtol=1e-7, atol=1e-12)


def test_gamma_inverse_against_jax():
    a = np.repeat(ALPHAS, len(YS))
    y = np.tile(YS, len(ALPHAS))
    x, d1, d2, info = cq.inc_inv_plain(cq.GAMMA, *t64(a, np.ones_like(a), y),
                                       order=2)
    assert (info[:, 0] == 0).all()
    xj = jax_dgamma.gammaincinv(a, y)
    ga = jax.jit(jax.grad(lambda a: jax_dgamma.gammaincinv(a, y).sum()))
    assert rel(x, xj) < 1e-10
    assert rel(d1[:, 0], ga(a)) < 1e-7
    # JAX's gammainc has no second derivative in the shape: central
    # differences of its first
    h = 1e-5 * a
    close_of_largest(d2[:, 0, 0], (ga(a + h) - ga(a - h)) / (2 * h), 1e-6)


# --- against the host route ------------------------------------------------


@pytest.mark.parametrize("which", ["betainc", "betaincinv", "gammainc",
                                   "gammaincinv"])
def test_plain_route_against_host_route(which, monkeypatch):
    gamma = which.startswith("gamma")
    pairs = [(al, 1.0) for al in ALPHAS] if gamma else PQ
    if which.endswith("inv"):
        p, q, x = grid(pairs, YS)
    else:
        xs = [1e-3, 0.3, 2.0, 8.0, 60.0] if gamma else \
            np.random.default_rng(5).uniform(0.001, 0.999, 5)
        p, q, x = grid(pairs, xs)
    fn = getattr(dgamma, which)
    # the gamma quantiles' second partials: test_gamma_inverse_against_jax
    second = which != "gammaincinv"

    def run(create_graph):
        a, b, xt = (torch.tensor(v, dtype=torch.float64, requires_grad=True)
                    for v in (p, q, x))
        args = (a, xt) if gamma else (a, b, xt)
        v = fn(*args)
        g = torch.autograd.grad(v.sum(), args, create_graph=create_graph)
        out = [v.detach()] + [t.detach() for t in g]
        if not create_graph:
            return out, []
        # the second partials in the first argument and, for the betas, the
        # mixed one (elementwise functions: the gradient of each row's sum)
        h = [torch.autograd.grad(g[0].sum(), args[0], retain_graph=True)[0]]
        if not gamma:
            h.append(torch.autograd.grad(g[0].sum(), args[1])[0])
        return out, h

    # the host route's first partials from its fit route (dual numbers),
    # the second from its Hessian route
    hv, hh = run(False)[0], run(True)[1] if second else []
    monkeypatch.setattr(dgamma, "_e2", lambda t: cq.PLAIN)
    cv, ch = run(second)
    for got, want in zip(cv, hv):
        assert rel(got, want) < 1e-12
    for got, want in zip(ch, hh):
        close_of_largest(got, want, 1e-9)


# --- the mixture quantiles ---------------------------------------------------


MIX_MODELS = [6, 9, 10, 11, 12, 13]


def _thetas(NS, K):
    x0, bounds = jax_codeml.nssites_x0_bounds(NS, K, False, 0.4)
    rng = np.random.default_rng(100 + NS)
    rows = [np.asarray(x0, float)]
    for _ in range(3):
        rows.append(np.array([rng.uniform(max(lo, -3.0), min(hi, 4.0))
                              for lo, hi in bounds]))
    return np.stack(rows)


# four quantiles: no median target falls on a point where a CDF's density
# is 0 (with five, M10's x0 puts p0 = 0.9 on the fifth target, whose root x
# = 1 has a zero density, where both packages' Newton steps amplify the
# bracket's last bits by 1e12)
MIX_K = 4


@pytest.mark.parametrize("NS", MIX_MODELS)
def test_mixture_quantiles_against_jax(NS):
    th = _thetas(NS, MIX_K)
    x0, info = cq.mix_quantiles_plain(NS, torch.tensor(th), MIX_K)
    assert (info[..., 0] == 0).all()
    w = np.arange(1.0, MIX_K + 1.0)

    def jax_q(t):
        x = jax_codeml.cdf_quantiles(jax_codeml.nssites_mixture_cdf(NS, t),
                                     MIX_K)
        return (x * w).sum(), x
    fj = jax.jit(jax.value_and_grad(jax_q, has_aux=True))
    for i, row in enumerate(th):
        t = torch.tensor(row, requires_grad=True)
        x = codeml.newton_quantiles(codeml.nssites_mixture_cdf(NS, t),
                                    x0[i])
        (g,) = torch.autograd.grad((x * torch.tensor(w)).sum(), t)
        (_, xj), gj = fj(row)
        assert rel(x.detach(), xj) < 1e-9
        assert torch.isfinite(g).all()
        if np.isfinite(gj).all():
            close_of_largest(g, gj, 1e-6)


@pytest.mark.parametrize("NS", MIX_MODELS)
def test_mixture_density_matches_the_cdf(NS):
    # the closed-form density the bracket's Newton steps use (the kernel's
    # mix_pdf) against autograd of the host route's mixture CDF, at omegas
    # on both sides of the kink at 1 and at each model's x0 and a seeded
    # theta
    xs = torch.tensor([1e-3, 0.05, 0.4, 0.93, 1.0 + 1e-6, 1.7, 4.0, 12.0],
                      dtype=torch.float64)
    for row in _thetas(NS, MIX_K)[:2]:
        th = torch.tensor(row)
        xg = xs.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(
            codeml.nssites_mixture_cdf(NS, th)(xg).sum(), xg)
        got = cq._mix_pdf(NS, cq._mix_parts(NS, th), xs[None, :, None])
        np.testing.assert_allclose(got.reshape(-1), want, rtol=1e-12,
                                   atol=1e-300)


# ncatG above 32 (the kernel takes a block per quantile): the bracket and
# the Newton steps at each model's x0
MANY_K = 40


@pytest.mark.parametrize("NS", MIX_MODELS)
def test_mixture_quantiles_many_classes(NS):
    row = _thetas(NS, MANY_K)[0]
    x0, info = cq.mix_quantiles_plain(NS, torch.tensor(row), MANY_K)
    assert x0.shape == (MANY_K,) and (info[:, 0] == 0).all()
    x = codeml.newton_quantiles(
        codeml.nssites_mixture_cdf(NS, torch.tensor(row)), x0)
    xj = jax_codeml.cdf_quantiles(jax_codeml.nssites_mixture_cdf(NS, row),
                                  MANY_K)
    assert rel(x, xj) < 1e-9


# M12 and M13 with modes far apart, targets on the flat stretches between
# them included (M12's p1 = 0.55 and M13's 0.5 + 0.25 put a median target
# exactly there), where the Newton clusters miss the root
SEPARATED = [(12, [0.2, 0.55, 8.0, 0.05, 0.3], 10),
             (12, [0.2, 0.3, 30.0, 0.02, 2.0], 10),
             (13, [np.log(2.0), 0.0, 10.0, 0.05, 0.05, 0.5], 2),
             (13, [0.0, 0.0, 20.0, 0.01, 0.02, 1.0], 10)]


def _sections(NS, th, K, rounds=14):
    """The first design's bracket: 14 rounds of 33-section, each keeping
    the section whose upper end is the first point not below the target."""
    parts = cq._mix_parts(NS, th)
    target = (torch.arange(K, dtype=torch.float64) + 0.5) / K
    lo = torch.full((K,), cq.MIX_LO, dtype=torch.float64)
    hi = torch.full_like(lo, cq.MIX_HI)
    lanes = torch.arange(32, dtype=torch.float64)
    for _ in range(rounds):
        x = lo[:, None] + (lanes + 1.0) * ((hi - lo) / 33.0)[:, None]
        f = cq._mix_cdf(NS, parts, x)[0] - target[:, None]
        lo, hi = cq._narrow(x, f, lo, hi)
    return lo, hi


@pytest.mark.parametrize("case", range(len(SEPARATED)))
def test_mixture_bracket_width_at_separated_modes(case):
    NS, row, K = SEPARATED[case]
    th = torch.tensor(row, dtype=torch.float64)
    lo, hi, info = cq.mix_bracket_plain(NS, th, K)
    assert (info[:, 0] == cq.OK).all()
    adjacent = hi <= torch.nextafter(lo, torch.full_like(lo, np.inf))
    assert (adjacent | (hi - lo <= cq.MIX_WIDTH)).all()
    slo, shi = _sections(NS, th, K)
    assert torch.equal(0.5 * (lo + hi), 0.5 * (slo + shi))
    x, xinfo = cq.mix_quantiles_plain(NS, th, K)
    assert torch.equal(x, 0.5 * (lo + hi)) and torch.equal(xinfo, info)


def test_mixture_bracket_short_of_its_width_is_noconv(monkeypatch):
    # M13's second target lies on the flat stretch between its modes and
    # takes 14 rounds, its first 7: with 12 the second's bracket stays
    # wide, and its status says so
    NS, row, K = SEPARATED[2]
    monkeypatch.setattr(cq, "MIX_ROUNDS", 12)
    lo, hi, info = cq.mix_bracket_plain(NS, torch.tensor(row), K)
    assert info[:, 0].tolist() == [cq.OK, cq.NOCONV]
    up = torch.nextafter(lo, torch.full_like(lo, np.inf))
    assert hi[0] <= up[0]
    assert hi[1] > up[1] and hi[1] - lo[1] > cq.MIX_WIDTH


def test_mixture_quantiles_card_route(monkeypatch):
    th = torch.tensor(_thetas(10, MIX_K)[1], requires_grad=True)
    host = codeml._mixture_quantiles(10, th, MIX_K)
    (gh,) = torch.autograd.grad(host.sum(), th)
    monkeypatch.setattr(dgamma, "_e2", lambda t: cq.PLAIN)
    with graphs.status_sink() as sink:
        card = codeml._mixture_quantiles(10, th, MIX_K)
        (gc,) = torch.autograd.grad(card.sum(), th)
    assert len(sink) >= 1 and float(graphs.status_of(sink, th)) == 0.0
    assert rel(card.detach(), host.detach()) < 1e-10
    close_of_largest(gc, gh, 1e-8)


def test_m10_zero_density_target_pinned(monkeypatch):
    # M10 at five quantiles and its x0, the point MIX_K avoids: p0 = 0.9
    # puts the fifth median target on omega = 1, where the beta part's
    # density is 0.  The two Newton steps then land away from the root
    # (omega 0.988), as the JAX package's do: the values are its
    # cdf_quantiles' (called as it is, 1e-12 relative).  The port's
    # class-omega Jacobian is finite and its own function's: central
    # differences of the host route, but for the fifth quantile's p0
    # column, where the quantile jumps (a p0 above the target moves the
    # root into the beta part), shown as a difference that does not
    # shrink with h.  The card's route (the plain versions) the host's.
    K = 5
    row = _thetas(10, K)[0]
    wj = np.asarray(jax_codeml.cdf_quantiles(
        jax_codeml.nssites_mixture_cdf(10, jnp.asarray(row)), K))

    def quantiles(th):
        return codeml._mixture_quantiles(10, th, K)

    def jacobian():
        th = torch.tensor(row, requires_grad=True)
        w = quantiles(th)
        return w.detach(), torch.stack([
            torch.autograd.grad(w[k], th, retain_graph=True)[0]
            for k in range(K)]).numpy()

    w, J = jacobian()
    assert rel(w, wj) < 1e-12
    assert np.isfinite(J).all()

    def at(th):
        with torch.no_grad():
            return quantiles(torch.tensor(th)).numpy()
    fd = np.zeros_like(J)
    for j in range(len(row)):
        e = np.zeros_like(row)
        e[j] = 1e-6
        fd[:, j] = (at(row + e) - at(row - e)) / 2e-6
    smooth = np.ones_like(J, dtype=bool)
    smooth[K - 1, 0] = False
    np.testing.assert_allclose(J[smooth], fd[smooth], rtol=1e-6, atol=1e-9)
    for h in (1e-6, 1e-9):
        e = np.zeros_like(row)
        e[0] = h
        assert abs(at(row + e)[-1] - at(row - e)[-1]) > 1e-3
    monkeypatch.setattr(dgamma, "_e2", lambda t: cq.PLAIN)
    wc, Jc = jacobian()
    assert rel(wc, w) < 1e-12
    close_of_largest(Jc, J, 1e-8)


# --- status words and derivatives -------------------------------------------


def test_status_words_and_refusals(monkeypatch):
    nan = float("nan")
    a, b, x = t64([0.5, nan, 0.5], [1.2, 1.2, 1.2], [0.3, 0.3, nan])
    assert cq.inc_plain(cq.BETA, a, b, x)[3][:, 0].tolist() == [0, 1, 1]
    assert cq.inc_inv_plain(cq.BETA, a, b, x)[3][:, 0].tolist() == [0, 1, 1]
    th = torch.tensor([0.9, 0.4, nan, 1.1, 1.1])
    assert (cq.mix_quantiles_plain(9, th, 2)[1][:, 0] == 1).all()
    monkeypatch.setattr(dgamma, "_e2", lambda t: cq.PLAIN)
    with pytest.raises(graphs.DeviceStatusError):
        dgamma.betainc(a, b, x)
    for fn in (cq.inc, cq.inc_inv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(cq.BETA, a, b, x)
    with pytest.raises(ValueError, match="CUDA"):
        cq.mix_quantiles(9, th, 3)


@pytest.mark.parametrize("which", ["betainc", "betaincinv"])
def test_third_derivative_raises(which, monkeypatch):
    monkeypatch.setattr(dgamma, "_e2", lambda t: cq.PLAIN)
    fn = getattr(dgamma, which)

    def gradient():
        a = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
        v = fn(a, 1.3, torch.tensor([0.2, 0.6], dtype=torch.float64))
        return a, torch.autograd.grad(v.sum(), a, create_graph=True)[0]

    a, g = gradient()
    (h,) = torch.autograd.grad(g, a, retain_graph=True)  # the second passes
    assert torch.isfinite(h)
    with pytest.raises(RuntimeError, match="differentiable twice"):
        torch.autograd.grad(g, a, create_graph=True)    # toward a third
    with dgamma.third_partials_as_zero():
        a, g = gradient()
    (h0,) = torch.autograd.grad(g, a, create_graph=True)
    assert float(h0.detach()) == float(h)
    if h0.requires_grad:
        (t,) = torch.autograd.grad(h0, a, allow_unused=True)
        assert t is None or float(t) == 0.0
