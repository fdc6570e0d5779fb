"""Discrete-gamma and discrete-beta rate heterogeneity, differentiable.

Port of `paml_tpu/core/dgamma.py` (reference: `DiscreteGamma`,
src/tools.c:2600, `DiscreteBeta`, :2563): the regularized incomplete beta
function by its continued fraction (modified Lentz, 200 terms; reference:
CDFBeta, src/tools.c:3065 region), the regularized incomplete gamma
function by its series and continued fraction, their inverses, and the
equal-probability discretizations built on them; `gauss_laguerre` and
`gamma_expectation_gl` for basemlg's continuous gamma.

This is arithmetic on K <= 11 numbers, so it runs on the host in float64
whatever device its arguments lie on: the arguments are copied to the
CPU, the result goes back to their device, and autograd crosses both
copies.  PyTorch has no incomplete beta function, and its `gammainc` has
no derivative in the shape parameter, so both are the package's own, each
written once over three kinds of number (`_betainc_any`, `_gammainc_any`):

* numpy arrays: the values (the forward of every function here, and the
  root finders behind the inverses);
* `_Dual`, numpy values with first derivatives carried through the same
  loops: the backward of a gradient (one pass, no graph);
* torch tensors under autograd: the backward of a backward.  When a
  gradient is taken with `create_graph=True` (the Hessian of
  `codeml.standard_errors`), each backward here rebuilds its partial
  derivatives from differentiable operations, so second derivatives are
  exact.  The inverses' derivatives come from the inverse-function
  theorem, with the JAX package's clamps for boundary-spiked betas.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

N_BETA_CF = 200       # terms of the incomplete beta continued fraction
N_GAMMA = 400         # terms of the incomplete gamma series / fraction
_EXTRA = 8            # terms taken after values and derivatives converged
_EXTRA_T = 64         # for tensors, whose derivatives the loop cannot see
_TINY = 1e-30
X_LO, X_HI = 1e-12, 1.0 - 1e-12      # the beta quantiles' range

# seconds spent in this module's forwards and backwards since import
SECONDS = {"host": 0.0}


def _timed(fn):
    @functools.wraps(fn)
    def wrapper(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            SECONDS["host"] += time.perf_counter() - t0
    return wrapper


# ---------------------------------------------------------------------------
# first-order dual numbers over numpy
# ---------------------------------------------------------------------------


class _Dual:
    """val [K] with first derivatives der [m, K] in m seed directions."""
    __slots__ = ("val", "der")

    def __init__(self, val, der):
        self.val, self.der = val, der

    @staticmethod
    def seeds(*vals):
        """One dual per value, each its own seed direction."""
        vals = np.broadcast_arrays(*[np.asarray(v, np.float64)
                                     for v in vals])
        m = len(vals)
        out = []
        for i, v in enumerate(vals):
            der = np.zeros((m,) + v.shape)
            der[i] = 1.0
            out.append(_Dual(v.copy(), der))
        return out

    def __add__(self, o):
        o = _lift(o)
        return _Dual(self.val + o.val, self.der + o.der)
    __radd__ = __add__

    def __sub__(self, o):
        o = _lift(o)
        return _Dual(self.val - o.val, self.der - o.der)

    def __rsub__(self, o):
        return _lift(o) - self

    def __neg__(self):
        return _Dual(-self.val, -self.der)

    def __mul__(self, o):
        o = _lift(o)
        return _Dual(self.val * o.val, self.der * o.val + self.val * o.der)
    __rmul__ = __mul__

    def __truediv__(self, o):
        o = _lift(o)
        q = self.val / o.val
        return _Dual(q, (self.der - q * o.der) / o.val)

    def __rtruediv__(self, o):
        return _lift(o) / self


def _lift(o) -> _Dual:
    """o as a dual: a plain number or array is a constant."""
    return o if isinstance(o, _Dual) else _Dual(np.asarray(o, np.float64),
                                                0.0)


def _is_t(z):
    return isinstance(z, torch.Tensor)


def _val(z):
    """The plain values of z (numpy array or detached tensor)."""
    if isinstance(z, _Dual):
        return z.val
    return z.detach() if _is_t(z) else z


def _unary(z, f_np, f_t, dfdz):
    if isinstance(z, _Dual):
        return _Dual(f_np(z.val), dfdz(z.val) * z.der)
    return f_t(z) if _is_t(z) else f_np(z)


def _log(z):
    return _unary(z, np.log, torch.log, lambda v: 1.0 / v)


def _log1p(z):
    return _unary(z, np.log1p, torch.log1p, lambda v: 1.0 / (1.0 + v))


def _exp(z):
    return _unary(z, np.exp, torch.exp, np.exp)


def _lgamma(z):
    from scipy.special import digamma, gammaln
    return _unary(z, gammaln, torch.lgamma, digamma)


def _select(mask, a, b):
    """a where mask else b; mask is a boolean array (tensor for tensors)."""
    if isinstance(a, _Dual) or isinstance(b, _Dual):
        a, b = _lift(a), _lift(b)
        return _Dual(np.where(mask, a.val, b.val),
                     np.where(mask, a.der, b.der))
    if _is_t(a) or _is_t(b):
        ref = a if _is_t(a) else b
        return torch.where(mask, torch.as_tensor(a, dtype=ref.dtype),
                           torch.as_tensor(b, dtype=ref.dtype))
    return np.where(mask, a, b)


def _clamp(z, lo=None, hi=None):
    """Clip the values of z; a clipped entry's derivatives are zero."""
    if _is_t(z):
        return torch.clamp(z, lo, hi)
    v = _val(z)
    out = z
    if lo is not None:
        out = _select(v < lo, lo, out)
    if hi is not None:
        out = _select(v > hi, hi, out)
    return out


def _guard(z):
    """|z| < tiny replaced by tiny (the Lentz safeguard)."""
    v = _val(z)
    return _select(abs(v) < _TINY, _TINY, z)


def _done(delta, count):
    """Early exit of a convergent loop: True once every factor `delta` has
    been 1 to the last bit (and its derivatives 0) for _EXTRA terms.  A
    tensor's derivatives, taken by autograd later, converge some terms
    after its values: _EXTRA_T terms more."""
    v = _val(delta)
    ok = bool((abs(v - 1.0) < 4e-16).all())
    if ok and isinstance(delta, _Dual):
        ok = bool((np.abs(delta.der) < 1e-15).all())
    count[0] = count[0] + 1 if ok else 0
    return count[0] >= (_EXTRA_T if _is_t(delta) else _EXTRA)


# ---------------------------------------------------------------------------
# the incomplete beta and gamma functions over any of the three numbers
# ---------------------------------------------------------------------------


def _betainc_any(a, b, x, n_iter: int = N_BETA_CF):
    """I_x(a, b); a, b, x of one shape (arrays, duals or tensors)."""
    av, bv, xv = _val(a), _val(b), _val(x)
    use_sym = xv > (av + 1.0) / (av + bv + 2.0)
    aa = _select(use_sym, b, a)
    bb = _select(use_sym, a, b)
    xx = _clamp(_select(use_sym, 1.0 - x, x), 0.0, 1.0 - 1e-16)
    lnfront = (aa * _log(_clamp(xx, 1e-300)) + bb * _log1p(-xx) - _log(aa)
               - (_lgamma(aa) + _lgamma(bb) - _lgamma(aa + bb)))
    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = xx * 0.0 + 1.0
    d = 1.0 / _guard(1.0 - qab * xx / qap)
    h = d
    count = [0]
    for m in range(1, n_iter):
        m = float(m)
        num = m * (bb - m) * xx / ((qam + 2.0 * m) * (aa + 2.0 * m))
        d = 1.0 / _guard(1.0 + num * d)
        c = 1.0 + num / _guard(c)
        h = h * d * c
        num = -(aa + m) * (qab + m) * xx / ((aa + 2.0 * m)
                                            * (qap + 2.0 * m))
        d = 1.0 / _guard(1.0 + num * d)
        c = 1.0 + num / _guard(c)
        delta = d * c
        h = h * delta
        if _done(delta, count):
            break
    res = _exp(lnfront) * h
    return _clamp(_select(use_sym, 1.0 - res, res), 0.0, 1.0)


def _gammainc_any(a, x, n_iter: int = N_GAMMA):
    """P(a, x), the regularized lower incomplete gamma function; a, x of
    one shape.  Series for x < a + 1, else the continued fraction of
    Q = 1 - P (modified Lentz); each runs on inputs of its own range, so
    the branch not taken stays finite."""
    av, xv = _val(a), _val(x)
    ser = xv < av + 1.0
    x = _clamp(x, 1e-300)
    xs = _select(ser, x, a * 0.5 + 0.5)
    xc = _select(ser, a + 1.0, x)
    # series: sum_k x^k / (a (a + 1) ... (a + k))
    ap, term = a, 1.0 / a
    total = term
    count = [0]
    for _ in range(n_iter):
        ap = ap + 1.0
        term = term * xs / ap
        total = total + term
        if _done(1.0 + term / total, count):
            break
    p_ser = total * _exp(-xs + a * _log(xs) - _lgamma(a))
    # continued fraction
    b = xc + 1.0 - a
    c = xc * 0.0 + 1.0 / _TINY
    d = 1.0 / _guard(b)
    h = d
    count = [0]
    for i in range(1, n_iter):
        an = -float(i) * (float(i) - a)
        b = b + 2.0
        d = 1.0 / _guard(an * d + b)
        c = _guard(b + an / c)
        delta = d * c
        h = h * delta
        if _done(delta, count):
            break
    p_cf = 1.0 - _exp(-xc + a * _log(xc) - _lgamma(a)) * h
    out = _clamp(_select(ser, p_ser, p_cf), 0.0, 1.0)
    return _select(xv <= 0.0, out * 0.0, out)


def _beta_logpdf(p, q, x):
    return ((p - 1.0) * _log(x) + (q - 1.0) * _log1p(-x)
            - (_lgamma(p) + _lgamma(q) - _lgamma(p + q)))


def _gamma_logpdf(a, x):
    return (a - 1.0) * _log(x) - x - _lgamma(a)


# ---------------------------------------------------------------------------
# root finders (numpy)
# ---------------------------------------------------------------------------


def _betaincinv_np(p, q, y):
    """x in [X_LO, X_HI] with I_x(p, q) = y: a library start, then the JAX
    package's guarded Newton polish on this module's own I."""
    from scipy.special import betaincinv as start
    x = np.clip(np.nan_to_num(start(p, q, y), nan=0.5), X_LO, X_HI)
    with np.errstate(all="ignore"):
        for _ in range(4):
            f = _betainc_any(p, q, x) - y
            xn = x - f / np.maximum(np.exp(_beta_logpdf(p, q, x)), 1e-300)
            xn = np.clip(xn, X_LO, X_HI)
            xn = np.where(np.isfinite(xn), xn, x)
            moved = np.abs(xn - x) > 4e-16 * x
            x = xn
            if not moved.any():
                break
    return x


def _gammaincinv_np(a, p):
    """x with P(a, x) = p: a library start, then Newton on this module's
    own P in log space, as the JAX package polishes."""
    from scipy.special import gammaincinv as start
    y = np.log(np.maximum(start(a, p), 1e-300))
    with np.errstate(all="ignore"):
        for _ in range(4):
            x = np.exp(y)
            f = _gammainc_any(a, x) - p
            step = np.clip(f * np.exp(-(a * y - x - _lgamma(a))), -1.0, 1.0)
            yn = y - step
            y = np.where(np.isfinite(yn), yn, y)
            if not (np.abs(step) > 4e-16).any():
                break
    return np.exp(y)


# ---------------------------------------------------------------------------
# autograd functions on the host
# ---------------------------------------------------------------------------


def _partials_np(fn, args):
    """Partial derivatives of the elementwise fn at numpy args, by duals."""
    with np.errstate(all="ignore"):
        out = fn(*_Dual.seeds(*args))
    return [np.broadcast_to(out.der[i], out.val.shape)
            for i in range(len(args))]


def _partials_t(fn, args, needs):
    """The same from differentiable torch operations (grad mode on): the
    entries `needs` marks, None elsewhere.  Each arg has the output's
    shape, so the gradient of the sum is the elementwise partial."""
    idx = [i for i, need in enumerate(needs) if need]
    grads = torch.autograd.grad(fn(*args).sum(), [args[i] for i in idx],
                                create_graph=True)
    out = [None] * len(args)
    for i, g in zip(idx, grads):
        out[i] = g
    return out


class _Direct(torch.autograd.Function):
    """An elementwise function of float64 CPU tensors of one shape, its
    value from numpy, its gradient from duals or, under create_graph, from
    the same loop in differentiable torch operations."""

    @staticmethod
    @_timed
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.save_for_backward(*args)
        with np.errstate(all="ignore"):
            return torch.from_numpy(np.asarray(
                fn(*[a.detach().numpy() for a in args]), np.float64))

    @staticmethod
    @_timed
    def backward(ctx, g):
        args = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        if torch.is_grad_enabled():
            parts = _partials_t(ctx.fn, args, needs)
        else:
            parts = [torch.from_numpy(np.array(p)) for p in _partials_np(
                ctx.fn, [a.detach().numpy() for a in args])]
        return (None,) + tuple(g * p if need else None
                               for p, need in zip(parts, needs))


def _nan_clip(z, cap):
    if _is_t(z):
        return torch.clamp(torch.nan_to_num(z, nan=0.0, posinf=cap,
                                            neginf=-cap), -cap, cap)
    return np.clip(np.nan_to_num(z, nan=0.0, posinf=cap, neginf=-cap),
                   -cap, cap)


def _betaincinv_partials(p, q, x, dI):
    """(dx/dp, dx/dq, dx/dy) by the inverse-function theorem with the JAX
    package's float64 safeguards: x clipped away from 0 and 1, the
    sensitivities and the pdf's reciprocal capped at 1e14."""
    cap = 1e14
    xc = _clamp(x, 1e-14, 1.0 - 1e-14)
    dIdp, dIdq = dI(p, q, xc)
    pdf = _exp(_clamp(_beta_logpdf(p, q, xc), -80.0, 80.0))
    inv_pdf = 1.0 / _clamp(pdf, 1.0 / cap)
    return (-_nan_clip(dIdp, cap) * inv_pdf, -_nan_clip(dIdq, cap) * inv_pdf,
            inv_pdf)


class _BetaIncInv(torch.autograd.Function):

    @staticmethod
    @_timed
    def forward(ctx, p, q, y):
        x = torch.from_numpy(_betaincinv_np(
            p.detach().numpy(), q.detach().numpy(), y.detach().numpy()))
        ctx.save_for_backward(p, q, y, x)
        return x

    @staticmethod
    @_timed
    def backward(ctx, g):
        p, q, y, x = ctx.saved_tensors
        if torch.is_grad_enabled():
            def dI(p, q, xc):
                # partials of I at (p, q, xc), differentiable in all three
                return _partials_t(_betainc_any, (p + 0.0 * xc, q + 0.0 * xc,
                                                  xc), (True, True, False))[:2]
            parts = _betaincinv_partials(p, q, x, dI)
        else:
            def dI(p, q, xc):
                return _partials_np(_betainc_any, (p, q, xc))[:2]
            with np.errstate(all="ignore"):
                parts = [torch.from_numpy(np.array(v)) for v in
                         _betaincinv_partials(
                             p.detach().numpy(), q.detach().numpy(),
                             x.detach().numpy(), dI)]
        return tuple(g * v if need else None
                     for v, need in zip(parts, ctx.needs_input_grad))


class _GammaIncInv(torch.autograd.Function):

    @staticmethod
    @_timed
    def forward(ctx, a, p):
        x = torch.from_numpy(_gammaincinv_np(a.detach().numpy(),
                                             p.detach().numpy()))
        ctx.save_for_backward(a, p, x)
        return x

    @staticmethod
    @_timed
    def backward(ctx, g):
        a, p, x = ctx.saved_tensors
        if torch.is_grad_enabled():
            dPda = _partials_t(_gammainc_any, (a + 0.0 * x, x),
                               (True, False))[0]
            inv_pdf = torch.exp(-_gamma_logpdf(a, x))
            parts = (-dPda * inv_pdf, inv_pdf)
        else:
            an, xn = a.detach().numpy(), x.detach().numpy()
            with np.errstate(all="ignore"):
                dPda = _partials_np(_gammainc_any, (an, xn))[0]
                inv_pdf = np.exp(-_gamma_logpdf(an, xn))
            parts = (torch.from_numpy(-dPda * inv_pdf),
                     torch.from_numpy(inv_pdf))
        return tuple(g * v if need else None
                     for v, need in zip(parts, ctx.needs_input_grad))


def _host(*args):
    """The arguments as float64 CPU tensors of one shape, and the device
    the result returns to (the first tensor argument's)."""
    dev = next((a.device for a in args if _is_t(a)), torch.device("cpu"))
    ts = [a.to(device="cpu", dtype=torch.float64) if _is_t(a)
          else torch.as_tensor(a, dtype=torch.float64) for a in args]
    return [t.contiguous() for t in torch.broadcast_tensors(*ts)], dev


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta I_x(a, b), differentiable in a, b, x."""
    args, dev = _host(a, b, x)
    return _Direct.apply(_betainc_any, *args).to(dev)


def gammainc(a, x) -> torch.Tensor:
    """Regularized lower incomplete gamma P(a, x), differentiable in a
    and x."""
    args, dev = _host(a, x)
    return _Direct.apply(_gammainc_any, *args).to(dev)


def betaincinv(p, q, y) -> torch.Tensor:
    """Inverse regularized incomplete beta: x with I_x(p, q) = y, kept in
    [1e-12, 1 - 1e-12]; gradients by the inverse-function theorem."""
    args, dev = _host(p, q, y)
    return _BetaIncInv.apply(*args).to(dev)


def gammaincinv(a, p) -> torch.Tensor:
    """Inverse regularized lower incomplete gamma: x with P(a, x) = p."""
    args, dev = _host(a, p)
    return _GammaIncInv.apply(*args).to(dev)


def _grid(lo: float, K: int, like: torch.Tensor, step: float = 1.0):
    return (torch.arange(K, dtype=torch.float64, device=like.device) * step
            + lo)


def discrete_gamma(alpha, K: int, beta=None, use_median: bool = False):
    """K equal-probability gamma rate categories: (rates [K], freqs [K]).
    The mean method by default; the median method rescales the category
    medians so that the overall mean is alpha / beta (reference:
    src/tools.c:2600)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float64)
    beta = alpha if beta is None else torch.as_tensor(
        beta, dtype=torch.float64, device=alpha.device)
    mean = alpha / beta
    freqs = torch.full((K,), 1.0 / K, dtype=torch.float64,
                       device=alpha.device)
    if K == 1:
        return mean.reshape(1), freqs
    if use_median:
        r = gammaincinv(alpha, _grid(0.5, K, alpha) / K) / beta
        return r * (mean * K / r.sum()), freqs
    cuts = gammaincinv(alpha, _grid(1.0, K - 1, alpha) / K) / beta
    F = gammainc(alpha + 1.0, cuts * beta)
    Fpad = torch.cat([F.new_zeros(1), F, F.new_ones(1)])
    # a tiny floor: at extreme alpha the low categories underflow to 0,
    # which puts t = 0 into P(t) and breaks second derivatives
    return torch.clamp_min((Fpad[1:] - Fpad[:-1]) * mean * K, 1e-8), freqs


def discrete_beta(p, q, K: int, use_median: bool = True):
    """K equal-probability beta(p, q) categories (reference:
    src/tools.c:2563); NSsites M7/M8 use the median method."""
    p = torch.as_tensor(p, dtype=torch.float64)
    q = torch.as_tensor(q, dtype=torch.float64, device=p.device)
    mean = p / (p + q)
    freqs = torch.full((K,), 1.0 / K, dtype=torch.float64, device=p.device)
    if use_median:
        x = betaincinv(p, q, _grid(0.5, K, p) / K)
        return x * (mean * K / x.sum()), freqs
    cuts = betaincinv(p, q, _grid(1.0, K - 1, p) / K)
    F = betainc(p + 1.0, q, cuts)
    Fpad = torch.cat([F.new_zeros(1), F, F.new_ones(1)])
    return (Fpad[1:] - Fpad[:-1]) * mean * K, freqs


def gauss_laguerre(n: int):
    """Gauss-Laguerre nodes and weights for integrals of exp(-x) f(x) on
    [0, inf) (reference: GaussLaguerreRule, src/tools.c:4387, tables up to
    order 1024; here numpy's Golub-Welsch rule).  Returns (x [n], w [n])."""
    return np.polynomial.laguerre.laggauss(n)


def gamma_expectation_gl(f, alpha: float, beta: float | None = None,
                         n: int = 32) -> float:
    """E[f(r)] for r ~ Gamma(alpha, beta) by Gauss-Laguerre after the
    substitution x = beta r, weighted by the Gamma(alpha) density (the
    reference's continuous-gamma tail handling in basemlg)."""
    from scipy.special import gammaln

    beta = alpha if beta is None else beta
    x, w = gauss_laguerre(n)
    vals = np.array([f(xi / beta) for xi in x])
    return float((w * vals * np.exp((alpha - 1) * np.log(x)
                                    - gammaln(alpha))).sum())
