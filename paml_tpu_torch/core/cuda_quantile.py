"""The quantile code on the card: E2, the kernels of `csrc/quantile.cu`,
and their plain versions.

The JAX package compiles its quantile code into every jitted value +
gradient (paml_tpu/core/dgamma.py:16-233, paml_tpu/apps/codeml.py:117-141):
the incomplete beta and gamma functions, their inverses and the NSsites
mixtures' median quantiles.  `core/dgamma.py` sends CUDA tensors here:

- `inc(kind, a, b, x, order)`: I_x(a, b) (kind BETA) or P(a, x) (kind
  GAMMA, b ignored), elementwise;
- `inc_inv(kind, p, q, y, order)`: x with I_x(p, q) = y, or P(p, x) = y;
- `mix_quantiles(model, theta, K)`: the bracketed K median quantiles of
  M6 / M9-M13's continuous part (`codeml._mixture_quantiles` takes two
  Newton steps from them).

`inc` and `inc_inv` return (value [...], d1 [..., 3] or None, d2 [..., 3,
3] or None, info [..., 2] int32): with order >= 1 the partials in the three
arguments, with order 2 the second partials, d2[..., i, j] the partial of
d1[..., i] in argument j (for the inverses that of the capped first
partials, as the host route differentiates them); info the status word (0
ok, 1 a non-finite input or result, 2 a series or continued fraction that
did not converge: its last factor further than CONV_TOL from 1, or a
mixture bracket still wider than the first design's after MIX_ROUNDS) and
the FP64 operations of the series / fraction terms the element's result
needed: the estimate's chain (lane 0's evaluations) and the partials (0
in the plain versions).  Nothing here reads the device on the host: the
callers hand the status words to `graphs.report_status`.

Each function has a kernel (`KERNEL`, CUDA float64 tensors only, one
launch each, counted in LAUNCHES) and a plain version (`PLAIN`, the same
arithmetic as tensor operations on the tensors' own device: the same
recurrences and rescalings, starts, rounds (a warp's 32 lanes as a last
axis of 32), brackets, clamps and caps, with fixed trip counts where the
kernel stops on convergence, entries that converged held where they
are).  The plain versions serve the tests and chip_smoke.py's checks of
the kernels; nothing on the main path calls them while a card is present.
"""
from __future__ import annotations

import math
import types

import torch

LAUNCHES = {"quantile": 0}

BETA, GAMMA = 0, 1
N_BETA_CF = 200       # terms of the beta continued fraction
N_GAMMA = 400         # terms of the gamma series / continued fraction
EXTRA = 8             # converged terms before the kernel's loop stops
CONV_TOL = 1e-12      # a converged loop's last factor lies this near 1
RESCALE = 4           # terms between the recurrences' rescalings
X_LO, X_HI = 1e-12, 1.0 - 1e-12      # the beta roots' range
CAP = 1e14            # cap of the inverse's sensitivities and 1 / pdf
ROOT_ROUNDS = 12                     # rounds of a beta or gamma root
STEP_DONE = 1e-9                     # a Halley step this small ends a root
Y_LO = -690.0                        # a gamma root's log bracket, below
MIX_ROUNDS = 17                      # the first design's 14 and three
MIX_SECTIONS = 2                     # multisection rounds before Newton
MIX_LO, MIX_HI = 1e-7, 99.0
MIX_WIDTH = (MIX_HI - MIX_LO) / 33.0 ** 14   # the first design's width
NTHETA = {6: 4, 9: 5, 10: 5, 11: 5, 12: 5, 13: 6}
OK, NONFINITE, NOCONV = 0, 1, 2
SQRT2, SQRT1_2 = math.sqrt(2.0), math.sqrt(0.5)
INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check(ts, what):
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{what} takes CUDA tensors, got {t.device}")
        if t.dtype != torch.float64:
            raise TypeError(f"{what} takes float64, got {t.dtype}")
        if t.shape != ts[0].shape:
            raise ValueError(f"{what}: shapes {[tuple(u.shape) for u in ts]}")


def _elementwise(entry, kind, a, b, x, order):
    from .. import _build

    _check((a, b, x), entry)
    shape, n = a.shape, a.numel()
    a, b, x = (t.contiguous() for t in (a, b, x))
    val = torch.empty_like(a)
    d1 = a.new_empty(shape + (3,)) if order >= 1 else None
    d2 = a.new_empty(shape + (3, 3)) if order >= 2 else None
    info = torch.empty(shape + (2,), dtype=torch.int32, device=a.device)
    if n:
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = getattr(_build.lib(), f"paml_{entry}_f64")(
                kind, order, a.data_ptr(), b.data_ptr(), x.data_ptr(), n,
                val.data_ptr(), None if d1 is None else d1.data_ptr(),
                None if d2 is None else d2.data_ptr(), info.data_ptr(),
                stream)
        LAUNCHES["quantile"] += 1
        _build.check(err, f"{entry} launch")
    return val, d1, d2, info


def inc(kind, a, b, x, order=1):
    """The kernel's I_x(a, b) / P(a, x) and partials (the module's
    docstring); a, b, x CUDA float64 tensors of one shape."""
    return _elementwise("inc", kind, a, b, x, order)


def inc_inv(kind, p, q, y, order=1):
    """The kernel's inverse, one warp per root."""
    return _elementwise("inc_inv", kind, p, q, y, order)


def mix_quantiles(model, theta, K):
    """The kernel's bracketed median quantiles: (x [K], info [K, 2]) of
    NSsites `model`'s continuous part at theta (CUDA float64, the layout of
    `codeml.nssites_mixture_cdf`), K >= 1 (a block per quantile)."""
    from .. import _build

    _check((theta,), "mix_quantiles")
    if model not in NTHETA or theta.numel() < NTHETA[model] or K < 1:
        raise ValueError(f"mix_quantiles: NSsites {model}, theta "
                         f"{tuple(theta.shape)}, K {K}")
    th = theta.reshape(-1)[:NTHETA[model]].contiguous()
    x = theta.new_empty(K)
    info = torch.empty((K, 2), dtype=torch.int32, device=theta.device)
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        err = _build.lib().paml_mix_quantiles_f64(
            model, th.data_ptr(), th.numel(), K, x.data_ptr(),
            info.data_ptr(), stream)
    LAUNCHES["quantile"] += 1
    _build.check(err, "mix_quantiles launch")
    return x, info


KERNEL = types.SimpleNamespace(inc=inc, inc_inv=inc_inv,
                               mix_quantiles=mix_quantiles)


def polygamma_kernel(x):
    """(digamma, trigamma) of x > 0 (CUDA float64) as the kernels compute
    them (the recurrence, then the asymptotic series), for a check against
    torch.special; not counted in LAUNCHES and on no path of the
    package."""
    from .. import _build

    _check((x,), "polygamma_kernel")
    x = x.contiguous()
    psi, psi1 = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.lib().paml_polygamma_f64(
            x.data_ptr(), x.numel(), psi.data_ptr(), psi1.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "polygamma launch")
    return psi, psi1


def kernel_work(entry, order, info, n_theta=0):
    """(operations, bytes) of one launch whose info came back as `info`:
    the FP64 operations the kernel counted in info[..., 1] (its loops'
    terms at their order along the estimate's chain and the partials,
    not the other lanes' bracket points: a lower bound, without the
    transcendental set-up), the inputs read once and the
    outputs written once (the bound: `cuda_pruning.bound_ms`)."""
    ops = float(info[..., 1].sum())
    n = info[..., 0].numel()
    if entry == "mix":
        return ops, 8.0 * n_theta + 16.0 * n
    words = 1 + (3 if order >= 1 else 0) + (9 if order >= 2 else 0)
    return ops, 8.0 * n * (3 + words + 1)


# ---------------------------------------------------------------------------
# the plain versions: forward-mode numbers over tensors
# ---------------------------------------------------------------------------


def _is_d(u):
    return isinstance(u, _D)


class _D:
    """A value v with its partials in two variables (a, b): first g = [a,
    b], and at order 2 second h = [aa, ab, bb] (None at order 1); every
    component a tensor of v's shape.  The kernel's D<O>, operation for
    operation."""
    __slots__ = ("v", "g", "h")

    def __init__(self, v, g, h=None):
        self.v, self.g, self.h = v, g, h

    @staticmethod
    def seed(v, which, order):
        z = torch.zeros_like(v)
        one = torch.ones_like(v)
        g = [one, z] if which == 0 else [z, one]
        return _D(v, g, [z, z, z] if order >= 2 else None)

    def _map(self, f, v):
        return _D(v, [f(x) for x in self.g],
                  None if self.h is None else [f(x) for x in self.h])

    def __add__(self, o):
        if not _is_d(o):
            return _D(self.v + o, self.g, self.h)
        return _D(self.v + o.v, [x + y for x, y in zip(self.g, o.g)],
                  None if self.h is None else
                  [x + y for x, y in zip(self.h, o.h)])

    def __radd__(self, o):
        return _D(o + self.v, self.g, self.h)

    def __neg__(self):
        return self._map(lambda t: -t, -self.v)

    def __sub__(self, o):
        if not _is_d(o):
            return _D(self.v - o, self.g, self.h)
        return _D(self.v - o.v, [x - y for x, y in zip(self.g, o.g)],
                  None if self.h is None else
                  [x - y for x, y in zip(self.h, o.h)])

    def __rsub__(self, o):
        r = -self
        r.v = o - self.v
        return r

    def __mul__(self, o):
        if not _is_d(o):
            return self._map(lambda t: t * o, self.v * o)
        u, w = self, o
        g = [u.g[0] * w.v + u.v * w.g[0], u.g[1] * w.v + u.v * w.g[1]]
        h = None
        if u.h is not None:
            h = [u.h[0] * w.v + 2.0 * u.g[0] * w.g[0] + u.v * w.h[0],
                 u.h[1] * w.v + u.g[0] * w.g[1] + u.g[1] * w.g[0]
                 + u.v * w.h[1],
                 u.h[2] * w.v + 2.0 * u.g[1] * w.g[1] + u.v * w.h[2]]
        return _D(u.v * w.v, g, h)

    def __rmul__(self, o):
        return self._map(lambda t: o * t, o * self.v)

    def __truediv__(self, o):
        if not _is_d(o):
            return self._map(lambda t: t / o, self.v / o)
        u, w = self, o
        q = u.v / w.v
        g = [(u.g[0] - q * w.g[0]) / w.v, (u.g[1] - q * w.g[1]) / w.v]
        h = None
        if u.h is not None:
            h = [(u.h[0] - 2.0 * g[0] * w.g[0] - q * w.h[0]) / w.v,
                 (u.h[1] - g[0] * w.g[1] - g[1] * w.g[0] - q * w.h[1]) / w.v,
                 (u.h[2] - 2.0 * g[1] * w.g[1] - q * w.h[2]) / w.v]
        return _D(q, g, h)

    def __rtruediv__(self, o):
        z = torch.zeros_like(self.v)
        c = _D(torch.full_like(self.v, o), [z, z],
               None if self.h is None else [z, z, z])
        return c / self


def _val(u):
    return u.v if _is_d(u) else u


def _chain(u, f0, f1, f2):
    g = [f1 * x for x in u.g]
    h = None
    if u.h is not None:
        h = [f2 * u.g[0] * u.g[0] + f1 * u.h[0],
             f2 * u.g[0] * u.g[1] + f1 * u.h[1],
             f2 * u.g[1] * u.g[1] + f1 * u.h[2]]
    return _D(f0, g, h)


def _log(u):
    if not _is_d(u):
        return torch.log(u)
    return _chain(u, torch.log(u.v), 1.0 / u.v, -1.0 / (u.v * u.v))


def _exp(u):
    if not _is_d(u):
        return torch.exp(u)
    e = torch.exp(u.v)
    return _chain(u, e, e, e)


def _digamma(x):
    """The kernel's digamma of x > 0: the recurrence up to x >= 10 (ten
    masked steps), then the asymptotic series."""
    r = torch.zeros_like(x)
    for _ in range(10):
        m = x < 10.0
        r = torch.where(m, r - 1.0 / x, r)
        x = torch.where(m, x + 1.0, x)
    f = 1.0 / (x * x)
    t = f * (-1.0 / 12 + f * (1.0 / 120 + f * (-1.0 / 252 + f * (
        1.0 / 240 + f * (-1.0 / 132 + f * (691.0 / 32760 + f * (-1.0 / 12)))))))
    return r + torch.log(x) - 0.5 / x + t


def _trigamma(x):
    """The kernel's trigamma of x > 0 (torch.special.polygamma(1, .)
    truncates its series at x^-7 from x >= 6: 4.9e-10 relative)."""
    r = torch.zeros_like(x)
    for _ in range(10):
        m = x < 10.0
        r = torch.where(m, r + 1.0 / (x * x), r)
        x = torch.where(m, x + 1.0, x)
    f = 1.0 / (x * x)
    t = f / x * (1.0 / 6 + f * (-1.0 / 30 + f * (1.0 / 42 + f * (
        -1.0 / 30 + f * (5.0 / 66 + f * (-691.0 / 2730 + f * (7.0 / 6)))))))
    return r + 1.0 / x + 0.5 * f + t


def _lgamma(u):
    if not _is_d(u):
        return torch.lgamma(u)
    return _chain(u, torch.lgamma(u.v), _digamma(u.v),
                  None if u.h is None else _trigamma(u.v))


def _where(mask, u, w):
    """torch.where over plain tensors or over two _D."""
    if not _is_d(u) and not _is_d(w):
        return torch.where(mask, u, w)
    return _D(torch.where(mask, u.v, w.v),
              [torch.where(mask, x, y) for x, y in zip(u.g, w.g)],
              None if u.h is None else
              [torch.where(mask, x, y) for x, y in zip(u.h, w.h)])


def _zero_where(mask, u, v):
    """u with its value replaced by v and its partials by 0 where mask."""
    if not _is_d(u):
        return torch.where(mask, v, u)
    return _D(torch.where(mask, v, u.v),
              [torch.where(mask, 0.0, x) for x in u.g],
              None if u.h is None else
              [torch.where(mask, 0.0, x) for x in u.h])


class _Stop:
    """The kernel's stopping rule over a loop of fixed trip count: a term
    whose factor 1 + U / Y is 1 to the last bit (|U| < 4e-16 |Y|, each of
    its partials, formed by a division where that holds, below 1e-15 (1 +
    |the same partial of Y / Y|)) counts;
    an entry with EXTRA such terms in a row is done, and `hold` keeps its
    numbers where they are from then on; `conv` tests the term it stopped
    at (or the last)."""

    def __init__(self, like):
        self.count = torch.zeros(like.shape, dtype=torch.int32,
                                 device=like.device)
        self.done = torch.zeros(like.shape, dtype=torch.bool,
                                device=like.device)
        self.diff = torch.full_like(like, math.inf)
        self.den = torch.zeros_like(like)

    def hold(self, new, old):
        return _where(self.done, old, new)

    def step(self, U, Y):
        diff, den = _val(U).abs(), _val(Y).abs()
        ok = diff < 4e-16 * den
        if _is_d(U):
            f = U / Y
            for t, y in zip(f.g + (f.h or []), Y.g + (Y.h or [])):
                ok = ok & (t.abs() < 1e-15 * (1.0 + (y / Y.v).abs()))
        self.diff = torch.where(self.done, self.diff, diff)
        self.den = torch.where(self.done, self.den, den)
        self.count = torch.where(ok, self.count + 1, 0)
        self.done = self.done | (self.count >= EXTRA)

    def conv(self):
        return self.diff <= CONV_TOL * self.den


def _pow2_scale(u, w):
    """2^-e, e the exponent of the larger of |u| and |w| (1 where that is 0
    or not finite): the kernel's rescaling, exact."""
    m = torch.maximum(_val(u).abs(), _val(w).abs())
    e = torch.frexp(m)[1]
    e = torch.where((m > 0.0) & torch.isfinite(m), e, 0)
    return torch.ldexp(torch.ones_like(m), -e)


def _beta_cf(aa, bb, xx):
    """(h = B / A of the transformed beta fraction, converged): the
    kernel's `beta_cf`."""
    qab = aa + bb
    Ap, Bp = _const(aa, 1.0), _const(aa, 1.0)
    Ac, Bc = (aa + 1.0) - qab * xx, aa + 1.0
    stop = _Stop(xx)
    for m in range(1, N_BETA_CF):
        fm = float(m)
        e = (bb - fm) * (fm * xx)
        be = aa + 2.0 * fm
        An, Bn = be * Ac + e * Ap, be * Bc + e * Bp
        Ap1, Bp1, Ac1, Bc1 = Ac, Bc, An, Bn
        o = -((aa + fm) * (qab + fm)) * xx
        bo = aa + (2.0 * fm + 1.0)
        An, Bn = bo * Ac1 + o * Ap1, bo * Bc1 + o * Bp1
        Y = An * Bc1
        U = Bn * Ac1 - Y
        new = [Ac1, Bc1, An, Bn]
        if m % RESCALE == 0:
            scale = _pow2_scale(An, Bn)
            new = [u * scale for u in new]
        Ap, Bp, Ac, Bc = (stop.hold(n, o) for n, o in
                          zip(new, (Ap, Bp, Ac, Bc)))
        stop.step(U, Y)
    return Bc / Ac, stop.conv()


def _const(like, v):
    """v as a number of like's kind (a _D with zero partials, or a tensor)
    and shape."""
    t = torch.full_like(_val(like), v)
    if not _is_d(like):
        return t
    z = torch.zeros_like(t)
    return _D(t, [z, z], None if like.h is None else [z, z, z])


def _beta_lnB(p, q):
    return torch.lgamma(p) + torch.lgamma(q) - torch.lgamma(p + q)


def _betainc(a, b, x, order, lnB=None):
    """(I_x(a, b) as a tensor (order 0) or _D in (a, b), its value
    converged within N_BETA_CF terms, clamped to [0, 1]) elementwise; lnB
    the lgamma terms at order 0 (computed here when None)."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    sym = x > (a + 1.0) / (a + b + 2.0)
    if order:
        A, B = _D.seed(a, 0, order), _D.seed(b, 1, order)
        aa, bb = _where(sym, B, A), _where(sym, A, B)
        lnb = _lgamma(aa) + _lgamma(bb) - _lgamma(aa + bb)
    else:
        aa, bb = torch.where(sym, b, a), torch.where(sym, a, b)
        lnb = _beta_lnB(a, b) if lnB is None else lnB
    xx = torch.clamp(torch.where(sym, 1.0 - x, x), 0.0, 1.0 - 1e-16)
    lnfront = (aa * torch.log(torch.clamp_min(xx, 1e-300))
               + bb * torch.log1p(-xx) - _log(aa) - lnb)
    h, conv = _beta_cf(aa, bb, xx)
    res = _exp(lnfront) * h
    out = _where(sym, 1.0 - res, res)
    v = _val(out)
    lo, hi = v < 0.0, v > 1.0
    out = _zero_where(hi, _zero_where(lo, out, 0.0), 1.0)
    return out, conv, lo | hi


def _gammainc(a, x0, order):
    """(P(a, x0) as a tensor or _D in a, converged, clamped): the series
    where x0 < a + 1, else the continued fraction; both are run, each on
    finite inputs, and the one the entry takes is kept."""
    a, x0 = torch.broadcast_tensors(a, x0)
    A = _D.seed(a, 0, order) if order else a
    ser = x0 < a + 1.0
    x = torch.clamp_min(x0, 1e-300)
    xs = torch.where(ser, x, 0.5 * a + 0.5)
    xc = torch.where(ser, a + 1.0, x)
    ap, Q, N = A, A, _const(A, 1.0)
    P = torch.ones_like(a)
    ss = _Stop(a)
    for k in range(N_GAMMA):
        ap = ap + 1.0
        P1 = P * xs
        new = [N * ap + P1, Q * ap, P1]
        U, Y = _const(A, 0.0) + P1, new[0]
        if (k + 1) % RESCALE == 0:
            scale = _pow2_scale(new[0], new[1])
            new = [u * scale for u in new]
        N, Q, P = (ss.hold(n, o) for n, o in zip(new, (N, Q, P)))
        ss.step(U, Y)
    p_ser = N / Q * _exp(-xs + A * torch.log(xs) - _lgamma(A))
    rx = 1.0 / xc
    bcf = xc + 1.0 - A
    Ap, Bp, Ac, Bc = _const(A, 1.0), _const(A, 0.0), bcf * rx, _const(A, 1.0)
    sc = _Stop(a)
    for i in range(1, N_GAMMA):
        fi = float(i)
        an = (fi - A) * (-fi * rx * rx)
        bcf = bcf + 2.0
        bi = bcf * rx
        An, Bn = bi * Ac + an * Ap, bi * Bc + an * Bp
        Y = An * Bc
        U = Bn * Ac - Y
        new = [Ac, Bc, An, Bn]
        if i % RESCALE == 0:
            scale = _pow2_scale(An, Bn)
            new = [u * scale for u in new]
        Ap, Bp, Ac, Bc = (sc.hold(n, o) for n, o in
                          zip(new, (Ap, Bp, Ac, Bc)))
        sc.step(U, Y)
    p_cf = 1.0 - _exp(-xc + A * torch.log(xc) - _lgamma(A)) * (Bc / Ac * rx)
    out = _where(ser, p_ser, p_cf)
    v = _val(out)
    lo, hi = (v < 0.0) | (x0 <= 0.0), v > 1.0
    out = _zero_where(hi & ~lo, _zero_where(lo, out, 0.0), 1.0)
    conv = torch.where(ser, ss.conv(), sc.conv())
    return out, conv, lo | hi


def _inc(kind, a, b, x, order):
    if kind == BETA:
        return _betainc(a, b, x, order)
    return _gammainc(a, x, order)


def _info(bad, conv):
    st = torch.where(bad, NONFINITE, torch.where(conv, OK, NOCONV))
    return torch.stack([st.to(torch.int32), torch.zeros_like(
        st, dtype=torch.int32)], -1)


def _finite(*ts):
    out = torch.isfinite(ts[0])
    for t in ts[1:]:
        out = out & torch.isfinite(t)
    return out


def _beta_logpdf(p, q, x):
    return ((p - 1.0) * torch.log(x) + (q - 1.0) * torch.log1p(-x)
            - _beta_lnB(p, q))


def inc_plain(kind, a, b, x, order=1):
    """`inc`'s plain version (any device; no host read)."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    if kind == GAMMA:
        b = torch.ones_like(a)
    r, conv, clamped = _inc(kind, a, b, x, order)
    ok = _finite(a, b, x)
    v = torch.where(ok, _val(r), float("nan"))
    info = _info(~torch.isfinite(v), conv)
    d1 = d2 = None
    if order >= 1:
        inside = ~clamped & (x > 0.0) & ((x < 1.0) if kind == BETA else True)
        L = (_beta_logpdf(a, b, x) if kind == BETA else
             (a - 1.0) * torch.log(x) - x - torch.lgamma(a))
        pdf = torch.where(inside, torch.exp(L), 0.0)
        zero = torch.zeros_like(v)
        d1 = torch.stack([r.g[0], r.g[1] if kind == BETA else zero, pdf], -1)
        if order >= 2:
            dg = _digamma
            if kind == BETA:
                dab = dg(a + b)
                ax = pdf * (torch.log(x) - dg(a) + dab)
                bx = pdf * (torch.log1p(-x) - dg(b) + dab)
                xx = pdf * ((a - 1.0) / x - (b - 1.0) / (1.0 - x))
                ab, bb = r.h[1], r.h[2]
            else:
                ax = pdf * (torch.log(x) - dg(a))
                xx = pdf * ((a - 1.0) / x - 1.0)
                bx = ab = bb = zero
            ax, bx, xx = (torch.where(inside, t, 0.0) for t in (ax, bx, xx))
            d2 = torch.stack([torch.stack([r.h[0], ab, ax], -1),
                              torch.stack([ab, bb, bx], -1),
                              torch.stack([ax, bx, xx], -1)], -2)
    return v, d1, d2, info


# --- the warp's rounds, lanes as a last axis of 32 ---------------------------


def _narrow(t, f, lo, hi):
    """The kernel's `narrow`: hi the smallest point not below, lo the
    largest below it, over the lanes (last axis) and the old bracket."""
    below = f < 0.0
    hi = torch.minimum(hi, torch.where(below, math.inf, t).amin(-1))
    lo = torch.maximum(lo, torch.where(below & (t < hi[..., None]), t,
                                       -math.inf).amax(-1))
    return lo, hi


def _beta_start(p, q, y):
    """The kernel's `beta_start` (AS 26.5.22; the tails' power laws)."""
    pp = torch.where(y < 0.5, y, 1.0 - y)
    t = torch.sqrt(-2.0 * torch.log(pp))
    z = (2.30753 + t * 0.27061) / (1.0 + t * (0.99229 + t * 0.04481)) - t
    z = torch.where(y < 0.5, -z, z)
    al = (z * z - 3.0) / 6.0
    h = 2.0 / (1.0 / (2.0 * p - 1.0) + 1.0 / (2.0 * q - 1.0))
    w = z * torch.sqrt(al + h) / h - (1.0 / (2.0 * q - 1.0)
                                      - 1.0 / (2.0 * p - 1.0)) * (
        al + 5.0 / 6.0 - 2.0 / (3.0 * h))
    x_big = p / (p + q * torch.exp(2.0 * w))
    lna, lnb = torch.log(p / (p + q)), torch.log(q / (p + q))
    t, u = torch.exp(p * lna) / p, torch.exp(q * lnb) / q
    w = t + u
    x_small = torch.where(y < t / w, torch.pow(p * w * y, 1.0 / p),
                          1.0 - torch.pow(q * w * (1.0 - y), 1.0 / q))
    x = torch.where((p >= 1.0) & (q >= 1.0), x_big, x_small)
    return torch.where(torch.isfinite(x), torch.clamp(x, X_LO, X_HI), 0.5)


def _logistic(t):
    return 1.0 / (1.0 + torch.exp(-t))


def _beta_root(p, q, y):
    """(x, converged): the kernel's `beta_root`, its rounds held once an
    entry stops."""
    lnB = _beta_lnB(p, q)
    lanes = torch.arange(32, dtype=p.dtype, device=p.device)
    lo, hi = torch.full_like(p, X_LO), torch.full_like(p, X_HI)
    tlo = torch.log(lo) - torch.log1p(-lo)
    thi = torch.log(hi) - torch.log1p(-hi)
    x = _beta_start(p, q, y)
    prev = torch.full_like(p, math.inf)
    active = torch.ones(p.shape, dtype=torch.bool, device=p.device)
    conv = active.clone()
    for _ in range(ROOT_ROUNDS):
        w = (thi - tlo) / 32.0
        t = torch.where(lanes == 0,
                        (torch.log(x) - torch.log1p(-x))[..., None],
                        tlo[..., None] + lanes * w[..., None])
        xl = torch.where(lanes == 0, x[..., None], _logistic(t))
        f, c, _ = _betainc(p[..., None], q[..., None], xl, 0, lnB[..., None])
        conv = conv & (c.all(-1) | ~active)
        f = f - y[..., None]
        nlo, nhi = _narrow(t, f, tlo, thi)
        f0 = f[..., 0]
        u = f0 / torch.clamp_min(torch.exp(
            (p - 1.0) * torch.log(x) + (q - 1.0) * torch.log1p(-x) - lnB),
            1e-300)
        cc = u * ((p - 1.0) / x - (q - 1.0) / (1.0 - x))
        xn = torch.clamp(x - u / (1.0 - 0.5 * torch.fmin(
            torch.ones_like(cc), cc)), X_LO, X_HI)
        tn = torch.log(xn) - torch.log1p(-xn)
        step = (xn - x).abs()
        take = torch.isfinite(xn) & (tn >= nlo) & (tn <= nhi) & (
            step <= 0.5 * prev)
        mid = torch.clamp(_logistic(0.5 * (nlo + nhi)), X_LO, X_HI)
        x = torch.where(active, torch.where(take, xn, mid), x)
        prev = torch.where(active, torch.where(take, step, math.inf), prev)
        tlo = torch.where(active, nlo, tlo)
        thi = torch.where(active, nhi, thi)
        active = active & ~(take & ~(step > STEP_DONE * torch.fmin(
            xn, 1.0 - xn)))
    return x, conv


def _gamma_root(a, p):
    """(x, converged): the kernel's `gamma_root`."""
    lg = torch.lgamma(a)
    z = SQRT2 * torch.special.erfinv(2.0 * p - 1.0)
    g = 2.0 / (9.0 * a)
    c3 = 1.0 - g + z * torch.sqrt(g)
    y_wh = torch.log(torch.clamp_min(a * (c3 * c3 * c3), 1e-300))
    y_sm = (torch.log(p) + torch.lgamma(a + 1.0)) / a
    lanes = torch.arange(32, dtype=a.dtype, device=a.device)
    ylo = torch.full_like(a, Y_LO)
    yhi = torch.log(2.0 * a + 40.0 * torch.sqrt(a) + 800.0)
    y = torch.clamp(y_wh, ylo, yhi)
    prev = torch.full_like(a, math.inf)
    active = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    conv = active.clone()
    for r in range(ROOT_ROUNDS):
        w = (yhi - ylo) / 32.0
        t = ylo[..., None] + lanes * w[..., None]
        if r == 0:
            t = torch.where(lanes == 1, y_sm[..., None], t)
        t = torch.where(lanes == 0, y[..., None], t)
        f, c, _ = _gammainc(a[..., None], torch.exp(t), 0)
        conv = conv & (c.all(-1) | ~active)
        f = f - p[..., None]
        nlo, nhi = _narrow(t, f, ylo, yhi)
        f0 = f[..., 0]
        if r == 0:
            better = f[..., 1].abs() < f0.abs()
            y = torch.where(better, y_sm, y)
            f0 = torch.where(better, f[..., 1], f0)
        x = torch.exp(y)
        u = f0 / torch.clamp_min(torch.exp(a * y - x - lg), 1e-300)
        cc = u * (a - x)
        yn = y - torch.clamp(u / (1.0 - 0.5 * torch.fmin(
            torch.ones_like(cc), cc)), -2.0, 2.0)
        step = (yn - y).abs()
        take = torch.isfinite(yn) & (yn >= nlo) & (yn <= nhi) & (
            step <= 0.5 * prev)
        y = torch.where(active, torch.where(take, yn, 0.5 * (nlo + nhi)), y)
        prev = torch.where(active, torch.where(take, step, math.inf), prev)
        ylo = torch.where(active, nlo, ylo)
        yhi = torch.where(active, nhi, yhi)
        active = active & ~(take & ~(step > STEP_DONE * torch.clamp_min(
            yn.abs(), 1.0)))
    return torch.exp(y), conv


def _nan_clip(z):
    return torch.clamp(torch.nan_to_num(z, nan=0.0, posinf=CAP, neginf=-CAP),
                       -CAP, CAP)


def _inv_partials(kind, p, q, x, order):
    """(d1, d2, converged) of the root x: the inverse-function theorem with
    the JAX package's safeguards (the kernel's formulas)."""
    zero = torch.zeros_like(x)
    dg = _digamma
    if kind == BETA:
        xc = torch.clamp(x, 1e-14, 1.0 - 1e-14)
        I, conv, _ = _betainc(p, q, xc, order)
        L = _beta_logpdf(p, q, xc)
        pdf = torch.exp(torch.clamp(L, -80.0, 80.0))
        inv = 1.0 / torch.clamp_min(pdf, 1.0 / CAP)
        Ac, Bc = _nan_clip(I.g[0]), _nan_clip(I.g[1])
        d1 = torch.stack([-Ac * inv, -Bc * inv, inv], -1)
        if order < 2:
            return d1, None, conv
        dxc = ((x >= 1e-14) & (x <= 1.0 - 1e-14)).to(x.dtype)
        dpq = dg(p + q)
        Lp = torch.log(xc) - dg(p) + dpq
        Lq = torch.log1p(-xc) - dg(q) + dpq
        Lx = ((p - 1.0) / xc - (q - 1.0) / (1.0 - xc)) * dxc
        free = (L >= -80.0) & (L <= 80.0) & (pdf >= 1.0 / CAP)
        ip, iq, ix = (torch.where(free, -inv * t, 0.0) for t in (Lp, Lq, Lx))
        raw = torch.exp(L)
        fa = torch.isfinite(I.g[0]) & (I.g[0].abs() <= CAP)
        fb = torch.isfinite(I.g[1]) & (I.g[1].abs() <= CAP)
        Ap, Aq = torch.where(fa, I.h[0], 0.0), torch.where(fa, I.h[1], 0.0)
        Ax = torch.where(fa, raw * Lp * dxc, 0.0)
        Bp, Bq = torch.where(fb, I.h[1], 0.0), torch.where(fb, I.h[2], 0.0)
        Bx = torch.where(fb, raw * Lq * dxc, 0.0)
        E = [[-(Ap * inv + Ac * ip), -(Aq * inv + Ac * iq), zero],
             [-(Bp * inv + Bc * ip), -(Bq * inv + Bc * iq), zero],
             [ip, iq, zero]]
        X = [-(Ax * inv + Ac * ix), -(Bx * inv + Bc * ix), ix]
    else:
        P, conv, _ = _gammainc(p, x, order)
        L = (p - 1.0) * torch.log(x) - x - torch.lgamma(p)
        inv = torch.exp(-L)
        d1 = torch.stack([-P.g[0] * inv, zero, inv], -1)
        if order < 2:
            return d1, None, conv
        La = torch.log(x) - dg(p)
        Lx = (p - 1.0) / x - 1.0
        ia, ix = -inv * La, -inv * Lx
        Pax = torch.exp(L) * La
        E = [[-(P.h[0] * inv + P.g[0] * ia), zero, zero],
             [zero, zero, zero],
             [ia, zero, zero]]
        X = [-(Pax * inv + P.g[0] * ix), zero, ix]
    d2 = torch.stack([torch.stack([E[r][j] + X[r] * d1[..., j]
                                   for j in range(3)], -1)
                      for r in range(3)], -2)
    return d1, d2, conv


def inc_inv_plain(kind, p, q, y, order=1):
    """`inc_inv`'s plain version (any device; no host read)."""
    p, q, y = torch.broadcast_tensors(p, q, y)
    if kind == GAMMA:
        q = torch.ones_like(p)
    ok = _finite(p, q, y)
    if kind == BETA:
        x, conv = _beta_root(p, q, y)
    else:
        x, conv = _gamma_root(p, y)
    x = torch.where(ok, x, float("nan"))
    bad = ~torch.isfinite(x)
    d1 = d2 = None
    if order >= 1:
        d1, d2, c = _inv_partials(kind, p, q, x, order)
        conv = conv & c
        d1 = torch.where(bad[..., None], 0.0, d1)
        if d2 is not None:
            d2 = torch.where(bad[..., None, None], 0.0, d2)
    return x, d1, d2, _info(bad, conv)


def _ndtr(z):
    return 0.5 * torch.erfc(-z * SQRT1_2)


def _npdf(z):
    return INV_SQRT2PI * torch.exp(-0.5 * z * z)


def _mix_parts(model, th):
    """[t_0 ... t_5] [..., 1, 1] and the lgamma terms (lnB, lg1, lg2) of the
    kernel's `Mix`."""
    t = [th[..., j, None, None] for j in range(th.shape[-1])]
    zero = torch.zeros_like(t[0])
    lnB = _beta_lnB(t[1], t[2]) if model in (9, 10, 11) else zero
    lg1 = (torch.lgamma(t[1]) if model == 6 else
           torch.lgamma(t[3]) if model in (9, 10) else zero)
    lg2 = torch.lgamma(t[3]) if model == 6 else zero
    return t, lnB, lg1, lg2


def _mix_cdf(model, parts, x):
    """(the continuous part's CDF at x, converged): the kernel's
    `mix_cdf`; `parts` from _mix_parts against x [..., K, 32]."""
    t, lnB, lg1, lg2 = parts

    def bcdf():
        return _betainc(t[1], t[2], torch.clamp(x, 1e-12, 1.0 - 1e-12), 0,
                        lnB)[:2]

    def gcdf(a, b, xv):
        return _gammainc(a, b * torch.clamp_min(xv, 0.0), 0)[:2]

    if model == 6:
        g1, c1 = gcdf(t[1], t[2], x)
        g2, c2 = gcdf(t[3], t[3], x)
        return t[0] * g1 + (1.0 - t[0]) * g2, c1 & c2
    if model == 9:
        b1, c1 = bcdf()
        g2, c2 = gcdf(t[3], t[4], x)
        return t[0] * b1 + (1.0 - t[0]) * g2, c1 & c2
    low = x <= 1.0
    if model == 10:
        b1, c1 = bcdf()
        g2, c2 = gcdf(t[3], t[4], x - 1.0)
        return (torch.where(low, t[0] * b1, t[0] + (1.0 - t[0]) * g2),
                torch.where(low, c1, c2))
    if model == 11:
        z1 = torch.clamp_min(_ndtr((t[3] - 1.0) / t[4]), 1e-12)
        b1, c1 = bcdf()
        hi = t[0] + (1.0 - t[0]) * (1.0 - _ndtr((t[3] - x) / t[4]) / z1)
        return torch.where(low, t[0] * b1, hi), c1 | ~low
    ones = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if model == 12:
        p1, mu2, s1, s2 = t[1], t[2], t[3], t[4]
        return (1.0 - p1 * _ndtr(-(x - 1.0) / s1) / _ndtr(1.0 / s1)
                - (1.0 - p1) * _ndtr(-(x - mu2) / s2)
                / torch.clamp_min(_ndtr(mu2 / s2), 1e-12)), ones
    e0, e1 = torch.exp(t[0]), torch.exp(t[1])
    z = e0 + e1 + 1.0
    f0, f1 = e0 / z, e1 / z
    f2 = 1.0 - f0 - f1
    mu2, s0, s1, s2 = t[2], t[3], t[4], t[5]
    return (1.0 - f0 * 2.0 * _ndtr(-x / s0)
            - f1 * _ndtr(-(x - 1.0) / s1) / _ndtr(1.0 / s1)
            - f2 * _ndtr(-(x - mu2) / s2)
            / torch.clamp_min(_ndtr(mu2 / s2), 1e-12)), ones


def _mix_pdf(model, parts, x):
    """The kernel's `mix_pdf`: the density, 0 where the CDF clamps."""
    t, lnB, lg1, lg2 = parts
    zero = torch.zeros_like(x)

    def bpdf():
        inside = (x > 1e-12) & (x < 1.0 - 1e-12)
        return torch.where(inside, torch.exp(
            (t[1] - 1.0) * torch.log(x) + (t[2] - 1.0) * torch.log1p(-x)
            - lnB), zero)

    def gpdf(a, b, lg, xv):
        return torch.where(xv > 0.0, b * torch.exp(
            (a - 1.0) * torch.log(b * xv) - b * xv - lg), zero)

    if model == 6:
        return (t[0] * gpdf(t[1], t[2], lg1, x)
                + (1.0 - t[0]) * gpdf(t[3], t[3], lg2, x))
    if model == 9:
        return t[0] * bpdf() + (1.0 - t[0]) * gpdf(t[3], t[4], lg1, x)
    low = x <= 1.0
    if model == 10:
        return torch.where(low, t[0] * bpdf(),
                           (1.0 - t[0]) * gpdf(t[3], t[4], lg1, x - 1.0))
    if model == 11:
        z1 = torch.clamp_min(_ndtr((t[3] - 1.0) / t[4]), 1e-12)
        return torch.where(low, t[0] * bpdf(), (1.0 - t[0])
                           * _npdf((t[3] - x) / t[4]) / (t[4] * z1))
    if model == 12:
        p1, mu2, s1, s2 = t[1], t[2], t[3], t[4]
        return (p1 * _npdf((x - 1.0) / s1) / (s1 * _ndtr(1.0 / s1))
                + (1.0 - p1) * _npdf((x - mu2) / s2)
                / (s2 * torch.clamp_min(_ndtr(mu2 / s2), 1e-12)))
    e0, e1 = torch.exp(t[0]), torch.exp(t[1])
    z = e0 + e1 + 1.0
    f0, f1 = e0 / z, e1 / z
    f2 = 1.0 - f0 - f1
    mu2, s0, s1, s2 = t[2], t[3], t[4], t[5]
    return (f0 * 2.0 * _npdf(x / s0) / s0
            + f1 * _npdf((x - 1.0) / s1) / (s1 * _ndtr(1.0 / s1))
            + f2 * _npdf((x - mu2) / s2)
            / (s2 * torch.clamp_min(_ndtr(mu2 / s2), 1e-12)))


def mix_quantiles_plain(model, theta, K):
    """`mix_quantiles`' plain version (any device; no host read); theta may
    carry leading axes, one set of parameters per row: x [..., K]."""
    lo, hi, info = mix_bracket_plain(model, theta, K)
    return 0.5 * (lo + hi), info


def mix_bracket_plain(model, theta, K):
    """The brackets [lo, hi] whose midpoints `mix_quantiles` returns, and
    its info: NOCONV where a bracket is still wider than the first
    design's (MIX_WIDTH, or two adjacent doubles) after MIX_ROUNDS."""
    if model not in NTHETA or K < 1:
        raise ValueError(f"mix_quantiles: NSsites {model}, K {K}")
    th = theta[..., :NTHETA[model]].to(torch.float64)
    shape = th.shape[:-1] + (K,)
    ok = torch.isfinite(th).all(-1)[..., None]
    kw = dict(dtype=th.dtype, device=th.device)
    parts = _mix_parts(model, th)
    target = (torch.arange(K, **kw) + 0.5) / K
    lo = torch.full(shape, MIX_LO, **kw)
    hi = torch.full_like(lo, MIX_HI)
    xe = torch.full_like(lo, math.nan)
    step = torch.zeros_like(lo)
    lanes = torch.arange(32, **kw)
    active = torch.ones(shape, dtype=torch.bool, device=th.device)
    conv = active.clone()
    nan = torch.zeros_like(conv)
    misses = torch.zeros(shape, dtype=torch.int32, device=th.device)
    for r in range(MIX_ROUNDS):
        w0 = hi - lo
        half = torch.fmax(2.0 * step, 8.0 * (torch.nextafter(
            xe, torch.full_like(xe, math.inf)) - xe))
        clo = torch.fmax(lo, xe - half)
        chi = torch.fmin(hi, xe + half)
        cluster = torch.where(lanes == 0, xe[..., None], clo[..., None]
                              + lanes * ((chi - clo) / 32.0)[..., None])
        sect = lo[..., None] + (lanes + 1.0) * ((hi - lo) / 33.0)[..., None]
        x = torch.where(torch.isnan(xe)[..., None], sect, cluster)
        c, cv = _mix_cdf(model, parts, x)
        conv = conv & (cv.all(-1) | ~active)
        nan = nan | (torch.isnan(c).any(-1) & active)
        f = c - target[:, None]
        nlo, nhi = _narrow(x, f, lo, hi)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
        tight = ~(nhi > torch.nextafter(nlo, torch.full_like(nlo, math.inf))
                  ) | (nhi - nlo <= MIX_WIDTH)
        # a cluster that missed the root: one 33-section round after the
        # first, only 33-section rounds after the second
        missed = active & ~torch.isnan(xe) & (nhi - nlo > w0 / 32.0)
        misses = misses + missed.to(torch.int32)
        best = torch.where(torch.isnan(f), math.inf, f.abs()).argmin(-1,
                                                                    True)
        xb = x.gather(-1, best)
        fb = f.gather(-1, best)
        xn = (xb - fb / _mix_pdf(model, parts, xb))[..., 0]
        newton = ((r + 1 >= MIX_SECTIONS) & torch.isfinite(xn) & ~missed
                  & (misses < 2))
        xn = torch.clamp(xn, nlo, nhi)
        xe = torch.where(active, torch.where(newton, xn, math.nan), xe)
        step = torch.where(active & newton, (xn - xb[..., 0]).abs(), step)
        active = active & ~tight
    return lo, hi, _info(nan | ~ok, conv & ~active)


PLAIN = types.SimpleNamespace(inc=inc_plain, inc_inv=inc_inv_plain,
                              mix_quantiles=mix_quantiles_plain)
