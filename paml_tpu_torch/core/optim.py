"""Bounded quasi-Newton maximization of likelihood functions.

Port of `paml_tpu/core/optim.py`.  `maximize`: host-side scipy L-BFGS-B
driving a torch value + gradient (one forward and one backward per
evaluation, on the device the objective lives on), with restarts from
the optimum and multi-start; a float32 objective takes the same float64
tolerances and restarts, as the JAX package's fits with an explicit dtype
do.  The non-finite value and gradient guards of the JAX package are
kept: each fixed a real stalled fit.

`maximize_device` and `maximize_device_bounded` (the JAX package's
`maximize_jax` and `maximize_jax_bounded`) run the whole L-BFGS on the
device: x, the memory, the value and the gradient never leave it, and
the host reads one flag, the stop test, once every CHECK_EVERY
line-search trials (`_stop_read`).

The JAX package's `maximize_policy` (an f32 stage on the chip, then an f64
polish on the host) is not ported: it exists because f64 is emulated on
the TPU, and the H100 runs f64 natively, so a fit here is one stage on the
device, in the dtype its objective was built in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import graphs, pruning


@dataclass
class FitResult:
    x: np.ndarray
    lnL: float
    n_eval: int
    converged: bool
    message: str = ""


_RUB_PATH = None   # optimizer trace file (the reference's rub)


def set_rub(path: str | None) -> None:
    """Write an optimizer-iteration trace to `path` (the reference's rub
    file, written by ming2's fout argument; Forestry codeml.c:756)."""
    global _RUB_PATH
    _RUB_PATH = path


# scipy L-BFGS-B settings of the JAX package's f64 fits
_OPTS = {"maxiter": 2000, "ftol": 1e-14, "gtol": 1e-9, "maxcor": 30,
         "maxls": 50}
_RESTARTS = 8


class GraphCache:
    """CUDA graphs of objectives' value + gradient that outlive a fit: one
    `graphs.GraphedValueGrad` per (objective, length of x), captured at
    its first evaluation by any fit handed the cache and replayed by every
    later one (the pairwise programs' one graph per program: each pair's
    data goes into fixed buffers that the objective reads).  The caller
    closes the cache when its fits are done."""

    def __init__(self):
        self._graphs: dict = {}

    def get(self, neg_fn, x: np.ndarray, device) -> graphs.GraphedValueGrad:
        key = (neg_fn, len(x))
        if key not in self._graphs:
            self._graphs[key] = graphs.GraphedValueGrad(
                neg_fn, torch.as_tensor(x, dtype=torch.float64).to(device))
            GRAPHS["captures"] += 1
        return self._graphs[key]

    def __len__(self) -> int:
        return len(self._graphs)

    def close(self) -> None:
        for g in self._graphs.values():
            g.close()
        self._graphs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maximize(neg_fn: Callable, x0: np.ndarray,
             bounds: list[tuple[float, float]] | None = None, *, device,
             multi_start: list[np.ndarray] | None = None,
             cache: GraphCache | None = None) -> FitResult:
    """Maximize a log-likelihood by minimizing `neg_fn` (a function of a
    float64 1-D tensor on `device` returning a scalar tensor; an objective
    built in float32 casts x itself).  On a CUDA device an objective that
    declares itself `capturable` is evaluated from one CUDA graph
    (`graphs.GraphedValueGrad`, captured at the first evaluation, used by
    every start and restart): one copy of x in, one replay, one copy of
    the value, the gradient and the status word out.  The graph is taken
    from the caller's `cache`, which keeps it, or else made for this fit
    and released on return.  Any other objective, and any on the CPU, is
    evaluated op by op (`graphs.value_grad_eager`); `GRAPHS` counts both
    kinds and the captures."""
    device = torch.device(device)
    n_eval = [0]
    vworst = [None]     # worst finite value seen (penalty anchor)
    rub = open(_RUB_PATH, "a") if _RUB_PATH else None
    held = GraphCache() if cache is None else cache
    graph = [None]      # the objective's GraphedValueGrad, taken at first use

    def fun(x):
        if graphed(neg_fn, device):
            if graph[0] is None:
                graph[0] = held.get(neg_fn, x, device)
            out = graph[0](x)
            GRAPHS["graphed_evals"] += 1
        else:
            out = graphs.value_grad_eager(neg_fn, x, device)
            GRAPHS["eager_evals"] += 1
        n_eval[0] += 1
        v, g = float(out[0]), out[1:]
        if not np.isfinite(v):
            # Non-finite value at a line-search trial: a huge sentinel makes
            # the line search's interpolation step underflow to zero and
            # report convergence at the start point.  A moderate penalty
            # anchored at the worst finite value backtracks like an
            # ordinary bad trial.
            anchor = vworst[0] if vworst[0] is not None else 1e8
            v = abs(anchor) * 1.5 + 1e3
            g = np.where(np.isfinite(g), g, 0.0)
        else:
            vworst[0] = v if vworst[0] is None else max(vworst[0], v)
            if not np.all(np.isfinite(g)):
                # a non-finite gradient at a finite value also poisons the
                # line search: keep the value, zero the bad components
                g = np.where(np.isfinite(g), g, 0.0)
        if rub is not None:
            rub.write(f"{n_eval[0]:6d} {-v:16.6f} "
                      f"{float(np.abs(g).max()):12.5g}\n")
        return v, g

    starts = [np.asarray(x0, dtype=np.float64)]
    if multi_start:
        starts += [np.asarray(s, dtype=np.float64) for s in multi_start]
    try:
        best = _minimize_starts(fun, starts, bounds)
    finally:
        if cache is None:
            held.close()
        if rub is not None:
            rub.close()
    return FitResult(x=np.asarray(best.x), lnL=-float(best.fun),
                     n_eval=n_eval[0], converged=bool(best.success),
                     message=str(best.message))


def _minimize_starts(fun, starts, bounds):
    """scipy's L-BFGS-B from each start, with restarts from each optimum:
    the best result."""
    from scipy.optimize import minimize

    best = None
    for s in starts:
        res = minimize(fun, s, jac=True, method="L-BFGS-B", bounds=bounds,
                       options=_OPTS)
        # restart from the optimum: resets the L-BFGS memory, which
        # escapes line-search stalls on ridged surfaces; stop when a
        # restart no longer improves
        for _ in range(_RESTARTS):
            res2 = minimize(fun, res.x, jac=True, method="L-BFGS-B",
                            bounds=bounds, options=_OPTS)
            if res2.fun < res.fun - 1e-10 * max(1.0, abs(res.fun)):
                res = res2
            else:
                if res2.fun < res.fun:
                    res = res2
                break
        if best is None or res.fun < best.fun:
            best = res
    return best


# --- L-BFGS on the device ----------------------------------------------------
#
# The JAX package runs optax's L-BFGS under one `jax.jit`: a while loop
# whose zoom line search (strong Wolfe conditions, Nocedal and Wright
# algorithms 3.5 and 3.6, with Hager and Zhang's approximate decrease)
# takes as many trials as it needs.  Here the loop is on the host but
# reads nothing from the device: every branch is a `torch.where` on device
# tensors, so the host only queues work, and it learns that the run has
# stopped from one flag read every CHECK_EVERY passes.  A pass is one
# line-search trial, one value + gradient: the same zoom line search is a
# state machine carried across passes (bracketing, then the cubic, the
# quadratic or the midpoint inside the bracket), and an iteration ends
# when its line search does, with a step or with none.  The accepted
# trial's value and gradient start the next iteration, so an iteration
# costs as many evaluations as its line search took trials (optax's loop
# evaluates the start point once more).  Passes after the stop are frozen
# no-ops: the result is the one of an exact stop, and at most
# CHECK_EVERY - 1 evaluations are spent after it.
#
# The state lives in tensors made once, which every pass overwrites in
# place, so that CHECK_EVERY passes can be recorded as one CUDA graph
# (the JAX package's `jit` of the loop) and replayed between the reads of
# the stop flag: on a CUDA device for an objective that declares itself
# `capturable`; elsewhere the same passes run op by op.  Both give the
# same bits.  The evaluations' status words (`graphs.status_sink`) are
# folded into the state and read with the stop flag.

CHECK_EVERY = 5          # passes (trials) between reads of the stop flag
LBFGS_MEMORY = 10        # optax.lbfgs's default memory
LS_STEPS = 20            # trials per line search (optax.lbfgs's default)
LS_C1, LS_C2 = 1e-4, 0.9     # sufficient decrease, curvature (optax's
                             # slope_rtol, curv_rtol)
LS_APPROX = 1e-6         # approximate decrease: value within this of the
                         # start, relative (optax's approx_dec_rtol)
LS_MIN_BRACKET = 1e-5    # a bracket this narrow with a point of decrease
                         # ends the search there (optax's interval_threshold)
CHECKS = {"reads": 0,    # reads of the stop flag (`_stop_read`)
          "trials": 0}   # line-search trials, one evaluation each
# how every fit evaluated its objective (`maximize` and the device L-BFGS),
# and mcmctree's exact likelihood (`ExactLoci.lnl`) its calls
GRAPHS = {"graphed_evals": 0,    # evaluations replayed from a CUDA graph
          "eager_evals": 0,      # evaluations dispatched op by op
          "captures": 0}         # CUDA graphs captured (`graphs.capture`)


def graphed(neg_fn, device) -> bool:
    """Whether the fits evaluate neg_fn from a CUDA graph: on a CUDA
    device, for an objective that declares itself `capturable` (no host
    read in an evaluation), with no pattern mesh engaged (whose shards may
    lie on other cards or ranks)."""
    return (torch.device(device).type == "cuda"
            and getattr(neg_fn, "capturable", False)
            and pruning.pattern_mesh() is None)


def _stop_read(st: dict) -> bool:
    """The device loop's one read of the device: its stop flag, and with it
    the status word of every evaluation since the start
    (`graphs.DeviceStatusError` if it is not 0)."""
    CHECKS["reads"] += 1
    done, status = torch.stack([st["done"].to(st["status"].dtype),
                                st["status"]]).tolist()
    graphs.check_status(status, "the device L-BFGS")
    return bool(done)


def _value_grad(neg_fn, y: torch.Tensor, status: torch.Tensor):
    """(value, gradient with non-finite components 0, status), status the
    larger of `status` and the evaluation's status words."""
    y = y.detach().requires_grad_(True)
    with graphs.status_sink() as sink, torch.enable_grad():
        v = neg_fn(y)
        (g,) = torch.autograd.grad(v, y)
    return (v.detach(), torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0),
            torch.maximum(status, graphs.status_of(sink, y)))


def _scale0(g: torch.Tensor) -> torch.Tensor:
    """The first step's scale, min(1, 1 / |g|) (optax's capped inverse
    gradient norm)."""
    return torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)


def _direction(g, S, Yg, rho, gamma):
    """-H g by the two-loop recursion over the memory (steps S, gradient
    changes Yg, rho = 1 / (s . y), 0 for no pair; H0 = gamma I): (p, its
    slope g . p, whether it descends)."""
    q, a = g, [None] * len(rho)
    for j in reversed(range(len(rho))):
        a[j] = rho[j] * torch.dot(S[j], q)
        q = q - a[j] * Yg[j]
    r = gamma * q
    for j in range(len(rho)):
        r = r + S[j] * (a[j] - rho[j] * torch.dot(Yg[j], r))
    d0 = -torch.dot(g, r)
    descent = d0 < 0
    p = torch.where(descent, -r, -_scale0(g) * g)
    return p, torch.where(descent, d0, torch.dot(g, p)), descent


def _cubicmin(a, fa, da, b, fb, c, fc):
    """The minimum of the cubic through (a, fa) with slope da, (b, fb) and
    (c, fc); NaN where there is none (optax `_cubicmin`)."""
    db, dc = b - a, c - a
    rb, rc = fb - fa - da * db, fc - fa - da * dc
    denom = (db * dc) ** 2 * (db - dc)
    A = (dc * dc * rb - db * db * rc) / denom
    B = (db ** 3 * rc - dc ** 3 * rb) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * da)) / (3.0 * A)


def _quadmin(a, fa, da, b, fb):
    """The minimum of the quadratic through (a, fa) with slope da and
    (b, fb) (optax `_quadmin`)."""
    db = b - a
    return a - da / (2.0 * (fb - fa - da * db) / (db * db))


def _zoom_trial(lo, f_lo, d_lo, hi, f_hi, cref, f_cref):
    """The next trial inside the bracket: the cubic's minimum if it lies
    in the bracket's middle three fifths, else the quadratic's if in its
    middle four fifths, else the midpoint (optax `_zoom_into_interval`)."""
    delta = (hi - lo).abs()
    left, right = torch.minimum(lo, hi), torch.maximum(lo, hi)
    mc = _cubicmin(lo, f_lo, d_lo, hi, f_hi, cref, f_cref)
    mq = _quadmin(lo, f_lo, d_lo, hi, f_hi)
    cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
    quad = ~cubic & (mq > left + 0.1 * delta) & (mq < right - 0.1 * delta)
    return torch.where(cubic, mc, torch.where(quad, mq, 0.5 * (lo + hi)))


def _wolfe_errors(a, f_t, d_t, f0, d0):
    """How far a trial at step a (value f_t, slope d_t) misses sufficient
    decrease (exact, or approximate: the slope bound with a value within
    LS_APPROX of the start) and the strong curvature condition; 0 where it
    meets them, inf where the trial is not finite (optax
    `_compute_decrease_error`, `_compute_curvature_error`)."""
    inf = torch.full_like(f0, float("inf"))
    exact = f_t - f0 - LS_C1 * a * d0
    approx = torch.maximum(d_t - (2.0 * LS_C1 - 1.0) * d0,
                           f_t - f0 - LS_APPROX * f0.abs())
    dec = torch.clamp_min(torch.minimum(approx, exact), 0.0)
    curv = torch.clamp_min(d_t.abs() - LS_C2 * d0.abs(), 0.0)
    return (torch.where(torch.isnan(dec), inf, dec),
            torch.where(torch.isnan(curv), inf, curv))


def _ls_start(f, g, p, d0):
    """A line search's state at its start along p (slope d0) from the
    point of value f and gradient g: no trial yet, the bracket and the
    best point of sufficient decrease (`safe`) at step 0."""
    zero = torch.zeros_like(f)
    return dict(p=p, d0=d0, count=torch.zeros((), dtype=torch.int64,
                                              device=f.device),
                found=torch.zeros((), dtype=torch.bool, device=f.device),
                a_prev=zero, f_prev=f, d_prev=d0, lo=zero, f_lo=f, d_lo=d0,
                hi=zero, f_hi=f, d_hi=d0, cref=zero, f_cref=f,
                safe_a=zero, safe_f=f, safe_g=g)


def _lbfgs_run(neg_fn, y0: torch.Tensor, maxiter: int, tol: float,
               ftol: float = 0.0, patience: int | None = None):
    """Minimize neg_fn from y0 on y0's device and in its dtype: (y, the
    value at y, iterations, trials) as device tensors.  An iteration is
    one zoom line search along the L-BFGS direction: it ends at a trial
    that meets the strong Wolfe conditions (exact or approximate
    decrease), or after LS_STEPS trials (or in a bracket narrower than
    LS_MIN_BRACKET) at its best point of sufficient decrease, or with no
    step if it found none.  Stops at a gradient norm at most tol, after
    `patience` iterations in a row that improve the value by at most
    ftol (1 + |f|) (None: never), after two iterations in a row with no
    step (the second from a reset memory), or after maxiter iterations.
    The passes between two reads of the stop flag are replayed from one
    CUDA graph where `graphed(neg_fn, device)` holds, else dispatched op
    by op; `GRAPHS` counts the evaluations of each kind and the
    captures."""
    st = _lbfgs_state(neg_fn, y0, tol)

    def one_pass():
        _lbfgs_pass(neg_fn, st, maxiter, tol, ftol, patience)

    def passes():
        for _ in range(CHECK_EVERY):
            one_pass()

    graph, kind = None, "eager_evals"
    if graphed(neg_fn, y0.device):
        # the warm-up pass moves the state: take it back before replaying
        before = {k: v.clone() for k, v in st.items()}
        graph, _ = graphs.capture(passes, warmup=one_pass)
        GRAPHS["captures"] += 1
        for k, v in before.items():
            st[k].copy_(v)
        del before
        passes, kind = graph.replay, "graphed_evals"
    try:
        for _ in range(-(-maxiter * LS_STEPS // CHECK_EVERY) + 1):
            if _stop_read(st):
                break
            passes()
            GRAPHS[kind] += CHECK_EVERY
    finally:
        del graph
    return st["y"], st["f"], st["it"], st["trials"]


def _lbfgs_state(neg_fn, y0: torch.Tensor, tol: float) -> dict:
    """`_lbfgs_run`'s state at y0 (one evaluation, op by op): every entry
    a buffer of its own, which each pass overwrites in place."""
    m = LBFGS_MEMORY
    y = y0.detach().clone()
    f, g, status = _value_grad(neg_fn, y, y.new_zeros((), dtype=torch.float64))
    GRAPHS["eager_evals"] += 1
    S = y.new_zeros((m, y.numel()))        # steps, oldest first
    Yg = torch.zeros_like(S)               # gradient changes
    rho = y.new_zeros(m)                   # 1 / (s . y); 0 for no pair
    gamma = _scale0(g)
    p, d0, _ = _direction(g, S, Yg, rho, gamma)
    zero = torch.zeros((), dtype=torch.int64, device=y.device)
    st = dict(y=y, f=f, g=g, S=S, Yg=Yg, rho=rho, gamma=gamma, it=zero,
              trials=zero, stall=zero, fails=zero, **_ls_start(f, g, p, d0),
              status=status, done=torch.linalg.vector_norm(g) <= tol)
    return {k: v.clone() for k, v in st.items()}


def _lbfgs_pass(neg_fn, st: dict, maxiter: int, tol: float, ftol: float,
                patience: int | None) -> None:
    """One line-search trial of `_lbfgs_run`, its state `st` updated in
    place (a no-op once st["done"] is set)."""
    s = st
    live = ~s["done"]
    f, g, p, d0, count, found = (s["f"], s["g"], s["p"], s["d0"],
                                 s["count"], s["found"])
    # the trial: doubling until a bracket is found, then inside it
    a = torch.where(found, _zoom_trial(s["lo"], s["f_lo"], s["d_lo"],
                                       s["hi"], s["f_hi"], s["cref"],
                                       s["f_cref"]),
                    torch.where(count == 0, torch.ones_like(f),
                                2.0 * s["a_prev"]))
    f_t, g_t, status = _value_grad(neg_fn, s["y"] + a * p, s["status"])
    d_t = torch.dot(g_t, p)
    dec, curv = _wolfe_errors(a, f_t, d_t, f, d0)
    ok = torch.maximum(dec, curv) <= 0.0
    safe = (dec <= 0.0) & (~found | (f_t < s["safe_f"]))
    safe_a = torch.where(safe, a, s["safe_a"])
    safe_f = torch.where(safe, f_t, s["safe_f"])
    safe_g = torch.where(safe, g_t, s["safe_g"])
    # bracketing (algorithm 3.5): the trial ends the bracket when it
    # misses decrease or is no better than the last, or starts it
    # when the slope has turned
    b_hi = (dec > 0.0) | ((f_t >= s["f_prev"]) & (count > 0))
    b_lo = (d_t >= 0.0) & ~b_hi
    new, prev = (a, f_t, d_t), (s["a_prev"], s["f_prev"], s["d_prev"])
    blo = [torch.where(b_lo, u, v) for u, v in zip(new, prev)]
    bhi = [torch.where(b_lo, v, u) for u, v in zip(new, prev)]
    # zooming (algorithm 3.6): the trial replaces one end
    old_lo = (s["lo"], s["f_lo"], s["d_lo"])
    old_hi = (s["hi"], s["f_hi"], s["d_hi"])
    z_mid = (dec > 0.0) | (f_t >= s["f_lo"])
    z_flip = (d_t * (s["hi"] - s["lo"]) >= 0.0) & ~z_mid
    zhi = [torch.where(z_mid, u, torch.where(z_flip, w, v))
           for u, v, w in zip(new, old_hi, old_lo)]
    zlo = [torch.where(z_mid, w, u) for u, w in zip(new, old_lo)]
    zref = [torch.where(z_mid | z_flip, v, w)
            for v, w in zip(old_hi[:2], old_lo[:2])]
    lo = [torch.where(found, u, v) for u, v in zip(zlo, blo)]
    hi = [torch.where(found, u, v) for u, v in zip(zhi, bhi)]
    cref = [torch.where(found, u, v) for u, v in zip(zref, blo[:2])]
    narrow = found & ((s["hi"] - s["lo"]).abs() <= LS_MIN_BRACKET)
    failed = ~ok & ((count + 1 >= LS_STEPS) | (narrow & (safe_a > 0.0)))
    end = ok | failed
    # where the line search ends: the trial, else its best point of
    # sufficient decrease, else no step
    a_fin = torch.where(failed, safe_a, a)
    f_fin = torch.where(failed, safe_f, f_t)
    g_fin = torch.where(failed, safe_g, g_t)
    moved = end & (a_fin > 0.0)
    nomove = end & ~moved
    s_k, y_k = a_fin * p, g_fin - g
    sy, yy = torch.dot(s_k, y_k), torch.dot(y_k, y_k)
    pair = moved & (sy > torch.finfo(s["y"].dtype).eps * yy)
    S = torch.where(pair, torch.cat([s["S"][1:], s_k[None]]), s["S"])
    Yg = torch.where(pair, torch.cat([s["Yg"][1:], y_k[None]]), s["Yg"])
    rho = torch.where(pair, torch.cat([s["rho"][1:], (1.0 / sy)[None]]),
                      s["rho"])
    gamma = torch.where(pair, sy / yy, s["gamma"])
    # after a search with no step: a reset memory
    rho = torch.where(nomove, torch.zeros_like(rho), rho)
    gamma = torch.where(nomove, _scale0(g), gamma)
    improved = (f - f_fin) > ftol * (1.0 + f_fin.abs())
    y_n = torch.where(moved, s["y"] + s_k, s["y"])
    f_n = torch.where(moved, f_fin, f)
    g_n = torch.where(moved, g_fin, g)
    # the next iteration's direction; one that does not descend
    # resets the memory
    p_n, d0_n, descent = _direction(g_n, S, Yg, rho, gamma)
    rho = torch.where(end & ~descent, torch.zeros_like(rho), rho)
    nxt = dict(y=y_n, f=f_n, g=g_n, S=S, Yg=Yg, rho=rho, gamma=gamma,
               it=s["it"] + end.long(), trials=s["trials"] + 1,
               stall=torch.where(end, torch.where(improved, 0,
                                                  s["stall"] + 1),
                                 s["stall"]),
               fails=torch.where(nomove, s["fails"] + 1,
                                 torch.where(moved, 0, s["fails"])),
               p=p, d0=d0, count=count + 1, found=found | b_hi | b_lo | ok,
               a_prev=a, f_prev=f_t, d_prev=d_t, lo=lo[0], f_lo=lo[1],
               d_lo=lo[2], hi=hi[0], f_hi=hi[1], d_hi=hi[2], cref=cref[0],
               f_cref=cref[1], safe_a=safe_a, safe_f=safe_f,
               safe_g=safe_g, status=status)
    start = _ls_start(f_n, g_n, p_n, d0_n)
    nxt.update({k: torch.where(end, v, nxt[k]) for k, v in start.items()})
    upd = {k: torch.where(live, nxt[k], s[k]) for k in nxt}
    done = (s["done"] | (end & (torch.linalg.vector_norm(upd["g"]) <= tol))
            | (upd["fails"] >= 2) | (upd["it"] >= maxiter))
    if patience is not None:
        done = done | (upd["stall"] >= patience)
    for k, v in upd.items():
        s[k].copy_(v)
    s["done"].copy_(done)


def maximize_device(neg_fn: Callable, x0: torch.Tensor, *,
                    maxiter: int = 500, tol: float = 1e-10):
    """Unbounded maximization with the whole L-BFGS on x0's device and in
    its dtype (the JAX package's `maximize_jax`, optax L-BFGS with its
    zoom line search under one jit): minimizes neg_fn from x0, stopping at
    a gradient norm below tol or after maxiter iterations.  Returns (x as
    numpy, lnL, iterations); an iteration is one line search, and
    CHECKS["trials"] adds its trials (evaluations after the first)."""
    y, f, it, trials = _lbfgs_run(neg_fn, x0, maxiter, tol)
    CHECKS["trials"] += int(trials)
    return y.detach().cpu().numpy(), -float(f), int(it)


def maximize_device_bounded(neg_fn: Callable, x0, bounds, *, device, dtype,
                            maxiter: int = 500, tol: float = 1e-9,
                            ftol: float | None = None, patience: int = 5):
    """Whole-fit-on-device bounded maximization (the JAX package's
    `maximize_jax_bounded`): the box mapped to an unconstrained chart by a
    scaled sigmoid, x = lo + (hi - lo) sigmoid(y), x0 clipped 1e-6 of the
    span inside the box; then `_lbfgs_run` in `dtype` on `device`, no host
    round trip per evaluation.  Stops on a gradient norm (in y) below tol,
    on `patience` iterations in a row that improve -lnL by less than
    ftol (1 + |f|) (ftol 3e-7 in float32, 1e-10 in float64 by default: a
    float32 gradient never reaches a float64 tolerance), or at maxiter.
    Returns (x as numpy, lnL, iterations), iterations counted as
    `maximize_device` counts them.  Parity-grade optima are `maximize`'s;
    this is the wall-time engine."""
    lo = torch.tensor([b[0] for b in bounds], dtype=dtype, device=device)
    hi = torch.tensor([b[1] for b in bounds], dtype=dtype, device=device)
    span = hi - lo
    x0 = torch.as_tensor(np.asarray(x0), dtype=dtype, device=device)
    x0 = torch.minimum(torch.maximum(x0, lo + 1e-6 * span), hi - 1e-6 * span)
    y0 = torch.logit((x0 - lo) / span)

    def to_x(y):
        return lo + span * torch.sigmoid(y)

    def neg_y(y):
        return neg_fn(to_x(y))
    neg_y.capturable = getattr(neg_fn, "capturable", False)

    if ftol is None:
        ftol = 3e-7 if dtype == torch.float32 else 1e-10
    y, f, it, trials = _lbfgs_run(neg_y, y0, maxiter, tol, ftol, patience)
    CHECKS["trials"] += int(trials)
    return to_x(y).cpu().numpy(), -float(f), int(it)


# --- parameter transforms --------------------------------------------------

def simplex_encode(p: torch.Tensor) -> torch.Tensor:
    """Proportions p (sum 1, len k) -> unconstrained (len k-1), log-ratio
    against the last class (reference: f_and_x, src/tools.c:1339)."""
    return torch.log(p[:-1]) - torch.log(p[-1])


def simplex_decode(x: torch.Tensor) -> torch.Tensor:
    z = torch.cat([x, torch.zeros(1, dtype=x.dtype, device=x.device)])
    return torch.exp(z - torch.logsumexp(z, dim=0))
