"""Bounded quasi-Newton maximization of likelihood functions.

Port of `maximize` in `paml_tpu/core/optim.py`: host-side scipy L-BFGS-B
driving a torch value + gradient (one forward and one backward per
evaluation, on the device the objective lives on), with restarts from
the optimum and multi-start.  The non-finite value and gradient guards of
the JAX package are kept: each fixed a real stalled fit.

The JAX package's `maximize_policy` (an f32 stage on the chip, then an f64
polish on the host) is not ported: it exists because f64 is emulated on
the TPU, and the H100 runs f64 natively, so a fit here is one f64 stage
on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


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


def maximize(neg_fn: Callable, x0: np.ndarray,
             bounds: list[tuple[float, float]] | None = None, *, device,
             multi_start: list[np.ndarray] | None = None) -> FitResult:
    """Maximize a log-likelihood by minimizing `neg_fn` (a function of a
    float64 1-D tensor on `device` returning a scalar tensor)."""
    from scipy.optimize import minimize

    n_eval = [0]
    vworst = [None]     # worst finite value seen (penalty anchor)
    rub = open(_RUB_PATH, "a") if _RUB_PATH else None

    def fun(x):
        xt = torch.tensor(x, dtype=torch.float64, device=device,
                          requires_grad=True)
        v = neg_fn(xt)
        (g,) = torch.autograd.grad(v, xt)
        n_eval[0] += 1
        v = float(v.detach())
        g = g.detach().cpu().numpy().astype(np.float64)
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
    if rub is not None:
        rub.close()
    return FitResult(x=np.asarray(best.x), lnL=-float(best.fun),
                     n_eval=n_eval[0], converged=bool(best.success),
                     message=str(best.message))


# --- parameter transforms --------------------------------------------------

def simplex_encode(p: torch.Tensor) -> torch.Tensor:
    """Proportions p (sum 1, len k) -> unconstrained (len k-1), log-ratio
    against the last class (reference: f_and_x, src/tools.c:1339)."""
    return torch.log(p[:-1]) - torch.log(p[-1])


def simplex_decode(x: torch.Tensor) -> torch.Tensor:
    z = torch.cat([x, torch.zeros(1, dtype=x.dtype, device=x.device)])
    return torch.exp(z - torch.logsumexp(z, dim=0))
