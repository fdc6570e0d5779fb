"""Nucleotide substitution models (the baseml model family).

Port of `paml_tpu/models/nuc.py`.  The model order is the reference's
(src/baseml.c:130): JC69 K80 F81 F84 HKY85 T92 TN93 REV UNREST REVu
UNRESTu.  JC69 to TN93 take the closed-form TN93 P(t); REV and REVu the
spectral P(t) of `core/pmat.py`; UNREST and UNRESTu, which are not
reversible, `pmat.pmat_expm` (scaling and squaring with a fixed Pade
degree, no host read), their stationary pi by `pmat.solve_small`.  Q is normalized to mean rate 1
(reference invariant, Appendix B of SURVEY.md).

The rate-matrix builders take rates and frequencies with leading batch
dimensions (one set per branch under nhomo).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.pmat import EXPM_S_MAX, pmat_expm, pmat_rev, pmat_tn93
from ..core.pmat import solve_small, tn93_alphas

NUC_MODELS = ["JC69", "K80", "F81", "F84", "HKY85", "T92", "TN93",
              "REV", "UNREST", "REVu", "UNRESTu"]

# number of rate parameters (excluding frequencies / branch lengths)
N_RATE_PARAMS = {"JC69": 0, "K80": 1, "F81": 0, "F84": 1, "HKY85": 1,
                 "T92": 1, "TN93": 2, "REV": 5, "UNREST": 11}

TN93_FAMILY = ("JC69", "K80", "F81", "F84", "HKY85", "T92", "TN93")


def model_pi(model: str, observed: np.ndarray) -> np.ndarray:
    """Equilibrium frequencies used by each model under nhomo = 0
    (reference: baseml GetInitials / InitializeBaseAA)."""
    if model in ("JC69", "K80"):
        return np.full(4, 0.25)
    if model == "T92":
        gc = observed[1] + observed[3]          # piC + piG
        return np.array([(1 - gc) / 2, gc / 2, (1 - gc) / 2, gc / 2])
    return np.asarray(observed, dtype=np.float64)


def normalize_Q(Qoff: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Set the diagonal and scale so that -sum_i pi_i Q_ii = 1."""
    Q = Qoff - torch.diag_embed(Qoff.sum(-1))
    mr = -(pi * torch.diagonal(Q, dim1=-2, dim2=-1)).sum(-1)
    return Q / mr[..., None, None]


def build_rev_Q(rates5: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """GTR/REV Q with s_AG = 1 fixed; the free exchangeabilities fill the
    pairs (T,C), (T,A), (T,G), (C,A), (C,G) in that order (reference:
    eigenQREVbase, src/treesub.c:2488).  rates5 [..., >= 5], pi [..., 4]."""
    a, b, c, d, e = (rates5[..., i] for i in range(5))
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    S = torch.stack([
        torch.stack([zero, a, b, c], dim=-1),
        torch.stack([a, zero, d, e], dim=-1),
        torch.stack([b, d, zero, one], dim=-1),
        torch.stack([c, e, one, zero], dim=-1),
    ], dim=-2)
    return normalize_Q(S * pi[..., None, :], pi)


def stationary_of(Q: torch.Tensor) -> torch.Tensor:
    """Stationary distribution: pi Q = 0 with sum(pi) = 1 (reference:
    QtoPi, src/tools.c), as a square solve with the last balance equation
    replaced by the normalization (differentiable at symmetric points,
    unlike a least-squares solve; a singular system reports its status,
    `pmat.solve_small`)."""
    n = Q.shape[-1]
    A = torch.cat([Q.T[:n - 1], Q.new_ones((1, n))])
    b = torch.cat([Q.new_zeros(n - 1), Q.new_ones(1)])
    return torch.clamp_min(solve_small(A, b, "stationary pi"), 1e-12)


def _scaled_by_stationary(Qoff: torch.Tensor):
    Q = Qoff - torch.diag(Qoff.sum(1))
    pi = stationary_of(Q)
    mr = -(pi * torch.diagonal(Q)).sum()
    return Q / mr, pi


def build_unrest_Q(rates11: torch.Tensor):
    """UNREST: 11 free off-diagonal rates in row-major order, the twelfth
    (G -> A under TCAG order, the last off-diagonal cell) fixed at 1
    (reference: QUNREST, src/treesub.c:2543); normalized with the
    stationary distribution of Q itself.  Returns (Q, pi)."""
    vals = torch.cat([rates11, rates11.new_ones(1)])
    # the 12 off-diagonal cells in row-major order (UNREST's parameter
    # order) as 3 rows of 4, a zero before each row and one at the end:
    # the 4 x 4 matrix with its zero diagonal
    Qoff = torch.cat([torch.nn.functional.pad(vals.reshape(3, 4), (1, 0))
                      .reshape(-1), vals.new_zeros(1)]).reshape(4, 4)
    return _scaled_by_stationary(Qoff)


def build_stepmatrix_Q(rates: torch.Tensor, pi: torch.Tensor,
                       step: np.ndarray, symmetric: bool):
    """REVu / UNRESTu user-constrained matrices: `step[i, j]` is the
    1-based free-rate index shared by cell (i, j), 0 the reference rate 1
    (reference: GetStepMatrix, src/baseml.c:912), numpy or an int64 tensor
    on the rates' device (an objective's, made once).  REVu returns Q,
    UNRESTu (Q, its stationary pi)."""
    vals = torch.cat([rates.new_ones(1), rates])
    S = vals[step if isinstance(step, torch.Tensor)
             else torch.as_tensor(np.asarray(step), device=vals.device)]
    S = S * (1.0 - torch.eye(4, dtype=S.dtype, device=S.device))
    if symmetric:
        return normalize_Q(S * pi[None, :], pi)
    return _scaled_by_stationary(S)


def pmats_for_model(model: str, rate_params: torch.Tensor, pi: torch.Tensor,
                    ts: torch.Tensor, step: np.ndarray | None = None,
                    twice: bool = False, s_max: int = EXPM_S_MAX):
    """P(t) for every branch and class length in ts (any shape):
    (P [*ts.shape, 4, 4], the root frequencies the model implies: pi,
    except UNREST and UNRESTu's stationary pi).  With `twice` the
    reversible models take the P(t) route that is differentiable twice;
    the closed forms and `pmat_expm` are so already.  `s_max`: the
    squarings `pmat_expm` runs (UNREST, UNRESTu)."""
    if model in TN93_FAMILY:
        a1, a2, b = tn93_alphas(model, pi, rate_params)
        return pmat_tn93(pi, a1, a2, b, ts), pi
    if model == "REV":
        Q = build_rev_Q(rate_params, pi)
        return pmat_rev(Q, pi, ts, twice), pi
    if model == "REVu":
        Q = build_stepmatrix_Q(rate_params, pi, step, symmetric=True)
        return pmat_rev(Q, pi, ts, twice), pi
    if model == "UNREST":
        Q, pi_s = build_unrest_Q(rate_params)
        return pmat_expm(Q, ts, s_max), pi_s
    if model == "UNRESTu":
        Q, pi_s = build_stepmatrix_Q(rate_params, pi, step, symmetric=False)
        return pmat_expm(Q, ts, s_max), pi_s
    raise ValueError(f"unknown model {model}")
