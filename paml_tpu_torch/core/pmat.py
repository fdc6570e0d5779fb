"""Transition-probability matrices P(t) = expm(Q t) for reversible Q.

Port of the float64 spectral path of `paml_tpu/core/pmat.py`: one batched
symmetric eigendecomposition per rate matrix, then every branch's P(t) from
the eigenbasis (reference: `PMatUVRoot`, src/tools.c:516, after
`eigenQREV`, src/tools.c:5023).

The gradient is the Daleckii-Krein (divided-difference) derivative of the
matrix exponential in the eigenbasis, written as the backward of a
`torch.autograd.Function` (the VJP of `_pmat_rev_jvp`, pmat.py:271-314).
`torch.linalg.eigh`'s own backward divides by eigenvalue gaps and returns
NaN on degenerate spectra (the Fequal codon Q at kappa = omega = 1 has
them); the divided differences stay exact there.

That backward takes the saved eigenpairs as constants, so it is marked
`differentiable_once`: a backward with `create_graph=True` through it
raises.  Hessians
(`codeml.standard_errors`) take `pmat_rev_multi_twice`, the same P(t) from
`torch.linalg.matrix_exp`, whose derivative is itself built from
differentiable operations.

The nucleotide models add the closed-form TN93 family (`pmat_tn93`, from
`paml_tpu/core/pmat.py:321-400`), `pmat_rev` for one reversible Q (REV,
REVu) and `pmat_expm` for the non-reversible UNREST and UNRESTu, all
differentiable twice but `pmat_rev` on the fit's route.

The float32 uniformization path of the JAX package is not ported yet
(ROADMAP A1): a float32 call raises.
"""
from __future__ import annotations

import functools

import torch

PI_FLOOR = 1e-100   # states with pi below this are dropped (reference:
                    # eigenQREV reduced computation, src/tools.c:5023)


def differentiable_once(backward):
    """Mark a hand-written backward that takes saved intermediates as
    constants: run under `create_graph=True` it raises, where a second
    derivative through it would be silently wrong.  (PyTorch's own
    `once_differentiable` raises only when the second backward reaches its
    error node, and `torch.autograd.grad` with named inputs prunes that
    node away.)"""
    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"{backward.__qualname__} is differentiable once: a "
                "backward with create_graph=True cannot pass through it "
                "(second derivatives: the objective's `twice` route)")
        return backward(ctx, *grads)
    return wrapper


def _sym_parts(Q: torch.Tensor, pi: torch.Tensor):
    """(S, sqp, mask): symmetrized Q restricted to pi > PI_FLOOR states.

    Zero-frequency states get zero S rows/cols and sqp 1, which yields
    identity rows in P (the reference's reduced-matrix semantics)."""
    mask = pi > PI_FLOOR
    sqp = torch.sqrt(torch.where(mask, pi, torch.ones_like(pi)))
    mm = mask[..., :, None] & mask[..., None, :]
    S = torch.where(mm, Q * sqp[..., :, None] / sqp[..., None, :],
                    torch.zeros_like(Q))
    S = 0.5 * (S + S.transpose(-1, -2))
    return S, sqp, mask


def _phi(mu_k: torch.Tensor, mu_l: torch.Tensor) -> torch.Tensor:
    """Divided difference (e^{mu_k} - e^{mu_l}) / (mu_k - mu_l) with the
    e^{mu} limit at coincident values.  Near-coincident arguments use the
    expm1 form (no cancellation); far-apart arguments use the direct
    difference (no 0 * inf when exp(mu_l) underflows)."""
    d = mu_k - mu_l
    one = torch.ones_like(d)
    near = d.abs() < 0.5
    d_near = torch.where(near, torch.where(d.abs() < 1e-300,
                                           torch.zeros_like(d), d), one)
    ratio = torch.where(d_near.abs() < 1e-8, 1.0 + 0.5 * d_near,
                        torch.expm1(d_near)
                        / torch.where(d_near == 0, one, d_near))
    phi_near = torch.exp(mu_l) * ratio
    d_far = torch.where(near, one, d)
    phi_far = (torch.exp(mu_k) - torch.exp(mu_l)) / d_far
    return torch.where(near, phi_near, phi_far)


class _PmatRevSpectral(torch.autograd.Function):
    """P [..., G, n, n] from Qs [G, n, n], pi [G, n], ts [..., G]."""

    @staticmethod
    def forward(ctx, Qs, pi, ts):
        S, sqp, mask = _sym_parts(Qs, pi)
        lam, U = torch.linalg.eigh(S)                      # [G,k], [G,n,k]
        L = U / sqp[..., :, None]                           # [G, n, k]
        R = U.transpose(-1, -2) * sqp[..., None, :]         # [G, k, n]
        mu = ts[..., None] * lam                            # [..., G, k]
        e = torch.exp(mu)
        P = torch.matmul(L * e[..., None, :], R)            # [..., G, n, n]
        ctx.save_for_backward(Qs, pi, ts, sqp, mask, lam, U, mu, P)
        return torch.clamp_min(P, 0.0)

    @staticmethod
    @differentiable_once
    def backward(ctx, gP):
        Qs, pi, ts, sqp, mask, lam, U, mu, P = ctx.saved_tensors
        batch = tuple(range(ts.dim() - 1))                  # dims before G
        L = U / sqp[..., :, None]
        R = U.transpose(-1, -2) * sqp[..., None, :]
        # the primal's max(P, 0) clip masks the cotangent
        W = torch.where(P > 0, gP, torch.zeros_like(gP))
        # dP_core = L (dM_eig * Phi) R  with  dM_eig = t G + dt diag(lam)
        gE = torch.matmul(torch.matmul(L.transpose(-1, -2), W),
                          R.transpose(-1, -2))
        gM = gE * _phi(mu[..., :, None], mu[..., None, :])
        gts = (torch.diagonal(gM, dim1=-2, dim2=-1) * lam).sum(-1)
        gG = ts[..., None, None] * gM
        if batch:
            gG = gG.sum(batch)
        # G = U^T dS U  and  dS = sym(mm * (...))
        gS = torch.matmul(torch.matmul(U, gG), U.transpose(-1, -2))
        gS = 0.5 * (gS + gS.transpose(-1, -2))
        mm = mask[..., :, None] & mask[..., None, :]
        gS = torch.where(mm, gS, torch.zeros_like(gS))
        gQ = gS * sqp[..., :, None] / sqp[..., None, :]
        gpi = None
        if ctx.needs_input_grad[1]:
            # dS terms in dsqp: Q dsqp_i / sqp_j - Q sqp_i dsqp_j / sqp_j^2
            gsqp = ((gS * Qs / sqp[..., None, :]).sum(-1)
                    - (gS * Qs * sqp[..., :, None]).sum(-2) / sqp ** 2)
            # dP_pi = (dinvsqp_i sqp_j + dsqp_j / sqp_i) Ep_ij with
            # Ep = U e U^T and dinvsqp = -dsqp / pi
            Ep = torch.matmul(U * torch.exp(mu)[..., None, :],
                              U.transpose(-1, -2))
            V = W * Ep
            if batch:
                V = V.sum(batch)
            g_inv = (V * sqp[..., None, :]).sum(-1)
            gsqp = gsqp + (V / sqp[..., :, None]).sum(-2)
            pi_safe = torch.where(mask, pi, torch.ones_like(pi))
            gsqp = gsqp - g_inv / pi_safe
            gpi = torch.where(mask, gsqp / (2.0 * sqp), torch.zeros_like(pi))
        return gQ, gpi, gts


def pmat_rev_multi(Qs: torch.Tensor, pi: torch.Tensor,
                   ts: torch.Tensor) -> torch.Tensor:
    """P(t) for G reversible rate matrices at once: Qs [G, n, n], pi [n] or
    [G, n], ts [..., G] -> P [..., G, n, n] (float64)."""
    if Qs.dtype != torch.float64:
        raise NotImplementedError(
            f"P(t) in {Qs.dtype}: only the float64 spectral path is ported "
            "(float32 uniformization: ROADMAP A1)")
    if pi.dim() == 1:
        pi = pi.expand(Qs.shape[0], -1)
    return _PmatRevSpectral.apply(Qs, pi, ts)


def pmat_rev_multi_twice(Qs: torch.Tensor, pi: torch.Tensor,
                         ts: torch.Tensor) -> torch.Tensor:
    """`pmat_rev_multi` for second derivatives: P [..., G, n, n] =
    expm(Qs[g] ts[..., g]) by `torch.linalg.matrix_exp`, differentiable any
    number of times in Qs and ts.  pi enters through Qs alone here.  A
    state of zero frequency keeps its row of Q instead of the reduced
    matrix's identity row; no other state reaches it and the root gives it
    no weight, so the likelihood is the same."""
    del pi
    return torch.clamp_min(
        torch.linalg.matrix_exp(Qs * ts[..., None, None]), 0.0)


def pmat_rev(Q: torch.Tensor, pi: torch.Tensor, t: torch.Tensor,
             twice: bool = False) -> torch.Tensor:
    """P(t) for one reversible rate matrix: Q [n, n] reversible w.r.t. pi
    [n], t of any shape -> [..., n, n] (float64; `pmat_rev_multi` at G = 1,
    or with `twice` its route that is differentiable twice)."""
    fn = pmat_rev_multi_twice if twice else pmat_rev_multi
    return fn(Q[None], pi[None], t[..., None])[..., 0, :, :]


# ---------------------------------------------------------------------------
# closed-form TN93 family (JC69, K80, F81, F84, HKY85, T92, TN93)
# ---------------------------------------------------------------------------
# Plain tensor expressions: autograd differentiates them any number of
# times.  pi may carry leading batch dimensions (one set per branch under
# nhomo) that broadcast against t's.


def tn93_rates(pi, a1, a2, b):
    """Normalize (alpha1, alpha2, beta) so that the mean rate is 1."""
    pT, pC, pA, pG = pi[..., 0], pi[..., 1], pi[..., 2], pi[..., 3]
    pY, pR = pT + pC, pA + pG
    mr = 2.0 * (pT * pC * a1 + pA * pG * a2 + pY * pR * b)
    return a1 / mr, a2 / mr, b / mr


def pmat_tn93(pi, a1, a2, b, t: torch.Tensor,
              normalize: bool = True) -> torch.Tensor:
    """Closed-form TN93 transition matrix, batched over t: [..., 4, 4],
    states in T, C, A, G order; alpha1 the T<->C rate, alpha2 the A<->G
    rate, beta the transversion rate, before the normalization
    (reference: src/tools.c:566-666)."""
    pT, pC, pA, pG = pi[..., 0], pi[..., 1], pi[..., 2], pi[..., 3]
    pY, pR = pT + pC, pA + pG
    if normalize:
        a1, a2, b = tn93_rates(pi, a1, a2, b)
    e2 = torch.exp(-b * t)
    e3 = torch.exp(-(pY * a1 + pR * b) * t)
    e4 = torch.exp(-(pR * a2 + pY * b) * t)
    one = torch.ones_like(e2)
    TT = pT * one + pT * pR / pY * e2 + pC / pY * e3
    TC = pC * one + pC * pR / pY * e2 - pC / pY * e3
    TA = pA * (one - e2)
    TG = pG * (one - e2)
    CT = pT * one + pT * pR / pY * e2 - pT / pY * e3
    CC = pC * one + pC * pR / pY * e2 + pT / pY * e3
    AA = pA * one + pA * pY / pR * e2 + pG / pR * e4
    AG = pG * one + pG * pY / pR * e2 - pG / pR * e4
    AT = pT * (one - e2)
    AC = pC * (one - e2)
    GA = pA * one + pA * pY / pR * e2 - pA / pR * e4
    GG = pG * one + pG * pY / pR * e2 + pA / pR * e4
    return torch.stack([
        torch.stack([TT, TC, TA, TG], dim=-1),
        torch.stack([CT, CC, TA, TG], dim=-1),
        torch.stack([AT, AC, AA, AG], dim=-1),
        torch.stack([AT, AC, GA, GG], dim=-1),
    ], dim=-2)


def tn93_alphas(model: str, pi, kappa):
    """A named model and the reference's kappa convention as TN93's
    (alpha1, alpha2, beta) with beta = 1 before the normalization
    (reference: src/tools.c:566-666 and baseml SetParameters): JC69 and
    F81 equal rates; K80, HKY85 and T92 kappa = alpha / beta; F84 alpha1 =
    1 + kappa / piY, alpha2 = 1 + kappa / piR; TN93 kappa = (kappa1,
    kappa2), a single kappa standing for both (the JAX package's clamped
    index reads kappa[0] twice).  kappa is a tensor whose last axis holds
    the rates."""
    pY = pi[..., 0] + pi[..., 1]
    pR = pi[..., 2] + pi[..., 3]
    one = torch.ones_like(pY)
    if model in ("JC69", "F81"):
        return one, one, one
    if model in ("K80", "HKY85", "T92"):
        return kappa[..., 0], kappa[..., 0], one
    if model == "F84":
        k = kappa[..., 0]
        return 1.0 + k / pY, 1.0 + k / pR, one
    if model == "TN93":
        return kappa[..., 0], kappa[..., min(1, kappa.shape[-1] - 1)], one
    raise ValueError(f"not a TN93-family model: {model}")


# ---------------------------------------------------------------------------
# non-reversible Q (UNREST, UNRESTu)
# ---------------------------------------------------------------------------


def pmat_expm(Q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P(t) = expm(Q t) for a general (non-reversible) Q [n, n], batched
    over t of any shape -> [..., n, n] (reference: QUNREST + matexp,
    src/treesub.c:2543, src/tools.c:4879).  One `torch.linalg.matrix_exp`
    over the whole batch, differentiable any number of times."""
    return torch.linalg.matrix_exp(Q * t[..., None, None])
