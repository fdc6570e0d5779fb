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
