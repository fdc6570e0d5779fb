"""Auto-discrete-gamma rate HMM over sites (baseml's AdG and nparK models).

Port of `paml_tpu/core/hmm.py`: the reference's `AutodGamma` transition
matrix (bivariate-normal bin probabilities, src/tools.c:2641) and the
`lfunAdG` forward recursion (src/treesub.c:7447), the only dependence
between sites in the likelihood.

Only the product of the sites' K x K matrices is needed, so `hmm_lnL`
takes it as a pairwise tree reduction over the sites: log2 L levels, each
one batched matrix product of every pair, normalized with its log scale
carried (the associative form of the JAX package, paml_tpu/core/hmm.py:
89-101), an odd matrix carried up a level.  A level is a handful of
launches whatever L is; a loop over the sites would be L of them.  The
operations are plain tensor operations, differentiable any number of
times; the scales are constants to autograd, as they cancel in the value.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .dgamma import discrete_gamma

_GL32 = np.polynomial.legendre.leggauss(32)


def binormal_cdf(h, k, r):
    """P(X <= h, Y <= k) for standard bivariate normals of correlation r
    (Drezner & Wesolowsky 1990, single-integral form), by fixed 32-point
    Gauss-Legendre quadrature; broadcasts over h, k and r."""
    h, k, r = (torch.as_tensor(v, dtype=torch.float64) for v in (h, k, r))
    x = torch.as_tensor(_GL32[0], dtype=torch.float64, device=r.device)
    w = torch.as_tensor(_GL32[1], dtype=torch.float64, device=r.device)
    h, k, r = h[..., None], k[..., None], r[..., None]
    t = r * (x + 1.0) / 2.0
    one_m_t2 = torch.clamp_min(1.0 - t * t, 1e-12)
    integrand = torch.exp(-(h * h + k * k - 2.0 * h * k * t)
                          / (2.0 * one_m_t2)) / torch.sqrt(one_m_t2)
    integral = (w * integrand).sum(-1) * (r[..., 0] / 2.0)
    return (torch.special.ndtr(h[..., 0]) * torch.special.ndtr(k[..., 0])
            + integral / (2.0 * math.pi))


def autod_gamma(alpha, rho, K: int):
    """(rates [K], freqs [K], M [K, K]) of the auto-discrete-gamma model
    (reference: AutodGamma, src/tools.c:2641): M[i, j] = P(class_t = j |
    class_t-1 = i), K times the binormal mass of bin (i, j)."""
    rho = torch.as_tensor(rho, dtype=torch.float64)
    dev = rho.device
    pts = torch.special.ndtri(
        torch.arange(1, K, dtype=torch.float64, device=dev) / K)
    edges = torch.cat([pts, pts.new_full((1,), 20.0)])
    Cij = binormal_cdf(edges[:, None], edges[None, :], rho)   # [K, K]
    Cpad = torch.nn.functional.pad(Cij, (1, 0, 1, 0))
    bin_mass = (Cpad[1:, 1:] - Cpad[:-1, 1:] - Cpad[1:, :-1]
                + Cpad[:-1, :-1])
    M = torch.clamp_min(bin_mass * K, 0.0)
    M = M / torch.clamp_min(M.sum(1, keepdim=True), 1e-300)
    r, w = discrete_gamma(alpha, K)
    return r, w, M


def _product(A: torch.Tensor, s: torch.Tensor):
    """A[L-1] ... A[1] A[0] of A [L, K, K] with log scales s [L] (each
    A[l] scaled by exp(-s[l])): (the normalized product, its log scale),
    by a pairwise tree reduction."""
    while A.shape[0] > 1:
        m = A.shape[0] // 2
        odd = A[2 * m:], s[2 * m:]
        Z = torch.matmul(A[1:2 * m:2], A[0:2 * m:2])       # later on the left
        z = torch.clamp_min(Z.detach().amax((-2, -1)), 1e-300)
        A = torch.cat([Z / z[:, None, None], odd[0]])
        s = torch.cat([s[0:2 * m:2] + s[1:2 * m:2] + torch.log(z), odd[1]])
    return A[0], s[0]


def hmm_lnL(lnf_sites: torch.Tensor, M: torch.Tensor,
            freqK: torch.Tensor) -> torch.Tensor:
    """Total log-likelihood of the rate HMM.

    lnf_sites: [K, L] per-class log-likelihoods of the sites, in the
    alignment's site order.  Forward recursion b_l = (M b_l-1) * f_l with
    b_1 = f_1 and lnL = log(freqK . b_L) (reference lfunAdG semantics),
    here as the product of the site matrices A_l = diag(f_l) M."""
    K, L = lnf_sites.shape
    mx = lnf_sites.detach().amax(0)                        # [L]
    f = torch.exp(lnf_sites - mx[None, :])                 # [K, L]
    base = mx.sum()
    b0 = f[:, 0]
    if L == 1:
        return base + torch.log(torch.clamp_min(freqK @ b0, 1e-300))
    A = f.T[1:, :, None] * M[None, :, :]                   # [L-1, K, K]
    s0 = torch.clamp_min(A.detach().amax((1, 2)), 1e-300)
    Afin, sfin = _product(A / s0[:, None, None], torch.log(s0))
    return (base + sfin
            + torch.log(torch.clamp_min(freqK @ (Afin @ b0), 1e-300)))
