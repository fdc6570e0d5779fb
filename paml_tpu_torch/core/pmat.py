"""Transition-probability matrices P(t) = expm(Q t) for reversible Q.

Port of `paml_tpu/core/pmat.py`.  In float64, one batched symmetric
eigendecomposition per rate matrix, then every branch's P(t) from the
eigenbasis (reference: `PMatUVRoot`, src/tools.c:516, after
`eigenQREV`, src/tools.c:5023); on the card by `cuda_eigh`'s Jacobi
kernel, which makes no host read, so that an evaluation can be captured
in a CUDA graph, on the CPU by `torch.linalg.eigh`.

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

In float32, `pmat_rev` and `pmat_rev_multi` take the JAX package's
uniformization series with per-branch masked squaring (`_pmat_rev_unif`,
paml_tpu/core/pmat.py:89-268): no eigendecomposition, every product in
full float32 whatever the caller's TF32 setting (`_mm`), and the gradient
by plain autograd through the chain of products.  Float64 stays spectral.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch

from . import cuda_eigh, graphs

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


def symmetrize(Q: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """S = D^{1/2} Q D^{-1/2}, symmetric for reversible Q."""
    return _sym_parts(Q, pi)[0]


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


def spectral_P(lam, U, sqp, ts):
    """(mu = ts lam [..., G, k], P [..., G, n, n] before the clip at 0)
    from the eigenpairs lam [G, k], U [G, n, k] of S = D^{1/2} Q D^{-1/2}
    and sqp = pi^{1/2} [G, n]."""
    L = U / sqp[..., :, None]                               # [G, n, k]
    R = U.transpose(-1, -2) * sqp[..., None, :]             # [G, k, n]
    mu = ts[..., None] * lam                                # [..., G, k]
    e = torch.exp(mu)
    return mu, torch.matmul(L * e[..., None, :], R)         # [..., G, n, n]


class _PmatRevSpectral(torch.autograd.Function):
    """P [..., G, n, n] from Qs [G, n, n], pi [G, n], ts [..., G]; on the
    card the eigenpairs come from `cuda_eigh`'s kernel, which reads nothing
    on the host (its status word goes to the caller's `status_sink`)."""

    @staticmethod
    def forward(ctx, Qs, pi, ts):
        S, sqp, mask = _sym_parts(Qs, pi)
        lam, U = cuda_eigh.eigh(S)                          # [G,k], [G,n,k]
        mu, P = spectral_P(lam, U, sqp, ts)
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


# ---------------------------------------------------------------------------
# float32: uniformization with masked squaring (no eigendecomposition)
# ---------------------------------------------------------------------------
# The JAX package's design (paml_tpu/core/pmat.py:89-126): in float32 the
# spectral reconstruction carries ~2e-6 absolute noise, a large relative
# error in a short branch's small entries, where site likelihoods divide
# by them.  The series
#   P(t) = e^{-a} sum_k a^k / k! M^k,   M = I + Q / q,   a = q t,
# q = max_i -Q_ii, has no negative term, so each entry keeps ~n K eps
# relative accuracy.  A branch with a > AMAX sums the series at a / 2^s
# and squares the result s times.

_UNIF_K = 24          # series terms: Poisson tail P(X > 24 | a0 = 5) ~ 3e-10
_UNIF_AMAX = 5.0      # series radius; above it, scale down and square
_UNIF_NSQ = 6         # at most this many squarings (a0 <= AMAX to q t = 320)


@contextlib.contextmanager
def _full_float32():
    """cuBLAS products in full float32 inside the block, TF32 off whatever
    the caller set (the JAX package's `_PREC` HIGH, f32-faithful)."""
    m = torch.backends.cuda.matmul
    if not m.allow_tf32:
        yield
        return
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = True


class _MatmulF32(torch.autograd.Function):
    """torch.bmm(a, b), forward and backward in full float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _full_float32():
            return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _full_float32():
            if ctx.needs_input_grad[0]:
                ga = torch.bmm(g, b.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                gb = torch.bmm(a.transpose(-1, -2), g)
        return ga, gb


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched product of 3-D a and b in full float32: with TF32
    allowed when the product is formed, through `_MatmulF32`, which turns
    it off for the forward and the backward; otherwise PyTorch's own
    `bmm` (no Python, and one autograd node, in its backward)."""
    if torch.backends.cuda.matmul.allow_tf32:
        return _MatmulF32.apply(a, b)
    return torch.bmm(a, b)


def _mat_powers(M: torch.Tensor, K: int) -> torch.Tensor:
    """[M^0 .. M^K] of M [G, n, n] stacked on axis -3: the sequential
    chain of K - 1 products (the JAX package's default,
    `PAML_TPU_POWS=seq`)."""
    pows = [torch.eye(M.shape[-1], dtype=M.dtype,
                      device=M.device).expand_as(M), M]
    for _ in range(2, K + 1):
        pows.append(_mm(pows[-1], M))
    return torch.stack(pows, dim=-3)


class _PoissonWeights(torch.autograd.Function):
    """w_k = e^-a a^k / k!, k = 0 .. _UNIF_K, on a new last axis: the JAX
    package's recurrence w_k = w_{k-1} a / k as one running product (the
    log form has a 0 log 0 NaN in its derivative at a = 0), and the
    derivative dw_k / da = w_{k-1} - w_k (w_{-1} = 0), finite everywhere.
    (Autograd of the running product would read back whether any a is 0:
    a host sync per backward.)"""

    @staticmethod
    def forward(ctx, a):
        k = torch.arange(1, _UNIF_K + 1, dtype=a.dtype, device=a.device)
        w = torch.cumprod(torch.cat([torch.exp(-a)[..., None],
                                     a[..., None] / k], -1), -1)
        ctx.save_for_backward(w)
        return w

    @staticmethod
    @differentiable_once
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dw = torch.cat([-w[..., :1], w[..., :-1] - w[..., 1:]], -1)
        return (g * dw).sum(-1)


def _square_masked(P: torch.Tensor, s_b: torch.Tensor) -> torch.Tensor:
    """P [..., n, n] squared s_b [...] times, at most _UNIF_NSQ.  All
    _UNIF_NSQ squarings run on every branch, each kept where s_b asks for
    it: the JAX package gates them behind one `lax.cond` on any(s_b > 0),
    which here would cost a host sync per call; `where` selects, so the
    values are the same."""
    shape = P.shape
    P, s_b = P.reshape((-1,) + shape[-2:]), s_b.reshape(-1, 1, 1)
    for i in range(_UNIF_NSQ):
        P = torch.where(s_b > i, _mm(P, P), P)
    return P.reshape(shape)


def _pmat_rev_unif(Qs: torch.Tensor, pi: torch.Tensor,
                   ts: torch.Tensor) -> torch.Tensor:
    """Float32 P(t) by uniformization and per-branch masked squaring: Qs
    [G, n, n], pi [G, n], ts [..., G] -> P [..., G, n, n].  States with pi
    at or below PI_FLOOR get zeroed Q rows and columns, hence identity
    rows in P (the reference's reduced Q, eigenQREV src/tools.c:5023),
    here set exactly."""
    G, n = Qs.shape[0], Qs.shape[-1]
    mask = pi > PI_FLOOR
    Qm = torch.where(mask[:, :, None] & mask[:, None, :], Qs,
                     torch.zeros_like(Qs))
    q = torch.clamp_min((-torch.diagonal(Qm, dim1=-2, dim2=-1)).amax(-1),
                        1e-30)                                   # [G]
    M = torch.eye(n, dtype=Qs.dtype, device=Qs.device) + Qm / q[:, None, None]
    Mk = _mat_powers(M, _UNIF_K)                                 # [G, K+1, n, n]
    a = q * ts                                                   # [..., G]
    # squarings s = ceil(log2(a / AMAX)), clamped to [0, NSQ]; above
    # AMAX 2^NSQ the scaled a0 saturates at 2 AMAX, where P is at its
    # stationary rows to the series' accuracy
    s_b = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(
        a / _UNIF_AMAX, 1.0))), max=float(_UNIF_NSQ))
    a0 = torch.clamp(a / torch.exp2(s_b), max=2.0 * _UNIF_AMAX)
    w = _PoissonWeights.apply(a0)                                # [..., G, K+1]

    batch = w.shape[:-2]
    wg = w.reshape(-1, G, _UNIF_K + 1).transpose(0, 1)           # [G, B, K+1]
    P = _mm(wg, Mk.reshape(G, _UNIF_K + 1, n * n))               # [G, B, n*n]
    P = P.transpose(0, 1).reshape(batch + (G, n, n))
    # a dropped state's row is e_i times the weights' sum, 1 to within a
    # rounding that s squarings would multiply by 2^s: make it exact
    eye = torch.eye(n, dtype=Qs.dtype, device=Qs.device)
    P = torch.where(mask[:, :, None], P, eye)
    return _square_masked(P, s_b)


def pmat_rev_multi(Qs: torch.Tensor, pi: torch.Tensor,
                   ts: torch.Tensor) -> torch.Tensor:
    """P(t) for G reversible rate matrices at once: Qs [G, n, n], pi [n] or
    [G, n], ts [..., G] -> P [..., G, n, n]; float64 by the spectral form,
    float32 by uniformization (`_pmat_rev_unif`)."""
    if pi.dim() == 1:
        pi = pi.expand(Qs.shape[0], -1)
    if Qs.dtype == torch.float32:
        return _pmat_rev_unif(Qs, pi, ts)
    if Qs.dtype != torch.float64:
        raise TypeError(f"P(t) takes float32 or float64, got {Qs.dtype}")
    return _PmatRevSpectral.apply(Qs, pi, ts)


def pmat_rev_multi_twice(Qs: torch.Tensor, pi: torch.Tensor,
                         ts: torch.Tensor) -> torch.Tensor:
    """`pmat_rev_multi` for second derivatives: P [..., G, n, n] =
    expm(Qs[g] ts[..., g]) by `torch.linalg.matrix_exp`, differentiable any
    number of times in Qs and ts, computed in float64 and returned in Qs's
    dtype (a float32 objective's Hessian keeps float64 P(t) and its
    derivatives).  pi enters through Qs alone here.  A state of zero
    frequency keeps its row of Q instead of the reduced matrix's identity
    row; no other state reaches it and the root gives it no weight, so the
    likelihood is the same."""
    del pi
    P = torch.linalg.matrix_exp(Qs.double() * ts.double()[..., None, None])
    return torch.clamp_min(P, 0.0).to(Qs.dtype)


def pmat_rev(Q: torch.Tensor, pi: torch.Tensor, t: torch.Tensor,
             twice: bool = False) -> torch.Tensor:
    """P(t) for one reversible rate matrix: Q [n, n] reversible w.r.t. pi
    [n], t of any shape -> [..., n, n] (`pmat_rev_multi` at G = 1, or with
    `twice` its route that is differentiable twice)."""
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
# non-reversible Q (UNREST, UNRESTu): expm and a small dense solve
# ---------------------------------------------------------------------------
#
# `torch.linalg.matrix_exp` picks its Pade degree and squarings on the host
# and `torch.linalg.solve` checks its result there, so neither can be
# recorded in a CUDA graph.  Both are written here as fixed sequences of
# tensor operations whose failures go to a status word
# (`graphs.report_status`): Gaussian elimination with partial pivoting in
# n fixed steps, and scaling and squaring with the [13/13] Pade
# approximant (Higham 2005, the degree `jax.scipy.linalg.expm` takes
# behind paml_tpu/core/pmat.py:402-409 at these norms) whose squaring
# count s comes from |Q t|_1 on the device, the squarings run S_MAX times
# and kept where s asks for them (as `_square_masked`).

SINGULAR, NOCONV = 3, 2     # status words: a zero pivot; s above S_MAX

_PADE13 = (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
           1187353796428800.0, 129060195264000.0, 10559470521600.0,
           670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
           960960.0, 16380.0, 182.0, 1.0)
_THETA13 = 5.371920351148152    # the largest |A|_1 the approximant takes
EXPM_S_MAX = 16                 # jax.scipy.linalg.expm's max_squarings


def solve_small(A: torch.Tensor, B: torch.Tensor,
                what: str = "solve") -> torch.Tensor:
    """X with A X = B for small A [..., n, n] and B [..., n] or [..., n, m],
    by Gaussian elimination with partial pivoting in n fixed steps of
    tensor operations, differentiable any number of times: no host read.
    A zero or non-finite pivot (a singular system) reports SINGULAR
    (`graphs.report_status`, under `what`); the result is then not
    finite."""
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B[..., None]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A, B = A.expand(batch + A.shape[-2:]), B.expand(batch + B.shape[-2:])
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    bad = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    for k in range(n):
        p = A[..., k:, k].abs().argmax(-1, keepdim=True) + k     # [..., 1]
        perm = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        A = A.gather(-2, perm[..., None].expand(A.shape))
        B = B.gather(-2, perm[..., None].expand(B.shape))
        piv = A[..., k, k]
        bad = bad | (piv == 0) | ~torch.isfinite(piv)
        if k + 1 < n:
            lk = A[..., k + 1:, k:k + 1] / piv[..., None, None]
            A = torch.cat([A[..., :k + 1, :],
                           A[..., k + 1:, :] - lk * A[..., k:k + 1, :]], -2)
            B = torch.cat([B[..., :k + 1, :],
                           B[..., k + 1:, :] - lk * B[..., k:k + 1, :]], -2)
    graphs.report_status(torch.where(bad, SINGULAR, 0).to(torch.int32), what)
    X = [None] * n
    for i in reversed(range(n)):
        r = B[..., i, :]
        for j in range(i + 1, n):
            r = r - A[..., i, j, None] * X[j]
        X[i] = r / A[..., i, i, None]
    X = torch.stack(X, -2)
    return X[..., 0] if vec else X


def expm_squarings(norm_max: float) -> int:
    """S_MAX for matrices A with |A|_1 <= norm_max: the squarings the
    scaling takes at that norm (at least 1)."""
    return max(1, math.ceil(math.log2(max(norm_max, 1.0) / _THETA13)))


def expm(A: torch.Tensor, s_max: int = EXPM_S_MAX) -> torch.Tensor:
    """expm(A) of A [..., n, n] by scaling and squaring with the [13/13]
    Pade approximant: s = max(0, ceil(log2(|A|_1 / theta13))) from each
    matrix's own norm on the device, A / 2^s, then s_max squarings each
    kept where s asks for it.  An s above s_max reports NOCONV
    (`graphs.report_status`): the matrix is not squared enough.  No host
    read; differentiable any number of times."""
    shape = A.shape
    A = A.reshape((-1,) + shape[-2:])
    norm = A.detach().abs().sum(-2).amax(-1)
    s = torch.clamp_min(torch.ceil(torch.log2(norm / _THETA13)), 0.0)
    graphs.report_status(torch.where(s > s_max, NOCONV, 0).to(torch.int32),
                         "expm: squarings past S_MAX")
    A = A * torch.exp2(-s)[:, None, None]
    b = _PADE13
    eye = torch.eye(shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
             + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    R = solve_small(V - U, V + U, "expm: Pade denominator")
    s = s[:, None, None]
    for i in range(s_max):
        R = torch.where(s > i, R @ R, R)
    return R.reshape(shape)


def pmat_expm(Q: torch.Tensor, t: torch.Tensor,
              s_max: int = EXPM_S_MAX) -> torch.Tensor:
    """P(t) = expm(Q t) for a general (non-reversible) Q [n, n], batched
    over t of any shape -> [..., n, n] (reference: QUNREST + matexp,
    src/treesub.c:2543, src/tools.c:4879), by `expm` with s_max masked
    squarings; differentiable any number of times."""
    return expm(Q * t[..., None, None], s_max)
