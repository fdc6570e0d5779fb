"""The symmetric eigensolver of float64 P(t) on the card, safe to capture.

`pmat`'s spectral P(t) (float64) diagonalizes the symmetrized rate
matrices S = D^{1/2} Q D^{-1/2} of every call.  The JAX package leaves that
to XLA's `jnp.linalg.eigh` (paml_tpu/core/pmat.py:82-90).  On the card
`torch.linalg.eigh` reads cuSOLVER's info on the host after each call, so
an evaluation that uses it cannot be recorded in a CUDA graph.  `eigh`
here sends a CUDA tensor to the hand-written Jacobi kernel of
`csrc/eigh.cu` instead: one block per matrix (order at most 64; S must be
symmetric, the kernel reads its upper triangle), and its failure state (a
non-finite entry, no convergence within MAX_SWEEPS sweeps) goes to a
status word on the card, which `graphs.report_status` hands to the
caller's `status_sink` or reads at once and raises on.  A CPU tensor
takes `torch.linalg.eigh` (the plain version, and the path of the tests).

`jacobi_plain` is the kernel's arithmetic as tensor operations, in its
order of rotations and rounding: on the card the kernel gives its bits
(chip_smoke.py 15a holds them equal at orders of each of the kernel's
instances).  The kernel is bound by the latency of its rounds, not by its
operations: one warp computes the next round's rotations while the others
apply the current one to A and V, behind one barrier a round
(`csrc/eigh.cu`'s header).  Each launch adds one to `LAUNCHES["eigh"]`;
`eigh_probe` is a debug entry that splits a round's time and is on no
path of the package.

Eigenvalues come out ascending, eigenvectors as U's columns.  Within a
cluster of equal eigenvalues the vectors are another basis than LAPACK's
or cuSOLVER's; P(t) and its derivative do not depend on the choice.
"""
from __future__ import annotations

import numpy as np
import torch

from . import graphs

LAUNCHES = {"eigh": 0}
NMAX = 64            # largest order the kernel takes
MAX_SWEEPS = 30      # sweeps before the kernel reports no convergence
# status words: 0 converged, 1 a non-finite entry, 2 no convergence


def eigh(S: torch.Tensor):
    """(eigenvalues [..., n] ascending, eigenvectors [..., n, n] as
    columns) of the symmetric float64 matrices S [..., n, n]: on the card
    the Jacobi kernel, its status reported to `graphs.report_status`; on
    the CPU `torch.linalg.eigh`."""
    if S.device.type == "cpu":
        return torch.linalg.eigh(S)
    lam, U, info = eigh_kernel(S)
    graphs.report_status(info[..., 0], "cuda_eigh")
    return lam, U


def eigh_kernel(S: torch.Tensor):
    """The kernel's launch: (lam [..., n], U [..., n, n], info [..., 2]
    int32: the status word and the sweeps taken per matrix).  S: a CUDA
    float64 tensor of symmetric matrices of order n <= NMAX."""
    return _launch(S, None)


# eigh_probe's flags: skip V's update, A's update, the rotations' chain;
# stamp each warp's clock (two stamps per warp, at most 17, and round)
SKIP_V, SKIP_A, SKIP_CHAIN, STAMPS = 1, 2, 4, 8
STAMP_WORDS = 17 * 64 * 2


def eigh_probe(S: torch.Tensor, flags: int = 0, sweeps: int = 0):
    """The kernel's debug instance (its npad 62 instance, or the generic
    one at other orders), for timing the parts of a round: as
    `eigh_kernel`, with the parts named in `flags` skipped (the results
    are then not the eigenpairs, but for SKIP_V's eigenvalues) and, with
    sweeps > 0, exactly that many sweeps run; with STAMPS, U's storage
    holds the clock stamps `round_stamps` reads.  Not counted in LAUNCHES
    and on no path of the package."""
    return _launch(S, (int(flags), int(sweeps)))


def round_stamps(S: torch.Tensor, sweeps: int, flags: int = 0) -> dict:
    """Clock cycles of the debug instance's rounds at S (the parts in
    `flags` skipped), from lane 0 of each warp of block 0 over the first
    sweep: {"round": the mean cycles from one round's start to the next
    (warp 0), "warps": {"w<i>": (mean cycles of its part of a round, mean
    cycles then waiting for the round's barrier)}}."""
    n = S.shape[-1]
    mc = n + (n & 1) - 1
    U = eigh_probe(S, STAMPS | flags, sweeps)[1]
    st = torch.as_strided(U, (STAMP_WORDS,), (1,)).view(torch.int64)
    st = st.reshape(-1, 64, 2).cpu().numpy().astype(np.float64)[:, :mc]
    warps = {}
    for w in range(st.shape[0]):
        if st[w, 0, 0] == 0:
            break
        a, b = st[w, :, 0], st[w, :, 1]
        warps[f"w{w}"] = (float(np.mean(b - a)),
                          float(np.mean(a[1:] - b[:-1])))
    return {"round": float(np.mean(np.diff(st[0, :, 0]))), "warps": warps}


def _launch(S: torch.Tensor, probe):
    from .. import _build

    if not S.is_cuda:
        raise ValueError(f"the eigh kernel takes CUDA tensors, got {S.device}")
    if S.dtype != torch.float64:
        raise TypeError(f"the eigh kernel takes float64, got {S.dtype}")
    n = S.shape[-1]
    if S.dim() < 2 or S.shape[-2] != n or not 1 <= n <= NMAX:
        raise ValueError(f"the eigh kernel takes [..., n, n] with n <= "
                         f"{NMAX}, got {tuple(S.shape)}")
    batch = S.shape[:-2]
    Sc = S.reshape(-1, n, n).contiguous()
    G = Sc.shape[0]
    lam = S.new_empty((G, n))
    if probe is None:
        U = S.new_empty((G, n, n))
    else:        # zeros, with room for the stamps of every warp
        U = S.new_zeros(max(G * n * n, STAMP_WORDS))[:G * n * n].view(G, n, n)
    info = torch.empty((G, 2), dtype=torch.int32, device=S.device)
    if G:
        args = (Sc.data_ptr(), lam.data_ptr(), U.data_ptr(), info.data_ptr(),
                G, n)
        with torch.cuda.device(S.device):
            stream = torch.cuda.current_stream(S.device).cuda_stream
            if probe is None:
                err = _build.lib().paml_eigh_f64(*args, stream)
                LAUNCHES["eigh"] += 1
            else:
                err = _build.lib().paml_eigh_probe_f64(*args, *probe, stream)
        _build.check(err, "eigh launch")
    return (lam.reshape(batch + (n,)), U.reshape(batch + (n, n)),
            info.reshape(batch + (2,)))


def _round_pairs(npad: int) -> list[tuple[list[int], list[int]]]:
    """Each round's index pairs (p < q) of the kernel's circle method over
    npad (even) indices: index npad - 1 fixed, the others turning."""
    m = npad - 1
    out = []
    for r in range(m):
        ps, qs = [], []
        for k in range(npad // 2):
            a, b = (r, m) if k == 0 else ((r + k) % m, (r - k + m) % m)
            ps.append(min(a, b))
            qs.append(max(a, b))
        out.append((ps, qs))
    return out


def jacobi_plain(S: torch.Tensor):
    """The kernel's computation as tensor operations on any device: (lam,
    U, info) as `eigh_kernel` returns them.  The same rotations in the same
    order, each product and sum rounded on its own; the convergence test's
    sums are taken in another order than the kernel's, which can change
    the sweep at which a matrix stops only when its off-diagonal mass lies
    within a rounding of the threshold."""
    n = S.shape[-1]
    batch = S.shape[:-2]
    S = S.reshape(-1, n, n).to(torch.float64)
    G, npad = S.shape[0], n + (n & 1)
    m = npad // 2
    A = S.new_zeros((G, npad, npad))
    A[:, :n, :n] = S
    V = torch.eye(npad, dtype=S.dtype, device=S.device).repeat(G, 1, 1)
    nonfinite = ~torch.isfinite(S).reshape(G, -1).all(-1)
    status = torch.where(nonfinite, 1, 0).to(torch.int32)
    sweeps = torch.zeros(G, dtype=torch.int32, device=S.device)
    active = ~nonfinite
    offmask = ~torch.eye(npad, dtype=torch.bool, device=S.device)
    upper = torch.triu(torch.ones(m, m, dtype=torch.bool, device=S.device),
                       1)
    ar = torch.arange(m, device=S.device)
    eps2 = float(np.finfo(np.float64).eps) ** 2
    rounds = [(torch.tensor(p, device=S.device),
               torch.tensor(q, device=S.device)) for p, q in
              _round_pairs(npad)]
    for sweep in range(MAX_SWEEPS + 1):
        a2 = A * A
        off = torch.where(offmask, a2, 0.0).reshape(G, -1).sum(-1)
        tot = a2.reshape(G, -1).sum(-1)
        active = active & ~(off <= eps2 * tot)
        if sweep == MAX_SWEEPS:
            status = torch.where(active, 2, status).to(torch.int32)
            break
        if not bool(active.any()):
            break
        sweeps = sweeps + active.to(torch.int32)
        live = active[:, None, None]
        for p, q in rounds:
            apq = A[:, p, q]                                    # [G, m]
            nz = apq != 0.0
            tau = (A[:, q, q] - A[:, p, p]) / (2.0 * torch.where(nz, apq,
                                                                  1.0))
            sg = torch.where(tau >= 0.0, 1.0, -1.0)
            t = torch.where(nz, sg / (tau.abs() + torch.sqrt(1.0 + tau * tau)),
                            0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            ca, sa = c[:, :, None], s[:, :, None]
            cb, sb = c[:, None, :], s[:, None, :]
            P_, Q_ = p[:, None], q[:, None]
            pr, qr = p[None, :], q[None, :]
            x00, x01 = A[:, P_, pr], A[:, P_, qr]
            x10, x11 = A[:, Q_, pr], A[:, Q_, qr]
            r00, r01 = ca * x00 - sa * x10, ca * x01 - sa * x11
            r10, r11 = sa * x00 + ca * x10, sa * x01 + ca * x11
            n00, n01 = cb * r00 - sb * r01, sb * r00 + cb * r01
            n10, n11 = cb * r10 - sb * r11, sb * r10 + cb * r11
            # the upper block (a < b) and its transpose, as the kernel
            # writes them
            N00 = torch.where(upper, n00, n00.transpose(1, 2))
            N01 = torch.where(upper, n01, n10.transpose(1, 2))
            N10 = torch.where(upper, n10, n01.transpose(1, 2))
            N11 = torch.where(upper, n11, n11.transpose(1, 2))
            # the diagonal blocks: the rotated pair's closed form
            tap = t * apq
            N00[:, ar, ar] = A[:, p, p] - tap
            N11[:, ar, ar] = A[:, q, q] + tap
            N01[:, ar, ar] = 0.0
            N10[:, ar, ar] = 0.0
            An = torch.empty_like(A)
            An[:, P_, pr], An[:, P_, qr] = N00, N01
            An[:, Q_, pr], An[:, Q_, qr] = N10, N11
            vp, vq = V[:, :, p], V[:, :, q]
            Vn = torch.empty_like(V)
            Vn[:, :, p] = cb * vp - sb * vq
            Vn[:, :, q] = sb * vp + cb * vq
            A = torch.where(live, An, A)
            V = torch.where(live, Vn, V)
    d = torch.diagonal(A, dim1=-2, dim2=-1)[:, :n]
    lam, order = torch.sort(d, dim=-1, stable=True)
    U = torch.gather(V[:, :n, :n], 2, order[:, None, :].expand(G, n, n))
    nan = torch.full_like(lam, float("nan"))
    lam = torch.where(nonfinite[:, None], nan, lam)
    U = torch.where(nonfinite[:, None, None], float("nan"), U)
    info = torch.stack([status, sweeps], -1)
    return (lam.reshape(batch + (n,)), U.reshape(batch + (n, n)),
            info.reshape(batch + (2,)))


def kernel_work(n: int, sweeps) -> tuple[float, float]:
    """(operations, bytes) of one launch on matrices of order n that took
    `sweeps` sweeps each (the kernel's info[..., 1]): per sweep npad - 1
    rounds of npad / 2 rotations (14 operations each), the 2 x 2 blocks
    of A (24 per block off the diagonal, 4 on it) and V (6 per row and
    pair), and a convergence test (3 per entry) before each sweep and
    after the last; S read once, lam and U written once."""
    npad = n + (n & 1)
    m = npad // 2
    per_round = 14 * m + 12 * m * (m - 1) + 4 * m + 6 * npad * m
    flop = 0.0
    for s in sweeps:
        flop += (s + 1) * 3 * npad * npad + s * (npad - 1) * per_round
    G = len(sweeps)
    return flop, 8.0 * G * (2 * n * n + n) + 8.0 * G
