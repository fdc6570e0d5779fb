"""Wrappers of the hand-written CUDA pruning kernels (`csrc/pruning.cu`).

Counterpart of `paml_tpu/core/pallas_pruning.py`.  The host side of the
Pallas kernels carries over: the DFS-postorder schedule with slot liveness
and the sparse scale set (`Plan`, from `_Plan`), and padding of the states
to N = 64.  The schedule becomes an int32 table on the device instead of
code unrolled per topology, so one binary serves every tree.

`pruning_fwd` and `pruning_bwd` check device, dtype, shape and contiguity,
allocate the outputs and the workspace with `torch.empty`, launch on the
current stream and raise if the launch failed; each adds one to its count
in `LAUNCHES` where it launches.  `ClassSiteLnfKernel` ties them together
as a `torch.autograd.Function`.  There is no fallback: a tensor the
kernels do not take raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .topology import Topology

N = 64                   # padded states (csrc/pruning.cu: N)
HT = 64                  # patterns per tile (csrc/pruning.cu: HT)
SCALE_EVERY = 4          # forward rescale interval in internal levels
F_TIP, F_ROOT, F_SCALE = 1, 2, 4
WORK_BUDGET = 2 << 30    # bytes of adjoint workspace + slabs per call

LAUNCHES = {"pruning_fwd": 0, "pruning_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host-side schedule
# ---------------------------------------------------------------------------


class Plan:
    """Kernel schedule for one topology (port of `_Plan`)."""

    def __init__(self, topo: Topology):
        ns, root = topo.ns, int(topo.root)
        kids_of: dict[int, tuple[int, ...]] = {}
        order: list[int] = []
        # iterative DFS postorder over ALL nodes (tips included)
        stack: list[tuple[int, bool]] = [(root, False)]
        while stack:
            v, done = stack.pop()
            if done:
                order.append(v)
                continue
            stack.append((v, True))
            kids = tuple(int(c) for c in topo.children[v] if c >= 0) \
                if v >= ns else ()
            kids_of[v] = kids
            for c in reversed(kids):
                stack.append((c, False))
        # slot allocation: c_v lives from v's step until its parent's step;
        # greedy reuse bounds the slots by ~tree depth
        slot: dict[int, int] = {}
        free: list[int] = []
        nslots = 0
        for v in order:
            for k in kids_of.get(v, ()):
                free.append(slot[k])
            if v != root:
                if free:
                    slot[v] = free.pop()
                else:
                    slot[v] = nslots
                    nslots += 1
        # sparse forward scaling: every path rescales at least every
        # SCALE_EVERY internal nodes, and the root always
        scale_set: set[int] = set()
        ud: dict[int, int] = {}
        for v in order:
            if v < ns:
                ud[v] = 0
                continue
            d = 1 + max(ud[k] for k in kids_of[v])
            if d >= SCALE_EVERY or v == root:
                scale_set.add(v)
                ud[v] = 0
            else:
                ud[v] = d
        self.order = order
        self.kids_of = kids_of
        self.slot = slot
        self.nslots = max(nslots, 1)
        self.root = root
        self.scale_set = scale_set
        self.kmax = max(1, topo.maxk)
        # one row per step: node, flags, slot, arity, child nodes, child
        # slots (-1 padded)
        kmax = self.kmax
        table = np.full((len(order), 4 + 2 * kmax), -1, dtype=np.int32)
        for i, v in enumerate(order):
            kids = kids_of[v]
            flags = ((F_TIP if v < ns else 0) | (F_ROOT if v == root else 0)
                     | (F_SCALE if v in scale_set else 0))
            table[i, :4] = (v, flags, slot.get(v, -1), len(kids))
            table[i, 4:4 + len(kids)] = kids
            table[i, 4 + kmax:4 + kmax + len(kids)] = [slot[k] for k in kids]
        self.table = table
        self._dev: dict[torch.device, torch.Tensor] = {}

    def device_table(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = torch.as_tensor(self.table, device=device)
            self._dev[device] = t
        return t


def plan(topo: Topology) -> Plan:
    p = getattr(topo, "_cuda_plan", None)
    if p is None:
        p = Plan(topo)
        topo._cuda_plan = p
    return p


# ---------------------------------------------------------------------------
# argument checks and padding
# ---------------------------------------------------------------------------


class _Inputs:
    """Kernel-ready inputs: states padded to N, tips in kernel layout."""

    def __init__(self, P, tips, topo: Topology, pi):
        if not P.is_cuda:
            raise ValueError(f"CUDA pruning kernels take CUDA tensors, got "
                             f"P on {P.device}")
        if P.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"CUDA pruning kernels take float32 or float64, "
                            f"got {P.dtype}")
        if P.dim() != 4 or P.shape[0] != topo.nnode or \
                P.shape[2] != P.shape[3]:
            raise ValueError(f"P must be [nnode={topo.nnode}, C, n, n], got "
                             f"{tuple(P.shape)}")
        nnode, C, n, _ = P.shape
        if C == 0 or tips.dim() < 2 or tips.shape[1] == 0:
            raise ValueError("CUDA pruning kernels need C > 0 classes and "
                             "H > 0 patterns")
        if n > N:
            raise ValueError(f"CUDA pruning kernels take n <= {N} states, "
                             f"got {n}")
        if pi.device != P.device or pi.dtype != P.dtype or \
                tuple(pi.shape) != (C, n):
            raise ValueError(f"pi must be [{C}, {n}] {P.dtype} on "
                             f"{P.device}, got {tuple(pi.shape)} {pi.dtype} "
                             f"on {pi.device}")
        if tips.device != P.device:
            raise ValueError(f"tips on {tips.device}, P on {P.device}")
        if tips.dim() == 2:
            if tips.dtype != torch.int32 or not tips.is_contiguous():
                raise TypeError("state-code tips must be contiguous int32, "
                                f"got {tips.dtype}")
            if tips.shape[0] != topo.ns:
                raise ValueError(f"tips must be [ns={topo.ns}, H], got "
                                 f"{tuple(tips.shape)}")
            check_state_codes(tips, n)
            self.states, self.part = tips, None
        elif tips.dim() == 3:
            if tips.dtype != P.dtype or tuple(tips.shape[::2]) != (topo.ns, n):
                raise ValueError(f"tip partials must be [ns={topo.ns}, H, "
                                 f"{n}] {P.dtype}, got {tuple(tips.shape)} "
                                 f"{tips.dtype}")
            part = tips.new_zeros((topo.ns, N, tips.shape[1]))
            part[:, :n, :] = tips.transpose(1, 2)
            self.states, self.part = None, part
        else:
            raise ValueError(f"tips must be [ns, H] or [ns, H, n], got "
                             f"{tuple(tips.shape)}")
        if n == N and P.is_contiguous():
            self.P = P
        else:
            self.P = P.new_zeros((nnode, C, N, N))
            self.P[..., :n, :n] = P
        self.pi = pi.new_zeros((C, N))
        self.pi[:, :n] = pi
        self.plan = plan(topo)
        self.sched = self.plan.device_table(P.device)
        self.nnode, self.C, self.n = nnode, C, n
        self.H = tips.shape[1]
        self.ntiles = -(-self.H // HT)
        self.ns = topo.ns

    def common(self):
        p = self.plan
        return (self.sched.data_ptr(), len(p.order), p.table.shape[1],
                p.kmax, self.P.data_ptr(),
                None if self.states is None else self.states.data_ptr(),
                None if self.part is None else self.part.data_ptr(),
                self.pi.data_ptr())


def check_state_codes(states: torch.Tensor, n: int) -> None:
    """The kernels index P with the codes: refuse any outside [0, n)."""
    lo, hi = torch.aminmax(states)
    if int(lo) < 0 or int(hi) >= n:
        raise ValueError(f"state codes must lie in [0, {n}), got "
                         f"[{int(lo)}, {int(hi)}]")


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(x: _Inputs) -> torch.Tensor:
    from .. import _build

    lnf = x.P.new_empty((x.C, x.H))
    work = x.P.new_empty((x.ntiles * x.C * x.plan.nslots * N * HT,))
    fn = getattr(_build.lib(), f"paml_pruning_fwd_{_suffix(x.P.dtype)}")
    with torch.cuda.device(x.P.device):
        err = fn(*x.common(), lnf.data_ptr(), work.data_ptr(), x.ntiles,
                 x.C, x.H, x.plan.nslots, _stream(x.P.device))
    LAUNCHES["pruning_fwd"] += 1
    _build.check(err, "pruning_fwd launch")
    return lnf


def bwd_grid(nnode: int, ns: int, C: int, ntiles: int, esize: int) -> int:
    """Blocks along the tile axis of the adjoint: as many as the tiles,
    fewer when the per-block workspace and dP slab exceed WORK_BUDGET."""
    nint = nnode - ns
    per_block = ((nnode + 2 * nint) * N * HT + nint * HT + nnode * N * N
                 + N) * esize
    return max(1, min(ntiles, WORK_BUDGET // (C * per_block)))


def _launch_bwd(x: _Inputs, gbar: torch.Tensor):
    from .. import _build

    if gbar.device != x.P.device or tuple(gbar.shape) != (x.C, x.H):
        raise ValueError(f"gbar must be [{x.C}, {x.H}] on {x.P.device}, got "
                         f"{tuple(gbar.shape)} on {gbar.device}")
    gbar = gbar.to(x.P.dtype).contiguous()
    nint = x.nnode - x.ns
    G = bwd_grid(x.nnode, x.ns, x.C, x.ntiles, x.P.element_size())
    work = x.P.new_empty((G * x.C * ((x.nnode + 2 * nint) * N * HT
                                     + nint * HT),))
    dP_slab = x.P.new_empty((G * x.nnode * x.C * N * N,))
    dpi_slab = x.P.new_empty((G * x.C * N,))
    dP = x.P.new_empty((x.nnode, x.C, x.n, x.n))
    dpi = x.P.new_empty((x.C, x.n))
    fn = getattr(_build.lib(), f"paml_pruning_bwd_{_suffix(x.P.dtype)}")
    with torch.cuda.device(x.P.device):
        err = fn(*x.common(), gbar.data_ptr(), dP_slab.data_ptr(),
                 dpi_slab.data_ptr(), work.data_ptr(), dP.data_ptr(),
                 dpi.data_ptr(), G, x.ntiles, x.C, x.H, x.ns, x.nnode, x.n,
                 x.plan.root, _stream(x.P.device))
    LAUNCHES["pruning_bwd"] += 1
    _build.check(err, "pruning_bwd launch")
    return dP, dpi


def pruning_fwd(P, tips, topo: Topology, pi) -> torch.Tensor:
    """Forward kernel: lnf [C, H] (no autograd)."""
    return _launch_fwd(_Inputs(P, tips, topo, pi))


def pruning_bwd(P, tips, topo: Topology, pi, gbar):
    """Adjoint kernel: (dP [nnode, C, n, n], dpi [C, n]) for the
    cotangent gbar [C, H] of lnf."""
    return _launch_bwd(_Inputs(P, tips, topo, pi), gbar)


class ClassSiteLnfKernel(torch.autograd.Function):
    """lnf [C, H] from the forward kernel; its backward is the adjoint
    kernel.  Tips are data (no gradient)."""

    @staticmethod
    def forward(ctx, P, tips, topo, pi):
        x = _Inputs(P, tips, topo, pi)
        ctx.inputs = x
        return _launch_fwd(x)

    @staticmethod
    def backward(ctx, gbar):
        dP, dpi = _launch_bwd(ctx.inputs, gbar)
        del ctx.inputs
        return dP, None, None, dpi
