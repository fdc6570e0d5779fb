"""Wrappers of the hand-written CUDA pruning kernels (`csrc/`).

Counterpart of `paml_tpu/core/pallas_pruning.py` (B1/B2, `pruning.cu`) and
`paml_tpu/core/pallas_pruning_big.py` (B3/B4, `pruning_big.cu`).  The host
side of the Pallas kernels carries over: the DFS-postorder schedule with
slot liveness and the sparse scale set (`Plan`, from `_Plan`), the
large-tree schedules with their residual rows (`BigPlan`, from
`_sched_arrays`), and padding of the states to N = 64.  The schedules
become int32 tables on the device instead of code unrolled per topology,
so one binary serves every tree.

`pruning_fwd`, `pruning_bwd`, `pruning_big_fwd` and `pruning_big_bwd` check
the state codes, device, dtype, shape and contiguity, allocate the outputs
and the workspace with `torch.empty`, launch on the current stream and
raise if the launch failed; each adds one to its count in `LAUNCHES` where
it launches.  `ClassSiteLnfKernel` (B1/B2) and `ClassSiteLnfBig` (B3/B4)
tie them together as `torch.autograd.Function`s, which leave the state
codes to their caller (the codeml objective checks its tips once);
`use_big_kernels` chooses between the two pairs.  There is no fallback: a
tensor the kernels do not take raises.
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

BIG_WORK_SHARE = 8       # B4's slabs take at most 1/8 of the card's memory

LAUNCHES = {"pruning_fwd": 0, "pruning_bwd": 0, "big_fwd": 0, "big_bwd": 0}


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


class BigPlan:
    """Schedules of the large-tree kernels (port of `_sched_arrays`).

    A cherry (a non-root internal node whose children are all tips) gets no
    residual row: the adjoint rebuilds its scaled partial from the
    grandchild tips.  The other internal nodes get rows 0..n_srows-1.

      fs row (DFS postorder, root last):
        [v, out_slot, srow | -1, kid_slot x Kmax (-1 pad)]
      bs row (internal nodes, reverse DFS, root first):
        [v, aslot, srow_v, (kid, kid_srow | -1, kid_aslot | -1,
                            grandkid_tip x Kmax) x Kmax]
    """

    def __init__(self, topo: Topology):
        p = plan(topo)
        ns, root = topo.ns, p.root
        kmax = max((len(k) for k in p.kids_of.values() if k), default=2)
        cherry = {v for v in p.order if v >= ns and v != root
                  and all(k < ns for k in p.kids_of[v])}
        srow: dict[int, int] = {}
        for v in p.order:
            if v >= ns and v not in cherry:
                srow[v] = len(srow)
        fs = np.full((topo.nnode, 3 + kmax), -1, dtype=np.int32)
        for i, v in enumerate(p.order):
            fs[i, :3] = (v, p.nslots if v == root else p.slot[v],
                         srow.get(v, -1))
            for k, kid in enumerate(p.kids_of[v]):
                fs[i, 3 + k] = p.slot[kid]
        internal_rev = [v for v in reversed(p.order) if v >= ns]
        stride = 3 + kmax
        bs = np.full((len(internal_rev), 3 + stride * kmax), -1,
                     dtype=np.int32)
        for i, v in enumerate(internal_rev):
            aslot = p.nslots if v == root else p.slot[v]
            bs[i, :3] = (v, aslot, srow.get(v, -1))
            kids = p.kids_of[v]
            for k, kid in enumerate(kids):
                base = 3 + stride * k
                bs[i, base:base + 3] = (kid, srow.get(kid, -1),
                                        p.slot[kid] if kid >= ns else -1)
                if kid in cherry:
                    gk = p.kids_of[kid]
                    bs[i, base + 3:base + 3 + len(gk)] = gk
                # the adjoint writes A_kid into kid's slot after reading
                # A_v: only the last child may share v's slot
                assert kid < ns or k == len(kids) - 1 or \
                    p.slot[kid] != aslot
        self.fs, self.bs, self.kmax = fs, bs, kmax
        self.srow_nodes = list(srow)          # node of each residual row
        self.n_srows = len(srow)
        self.all_full = all(len(p.kids_of[v]) == kmax
                            for v in p.order if v >= ns)
        self.nslots, self.root = p.nslots, root
        # B4's workspace per block: nslots + 1 adjoint slots, and s_k and
        # c_k of each child
        self.work_per_block = (p.nslots + 1 + 2 * kmax) * N * HT
        self._dev: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = (torch.as_tensor(self.fs, device=device),
                 torch.as_tensor(self.bs, device=device))
            self._dev[device] = t
        return t


def big_plan(topo: Topology) -> BigPlan:
    p = getattr(topo, "_cuda_big_plan", None)
    if p is None:
        p = BigPlan(topo)
        topo._cuda_big_plan = p
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
        self.topo = topo
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
    """The kernels index P with the codes: refuse any outside [0, n).
    Two host syncs: callers check a tips tensor once, not per launch."""
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


def _checked(tips, P):
    if tips.dim() == 2:
        check_state_codes(tips, P.shape[-1])
    return tips


def pruning_fwd(P, tips, topo: Topology, pi) -> torch.Tensor:
    """Forward kernel: lnf [C, H] (no autograd)."""
    return _launch_fwd(_Inputs(P, _checked(tips, P), topo, pi))


def pruning_bwd(P, tips, topo: Topology, pi, gbar):
    """Adjoint kernel: (dP [nnode, C, n, n], dpi [C, n]) for the
    cotangent gbar [C, H] of lnf."""
    return _launch_bwd(_Inputs(P, _checked(tips, P), topo, pi), gbar)


class ClassSiteLnfKernel(torch.autograd.Function):
    """lnf [C, H] from the forward kernel; its backward is the adjoint
    kernel.  Tips are data (no gradient).  The inputs are saved with
    `save_for_backward`, so a checkpointed caller frees them."""

    @staticmethod
    def forward(ctx, P, tips, topo, pi):
        ctx.topo = topo
        ctx.save_for_backward(P, tips, pi)
        return _launch_fwd(_Inputs(P, tips, topo, pi))

    @staticmethod
    def backward(ctx, gbar):
        P, tips, pi = ctx.saved_tensors
        dP, dpi = _launch_bwd(_Inputs(P, tips, ctx.topo, pi), gbar)
        return dP, None, None, dpi


# ---------------------------------------------------------------------------
# large-tree kernels (B3/B4)
# ---------------------------------------------------------------------------


def use_big_kernels(topo: Topology, C: int, H: int, state_tips: bool,
                    esize: int) -> bool:
    """B3/B4 for state-code tips when B2's workspace budget cannot give
    every pattern tile its own block; B1/B2 otherwise (multi-hot tips, and
    trees that B2 serves at full width)."""
    ntiles = -(-H // HT)
    return state_tips and bwd_grid(topo.nnode, topo.ns, C, ntiles,
                                   esize) < ntiles


def _big_inputs(P, tips, topo, pi) -> _Inputs:
    x = _Inputs(P, tips, topo, pi)
    if x.states is None:
        raise ValueError("the large-tree kernels take state-code tips "
                         "[ns, H] only")
    return x


def _launch_big_fwd(x: _Inputs, want_S: bool):
    from .. import _build

    bp = big_plan(x.topo)
    fs, _ = bp.device_tables(x.P.device)
    lnf = x.P.new_empty((x.C, x.H))
    S = x.P.new_empty((bp.n_srows, x.C, x.n, x.H)) if want_S else None
    work = x.P.new_empty((x.ntiles * x.C * bp.nslots * N * HT,))
    fn = getattr(_build.lib(), f"paml_big_fwd_{_suffix(x.P.dtype)}")
    with torch.cuda.device(x.P.device):
        err = fn(fs.data_ptr(), fs.shape[0], bp.kmax, x.P.data_ptr(),
                 x.states.data_ptr(), x.pi.data_ptr(), lnf.data_ptr(),
                 None if S is None else S.data_ptr(), work.data_ptr(),
                 x.ntiles, x.C, x.H, x.ns, x.n, bp.nslots,
                 _stream(x.P.device))
    LAUNCHES["big_fwd"] += 1
    _build.check(err, "big_fwd launch")
    return lnf, S


def big_bwd_grid(nnode: int, C: int, ntiles: int, esize: int, sms: int,
                 mem_bytes: int, work_per_block: int) -> int:
    """Blocks along the tile axis of B4: enough for G x C >= the card's SM
    count, at most one per tile, and fewer when the dP slabs (nnode x C x
    64 x 64 values per g) and workspace would pass 1/BIG_WORK_SHARE of the
    card's memory.  The card's size, not its free memory at the call, sets
    the cap: the grid fixes the slab sum order, and so the bits of dP."""
    per_g = (nnode * C * N * N + C * N + C * work_per_block) * esize
    cap = mem_bytes // BIG_WORK_SHARE // per_g
    return max(1, min(ntiles, -(-sms // C), cap))


def _launch_big_bwd(x: _Inputs, gbar: torch.Tensor, S: torch.Tensor):
    from .. import _build

    bp = big_plan(x.topo)
    if gbar.device != x.P.device or tuple(gbar.shape) != (x.C, x.H):
        raise ValueError(f"gbar must be [{x.C}, {x.H}] on {x.P.device}, got "
                         f"{tuple(gbar.shape)} on {gbar.device}")
    want = (bp.n_srows, x.C, x.n, x.H)
    if S.device != x.P.device or S.dtype != x.P.dtype or \
            tuple(S.shape) != want or not S.is_contiguous():
        raise ValueError(f"S must be a contiguous {x.P.dtype} {want} on "
                         f"{x.P.device}, got {S.dtype} {tuple(S.shape)} on "
                         f"{S.device}")
    gbar = gbar.to(x.P.dtype).contiguous()
    _, bs = bp.device_tables(x.P.device)
    wpb = bp.work_per_block
    props = torch.cuda.get_device_properties(x.P.device)
    G = big_bwd_grid(x.nnode, x.C, x.ntiles, x.P.element_size(),
                     props.multi_processor_count, props.total_memory, wpb)
    work = x.P.new_empty((G * x.C * wpb,))
    dP_slab = x.P.new_empty((G * x.nnode * x.C * N * N,))
    dpi_slab = x.P.new_empty((G * x.C * N,))
    dP = x.P.new_empty((x.nnode, x.C, x.n, x.n))
    dpi = x.P.new_empty((x.C, x.n))
    fn = getattr(_build.lib(), f"paml_big_bwd_{_suffix(x.P.dtype)}")
    with torch.cuda.device(x.P.device):
        err = fn(bs.data_ptr(), bs.shape[0], bp.kmax, x.P.data_ptr(),
                 x.states.data_ptr(), x.pi.data_ptr(), gbar.data_ptr(),
                 S.data_ptr(), dP_slab.data_ptr(), dpi_slab.data_ptr(),
                 work.data_ptr(), dP.data_ptr(), dpi.data_ptr(), G,
                 x.ntiles, x.C, x.H, x.ns, x.n, x.nnode, bp.nslots, bp.root,
                 _stream(x.P.device))
    LAUNCHES["big_bwd"] += 1
    _build.check(err, "big_bwd launch")
    return dP, dpi


def pruning_big_fwd(P, tips, topo: Topology, pi, want_S: bool = True):
    """Large-tree forward kernel: (lnf [C, H], S [n_srows, C, n, H] or
    None), S holding the scaled partials of the non-cherry internal
    nodes (no autograd)."""
    return _launch_big_fwd(_big_inputs(P, _checked(tips, P), topo, pi),
                           want_S)


def pruning_big_bwd(P, tips, topo: Topology, pi, gbar, S):
    """Large-tree adjoint kernel: (dP [nnode, C, n, n], dpi [C, n]) for the
    cotangent gbar [C, H] of lnf, from the forward's residual S."""
    return _launch_big_bwd(_big_inputs(P, _checked(tips, P), topo, pi),
                           gbar, S)


class ClassSiteLnfBig(torch.autograd.Function):
    """lnf [C, H] from B3, which also writes the residual S when a
    gradient is wanted; the backward is B4 reading S.  S is saved with
    `save_for_backward`, so a checkpointed chunk frees it and B3 writes it
    again when the backward recomputes the chunk."""

    @staticmethod
    def forward(ctx, P, tips, topo, pi):
        want_S = ctx.needs_input_grad[0] or ctx.needs_input_grad[3]
        lnf, S = _launch_big_fwd(_big_inputs(P, tips, topo, pi), want_S)
        ctx.topo = topo
        ctx.save_for_backward(P, tips, pi, S)
        return lnf

    @staticmethod
    def backward(ctx, gbar):
        P, tips, pi, S = ctx.saved_tensors
        dP, dpi = _launch_big_bwd(_big_inputs(P, tips, ctx.topo, pi), gbar,
                                  S)
        return dP, None, None, dpi
