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
`use_big_kernels` chooses between the two pairs.  B3/B4 walk binary trees:
their wrappers run `big_tree(topo)`, whose added nodes take an identity P,
and return dP of topo's own nodes.  There is no fallback: a tensor the
kernels do not take raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .topology import Topology

N = 64                   # padded states (csrc/pruning_common.cuh: N)
HT = 64                  # patterns per tile of B1/B2 (HT)
SCALE_EVERY = 4          # forward rescale interval in internal levels
F_TIP, F_ROOT, F_SCALE = 1, 2, 4
WORK_BUDGET = 2 << 30    # bytes of adjoint workspace + slabs per call

BIG_HT = 32              # patterns per tile of B3/B4 (BHT)
BIG_LDN, BIG_LDH = N + 4, BIG_HT + 4   # their shared row strides
BIG_KMAX = 2             # children per node B3/B4 take (pruning_big.cu: KMAX)
BIG_RED = 2 * 8 * BIG_HT  # their column-reduction scratch (RED)
BIG_TMAX = 16            # tiles per visit of a B4 block
BIG_WORK_SHARE = 8       # B4's slabs take at most 1/8 of the card's memory
SMEM_MAX = 232448        # dynamic shared memory a block may use (H100)

# H100 SXM data sheet: FP64 on the tensor cores and FP32 outside them, both
# 67 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

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
      fsi, B3's table: fs's rows of the internal nodes, each followed by
        its kid nodes x Kmax (-1 pad), so that B3 gathers a tip child's
        contribution where its parent needs it, then `keep` (1 when the
        next row is the node's parent: its contribution stays in shared
        memory) and the index of the kid that the row above kept (-1)
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
        kid_nodes = np.full((topo.nnode, kmax), -1, dtype=np.int32)
        for i, v in enumerate(p.order):
            kid_nodes[i, :len(p.kids_of[v])] = p.kids_of[v]
        inner = fs[:, 0] >= ns
        fsi = np.concatenate([fs[inner], kid_nodes[inner],
                              np.full((int(inner.sum()), 2), -1, np.int32)],
                             axis=1)
        fsi[:, -2] = 0
        for i in range(1, len(fsi)):
            last = p.kids_of[int(fsi[i, 0])][-1]
            if last == fsi[i - 1, 0]:
                fsi[i - 1, -2] = 1
                fsi[i, -1] = len(p.kids_of[int(fsi[i, 0])]) - 1
        self.fsi = np.ascontiguousarray(fsi)
        self.srow_nodes = list(srow)          # node of each residual row
        self.n_srows = len(srow)
        self.all_full = all(len(p.kids_of[v]) == kmax
                            for v in p.order if v >= ns)
        self.nslots, self.root = p.nslots, root
        # B4's workspace per block: nslots + 1 adjoint slots for each of the
        # (at most BIG_TMAX) tiles of a visit
        self.work_per_block = (p.nslots + 1) * BIG_TMAX * N * BIG_HT
        self._dev: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def device_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = (torch.as_tensor(self.fsi, device=device),
                 torch.as_tensor(self.bs, device=device))
            self._dev[device] = t
        return t


def big_plan(topo: Topology) -> BigPlan:
    p = getattr(topo, "_cuda_big_plan", None)
    if p is None:
        p = BigPlan(topo)
        topo._cuda_big_plan = p
    return p


def big_tree(topo: Topology) -> Topology:
    """The tree B3/B4 walk for `topo`, cached on it: every node of more
    than BIG_KMAX children resolved, its children split into BIG_KMAX
    groups of near-equal size (np.array_split order), each group of more
    than one child under a new internal node, recursively, so that depth
    grows by the log of the arity.  The new nodes are numbered from
    topo.nnode on; their branches have length 0 and take an identity P
    (`with_identity`), so lnf and the original nodes' dP are unchanged.
    `topo` itself when no node is wider."""
    t = getattr(topo, "_cuda_big_tree", None)
    if t is not None:
        return t
    ns, nnode, kmax = topo.ns, topo.nnode, BIG_KMAX
    kids = {v: [int(c) for c in topo.children[v] if c >= 0]
            for v in range(ns, nnode)}
    if max(len(k) for k in kids.values()) <= kmax:
        topo._cuda_big_tree = topo
        return topo
    nxt = nnode

    def group(ks):
        nonlocal nxt
        if len(ks) <= kmax:
            return ks
        out = []
        for part in np.array_split(np.asarray(ks), kmax):
            if len(part) == 1:
                out.append(int(part[0]))
            else:
                u, nxt = nxt, nxt + 1
                kids[u] = group([int(p) for p in part])
                out.append(u)
        return out
    for v in range(ns, nnode):
        kids[v] = group(kids[v])
    parent = np.full(nxt, -1, dtype=np.int32)
    children = np.full((nxt, kmax), -1, dtype=np.int32)
    for v, ks in kids.items():
        children[v, :len(ks)] = ks
        parent[ks] = v
    post: list[int] = []
    stack = [(int(topo.root), False)]
    while stack:
        v, done = stack.pop()
        if done:
            post.append(v)
        elif v >= ns:
            stack.append((v, True))
            stack.extend((k, False) for k in reversed(kids[v]))
    extra = nxt - nnode
    ages0 = None if topo.ages0 is None else \
        np.concatenate([topo.ages0, np.full(extra, np.nan)])
    t = Topology(
        ns=ns, nnode=nxt, root=topo.root, parent=parent, children=children,
        postorder=np.array(post, dtype=np.int32),
        blen0=np.concatenate([topo.blen0, np.zeros(extra)]),
        labels=np.concatenate([topo.labels, np.zeros(extra, np.int32)]),
        node_names=list(topo.node_names) + [""] * extra, ages0=ages0)
    topo._cuda_big_tree = t
    return t


def with_identity(P: torch.Tensor, tree: Topology) -> torch.Tensor:
    """P [nnode, C, n, n] extended to the nodes of `tree` (from
    `big_tree`): an identity P for each node it added."""
    extra = tree.nnode - P.shape[0]
    if extra == 0:
        return P
    C, n = P.shape[1], P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    return torch.cat([P, eye.expand(extra, C, n, n)])


# ---------------------------------------------------------------------------
# argument checks and padding
# ---------------------------------------------------------------------------


class _Inputs:
    """Kernel-ready inputs: states padded to N, tips in kernel layout.  The
    kernels walk `run` (default topo), the `big_tree` of topo, whose added
    nodes get an identity P."""

    def __init__(self, P, tips, topo: Topology, pi, run: Topology = None):
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
        run = topo if run is None else run
        if n == N and P.is_contiguous() and run.nnode == nnode:
            self.P = P
        else:
            self.P = P.new_zeros((run.nnode, C, N, N))
            self.P[:nnode, :, :n, :n] = P
            self.P[nnode:, :, range(n), range(n)] = 1.0
        self.pi = pi.new_zeros((C, N))
        self.pi[:, :n] = pi
        self.topo = run
        self.plan = plan(run)
        self.sched = self.plan.device_table(P.device)
        self.nnode, self.C, self.n = run.nnode, C, n
        self.nnode_in = nnode
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


def use_big_kernels(state_tips: bool) -> bool:
    """B3/B4 for state-code tips, on any tree (they walk its `big_tree`,
    binary); B1/B2 for multi-hot tips.  Since their redesign B3+B4 beat
    B1+B2 at every shape measured on both sides, from 11 to 1024 taxa and
    1 to 4 classes, polytomies included (PERF.md)."""
    return state_tips


def big_fwd_smem(esize: int) -> int:
    """Dynamic shared memory of a B3 block: P_v [N][LDN]; s_v and the
    kept contribution [N][LDH]; the column-reduction scratch."""
    return (N * BIG_LDN + 2 * N * BIG_LDH + BIG_RED) * esize


def big_bwd_smem(esize: int, kmax: int) -> int:
    """Dynamic shared memory of a B4 block (pruning_big.cu's carve): per
    child of the tree's kmax P_k or its tip dP_k [N][LDN] and c_k
    [N][LDH]; s_k and G_k for BIG_KMAX children and A_v [N][LDH]; the
    column-reduction scratch; dpi [N]."""
    return (kmax * N * BIG_LDN + (kmax + 2 * BIG_KMAX + 1) * N * BIG_LDH
            + BIG_RED + N) * esize


def big_tiles(H: int) -> int:
    return -(-H // BIG_HT)


def visit_tiles(ntiles: int, G: int) -> int:
    """Tiles a B4 block takes per walk of the tree: its whole range of
    tiles, at most BIG_TMAX."""
    return min(BIG_TMAX, -(-ntiles // G))


def kernel_work(name: str, topo: Topology, C: int, H: int, n: int,
                esize: int, state_tips: bool = True) -> tuple[float, float]:
    """(operations, bytes) that kernel `name` needs on these shapes: the
    products of the n real states (2 n^2 per pattern, class and product;
    a state-code tip's contribution is a gather and its dP a scatter, no
    product), each input read once and each output written once.  The
    forward does one product per non-root internal node (plus one per tip
    for multi-hot tips); the adjoint three (c_k again, dP_k, A_k), plus one
    dP_k per multi-hot tip."""
    nint = topo.nnode - topo.ns - 1
    prod = 2.0 * n * n * H * C
    P_b = topo.nnode * C * n * n * esize
    tips_b = topo.ns * H * (4 if state_tips else n * esize)
    S_b = big_plan(topo).n_srows * C * n * H * esize
    pi_b, lnf_b = C * n * esize, C * H * esize
    if name in ("pruning_fwd", "big_fwd"):
        flop = (nint + (0 if state_tips else topo.ns)) * prod
        nbytes = P_b + tips_b + pi_b + lnf_b
        return flop, nbytes + (S_b if name == "big_fwd" else 0)
    flop = (3 * nint + (0 if state_tips else topo.ns)) * prod
    nbytes = P_b + tips_b + pi_b + lnf_b + P_b + pi_b   # in: gbar; out: dP, dpi
    return flop, nbytes + (S_b if name == "big_bwd" else 0)


def bound_ms(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    return 1e3 * max(flop / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _big_inputs(P, tips, topo, pi) -> _Inputs:
    x = _Inputs(P, tips, topo, pi, big_tree(topo))
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
    ntiles = big_tiles(x.H)
    work = x.P.new_empty((ntiles * x.C * bp.nslots * N * BIG_HT,))
    fn = getattr(_build.lib(), f"paml_big_fwd_{_suffix(x.P.dtype)}")
    with torch.cuda.device(x.P.device):
        err = fn(fs.data_ptr(), fs.shape[0], bp.kmax, x.P.data_ptr(),
                 x.states.data_ptr(), x.pi.data_ptr(), lnf.data_ptr(),
                 None if S is None else S.data_ptr(), work.data_ptr(),
                 ntiles, x.C, x.H, x.ns, x.n, bp.nslots,
                 big_fwd_smem(x.P.element_size()), _stream(x.P.device))
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
    props = torch.cuda.get_device_properties(x.P.device)
    ntiles = big_tiles(x.H)
    G = big_bwd_grid(x.nnode, x.C, ntiles, x.P.element_size(),
                     props.multi_processor_count, props.total_memory,
                     bp.work_per_block)
    tv = visit_tiles(ntiles, G)
    work = x.P.new_empty((G * x.C * (bp.nslots + 1) * tv * N * BIG_HT,))
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
                 ntiles, tv, x.C, x.H, x.ns, x.n, x.nnode, bp.nslots,
                 bp.root, big_bwd_smem(x.P.element_size(), bp.kmax),
                 _stream(x.P.device))
    LAUNCHES["big_bwd"] += 1
    _build.check(err, "big_bwd launch")
    return dP[:x.nnode_in], dpi


def pruning_big_fwd(P, tips, topo: Topology, pi, want_S: bool = True):
    """Large-tree forward kernel: (lnf [C, H], S [n_srows, C, n, H] or
    None), S holding the scaled partials of the non-cherry internal
    nodes of `big_tree(topo)` (no autograd)."""
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
