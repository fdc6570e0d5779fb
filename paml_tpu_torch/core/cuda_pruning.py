"""Wrappers of the hand-written CUDA pruning kernels (`csrc/`).

Counterpart of `paml_tpu/core/pallas_pruning.py` (B1/B2, `pruning.cu`) and
`paml_tpu/core/pallas_pruning_big.py` (B3/B4, `pruning_big.cu`).  Both
pairs are one tree walk (`csrc/pruning_tree.cuh`): a forward kernel that
writes lnf and, when a gradient is wanted, the residual S of scaled
partials, and an adjoint kernel that reads S.  B3/B4 take state-code tips;
B1/B2 take coded tips with an ambiguity table (`tipcodes.TipCodes`), so
that an alignment with gaps runs the same walk.  The host side of the
Pallas kernels carries over: the DFS-postorder schedule with slot liveness
(`Plan`, from `_Plan`), the schedules with their residual rows (`BigPlan`,
from `_sched_arrays`), and padding of the states to the padded state count
N, which each kernel takes as a template parameter as the TPU kernels take
it from their shapes: an instance at N = 32 (amino acids) and one at N =
64 (codons), chosen from n by `padded_states`.  The schedules are int32
tables on the device instead of code unrolled per topology, so one binary
serves every tree.

`pruning_fwd`, `pruning_bwd`, `pruning_big_fwd` and `pruning_big_bwd` check
the codes, device, dtype, shape and contiguity, allocate the outputs and
the workspace with `torch.empty`, launch on the current stream and raise
if the launch failed; each adds one to its count in `LAUNCHES` where it
launches, and one to its instance's in `INSTANCE_LAUNCHES`
(`pruning_fwd_n32`, `pruning_fwd_n64`, ...).  Their keyword `npad` forces
an instance (64 at 20 states, to hold the two instances against each
other); nothing else chooses N but n.  B1/B2's wrappers also take dense
[ns, H, n] partials, coded once per tensor (`kernel_tips`).
`ClassSiteLnfKernel` ties a pair together as a `torch.autograd.Function`,
which leaves the codes to its caller (the codeml objective checks its tips
once); `use_big_kernels` chooses between the two pairs.  The kernels walk
binary trees: the wrappers run `big_tree(topo)`, whose added nodes take an
identity P, and return dP of topo's own nodes.  There is no fallback: a
tensor the kernels do not take raises, and an instance that fails to
launch raises.

The walk's tangents (`csrc/pruning_tangent.cuh`, float64): H1
(`pruning_tan_fwd`, `pruning_big_tan_fwd`) and H2 (`pruning_tan_bwd`,
`pruning_big_tan_bwd`) along a batch of D directions of (P, pi), counted
as `tan_fwd` / `tan_bwd`; `ClassSiteLnfKernelTwice` strings the forward,
the adjoint and the two tangents together for `codeml.hessian`, on the
residual of `full_plan`.
"""
from __future__ import annotations

import numpy as np
import torch

from .pmat import differentiable_once
from .tipcodes import TipCodes, encode
from .topology import Topology

# the padded state counts N of the walk's instances (csrc/pruning_common.cuh:
# Pad<N>)
INSTANCES = (32, 64)

BIG_HT = 32              # patterns per tile (BHT)
BIG_LDH = BIG_HT + 4     # the shared row stride of an [N x BHT] operand
BIG_KMAX = 2             # children per node the walk takes (KMAX)
BIG_RED = 2 * 8 * BIG_HT  # the column-reduction scratch (RED)
BIG_TMAX = 16            # tiles per visit of an adjoint block
BIG_WORK_SHARE = 8       # the adjoint's slabs take at most 1/8 of the card
SMEM_MAX = 232448        # dynamic shared memory a block may use (H100)
SMEM_SM = 233472         # shared memory of an SM (H100), 1 KB a block kept
TAN_TMAX = 8             # tiles per visit of an H2 block (the tangents)

# H100 SXM data sheet: FP64 on the tensor cores and FP32 outside them, both
# 67 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the walk's pairs, then its tangents H1 / H2 (both tip encodings)
KERNELS = ("pruning_fwd", "pruning_bwd", "big_fwd", "big_bwd", "tan_fwd",
           "tan_bwd")
LAUNCHES = dict.fromkeys(KERNELS, 0)
# the same launches by instance: `<kernel>_n<N>`
INSTANCE_LAUNCHES = {f"{k}_n{m}": 0 for k in KERNELS for m in INSTANCES}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, INSTANCE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def padded_states(n: int) -> int:
    """The padded state count N of the kernel instance that takes n states:
    32 for up to 32 states (amino acids), 64 for 33 to 64 (codons).  The
    TPU kernels pad to max(round_up(n, 8), 16) (`maybe_pallas_lnf`,
    paml_tpu/core/pallas_pruning.py:692), 24 for 20 states; the card's
    FP64 products tile rows by 16 and the walk's 8 warps split 32 or 64 of
    them, so 24 rounds up to 32.  (Below 16 states `pruning.class_site_lnf`
    takes the level route; a wrapper called directly takes N = 32.)"""
    if not 1 <= n <= INSTANCES[-1]:
        raise ValueError(f"CUDA pruning kernels take 1 to {INSTANCES[-1]} "
                         f"states, got {n}")
    return next(m for m in INSTANCES if n <= m)


def _npad(n: int, npad: int | None) -> int:
    """padded_states(n), or the instance a caller forces (at least n)."""
    if npad is None:
        return padded_states(n)
    if npad not in INSTANCES or npad < n:
        raise ValueError(f"no kernel instance at N = {npad} takes {n} "
                         f"states (instances: {INSTANCES})")
    return npad


def ldn(npad: int) -> int:
    """The shared row stride of an [N x N] operand (LDN = N + 4)."""
    return npad + 4


# ---------------------------------------------------------------------------
# host-side schedule
# ---------------------------------------------------------------------------


class Plan:
    """DFS postorder and contribution slots for one topology (port of
    `_Plan`)."""

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
        self.order = order
        self.kids_of = kids_of
        self.slot = slot
        self.nslots = max(nslots, 1)
        self.root = root


def plan(topo: Topology) -> Plan:
    p = getattr(topo, "_cuda_plan", None)
    if p is None:
        p = Plan(topo)
        topo._cuda_plan = p
    return p


class BigPlan:
    """Schedules of the tree walk (port of `_sched_arrays`).

    A cherry (a non-root internal node whose children are all tips) gets no
    residual row: the adjoint rebuilds its scaled partial from the
    grandchild tips.  The other internal nodes get rows 0..n_srows-1.
    With `cherries` false no node counts as a cherry (`full_plan`).

      fs row (DFS postorder, root last):
        [v, out_slot, srow | -1, kid_slot x Kmax (-1 pad)]
      fsi, the forward's table: fs's rows of the internal nodes, each
        followed by its kid nodes x Kmax (-1 pad), so that the forward
        gathers a tip child's contribution where its parent needs it, then
        `keep` (1 when the next row is the node's parent: its contribution
        stays in shared memory) and the index of the kid that the row above
        kept (-1)
      bs row (internal nodes, reverse DFS, root first):
        [v, aslot, srow_v, (kid, kid_srow | -1, kid_aslot | -1,
                            grandkid_tip x Kmax) x Kmax]
    """

    def __init__(self, topo: Topology, cherries: bool = True):
        p = plan(topo)
        ns, root = topo.ns, p.root
        kmax = max((len(k) for k in p.kids_of.values() if k), default=2)
        cherry = set() if not cherries else {
            v for v in p.order if v >= ns and v != root
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
        self._dev: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def work_per_block(self, npad: int) -> int:
        """The adjoint's workspace per block at N = npad: nslots + 1
        adjoint slots [N x BHT] for each of the (at most BIG_TMAX) tiles of
        a visit."""
        return (self.nslots + 1) * BIG_TMAX * npad * BIG_HT

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


def full_plan(topo: Topology) -> BigPlan:
    """The schedules of the Hessian's route (`ClassSiteLnfKernelTwice`): a
    plan without cherries, so that every internal node, the root
    included, has a row in the forward's residual S (DFS postorder) and
    the tangent kernels read every scaled partial from S and its tangent
    from Sd in the same rows."""
    p = getattr(topo, "_cuda_full_plan", None)
    if p is None:
        p = BigPlan(topo, cherries=False)
        topo._cuda_full_plan = p
    return p


def big_tree(topo: Topology) -> Topology:
    """The tree the kernels walk for `topo`, cached on it: every node of
    more than BIG_KMAX children resolved, its children split into BIG_KMAX
    groups of near-equal size (np.array_split order), each group of more
    than one child under a new internal node, recursively, so that depth
    grows by the log of the arity.  The new nodes are numbered from
    topo.nnode on (`n_own` = topo.nnode on the result); their branches
    have length 0 and take an identity P (`with_identity`), so lnf and the
    original nodes' dP are unchanged: the adjoints clip G only for the
    children of topo's own nodes (`pruning_common.cuh: clip_adjoint`,
    `pruning._lnf_lvl_bwd`).  `topo` itself when no node is wider."""
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
    t.n_own = nnode
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
# tips, argument checks and padding
# ---------------------------------------------------------------------------


def kernel_tips(tips):
    """The tips as the kernels take them: int32 state codes [ns, H] as they
    are (B3/B4); TipCodes as they are (B1/B2), or their codes when no cell
    is ambiguous; dense [ns, H, n] partials coded first (`encode`), once
    per tensor: the coding is cached on the tensor until it is changed in
    place."""
    if isinstance(tips, TipCodes):
        return tips if tips.n_amb else tips.codes
    if tips.dim() != 3:
        return tips
    hit = getattr(tips, "_tip_codes", None)
    if hit is None or hit[0] != tips._version:
        hit = (tips._version, encode(tips))
        tips._tip_codes = hit
    return kernel_tips(hit[1])


def check_state_codes(states: torch.Tensor, n: int, n_amb: int = 0) -> None:
    """The kernels index P (or the ambiguity table, from code n on) with
    the codes: refuse any outside [0, n + n_amb).  Two host syncs: callers
    check a tips tensor once, not per launch."""
    lo, hi = torch.aminmax(states)
    if int(lo) < 0 or int(hi) >= n + n_amb:
        raise ValueError(f"state codes must lie in [0, {n + n_amb}), got "
                         f"[{int(lo)}, {int(hi)}]")


def check_tips(tips, n: int) -> None:
    """`check_state_codes` on int32 state codes or on TipCodes' codes;
    dense partials need none."""
    if isinstance(tips, TipCodes):
        check_state_codes(tips.codes, n, tips.n_amb)
    elif tips.dim() == 2:
        check_state_codes(tips, n)


def padded_P(P: torch.Tensor, nnode: int, npad: int) -> torch.Tensor:
    """P [nnode_P, C, n, n] as the kernel instance at N = npad takes it:
    npad states (zeros outside n), and an identity P for each node from
    nnode_P to nnode (the nodes `big_tree` added); P itself when it is that
    already.  Views and fills only, no index tensor from the host: no host
    sync, so an evaluation can be captured in a CUDA graph."""
    n = P.shape[-1]
    if n == npad and P.is_contiguous() and P.shape[0] == nnode:
        return P
    out = P.new_zeros((nnode, P.shape[1], npad, npad))
    out[:P.shape[0], :, :n, :n] = P
    out[P.shape[0]:, :, :n, :n].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return out


class _Inputs:
    """Kernel-ready inputs for the instance at N = `padded_states(n)` (or
    `npad`, where a caller forces one): P padded to N states and extended
    to the tree the kernels walk (`big_tree(topo)`, identity P on the added
    nodes), pi padded, the codes, and for TipCodes the ambiguity table
    padded to N states (amb None, A 0 for state codes).  Built on any
    device; the launches take CUDA tensors alone (`_require_cuda`)."""

    def __init__(self, P, tips, topo: Topology, pi, npad: int | None = None):
        if P.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"CUDA pruning kernels take float32 or float64, "
                            f"got {P.dtype}")
        if P.dim() != 4 or P.shape[0] != topo.nnode or \
                P.shape[2] != P.shape[3]:
            raise ValueError(f"P must be [nnode={topo.nnode}, C, n, n], got "
                             f"{tuple(P.shape)}")
        nnode, C, n, _ = P.shape
        codes, amb = (tips.codes, tips.amb) if isinstance(tips, TipCodes) \
            else (tips, None)
        if C == 0 or codes.dim() != 2 or codes.shape[1] == 0:
            raise ValueError("CUDA pruning kernels need C > 0 classes, H > 0 "
                             "patterns and tips [ns, H] (codes)")
        self.N = N = _npad(n, npad)
        if pi.device != P.device or pi.dtype != P.dtype or \
                tuple(pi.shape) != (C, n):
            raise ValueError(f"pi must be [{C}, {n}] {P.dtype} on "
                             f"{P.device}, got {tuple(pi.shape)} {pi.dtype} "
                             f"on {pi.device}")
        if codes.device != P.device:
            raise ValueError(f"tips on {codes.device}, P on {P.device}")
        if codes.dtype != torch.int32 or not codes.is_contiguous():
            raise TypeError("state-code tips must be contiguous int32, "
                            f"got {codes.dtype}")
        if codes.shape[0] != topo.ns:
            raise ValueError(f"tips must be [ns={topo.ns}, H], got "
                             f"{tuple(codes.shape)}")
        self.states, self.amb, self.A = codes, None, 0
        if amb is not None:
            if amb.device != P.device or amb.dim() != 2 or \
                    amb.shape[1] != n:
                raise ValueError(f"the ambiguity table must be [A, {n}] on "
                                 f"{P.device}, got {tuple(amb.shape)} on "
                                 f"{amb.device}")
            self.A = amb.shape[0]
            self.amb = P.new_zeros((self.A, N))
            self.amb[:, :n] = amb
        run = big_tree(topo)
        self.P = padded_P(P, run.nnode, N)
        self.pi = pi.new_zeros((C, N))
        self.pi[:, :n] = pi
        self.topo = run
        self.nnode, self.C, self.n = run.nnode, C, n
        self.nnode_in = nnode
        self.H = codes.shape[1]
        self.ns = topo.ns

    @property
    def fused(self) -> bool:
        """B1/B2 (coded tips with a table) rather than B3/B4."""
        return self.amb is not None

    def table_args(self):
        """(amb, A, tip table TA, its row stride LA) of B1/B2's entries:
        TA [ns, C, N, LA], LA = A rounded up to whole tiles."""
        if self.A == 0:
            return None, 0, None, 0
        LA = -(-self.A // BIG_HT) * BIG_HT
        check_tip_table(self.ns, self.C, self.A, self.P.element_size(),
                        torch.cuda.get_device_properties(
                            self.P.device).total_memory, self.N)
        TA = self.P.new_empty((self.ns * self.C * self.N * LA,))
        return self.amb.data_ptr(), self.A, TA, LA


def tip_table_bytes(ns: int, C: int, n_amb: int, esize: int,
                    npad: int) -> int:
    """Bytes of B1/B2's tip table TA [ns, C, N, LA] at N = npad, LA = n_amb
    rounded up to whole tiles."""
    return ns * C * npad * (-(-n_amb // BIG_HT) * BIG_HT) * esize


def check_tip_table(ns: int, C: int, n_amb: int, esize: int,
                    mem_bytes: int, npad: int) -> None:
    """Refuse a tip table of more than 1/BIG_WORK_SHARE of the card's
    memory: it grows with the number of distinct non-one-hot tip vectors,
    a few hundred for gapped codon data but up to ns x H for soft
    partials."""
    need = tip_table_bytes(ns, C, n_amb, esize, npad)
    if need > mem_bytes // BIG_WORK_SHARE:
        raise ValueError(
            f"the tip table of {n_amb} ambiguity vectors ({ns} tips x {C} "
            f"classes) needs {need / 1e9:.2f} GB, more than 1/"
            f"{BIG_WORK_SHARE} of the card's {mem_bytes / 1e9:.1f} GB: the "
            "CUDA pruning kernels take tips with few distinct non-one-hot "
            "vectors; use the plain version (tensors on the CPU) for these")


def _suffix(dtype, npad: int) -> str:
    """The entry point's suffix: dtype and instance (`f64_n32`, ...)."""
    return f"{'f32' if dtype == torch.float32 else 'f64'}_n{npad}"


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def use_big_kernels(state_tips: bool) -> bool:
    """B3/B4 for state-code tips, B1/B2 for coded tips with ambiguity
    (`kernel_tips`), on any tree (both walk its `big_tree`)."""
    return state_tips


def big_fwd_smem(esize: int, npad: int) -> int:
    """Dynamic shared memory of a forward block (B1, B3) at N = npad: P_v
    [N][LDN]; s_v and the kept contribution [N][LDH]; the column-reduction
    scratch."""
    return (npad * ldn(npad) + 2 * npad * BIG_LDH + BIG_RED) * esize


def big_bwd_smem(esize: int, kmax: int, npad: int) -> int:
    """Dynamic shared memory of an adjoint block (B2, B4;
    pruning_tree.cuh's carve) at N = npad: per child of the tree's kmax P_k
    or its tip dP_k [N][LDN] and c_k [N][LDH]; s_k and G_k for BIG_KMAX
    children and A_v [N][LDH]; the column-reduction scratch; dpi [N]."""
    return (kmax * npad * ldn(npad)
            + (kmax + 2 * BIG_KMAX + 1) * npad * BIG_LDH
            + BIG_RED + npad) * esize


def big_tiles(H: int) -> int:
    return -(-H // BIG_HT)


def visit_tiles(ntiles: int, G: int) -> int:
    """Tiles an adjoint block takes per walk of the tree: its whole range
    of tiles, at most BIG_TMAX."""
    return min(BIG_TMAX, -(-ntiles // G))


def kernel_work(name: str, topo: Topology, C: int, H: int, n: int,
                esize: int, n_amb: int = 0,
                want_S: bool = True) -> tuple[float, float]:
    """(operations, bytes) that kernel `name` needs on these shapes: the
    products of the n real states (2 n^2 per pattern, class and product;
    a tip's contribution is a gather and its dP a scatter, no product),
    each input read once and each output written once.  The forward does
    one product per non-root internal node; the adjoint three (c_k again,
    dP_k, A_k) and reads the residual S.  S counts among B3's outputs, as
    its TPU counterpart writes it (unless the launch is one without a
    residual, `want_S` false: BEB's forward), and not among B1's: the TPU
    kernel B1 replaces computes lnf alone, S being only this design's
    hand-off to B2.  The bound is taken at the real n; called with n = N
    it gives the work of the padded instance.  B1/B2's coded tips
    with n_amb ambiguity vectors: each tip's table P amb^T needs 2 n^2 A
    per class in the forward, and folding G_k's ambiguous columns into dP_k
    as much again in the adjoint; the codes are 4 bytes a cell."""
    nint = topo.nnode - topo.ns - 1
    prod = 2.0 * n * n * H * C
    table = 2.0 * n * n * n_amb * C * topo.ns
    P_b = topo.nnode * C * n * n * esize
    tips_b = topo.ns * H * 4 + n_amb * n * esize
    S_b = big_plan(topo).n_srows * C * n * H * esize
    pi_b, lnf_b = C * n * esize, C * H * esize
    if name == "pruning_fwd":
        return nint * prod + table, P_b + tips_b + pi_b + lnf_b
    if name == "big_fwd":
        return (nint * prod + table,
                P_b + tips_b + pi_b + lnf_b + (S_b if want_S else 0))
    # in: gbar; out: dP, dpi
    return (3 * nint * prod + table,
            2 * (P_b + pi_b) + tips_b + lnf_b + S_b)


def tan_work(name: str, topo: Topology, C: int, H: int, n: int, esize: int,
             D: int, n_amb: int = 0, G: int = 1) -> tuple[float, float]:
    """(operations, bytes) of the tangent kernels for D directions, as
    `kernel_work` counts (the n real states; a tip's contribution a
    gather, its dP a scatter).  H1 (`tan_fwd`): the forward's products
    twice per direction (cd = Pd s + P sd), the tip table's tangent Pd
    amb^T; it reads P, Pd, pi, pid, the tips and S (the residual of every
    internal node, `full_plan`) and writes Sd and lnfd.  H2 (`tan_bwd`):
    per direction the three products of the adjoint with two terms each
    (cd, dPd = Gd s^T + G sd^T, Ad = Pd^T G + P^T Gd), and c and A once;
    it reads also gbar, gd and Sd, writes dPd and dpid, and writes and
    reads its G dP slabs [G, D, nnode, C, n, n] once each."""
    nint = topo.nnode - topo.ns - 1
    prod = 2.0 * n * n * H * C
    table = 2.0 * n * n * n_amb * C * topo.ns
    P_b = topo.nnode * C * n * n * esize
    tips_b = topo.ns * H * 4 + n_amb * n * esize
    S_b = full_plan(topo).n_srows * C * n * H * esize
    pi_b, lnf_b = C * n * esize, C * H * esize
    ins = (1 + D) * (P_b + pi_b) + tips_b + S_b
    if name == "tan_fwd":
        return D * (2 * nint * prod + table), ins + D * (S_b + lnf_b)
    return ((6 * D + 2) * nint * prod + (1 + D) * table,
            ins + D * (S_b + P_b + pi_b) + (1 + D) * lnf_b
            + 2 * G * D * P_b)


def bound_ms(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    return 1e3 * max(flop / PEAK_FLOPS, nbytes / PEAK_BYTES)


def big_bwd_grid(nnode: int, C: int, ntiles: int, esize: int, sms: int,
                 mem_bytes: int, work_per_block: int, npad: int) -> int:
    """Blocks along the tile axis of the adjoint (B2, B4): enough for G x C
    >= the card's SM count, at most one per tile, and fewer when the dP
    slabs (nnode x C x N x N values per g, N = npad) and workspace would
    pass 1/BIG_WORK_SHARE of the card's memory.  The card's size, not its
    free memory at the call, sets the cap: the grid fixes the slab sum
    order, and so the bits of dP."""
    per_g = (nnode * C * npad * npad + C * npad + C * work_per_block) * esize
    cap = mem_bytes // BIG_WORK_SHARE // per_g
    return max(1, min(ntiles, -(-sms // C), cap))


def tan_smem(npad: int, esize: int = 8) -> int:
    """Dynamic shared memory of an H1 or H2 block at N = npad
    (pruning_tangent.cuh: tan_smem): each child's P_k and one child's Pd_k
    [N][LDN]; each child's s_k and X_k, one child's sd_k and one more tile
    (H1 a tip's second buffer, H2 G_k) [N][LDH]; the column-reduction
    scratch."""
    return ((BIG_KMAX + 1) * npad * ldn(npad)
            + (2 * BIG_KMAX + 2) * npad * BIG_LDH + BIG_RED) * esize


def tan_blocks_per_sm(npad: int) -> int:
    """Blocks per SM the tangents' design counts on at N = npad (their
    launch bounds, pruning_tangent.cuh: TanOcc): as many float64 blocks as
    the SM's shared memory holds, 1 KB a block kept by the card."""
    return SMEM_SM // (tan_smem(npad) + 1024)


def tan_grid(ntiles: int, C: int, D: int, sms: int, npad: int,
             cap: int | None = None) -> tuple[int, int]:
    """(G, Z): the tangent kernels' grid, G tile ranges x C classes x Z
    direction groups, in one whole wave of the card's sms x
    tan_blocks_per_sm(npad) block slots.  As many tile ranges as the
    slots hold with every direction in a block (at most one a tile, at
    most `cap`); the directions split into groups only where tiles x
    classes leave slots empty (small chunks), so that the direction-
    independent part is done once per tile wherever the tiles fill the
    card.  From the card's SM count (and, by `cap`, its size) alone: the
    slabs' sum order, and so the bits, repeat."""
    slots = sms * tan_blocks_per_sm(npad)
    G = max(1, min(ntiles, slots // C, cap or ntiles))
    Z = max(1, min(D, slots // (G * C)))
    return G, Z


def tan_waves(G: int, C: int, Z: int, sms: int, npad: int) -> float:
    """Waves of a tangent grid: its blocks over the card's block slots."""
    return G * C * Z / (sms * tan_blocks_per_sm(npad))


def tan_work_per_block(D: int, Z: int, nslots: int, TV: int,
                       npad: int) -> int:
    """H2's workspace per block (pruning_tangent.cuh): the adjoint slots A
    and, for each of its ceil(D / Z) directions, Ad [nslots + 1][TV][N][BHT];
    the node's direction-independent part [TV][3][N][BHT] and [TV][BHT]."""
    dz = -(-D // Z)
    return ((1 + dz) * (nslots + 1) * TV * npad * BIG_HT
            + TV * (3 * npad + 1) * BIG_HT)


def tan_bwd_grid(nnode: int, C: int, D: int, ntiles: int, esize: int,
                 sms: int, mem_bytes: int, nslots: int,
                 npad: int) -> tuple[int, int, int]:
    """(G, Z, TV) of H2: `tan_grid`, G capped where its dPd slabs (D x
    nnode x C x N x N values per g) and workspace would pass
    1/BIG_WORK_SHARE of the card's memory; TV the tiles per visit, a
    block's whole range up to TAN_TMAX.  Fixed by the card, not by its
    free memory, so that the slabs' sum order, and so the bits, repeat."""
    per_g = (D * nnode * C * npad * npad + D * C * npad
             + C * tan_work_per_block(D, 1, nslots, TAN_TMAX, npad)) * esize
    cap = max(1, mem_bytes // BIG_WORK_SHARE // per_g)
    G, Z = tan_grid(ntiles, C, D, sms, npad, cap)
    return G, Z, min(TAN_TMAX, -(-ntiles // G))


def tip_tables_plain(P: torch.Tensor, Pdot: torch.Tensor,
                     amb: torch.Tensor, ns: int) -> torch.Tensor:
    """The plain version of the tangents' tip tables (tip_table_kernel over
    the directions): [1 + D, ns, C, N, LA], TA = P amb^T of each tip and
    class, then TAd = Pdot amb^T for each direction; P [nnode, C, N, N] and
    Pdot [D, nnode, C, N, N] padded to N, amb [A, N], LA = A rounded up to
    whole tiles (zeros past A)."""
    A, N = amb.shape
    LA = -(-A // BIG_HT) * BIG_HT
    Ps = torch.cat([P[None, :ns], Pdot[:, :ns]])
    out = Ps.new_zeros(Ps.shape[:-1] + (LA,))
    out[..., :A] = Ps @ amb.T
    return out


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _count(key: str, npad: int) -> None:
    LAUNCHES[key] += 1
    INSTANCE_LAUNCHES[f"{key}_n{npad}"] += 1


def _require_cuda(x: _Inputs) -> None:
    if not x.P.is_cuda:
        raise ValueError(f"CUDA pruning kernels take CUDA tensors, got "
                         f"P on {x.P.device}")


def _launch_fwd(x: _Inputs, want_S: bool, bp: BigPlan | None = None):
    from .. import _build

    _require_cuda(x)
    bp = bp or big_plan(x.topo)
    fs, _ = bp.device_tables(x.P.device)
    lnf = x.P.new_empty((x.C, x.H))
    S = x.P.new_empty((bp.n_srows, x.C, x.n, x.H)) if want_S else None
    ntiles = big_tiles(x.H)
    work = x.P.new_empty((ntiles * x.C * bp.nslots * x.N * BIG_HT,))
    head = (fs.data_ptr(), fs.shape[0], bp.kmax, x.P.data_ptr(),
            x.states.data_ptr())
    tail = (ntiles, x.C, x.H, x.ns, x.n, bp.nslots)
    smem = big_fwd_smem(x.P.element_size(), x.N)
    stream = _stream(x.P.device)
    lib, sfx = _build.lib(), _suffix(x.P.dtype, x.N)
    key = "pruning_fwd" if x.fused else "big_fwd"
    with torch.cuda.device(x.P.device):
        if x.fused:
            amb, A, TA, LA = x.table_args()
            err = getattr(lib, f"paml_pruning_fwd_{sfx}")(
                *head, amb, A, x.pi.data_ptr(), lnf.data_ptr(), _ptr(S),
                work.data_ptr(), _ptr(TA), *tail, LA, smem, stream)
        else:
            err = getattr(lib, f"paml_big_fwd_{sfx}")(
                *head, x.pi.data_ptr(), lnf.data_ptr(), _ptr(S),
                work.data_ptr(), *tail, smem, stream)
    _count(key, x.N)
    _build.check(err, f"{key}_n{x.N} launch")
    return lnf, S


def _check_S(x: _Inputs, S, bp: BigPlan, D: int | None = None,
             what: str = "S") -> None:
    """S (or Sd, [D, ...]) as the forward (or H1) wrote it for plan bp."""
    want = (bp.n_srows, x.C, x.n, x.H)
    if D is not None:
        want = (D,) + want
    if S is None or S.device != x.P.device or S.dtype != x.P.dtype or \
            tuple(S.shape) != want or not S.is_contiguous():
        got = None if S is None else (S.dtype, tuple(S.shape), S.device)
        raise ValueError(f"{what} must be a contiguous {x.P.dtype} {want} on "
                         f"{x.P.device}, got {got}")


def _check_cotangent(x: _Inputs, g, lead: tuple = (), what: str = "gbar"):
    """A cotangent of lnf [*lead, C, H] on P's device, in P's dtype."""
    if g.device != x.P.device or tuple(g.shape) != lead + (x.C, x.H):
        raise ValueError(f"{what} must be {list(lead + (x.C, x.H))} on "
                         f"{x.P.device}, got {tuple(g.shape)} on {g.device}")
    return g.to(x.P.dtype).contiguous()


def _launch_bwd(x: _Inputs, gbar: torch.Tensor, S: torch.Tensor,
                bp: BigPlan | None = None):
    from .. import _build

    _require_cuda(x)
    bp = bp or big_plan(x.topo)
    gbar = _check_cotangent(x, gbar)
    _check_S(x, S, bp)
    _, bs = bp.device_tables(x.P.device)
    props = torch.cuda.get_device_properties(x.P.device)
    ntiles = big_tiles(x.H)
    G = big_bwd_grid(x.nnode, x.C, ntiles, x.P.element_size(),
                     props.multi_processor_count, props.total_memory,
                     bp.work_per_block(x.N), x.N)
    tv = visit_tiles(ntiles, G)
    work = x.P.new_empty((G * x.C * (bp.nslots + 1) * tv * x.N * BIG_HT,))
    dP_slab = x.P.new_empty((G * x.nnode * x.C * x.N * x.N,))
    dpi_slab = x.P.new_empty((G * x.C * x.N,))
    dP = x.P.new_empty((x.nnode, x.C, x.n, x.n))
    dpi = x.P.new_empty((x.C, x.n))
    head = (bs.data_ptr(), bs.shape[0], bp.kmax, x.P.data_ptr(),
            x.states.data_ptr())
    slabs = (gbar.data_ptr(), S.data_ptr(), dP_slab.data_ptr(),
             dpi_slab.data_ptr(), work.data_ptr())
    tail = (G, ntiles, tv, x.C, x.H, x.ns, x.n, x.nnode, x.nnode_in,
            bp.nslots, bp.root)
    smem = big_bwd_smem(x.P.element_size(), bp.kmax, x.N)
    stream = _stream(x.P.device)
    lib, sfx = _build.lib(), _suffix(x.P.dtype, x.N)
    key = "pruning_bwd" if x.fused else "big_bwd"
    with torch.cuda.device(x.P.device):
        if x.fused:
            amb, A, TA, LA = x.table_args()
            err = getattr(lib, f"paml_pruning_bwd_{sfx}")(
                *head, amb, A, x.pi.data_ptr(), *slabs, _ptr(TA),
                dP.data_ptr(), dpi.data_ptr(), *tail, LA, smem, stream)
        else:
            err = getattr(lib, f"paml_big_bwd_{sfx}")(
                *head, x.pi.data_ptr(), *slabs, dP.data_ptr(),
                dpi.data_ptr(), *tail, smem, stream)
    _count(key, x.N)
    _build.check(err, f"{key}_n{x.N} launch")
    return dP[:x.nnode_in], dpi


def _fused_inputs(P, tips, topo, pi, npad) -> _Inputs:
    """B1/B2's inputs: state codes, TipCodes or dense partials, any of them
    as coded tips with a table (empty for state codes)."""
    tips = kernel_tips(tips)
    check_tips(tips, P.shape[-1])
    if not isinstance(tips, TipCodes):
        tips = TipCodes(tips, P.new_zeros((0, P.shape[-1])))
    return _Inputs(P, tips, topo, pi, npad)


def _big_inputs(P, tips, topo, pi, npad) -> _Inputs:
    if isinstance(tips, TipCodes) or tips.dim() != 2:
        raise ValueError("the large-tree kernels take state-code tips "
                         "[ns, H] only")
    check_state_codes(tips, P.shape[-1])
    return _Inputs(P, tips, topo, pi, npad)


def pruning_fwd(P, tips, topo: Topology, pi, want_S: bool = True, *,
                npad: int | None = None):
    """Fused forward kernel (B1): (lnf [C, H], S [n_srows, C, n, H] or
    None), S the scaled partials of the non-cherry internal nodes of
    `big_tree(topo)` (no autograd).  tips: int32 state codes [ns, H],
    TipCodes, or dense partials [ns, H, n].  `npad` forces the instance
    (32 or 64, at least n; default `padded_states(n)`)."""
    return _launch_fwd(_fused_inputs(P, tips, topo, pi, npad), want_S)


def pruning_bwd(P, tips, topo: Topology, pi, gbar, S, *,
                npad: int | None = None):
    """Fused adjoint kernel (B2): (dP [nnode, C, n, n], dpi [C, n]) for
    the cotangent gbar [C, H] of lnf, from the forward's residual S (of
    either instance: S holds the n real states)."""
    return _launch_bwd(_fused_inputs(P, tips, topo, pi, npad), gbar, S)


def pruning_big_fwd(P, tips, topo: Topology, pi, want_S: bool = True, *,
                    npad: int | None = None):
    """Large-tree forward kernel (B3) on state-code tips: (lnf [C, H], S or
    None) as `pruning_fwd`."""
    return _launch_fwd(_big_inputs(P, tips, topo, pi, npad), want_S)


def pruning_big_bwd(P, tips, topo: Topology, pi, gbar, S, *,
                    npad: int | None = None):
    """Large-tree adjoint kernel (B4) on state-code tips, as
    `pruning_bwd`."""
    return _launch_bwd(_big_inputs(P, tips, topo, pi, npad), gbar, S)


class ClassSiteLnfKernel(torch.autograd.Function):
    """lnf [C, H] from a forward kernel, which also writes the residual S
    when a gradient is wanted; the backward is the pair's adjoint reading
    S.  B3/B4 for state codes (amb None), B1/B2 for coded tips and their
    ambiguity table.  Tips are data (no gradient), their codes checked by
    the caller.  S is saved with `save_for_backward`, so a checkpointed
    chunk frees it and the forward writes it again when the backward
    recomputes the chunk."""

    @staticmethod
    def forward(ctx, P, codes, amb, topo, pi):
        want_S = ctx.needs_input_grad[0] or ctx.needs_input_grad[4]
        tips = codes if amb is None else TipCodes(codes, amb)
        lnf, S = _launch_fwd(_Inputs(P, tips, topo, pi), want_S)
        ctx.topo = topo
        ctx.save_for_backward(P, codes, amb, pi, S)
        return lnf

    @staticmethod
    @differentiable_once
    def backward(ctx, gbar):
        P, codes, amb, pi, S = ctx.saved_tensors
        tips = codes if amb is None else TipCodes(codes, amb)
        dP, dpi = _launch_bwd(_Inputs(P, tips, ctx.topo, pi), gbar, S)
        return dP, None, None, None, dpi


# ---------------------------------------------------------------------------
# the tangents (H1, H2) and the Hessian's route
# ---------------------------------------------------------------------------


def _tan_dirs(x: _Inputs, Pdot: torch.Tensor, pidot: torch.Tensor):
    """Directions (Pdot [D, nnode, C, n, n], pidot [D, C, n]) as the
    tangent kernels take them: padded to N states like P, the nodes that
    `big_tree` added given Pdot = 0 (their identity P is a constant)."""
    D = Pdot.shape[0] if Pdot.dim() == 5 else 0
    if D == 0 or tuple(Pdot.shape[1:]) != (x.nnode_in, x.C, x.n, x.n) or \
            tuple(pidot.shape) != (D, x.C, x.n):
        raise ValueError(f"directions must be Pdot [D, {x.nnode_in}, {x.C}, "
                         f"{x.n}, {x.n}] and pidot [D, {x.C}, {x.n}], got "
                         f"{tuple(Pdot.shape)} and {tuple(pidot.shape)}")
    for t in (Pdot, pidot):
        if t.device != x.P.device or t.dtype != x.P.dtype:
            raise ValueError(f"directions must be {x.P.dtype} on "
                             f"{x.P.device}, got {t.dtype} on {t.device}")
    Pp = Pdot.new_zeros((D, x.nnode, x.C, x.N, x.N))
    Pp[:, :x.nnode_in, :, :x.n, :x.n] = Pdot
    pp = pidot.new_zeros((D, x.C, x.N))
    pp[..., :x.n] = pidot
    return Pp, pp


def _tan_entry(x: _Inputs, which: str):
    from .. import _build

    _require_cuda(x)
    if x.P.dtype != torch.float64:
        raise TypeError(f"the tangent kernels take float64, got {x.P.dtype}")
    pre = "pruning_" if x.fused else "big_"
    return getattr(_build.lib(), f"paml_{pre}tan_{which}_f64_n{x.N}")


def _tan_tables(x: _Inputs, D: int):
    """(amb, A, TA workspace for 1 + D tables, LA) of the tangents' entries;
    null and 0 for state codes."""
    if x.A == 0:
        return None, 0, None, 0
    LA = -(-x.A // BIG_HT) * BIG_HT
    check_tip_table(x.ns, x.C, x.A, x.P.element_size() * (1 + D),
                    torch.cuda.get_device_properties(x.P.device).total_memory,
                    x.N)
    return x.amb.data_ptr(), x.A, \
        x.P.new_empty(((1 + D) * x.ns * x.C * x.N * LA,)), LA


def _launch_tan_fwd(x: _Inputs, Pdot, pidot, S):
    """(lnfd, Sd, the tip tables [1 + D, ns, C, N, LA] it built: TA, then
    TAd for each direction; None on state codes)."""
    from .. import _build

    fn = _tan_entry(x, "fwd")
    bp = full_plan(x.topo)
    _check_S(x, S, bp)
    Pp, pp = _tan_dirs(x, Pdot, pidot)
    D = Pp.shape[0]
    _, bs = bp.device_tables(x.P.device)
    ntiles = big_tiles(x.H)
    G, Z = tan_grid(ntiles, x.C, D, torch.cuda.get_device_properties(
        x.P.device).multi_processor_count, x.N)
    amb, A, TA, LA = _tan_tables(x, D)
    lnfd = x.P.new_empty((D, x.C, x.H))
    Sd = x.P.new_empty((D, bp.n_srows, x.C, x.n, x.H))
    with torch.cuda.device(x.P.device):
        err = fn(bs.data_ptr(), bs.shape[0], bp.kmax, x.P.data_ptr(),
                 Pp.data_ptr(), x.states.data_ptr(), amb, A, _ptr(TA), LA,
                 x.pi.data_ptr(), pp.data_ptr(), S.data_ptr(), Sd.data_ptr(),
                 lnfd.data_ptr(), D, G, Z, ntiles, x.C, x.H, x.ns, x.n,
                 x.nnode, bp.n_srows, _stream(x.P.device))
    _count("tan_fwd", x.N)
    _build.check(err, f"tan_fwd_n{x.N} launch")
    return lnfd, Sd, None if TA is None else TA.view(1 + D, x.ns, x.C, x.N,
                                                      LA)


def _launch_tan_bwd(x: _Inputs, Pdot, pidot, gbar, gdot, S, Sd):
    from .. import _build

    fn = _tan_entry(x, "bwd")
    bp = full_plan(x.topo)
    Pp, pp = _tan_dirs(x, Pdot, pidot)
    D = Pp.shape[0]
    _check_S(x, S, bp)
    _check_S(x, Sd, bp, D, "Sd")
    gbar = _check_cotangent(x, gbar)
    gdot = _check_cotangent(x, gdot, (D,), "gdot")
    _, bs = bp.device_tables(x.P.device)
    props = torch.cuda.get_device_properties(x.P.device)
    ntiles = big_tiles(x.H)
    G, Z, TV = tan_bwd_grid(x.nnode, x.C, D, ntiles, x.P.element_size(),
                            props.multi_processor_count, props.total_memory,
                            bp.nslots, x.N)
    amb, A, TA, LA = _tan_tables(x, D)
    dP_slab = x.P.new_empty((G * D * x.nnode * x.C * x.N * x.N,))
    dpi_slab = x.P.new_empty((G * D * x.C * x.N,))
    work = x.P.new_empty((Z * G * x.C * tan_work_per_block(
        D, Z, bp.nslots, TV, x.N),))
    dPd = x.P.new_empty((D, x.nnode_in, x.C, x.n, x.n))
    dpid = x.P.new_empty((D, x.C, x.n))
    with torch.cuda.device(x.P.device):
        err = fn(bs.data_ptr(), bs.shape[0], bp.kmax, x.P.data_ptr(),
                 Pp.data_ptr(), x.states.data_ptr(), amb, A, _ptr(TA), LA,
                 x.pi.data_ptr(), pp.data_ptr(), gbar.data_ptr(),
                 gdot.data_ptr(), S.data_ptr(), Sd.data_ptr(),
                 dP_slab.data_ptr(), dpi_slab.data_ptr(), work.data_ptr(),
                 dPd.data_ptr(), dpid.data_ptr(), D, G, Z, ntiles, TV, x.C,
                 x.H, x.ns, x.n, x.nnode, x.nnode_in, x.nnode_in, bp.nslots,
                 bp.n_srows, bp.root, _stream(x.P.device))
    _count("tan_bwd", x.N)
    _build.check(err, f"tan_bwd_n{x.N} launch")
    return dPd, dpid


def pruning_tan_fwd(P, tips, topo: Topology, pi, Pdot, pidot, S, *,
                    npad: int | None = None):
    """H1 on coded tips (B1/B2's walk): (lnfd [D, C, H], Sd [D, nrows, C,
    n, H]), the tangents of lnf and of the residual S along the D
    directions (Pdot [D, nnode, C, n, n], pidot [D, C, n]); S as
    `ClassSiteLnfKernelTwice`'s forward writes it (`full_plan`)."""
    return _launch_tan_fwd(_fused_inputs(P, tips, topo, pi, npad), Pdot,
                           pidot, S)[:2]


def pruning_tan_bwd(P, tips, topo: Topology, pi, gbar, Pdot, pidot, gdot, S,
                    Sd, *, npad: int | None = None):
    """H2 on coded tips: (dPd [D, nnode, C, n, n], dpid [D, C, n]), the
    tangent of the adjoint (gbar, P, pi) -> (dP, dpi) along (gdot [D, C,
    H], Pdot, pidot), from S and H1's Sd."""
    return _launch_tan_bwd(_fused_inputs(P, tips, topo, pi, npad), Pdot,
                           pidot, gbar, gdot, S, Sd)


def pruning_big_tan_fwd(P, tips, topo: Topology, pi, Pdot, pidot, S, *,
                        npad: int | None = None):
    """H1 on state-code tips (B3/B4's walk), as `pruning_tan_fwd`."""
    return _launch_tan_fwd(_big_inputs(P, tips, topo, pi, npad), Pdot,
                           pidot, S)[:2]


def pruning_big_tan_bwd(P, tips, topo: Topology, pi, gbar, Pdot, pidot,
                        gdot, S, Sd, *, npad: int | None = None):
    """H2 on state-code tips, as `pruning_tan_bwd`."""
    return _launch_tan_bwd(_big_inputs(P, tips, topo, pi, npad), Pdot,
                           pidot, gbar, gdot, S, Sd)


class ClassSiteLnfKernelTwice:
    """The pruning pass of a Hessian on one pattern chunk, differentiable
    twice through the kernels: the forward (lnf [C, H], with the residual
    of `full_plan`), its adjoint for a cotangent gbar (B2/B4:
    `adjoint`), and its second order along a batch of D directions: H1
    (`tan_fwd`: lnfd [D, C, H]) and then H2 (`tan_bwd`: (dPd, dpid) for
    the cotangent's own tangent gdot [D, C, H]), which `codeml.hessian`
    chains with autograd's derivatives of the model and of the mixture.

    Not a `torch.autograd.Function`: PyTorch's batched double backward
    (`is_grads_batched`) vmaps the engine over every backward, which
    cannot carry a ctypes launch, so the caller hands the batch of
    directions to `tan_fwd` / `tan_bwd` itself.  P and pi are float64
    and carry no graph.  CUDA tensors launch the kernels (B1/B2/H1/H2 on
    TipCodes with ambiguity, B3/B4/H1/H2 on state codes); CPU tensors run
    the plain versions (`pruning.class_site_lnf_plain`, `_bwd_plain`,
    `_tan_plain`, `_bwd_tan_plain`)."""

    def __init__(self, P, tips, topo: Topology, pi):
        from . import pruning

        self.P, self.tips, self.topo, self.pi = P, tips, topo, pi
        self.S = self.Sd = self.dirs = self.TA = None
        if P.is_cuda:
            self.x = _Inputs(P, kernel_tips(tips), topo, pi)
            self.lnf, self.S = _launch_fwd(self.x, True,
                                           full_plan(self.x.topo))
        else:
            with torch.no_grad():
                self.lnf = pruning.class_site_lnf_plain(P, tips, topo, pi)

    def adjoint(self, gbar):
        """(dP [nnode, C, n, n], dpi [C, n]) for the cotangent gbar."""
        from . import pruning

        if self.P.is_cuda:
            return _launch_bwd(self.x, gbar, self.S, full_plan(self.x.topo))
        return pruning.class_site_lnf_bwd_plain(self.P, self.tips, self.topo,
                                                self.pi, gbar)

    def tan_fwd(self, Pdot, pidot):
        """H1: lnfd [D, C, H] along (Pdot [D, nnode, C, n, n], pidot [D, C,
        n]); the directions and Sd are kept for `tan_bwd`, and on the card
        the tip tables H1 built (`TA`, None on state codes) until then."""
        from . import pruning

        self.dirs = (Pdot, pidot)
        if self.P.is_cuda:
            lnfd, self.Sd, self.TA = _launch_tan_fwd(self.x, Pdot, pidot,
                                                     self.S)
        else:
            lnfd, self.Sd = pruning.class_site_lnf_tan_plain(
                self.P, self.tips, self.topo, self.pi, Pdot, pidot)
        return lnfd

    def tan_bwd(self, gbar, gdot):
        """H2 along `tan_fwd`'s directions and gdot [D, C, H]: (dPd [D,
        nnode, C, n, n], dpid [D, C, n]); frees Sd."""
        from . import pruning

        (Pdot, pidot), Sd = self.dirs, self.Sd
        self.dirs = self.Sd = self.TA = None
        if self.P.is_cuda:
            return _launch_tan_bwd(self.x, Pdot, pidot, gbar, gdot, self.S,
                                   Sd)
        return pruning.class_site_lnf_bwd_tan_plain(
            self.P, self.tips, self.topo, self.pi, gbar, Pdot, pidot, gdot)
