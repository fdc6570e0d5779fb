"""Felsenstein pruning: the plain PyTorch version and the public dispatch.

Port of the level path of `paml_tpu/core/pruning.py` (reference:
`ConditionalPNode`, src/codeml.c:3526, with `NodeScale`,
src/treesub.c:7200).  The tree is grouped into depth levels; each node's
upward contribution c_v = P_v s_v is one batched einsum per level, a
parent's partial is the product of its children's contributions followed
by a per-(class, pattern) max-rescale accumulated in log space.  The
gradient is the analytic inside/outside adjoint (`_lnf_lvl_bwd`), the
backward of a `torch.autograd.Function`.

`class_site_lnf` is the entry point.  A CUDA tensor of nucleotides (n <
16 states) takes the level path on the card, counted in `LEVEL_CALLS`,
as the JAX package keeps such data off its kernels; any other CUDA tensor
goes to the hand written kernels in `cuda_pruning` (launched, or an error
raised): the large-tree pair B3/B4 for state-code tips, the fused pair
B1/B2 for tips with any ambiguity (`cuda_pruning.use_big_kernels`); a CPU
tensor goes to the plain version here.  The plain versions run on any device, so the
kernels can be held against them on the card: `class_site_lnf_plain` and
`class_site_lnf_bwd_plain` (the level path), `class_site_lnf_big_plain`
and `class_site_lnf_big_bwd_plain` (the kernels' inputs and outputs,
residual S included).
Each call with a CUDA tensor adds one to `PLAIN_CALLS["cuda"]`, so a run
can show that its main path never took them there.  These paths are
differentiable once (`pmat.differentiable_once`); `class_site_lnf_twice` is
the level pass under plain autograd, for Hessians, with a count of its own
(`TWICE_CALLS`).

Under `set_pattern_mesh` the pattern axis of `class_site_lnf` is cut over
the devices and ranks of a `parallel.sharding.Mesh`, each slice taking
the one-device dispatch above.

`lnL_chunked` evaluates the pattern axis in chunks, each checkpointed, so
that memory holds one chunk's buffers (the JAX package's `lnL_chunked`).
`lnL_levels_batched` is the level path's forward alone with a leading
axis over data sets on one tree (mcmctree's loci).

Shapes (the JAX package's layout):
  tips:  [ns, H] integer state codes, [ns, H, n] (multi-)hot partials, or
         `TipCodes` (codes and an ambiguity table; expanded to the
         partials by the plain versions)
  P:     [nnode, C, n, n]  row j = parent state: c[j, h] = sum_i P[j, i] s[i, h]
  pi:    [C, n]            per-class root frequencies
  out:   per-(class, pattern) log site likelihood [C, H]
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import cuda_pruning
from .pmat import differentiable_once
from .tipcodes import TipCodes
from .topology import Topology

_GRAD_CAP = 1e12       # adjoint clip at absurd line-search trial points
_BIG = 1e30            # nan_to_num bound on dP and dpi

PLAIN_CALLS = {"cuda": 0}
TWICE_CALLS = {"cuda": 0}     # the Hessian route's calls, counted apart
LEVEL_CALLS = {"cuda": 0}     # the 4-state route's calls on the card

# below this many states a CUDA tensor takes the level path on the card
# (`class_site_lnf_levels`), as the JAX package's dispatch does
LEVEL_MAX_STATES = 16

# ---------------------------------------------------------------------------
# static schedules
# ---------------------------------------------------------------------------


def _levels(topo: Topology):
    """Group internal nodes into depth levels (children strictly below).

    Returns a list of levels; each level is a list of (node, kids-tuple)."""
    cached = getattr(topo, "_levels_cache", None)
    if cached is not None:
        return cached
    depth = np.zeros(topo.nnode, dtype=np.int64)
    kids_of = {}
    for v in topo.postorder:
        kids = tuple(int(c) for c in topo.children[v] if c >= 0)
        kids_of[int(v)] = kids
        depth[v] = 1 + max(depth[k] for k in kids)
    out = []
    for d in range(1, int(depth[topo.postorder].max()) + 1):
        lv = [(int(v), kids_of[int(v)]) for v in topo.postorder
              if depth[v] == d]
        if lv:
            out.append(lv)
    topo._levels_cache = out
    return out


def _arity_groups(level):
    """Split a level's [(node, kids)] by arity -> {K: [(node, kids)]}."""
    groups: dict[int, list] = {}
    for node, kids in level:
        groups.setdefault(len(kids), []).append((node, kids))
    return groups


# ---------------------------------------------------------------------------
# level path
# ---------------------------------------------------------------------------


def _is_state_tips(tips: torch.Tensor) -> bool:
    """Integer [ns, H] state codes (clean data) instead of [ns, H, n]
    partials?  State codes turn the tip product into a gather."""
    return tips.dim() == 2


def _tipsT_of(tips, dtype) -> torch.Tensor:
    if isinstance(tips, TipCodes):
        tips = tips.dense(dtype)
    if _is_state_tips(tips):
        return tips.long()
    return tips.to(dtype).transpose(-1, -2)


def _tip_contribs(P, tipsT, topo: Topology):
    """Every tip's upward contribution [ns, C, n, H] at once."""
    ns = topo.ns
    C, n = P.shape[1], P.shape[3]
    if _is_state_tips(tipsT):
        # ctip[t, c, j, h] = P[t, c, j, states[t, h]]
        H = tipsT.shape[1]
        idx = tipsT[:, None, None, :].expand(ns, C, n, H)
        return torch.gather(P[:ns], 3, idx)
    return torch.einsum("tih,tcji->tcjh", tipsT, P[:ns])


def _forward_levels(P, tipsT, topo: Topology, stored=None):
    """Upward level sweep, every internal node rescaled.  Returns (s, m,
    c): node -> scaled partial [C, n, H] (internal nodes), node -> scale
    factor [C, H], node -> contribution [C, n, H] (every node but the
    root).  `stored` maps nodes to scaled partials taken as given (the
    residual rows of the large-tree adjoint); the scale factors are still
    recomputed from the children."""
    stored = stored or {}
    # `unbind` rather than one index per node: under autograd (the Hessian
    # route) an index's backward writes a zero tensor of the whole stack,
    # so a level of W nodes (or the ns tips) would move W times its size
    c = dict(enumerate(_tip_contribs(P, tipsT, topo).unbind(0)))
    s: dict[int, torch.Tensor] = {}
    m: dict[int, torch.Tensor] = {}
    for level in _levels(topo):
        emit_nodes, emit_vals = [], []
        for K, grp in _arity_groups(level).items():
            W = len(grp)
            kid_c = torch.stack([c[k] for _, kids in grp for k in kids])
            kid_c = kid_c.reshape((W, K) + kid_c.shape[1:])   # [W,K,C,n,H]
            kid_c = kid_c.unbind(1)
            prod = kid_c[0]
            for k in range(1, K):
                prod = prod * kid_c[k]                        # [W,C,n,H]
            # the scale cancels in lnf: a constant to autograd
            mm = prod.detach().amax(dim=-2)                   # [W,C,H]
            msafe = torch.where(mm > 0, mm, torch.ones_like(mm))
            sv = (prod / msafe[..., None, :]).unbind(0)
            for w, (node, _) in enumerate(grp):
                s[node] = stored[node] if node in stored else sv[w]
                m[node] = msafe[w]
                if node != topo.root:
                    emit_nodes.append(node)
                    emit_vals.append(s[node])
        if emit_nodes:
            S = torch.stack(emit_vals)                        # [W,C,n,H]
            Pn = P[_index(topo, emit_nodes, P.device)]
            cv = torch.einsum("wcih,wcji->wcjh", S, Pn).unbind(0)
            for w, node in enumerate(emit_nodes):
                c[node] = cv[w]
    return s, m, c


def _index(topo: Topology, values: list, device) -> torch.Tensor:
    """The list of node numbers (or flags) `values` as a tensor on
    `device`, made once per tree and device: an evaluation then copies
    nothing from the host (a CUDA graph cannot record the copy)."""
    cache = topo.__dict__.setdefault("_index_cache", {})
    # the element type in the key: flags (True, False) equal nodes (1, 0)
    key = (tuple(values), tuple(type(v) for v in values), str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(values, device=device)
    return cache[key]


def root_partials(P, tips, topo: Topology):
    """Per-class root partials [C, H, n] and per-(class, pattern) log scale
    [C, H] (the JAX package's `root_partials`): the level sweep's scaled
    partial of the root and the sum of every internal node's log scale
    factor, so that the conditional likelihood of the root's states is
    exp(logscale) x partials."""
    s, m, _ = _forward_levels(P, _tipsT_of(tips, P.dtype), topo)
    return (s[topo.root].transpose(-1, -2),
            torch.log(torch.stack(list(m.values()))).sum(0))


def _root_F(s_root, pi):
    F = torch.einsum("cnh,cn->ch", s_root, pi)
    return torch.clamp_min(F, torch.finfo(F.dtype).tiny)


def _lnf_from(m, F):
    return torch.log(F) + torch.log(torch.stack(list(m.values()))).sum(0)


def _lnf_lvl_bwd(topo: Topology, P, tipsT, s, m, c, F, pi, gbar):
    """Analytic inside/outside adjoint: one downward sweep -> (dP, dpi)."""
    ns = topo.ns
    n_own = getattr(topo, "n_own", topo.nnode)
    dtype = P.dtype
    C, n = P.shape[1], P.shape[3]
    state_tips = _is_state_tips(tipsT)
    H = gbar.shape[1]

    def tip_onehotT(k):
        if state_tips:
            return torch.nn.functional.one_hot(tipsT[k], n).to(dtype).T
        return tipsT[k]

    A = {topo.root: gbar[:, None, :] * pi[:, :, None] / F[:, None, :]}
    dP: dict[int, torch.Tensor] = {}
    for level in reversed(_levels(topo)):
        for K, grp in _arity_groups(level).items():
            W = len(grp)
            kid_c = torch.stack([c[k] for _, kids in grp for k in kids])
            kid_c = kid_c.reshape(W, K, C, n, H)
            # leave-one-out products over the child axis
            pre = [torch.ones_like(kid_c[:, 0])]
            for k in range(1, K):
                pre.append(pre[-1] * kid_c[:, k - 1])
            suf = [torch.ones_like(kid_c[:, 0])]
            for k in range(K - 2, -1, -1):
                suf.insert(0, suf[0] * kid_c[:, k + 1])
            loo = torch.stack([pre[k] * suf[k] for k in range(K)], dim=1)
            Av = torch.stack([A[node] for node, _ in grp])      # [W,C,n,H]
            mv = torch.stack([m[node] for node, _ in grp])      # [W,C,H]
            G = Av[:, None] * loo / mv[:, None, :, None, :]     # [W,K,C,n,H]
            kidflat = [k for _, kids in grp for k in kids]
            # keep the adjoint finite at absurd line-search trial points;
            # a node that `cuda_pruning.big_tree` added keeps its G (NaN ->
            # 0 alone), as in the kernels (`clip_adjoint`)
            own = [k < n_own for k in kidflat]
            Gc = torch.clamp(torch.nan_to_num(G, nan=0.0, posinf=_GRAD_CAP,
                                              neginf=-_GRAD_CAP),
                             -_GRAD_CAP, _GRAD_CAP)
            if not all(own):
                keep = _index(topo, own, G.device).reshape(W, K, 1, 1, 1)
                Gc = torch.where(keep, Gc, torch.nan_to_num(
                    G, nan=0.0, posinf=float("inf"), neginf=float("-inf")))
            G = Gc
            U = torch.stack([
                (tip_onehotT(k)[None].expand(C, n, H) if k < ns else s[k])
                for k in kidflat]).reshape(W, K, C, n, H)
            dPk = torch.einsum("wkcjh,wkcih->wkcji", G, U)
            Pk = P[_index(topo, kidflat, P.device)]
            Ak = torch.einsum("wkcjh,wkcji->wkcih", G,
                              Pk.reshape(W, K, C, n, n))
            for w, (_, kids) in enumerate(grp):
                for k, kid in enumerate(kids):
                    dP[kid] = dPk[w, k]
                    if kid >= ns:
                        A[kid] = Ak[w, k]
    zero = torch.zeros((C, n, n), dtype=dtype, device=P.device)
    dP_all = torch.stack([dP.get(v, zero) for v in range(topo.nnode)])
    dpi = torch.einsum("ch,cnh->cn", gbar / F, s[topo.root])
    dP_all = torch.nan_to_num(dP_all, nan=0.0, posinf=_BIG, neginf=-_BIG)
    dpi = torch.nan_to_num(dpi, nan=0.0, posinf=_BIG, neginf=-_BIG)
    return dP_all, dpi


class _ClassSiteLnfLvl(torch.autograd.Function):

    @staticmethod
    def forward(ctx, P, tips, topo, pi):
        tipsT = _tipsT_of(tips, P.dtype)
        s, m, c = _forward_levels(P, tipsT, topo)
        F = _root_F(s[topo.root], pi)
        ctx.topo = topo
        ctx.res = (P, tipsT, s, m, c, F, pi)
        return _lnf_from(m, F)

    @staticmethod
    @differentiable_once
    def backward(ctx, gbar):
        dP, dpi = _lnf_lvl_bwd(ctx.topo, *ctx.res, gbar.contiguous())
        del ctx.res
        return dP, None, None, dpi


def class_site_lnf_levels(P, tips, topo: Topology, pi):
    """The 4-state route: the level path and its analytic adjoint as
    tensor operations, on whatever device P lies, each call on the card
    counted in `LEVEL_CALLS` (apart from `PLAIN_CALLS`).  The JAX package
    keeps the same work off its kernels: `maybe_pallas_lnf` returns None
    below 16 states (paml_tpu/core/pallas_pruning.py:687, "einsum path is
    already fine"), while the port's kernels pad every state count to at
    least N = 32 (`cuda_pruning.padded_states`): 64 times the products
    that 4 states need."""
    if P.is_cuda:
        LEVEL_CALLS["cuda"] += 1
    return _ClassSiteLnfLvl.apply(P, tips, topo, pi)


def _count_plain(P):
    if P.is_cuda:
        PLAIN_CALLS["cuda"] += 1


def class_site_lnf_plain(P, tips, topo: Topology, pi):
    """The plain version: per-(class, pattern) log site likelihood [C, H],
    differentiable in P and pi through the analytic adjoint."""
    _count_plain(P)
    return _ClassSiteLnfLvl.apply(P, tips, topo, pi)


def class_site_lnf_twice(P, tips, topo: Topology, pi):
    """The level pass under plain autograd: lnf [C, H], differentiable any
    number of times in P and pi (the analytic adjoints and the kernels are
    differentiable once).  The Hessian of `codeml.standard_errors` is its
    one caller; on the card it is the one place where the plain version
    runs inside a program, so its calls have their own count."""
    if P.is_cuda:
        TWICE_CALLS["cuda"] += 1
    s, m, _ = _forward_levels(P, _tipsT_of(tips, P.dtype), topo)
    return _lnf_from(m, _root_F(s[topo.root], pi))


def class_site_lnf_bwd_plain(P, tips, topo: Topology, pi, gbar):
    """The plain adjoint as a function: (dP [nnode, C, n, n], dpi [C, n])
    for the cotangent gbar [C, H] of lnf (forward recomputed)."""
    _count_plain(P)
    with torch.no_grad():
        tipsT = _tipsT_of(tips, P.dtype)
        s, m, c = _forward_levels(P, tipsT, topo)
        F = _root_F(s[topo.root], pi)
        return _lnf_lvl_bwd(topo, P, tipsT, s, m, c, F, pi, gbar)


def class_site_lnf_big_plain(P, tips, topo: Topology, pi):
    """The plain version of the forward kernels (B3, B1): (lnf [C, H],
    S [n_srows, C, n, H]), S the scaled partials of the non-cherry
    internal nodes in residual-row order, every internal node rescaled."""
    _count_plain(P)
    with torch.no_grad():
        s, m, _ = _forward_levels(P, _tipsT_of(tips, P.dtype), topo)
        F = _root_F(s[topo.root], pi)
        S = torch.stack([s[v] for v in cuda_pruning.big_plan(topo).srow_nodes])
        return _lnf_from(m, F), S


def class_site_lnf_big_bwd_plain(P, tips, topo: Topology, pi, gbar, S):
    """The plain version of the adjoint kernels (B4, B2): (dP [nnode, C,
    n, n], dpi [C, n]) for the cotangent gbar [C, H] of lnf.  The scaled
    partials come from the residual rows S, the cherries' are rebuilt from
    their tips, and the contributions and scale factors are recomputed
    from them, as in the kernels."""
    _count_plain(P)
    with torch.no_grad():
        rows = cuda_pruning.big_plan(topo).srow_nodes
        tipsT = _tipsT_of(tips, P.dtype)
        s, m, c = _forward_levels(P, tipsT, topo, dict(zip(rows, S)))
        F = _root_F(s[topo.root], pi)
        return _lnf_lvl_bwd(topo, P, tipsT, s, m, c, F, pi, gbar)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


# The pattern mesh (`parallel/sharding.py`): None, or a `sharding.Mesh`
# over which `class_site_lnf` cuts the pattern axis.  This is where the
# JAX package shard_maps the pass (paml_tpu/core/pruning.py:588-634): P and
# pi replicated, tips and lnf split on the pattern axis, so that every
# caller (codeml, baseml, the clocks, BEB's forward, the level route)
# inherits it.
_pattern_mesh = None


def set_pattern_mesh(mesh) -> None:
    """Cut the pattern axis of `class_site_lnf` over `mesh` (a
    `parallel.sharding.Mesh`); None disengages it."""
    global _pattern_mesh
    _pattern_mesh = mesh


def pattern_mesh():
    """The engaged pattern mesh, or None."""
    return _pattern_mesh


def _n_patterns(tips) -> int:
    return (tips.codes if isinstance(tips, TipCodes) else tips).shape[1]


def _tip_shards(tips, mesh, kernel: bool):
    """This process's slices of tips for `mesh`, each on its device: one
    contiguous pattern range per mesh device (`Mesh.local_bounds`).  With
    `kernel` (CUDA tensors at LEVEL_MAX_STATES states or more) the tips are
    coded for the kernels first, so that dense partials are coded once
    for the whole axis (`cuda_pruning.kernel_tips`).  Made once per tips
    object and cached on it (codes, like the objectives' tips, are checked
    once and never re-coded per evaluation); a tensor changed in place is
    sliced again."""
    key = (mesh, kernel)
    version = None if isinstance(tips, TipCodes) else tips._version
    hit = tips.shards if isinstance(tips, TipCodes) else \
        getattr(tips, "_pattern_shards", None)
    if hit is not None and hit[0] == key and hit[1] == version:
        return hit[2]
    src = cuda_pruning.kernel_tips(tips) if kernel else tips
    b = mesh.local_bounds(_n_patterns(tips))
    parts = []
    for d, lo, hi in zip(mesh.devices, b, b[1:]):
        if isinstance(src, TipCodes):
            parts.append(TipCodes(src.codes[:, lo:hi].contiguous().to(d),
                                  src.amb.to(d)))
        else:
            parts.append(src[:, lo:hi].contiguous().to(d))
    hit = (key, version, parts)
    if isinstance(tips, TipCodes):
        tips.shards = hit
    else:
        tips._pattern_shards = hit
    return parts


def _class_site_lnf_sharded(P, tips, topo: Topology, pi, mesh):
    """lnf [C, H] with the pattern axis cut over `mesh`: each device runs
    the one-device dispatch on its slice (kernel launches are
    asynchronous, so the cards work side by side), and lnf comes back in
    pattern order on P's device; autograd carries dP and dpi home through
    the device copies.  Under a process group each rank computes its own
    slice and lnf is all-gathered, so every rank computes the same
    downstream; the cotangent of each rank's slice gives its share of dP
    and dpi, summed over the ranks (`distributed.sum_grad`)."""
    kernel = P.is_cuda and P.shape[-1] >= LEVEL_MAX_STATES
    parts = _tip_shards(tips, mesh, kernel)
    if mesh.group is not None:
        from ..parallel import distributed
        P, pi = distributed.sum_grad(P, mesh), distributed.sum_grad(pi, mesh)
    outs = [_class_site_lnf_local(P.to(d), t, topo, pi.to(d)).to(P.device)
            for d, t in zip(mesh.devices, parts)]
    lnf = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if mesh.group is not None:
        lnf = distributed.gather_patterns(lnf, mesh, _n_patterns(tips))
    return lnf


def class_site_lnf(P, tips, topo: Topology, pi):
    """Per-(class, pattern) log site likelihood [C, H].

    Under `set_pattern_mesh` the pattern axis is cut over the mesh's
    devices and ranks (`_class_site_lnf_sharded`) when it has at least one
    pattern per shard: the shards need not be equal (the JAX package pads
    to equal shards and shards only when H divides by their number); the
    port has no batched calls here (mcmctree's loci take
    `lnL_levels_batched`).  Each shard, or the whole axis, then takes the
    one-device dispatch below.

    A CUDA tensor of fewer than LEVEL_MAX_STATES states (nucleotides) runs
    the level path as tensor operations on the card
    (`class_site_lnf_levels`).  Any other CUDA tensor runs the hand-written
    kernels (`cuda_pruning`), which launch or raise; their codes must lie
    in [0, n + A)
    (`cuda_pruning.check_tips`, which the codeml objective runs once).
    Dense partials are coded first (`cuda_pruning.kernel_tips`).  A CPU
    tensor runs the plain version.  Gradients w.r.t. P and pi through the
    analytic adjoint; tips are data."""
    mesh = _pattern_mesh
    if mesh is not None and _n_patterns(tips) >= mesh.n_shards:
        return _class_site_lnf_sharded(P, tips, topo, pi, mesh)
    return _class_site_lnf_local(P, tips, topo, pi)


def _class_site_lnf_local(P, tips, topo: Topology, pi):
    """`class_site_lnf` on P's device alone."""
    if P.device.type == "cuda":
        if P.shape[-1] < LEVEL_MAX_STATES:
            return class_site_lnf_levels(P, tips, topo, pi)
        tips = cuda_pruning.kernel_tips(tips)
        if cuda_pruning.use_big_kernels(not isinstance(tips, TipCodes)):
            return cuda_pruning.ClassSiteLnfKernel.apply(P, tips, None, topo,
                                                         pi)
        return cuda_pruning.ClassSiteLnfKernel.apply(P, tips.codes, tips.amb,
                                                     topo, pi)
    if P.device.type != "cpu":
        raise ValueError(f"class_site_lnf: no path for device {P.device}")
    return class_site_lnf_plain(P, tips, topo, pi)


def site_loglik(P, tips, topo: Topology, pi, class_w,
                lnf=class_site_lnf) -> torch.Tensor:
    """Per-pattern log-likelihood [H], mixing site classes with weights
    class_w [C] (reference: `lfundG`, src/treesub.c:7608)."""
    lnf_c = lnf(P, tips, topo, pi) + torch.log(class_w)[:, None]
    return torch.logsumexp(lnf_c, dim=0)


def lnL(P, tips, topo: Topology, pi, class_w, fpatt,
        lnf=class_site_lnf) -> torch.Tensor:
    """Total log-likelihood sum_h fpatt[h] ln f_h (reference: `lfun`,
    src/treesub.c:7764).  `lnf` is the pruning pass: `class_site_lnf`, or
    `class_site_lnf_twice` for second derivatives."""
    return torch.sum(fpatt * site_loglik(P, tips, topo, pi, class_w, lnf))


def split_patterns(tips, fpatt, n_chunks: int):
    """The pattern axis of tips ([ns, H(, n)], or TipCodes) and fpatt [H]
    in n_chunks equal chunks, each contiguous: (tips chunks, fpatt
    chunks).  Pad the patterns (fpatt 0) to a multiple of n_chunks
    first."""
    codes = tips.codes if isinstance(tips, TipCodes) else tips
    H = codes.shape[1]
    if H % n_chunks:
        raise ValueError(f"{H} patterns do not split into {n_chunks} equal "
                         "chunks: pad them to a multiple of n_chunks")
    w = H // n_chunks
    chunks = tips.split(w) if isinstance(tips, TipCodes) else \
        [t.contiguous() for t in tips.split(w, dim=1)]
    return chunks, [f.contiguous() for f in fpatt.split(w)]


def lnL_chunked(P, tips_chunks, topo: Topology, pi, class_w,
                fpatt_chunks) -> torch.Tensor:
    """Total log-likelihood with the pattern axis in chunks (from
    `split_patterns`).  Each chunk is checkpointed: its forward keeps no
    buffers and is recomputed in the backward, so memory holds one
    chunk's buffers (reference: `lnL_chunked`,
    paml_tpu/core/pruning.py:670).  Nothing in a chunk draws random
    numbers, so the checkpoint keeps no RNG state: saving it reads the
    card's generator on the host, which a CUDA graph cannot record."""
    total = None
    for tp, fp in zip(tips_chunks, fpatt_chunks):
        v = checkpoint(lnL, P, tp, topo, pi, class_w, fp, use_reentrant=False,
                       preserve_rng_state=False)
        total = v if total is None else total + v
    return total


def _batched_plan(topo: Topology, device):
    """The level schedule of `lnL_levels_batched` as index tensors on
    `device`, built once per tree and device: per arity group (arity,
    width, the children [W * K], the non-root nodes, their rows in the
    group, the root's row or None)."""
    cache = topo.__dict__.setdefault("_batched_plan_cache", {})
    key = str(device)
    if key not in cache:
        plan = []
        for level in _levels(topo):
            for K, grp in _arity_groups(level).items():
                nodes = [v for v, _ in grp]
                rows = [w for w, v in enumerate(nodes) if v != topo.root]

                def t(a):
                    return torch.as_tensor(a, dtype=torch.long, device=device)
                plan.append((K, len(grp), t([k for _, ks in grp for k in ks]),
                             t([nodes[w] for w in rows]), t(rows),
                             nodes.index(topo.root) if topo.root in nodes
                             else None))
        cache[key] = plan
    return cache[key]


def lnL_levels_batched(P, tips, topo: Topology, pi, class_w, fpatt):
    """Log-likelihoods of G data sets on one tree, values only: the level
    path with a leading axis over the data sets (mcmctree's loci, which
    the JAX package evaluates as one `jax.vmap` of `lnL`,
    paml_tpu/apps/mcmctree.py:1272).  P [G, nnode, C, n, n], tips [G, ns,
    H, n] partials (a data set with fewer patterns padded with all-ones
    cells), pi [G, C, n], class_w [G, C], fpatt [G, H] (0 on padding) ->
    lnL [G].  Every node's contribution lives in one [G, nnode, C, n, H]
    buffer; no autograd graph; each call on the card counts in
    `LEVEL_CALLS`."""
    if P.is_cuda:
        LEVEL_CALLS["cuda"] += 1
    with torch.inference_mode():
        G, nnode, C, n = P.shape[:4]
        ns, H = topo.ns, tips.shape[2]
        c = P.new_empty((G, nnode, C, n, H))
        c[:, :ns] = torch.einsum("gthi,gtcji->gtcjh", tips.to(P.dtype),
                                 P[:, :ns])
        logm = P.new_zeros((G, C, H))
        s_root = None
        for K, W, kids, nodes, rows, root_row in _batched_plan(topo,
                                                                P.device):
            kid_c = c.index_select(1, kids).reshape(G, W, K, C, n, H)
            prod = kid_c[:, :, 0]
            for k in range(1, K):
                prod = prod * kid_c[:, :, k]              # [G, W, C, n, H]
            mm = prod.amax(dim=-2)                        # [G, W, C, H]
            msafe = torch.where(mm > 0, mm, torch.ones_like(mm))
            logm += torch.log(msafe).sum(1)
            sv = prod / msafe[..., None, :]
            if root_row is not None:
                s_root = sv[:, root_row]
                sv = sv.index_select(1, rows)
            if nodes.numel():
                c.index_copy_(1, nodes, torch.einsum(
                    "gwcih,gwcji->gwcjh", sv, P.index_select(1, nodes)))
        F = torch.einsum("gcnh,gcn->gch", s_root, pi)
        F = torch.clamp_min(F, torch.finfo(F.dtype).tiny)
        lnf = torch.log(F) + logm + torch.log(class_w)[..., None]
        return (fpatt * torch.logsumexp(lnf, dim=1)).sum(-1)


def site_class_posterior(P, tips, topo: Topology, pi, class_w):
    """Posterior P(class | pattern) [C, H] (NEB; reference: lfunNSsites_rate,
    src/codeml.c:5241)."""
    lnf_c = class_site_lnf(P, tips, topo, pi) + torch.log(class_w)[:, None]
    return torch.softmax(lnf_c, dim=0)
