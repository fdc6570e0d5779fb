"""Parsimony engine: Fitch scores, informative sites (reference: MPScore /
UpPass / DownPass, src/treesub.c:5417-5642; MPInformSites :1813).

Port of `paml_tpu/apps/parsimony.py` (numpy on the host).  State sets are
bitmasks and the up-pass is vectorized over all site patterns at once.
The bitmasks are uint32, as there: for 61 codon states the states from 32
on get no bit of their own, so codon scores are not Fitch's; the port
keeps the JAX package's bits so that tree searches start from the same
trees (ROADMAP C).
"""
from __future__ import annotations

import numpy as np

from ..core.topology import Topology
from ..io import seqio


def _tip_bitmasks(data: seqio.PackedData) -> np.ndarray:
    """[ns, H] uint32 bitmask of compatible states per tip/pattern."""
    bits = (data.tip_partials > 0).astype(np.uint32)
    weights = (1 << np.arange(data.nstates, dtype=np.uint32))
    return (bits * weights[None, None, :]).sum(-1).astype(np.uint32)


def mp_score(topo: Topology, data: seqio.PackedData) -> float:
    """Fitch parsimony score (weighted by pattern counts)."""
    masks = _tip_bitmasks(data)
    H = data.npatt
    buf = np.zeros((topo.nnode, H), dtype=np.uint32)
    buf[:topo.ns] = masks
    changes = np.zeros(H, dtype=np.int64)
    for node in topo.postorder:
        kids = [c for c in topo.children[node] if c >= 0]
        acc = buf[kids[0]]
        for c in kids[1:]:
            inter = acc & buf[c]
            nz = inter != 0
            changes += (~nz).astype(np.int64)
            acc = np.where(nz, inter, acc | buf[c])
        buf[node] = acc
    return float((changes * data.fpatt).sum())


def informative_sites(data: seqio.PackedData) -> np.ndarray:
    """Boolean per pattern: parsimony-informative (>= 2 states each seen in
    >= 2 sequences; reference MPInformSites, src/treesub.c:1813)."""
    resolved = data.tip_partials.sum(-1) == 1
    states = data.tip_partials.argmax(-1)
    H = data.npatt
    out = np.zeros(H, dtype=bool)
    for h in range(H):
        vals, counts = np.unique(states[resolved[:, h], h],
                                 return_counts=True)
        out[h] = (counts >= 2).sum() >= 2
    return out


def site_change_counts(topo: Topology, data: seqio.PackedData) -> np.ndarray:
    """Minimum change count per pattern (Fitch)."""
    masks = _tip_bitmasks(data)
    H = data.npatt
    buf = np.zeros((topo.nnode, H), dtype=np.uint32)
    buf[:topo.ns] = masks
    changes = np.zeros(H, dtype=np.int64)
    for node in topo.postorder:
        kids = [c for c in topo.children[node] if c >= 0]
        acc = buf[kids[0]]
        for c in kids[1:]:
            inter = acc & buf[c]
            nz = inter != 0
            changes += (~nz).astype(np.int64)
            acc = np.where(nz, inter, acc | buf[c])
        buf[node] = acc
    return changes


def pathway_mp(topo: Topology, data: seqio.PackedData, max_paths: int = 256):
    """Enumerate the most-parsimonious reconstructions per site pattern
    (Hartigan 1973; reference: PathwayMP, src/treesub.c:5642).

    Returns a list over patterns of dicts with `n_changes`, `n_paths`
    (exact count via the counting DP), and `paths` — up to `max_paths`
    internal-state assignments [n_internal] in node order ns..nnode-1.
    """
    n = data.nstates
    states = np.argmax(data.tip_partials, axis=-1)       # clean data
    BIG = 10 ** 9
    internals = list(topo.postorder)
    out = []
    for h in range(data.npatt):
        cost = {}
        cnt = {}
        for tip in range(topo.ns):
            c = np.full(n, BIG)
            c[states[tip, h]] = 0
            cost[tip] = c
            cnt[tip] = (c == 0).astype(object)
        for v in internals:
            kids = [int(k) for k in topo.children[v] if k >= 0]
            cv = np.zeros(n)
            ct = np.ones(n, dtype=object)
            for k in kids:
                # min over child state t of cost[k][t] + (t != s)
                trans = cost[k][None, :] + (1 - np.eye(n))
                best = trans.min(1)
                cv = cv + best
                # count of optimal child states per parent state
                mult = np.array(
                    [sum(cnt[k][t] for t in range(n)
                         if trans[s, t] == best[s]) for s in range(n)],
                    dtype=object)
                ct = ct * mult
            cost[v] = cv
            cnt[v] = ct
        root = topo.root
        mc = int(cost[root].min())
        n_paths = int(sum(cnt[root][s] for s in range(n)
                          if cost[root][s] == mc))

        # materialize up to max_paths assignments top-down
        paths = []

        def expand(assign, order_idx):
            if len(paths) >= max_paths:
                return
            if order_idx == len(preorder_int):
                paths.append([assign[v] for v in
                              range(topo.ns, topo.nnode)])
                return
            v = preorder_int[order_idx]
            par = int(topo.parent[v])
            if par == -1:
                choices = [s for s in range(n)
                           if cost[v][s] == mc]
            else:
                ps = assign[par]
                trans = cost[v] + (np.arange(n) != ps)
                best = trans.min()
                choices = [s for s in range(n) if trans[s] == best]
            for s in choices:
                assign[v] = s
                expand(assign, order_idx + 1)
                if len(paths) >= max_paths:
                    return

        preorder_int = []
        stack = [topo.root]
        while stack:
            v = stack.pop()
            preorder_int.append(v)
            for c in topo.children[v]:
                if c >= topo.ns:
                    stack.append(int(c))
        expand({}, 0)
        out.append(dict(n_changes=mc, n_paths=n_paths, paths=paths))
    return out
