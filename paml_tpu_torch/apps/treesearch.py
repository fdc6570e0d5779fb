"""Tree search: stepwise addition and NNI hill-climbing (runmode 2-5).

Port of `paml_tpu/apps/treesearch.py` (host Python and numpy, the same
candidates in the same order: `walk_pre` order, deep copies, NNI's
first-improvement `break`).  The ML scorer `fit_fn` is the caller's; the
programs pass `codeml.fit_packed`, `codeml.fit_aa_packed` or
`baseml.fit_packed` on the device the program runs on, so every codon or
amino-acid candidate is a full fit through the pruning kernels.

Reference: StepwiseAddition (src/treesub.c:4866), star decomposition
(:4960), NNI Perturbation (:4642, NeighborNNI treespace.c:283).  The
reference README notes PAML "is not good for tree making"; these drivers
mirror its capabilities (user-guided small searches), scoring candidates
with either parsimony (fast screen) or the full ML fit.
"""
from __future__ import annotations

import copy

import numpy as np

from ..core.topology import from_treenode
from ..io import seqio, treeio
from ..io.treeio import TreeNode
from . import parsimony


def _clone(tree: TreeNode) -> TreeNode:
    return copy.deepcopy(tree)


def _unrooted_insertions(tree: TreeNode):
    """All edges of an unrooted tree (root = basal multifurcation) where a
    new taxon can be inserted: every non-root node (edge above it)."""
    out = []
    for node in tree.walk_pre():
        if node is tree:
            continue
        out.append(node)
    return out


def _insert(tree: TreeNode, edge_child: TreeNode, new_tip_name: str):
    """Insert new tip on the edge above `edge_child`; returns a new tree."""
    t2 = _clone(tree)
    # find the matching node in the clone by walking in parallel
    orig = list(tree.walk_pre())
    clone = list(t2.walk_pre())
    target = clone[orig.index(edge_child)]
    # find parent in clone
    parent = None
    for n in t2.walk_pre():
        if target in n.children:
            parent = n
            break
    knot = TreeNode(children=[target, TreeNode(name=new_tip_name)])
    parent.children[parent.children.index(target)] = knot
    return t2


def stepwise_addition_mp(data: seqio.PackedData, names=None):
    """Stepwise addition under parsimony.  Returns (TreeNode, score)."""
    names = names or data.names
    tree = treeio.parse_newick(f"({names[0]}, {names[1]}, {names[2]});")
    for k in range(3, len(names)):
        best, best_score = None, np.inf
        for edge in _unrooted_insertions(tree):
            cand = _insert(tree, edge, names[k])
            sub = _subset_data(data, names[:k + 1])
            topo = from_treenode(_clone(cand), sub.names)
            sc = parsimony.mp_score(topo, sub)
            if sc < best_score:
                best, best_score = cand, sc
        tree = best
    topo = from_treenode(_clone(tree), data.names)
    return tree, parsimony.mp_score(topo, data)


def _subset_data(data: seqio.PackedData, keep_names) -> seqio.PackedData:
    idx = [data.names.index(n) for n in keep_names]
    import dataclasses
    return dataclasses.replace(
        data, names=[data.names[i] for i in idx],
        tip_partials=data.tip_partials[idx],
        pos_masks=(data.pos_masks[idx] if data.pos_masks is not None
                   else None))


def nni_neighbors(tree: TreeNode):
    """All NNI rearrangements around internal edges (reference:
    NeighborNNI, src/treespace.c:283)."""
    out = []
    nodes = list(tree.walk_pre())
    for node in nodes:
        if node is tree or node.is_tip:
            continue
        parent = None
        for n in nodes:
            if node in n.children:
                parent = n
                break
        if parent is None:
            continue
        sibs = [c for c in parent.children if c is not node]
        if not sibs or len(node.children) < 2:
            continue
        sib = sibs[0]
        for i in range(2):
            t2 = _clone(tree)
            c2 = list(t2.walk_pre())
            node2 = c2[nodes.index(node)]
            parent2 = c2[nodes.index(parent)]
            sib2 = c2[nodes.index(sib)]
            child2 = c2[nodes.index(node.children[i])]
            # swap sib <-> child i of node
            parent2.children[parent2.children.index(sib2)] = child2
            node2.children[node2.children.index(child2)] = sib2
            out.append(t2)
    return out


def nni_search_ml(data: seqio.PackedData, start_tree: TreeNode, fit_fn,
                  max_rounds: int = 10):
    """NNI hill climbing with an ML scorer: fit_fn(topo) -> lnL."""
    tree = _clone(start_tree)
    topo = from_treenode(_clone(tree), data.names)
    best_lnl = fit_fn(topo)
    for _ in range(max_rounds):
        improved = False
        for cand in nni_neighbors(tree):
            topo = from_treenode(_clone(cand), data.names)
            lnl = fit_fn(topo)
            if lnl > best_lnl + 1e-6:
                tree, best_lnl = cand, lnl
                improved = True
                break
        if not improved:
            break
    return tree, best_lnl


def stepwise_addition_ml(data: seqio.PackedData, fit_fn, names=None,
                         progress=False):
    """Stepwise addition under ML (reference: StepwiseAddition,
    src/treesub.c:4866, runmode=3 with ML scoring): taxa are added one at
    a time on the edge that maximizes the refit log-likelihood.

    fit_fn(topo, sub_data) -> lnL."""
    names = names or data.names
    tree = treeio.parse_newick(f"({names[0]}, {names[1]}, {names[2]});")
    best_lnl = None
    for k in range(3, len(names)):
        sub = _subset_data(data, names[:k + 1])
        best, best_lnl = None, -np.inf
        for edge in _unrooted_insertions(tree):
            cand = _insert(tree, edge, names[k])
            topo = from_treenode(_clone(cand), sub.names)
            lnl = fit_fn(topo, sub)
            if lnl > best_lnl:
                best, best_lnl = cand, lnl
        tree = best
        if progress:
            print(f"  + {names[k]}: lnL {best_lnl:.4f}")
    return tree, best_lnl


def star_decomposition(data: seqio.PackedData, fit_fn, mp=False,
                       max_joins=None, progress=False):
    """Star decomposition (reference: StarDecomposition,
    src/treesub.c:4960): start from the star tree and greedily join the
    pair of root children that most improves the score, until the root is
    a trichotomy (unrooted binary) or no join improves.

    fit_fn(topo, data) -> lnL (ignored when mp=True, which uses the
    parsimony score)."""
    names = data.names
    tree = treeio.parse_newick("(" + ", ".join(names) + ");")

    def score(t):
        topo = from_treenode(_clone(t), names)
        if mp:
            return -parsimony.mp_score(topo, data)
        return fit_fn(topo, data)

    cur = score(tree)
    joins = 0
    while len(tree.children) > 3:
        best, best_sc = None, -np.inf
        kids = list(tree.children)
        for i in range(len(kids)):
            for j in range(i + 1, len(kids)):
                t2 = _clone(tree)
                k2 = list(t2.children)
                knot = TreeNode(children=[k2[i], k2[j]])
                t2.children = ([knot] + [c for m, c in enumerate(k2)
                                         if m not in (i, j)])
                sc = score(t2)
                if sc > best_sc:
                    best, best_sc = t2, sc
        if best is None or best_sc < cur - 1e-9:
            break
        tree, cur = best, best_sc
        joins += 1
        if progress:
            print(f"  join {joins}: score {cur:.4f}")
        if max_joins and joins >= max_joins:
            break
    return tree, cur


def ls_branch_lengths(topo, dist: np.ndarray):
    """Least-squares branch lengths on a fixed topology from a pairwise
    distance matrix (reference: LSDistance, src/treesub.c:2642).

    Returns (blens [nnode] with root 0, sum of squared residuals)."""
    from scipy.optimize import nnls

    ns = topo.ns
    desc = topo.tip_descendants()
    branch_nodes = [int(v) for v in topo.branch_nodes()]
    pairs = [(i, j) for i in range(ns) for j in range(i)]
    A = np.zeros((len(pairs), len(branch_nodes)))
    for col, v in enumerate(branch_nodes):
        below = desc[v]
        for row, (i, j) in enumerate(pairs):
            if (i in below) != (j in below):
                A[row, col] = 1.0
    d = np.array([dist[i, j] for i, j in pairs])
    b, rnorm = nnls(A, d)
    blens = np.zeros(topo.nnode)
    for col, v in enumerate(branch_nodes):
        blens[v] = b[col]
    return blens, float(rnorm ** 2)


def nni_search_mp(data: seqio.PackedData, start_tree: TreeNode,
                  max_rounds: int = 20):
    tree = _clone(start_tree)
    best = parsimony.mp_score(from_treenode(_clone(tree), data.names), data)
    for _ in range(max_rounds):
        improved = False
        for cand in nni_neighbors(tree):
            sc = parsimony.mp_score(from_treenode(_clone(cand), data.names),
                                    data)
            if sc < best:
                tree, best = cand, sc
                improved = True
                break
        if not improved:
            break
    return tree, best
