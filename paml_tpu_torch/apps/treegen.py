"""Tree generation and enumeration utilities (evolver options 1-4, 8).

Counterparts of the reference's tree utilities: random labeled histories
(RandomLHistory, src/treesub.c:8612), birth-death/coalescent branch
lengths (BranchLengthBD, src/treesub.c:8552), species-addition tree
construction and exhaustive enumeration (MakeTreeIb / GetTreeI /
ListTrees, src/treespace.c:6-120), and pairwise partition distances
between trees in a file (TreeDistances, src/evolver.c:450).

Port of `paml_tpu/apps/treegen.py` (host Python and numpy): numpy's
Generator draws the same numbers in the same order as there, so one seed
gives the same trees in both packages.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.topology import from_treenode
from ..io.treeio import TreeNode, parse_newick
from .bootstrap import tree_partitions


def default_names(ns: int) -> list[str]:
    """A..Z, a..z for small ns, else S1..Sn (reference: evolver.c:203)."""
    if ns <= 52:
        return [chr((ord("A") + i) if i < 26 else (ord("a") + i - 26))
                for i in range(ns)]
    return [f"S{i + 1}" for i in range(ns)]


# ---------------------------------------------------------------------------
# random labeled histories + birth-death branch lengths
# ---------------------------------------------------------------------------


def random_labeled_history(ns: int, rooted=True, rng=None,
                           names: list[str] | None = None):
    """Random coalescent topology: every labeled history equally likely
    (reference: RandomLHistory, src/treesub.c:8612).  Returns (root
    TreeNode, coalescence order list of internal TreeNodes youngest
    first)."""
    rng = rng if rng is not None else np.random.default_rng()
    names = names or default_names(ns)
    lineages = [TreeNode(name=names[i], children=[], blen=None, label=None,
                         clade_label=None, age=None, annotation=None,
                         index=i) for i in range(ns)]
    internals = []
    k = ns
    stop = 3 if not rooted else 2
    while len(lineages) > stop:
        i = int(len(lineages) * rng.random())
        a = lineages.pop(i)
        j = int(len(lineages) * rng.random())
        b = lineages.pop(j)
        node = TreeNode(name="", children=[a, b], blen=None, label=None,
                        clade_label=None, age=None, annotation=None,
                        index=k)
        k += 1
        internals.append(node)
        lineages.append(node)
    root = TreeNode(name="", children=list(lineages), blen=None,
                    label=None, clade_label=None, age=None,
                    annotation=None, index=k)
    internals.append(root)
    return root, internals


def bd_ages(ns: int, birth: float, death: float, sample: float,
            mut: float, rng=None) -> np.ndarray:
    """Node ages (youngest first) under the birth-death-sampling kernel,
    or the coalescent when sample == 0 (reference: BranchLengthBD,
    src/treesub.c:8552).  With sampling, the root age is fixed at `mut`
    (tree height)."""
    rng = rng if rng is not None else np.random.default_rng()
    if sample == 0:                      # coalescent
        ages = []
        y = 0.0
        for i in range(ns, 1, -1):
            y += -math.log(rng.random()) / (i * (i - 1) / 2.0) * mut / 2
            ages.append(y)
        return np.array(ages)
    la, mu, rho = birth, death, sample
    t = np.empty(ns - 1)
    t[ns - 2] = 1.0
    if abs(la - mu) > 1e-6:
        eml = math.exp(mu - la)
        phi = (rho * la * (eml - 1) + (mu - la) * eml) / (eml - 1)
        for i in range(ns - 2):
            r = rng.random()
            t[i] = math.log((phi - r * rho * la)
                            / (phi - r * rho * la + r * (la - mu))) \
                / (mu - la)
    else:
        for i in range(ns - 2):
            r = rng.random()
            t[i] = r / (1 + la * rho * (1 - r))
    return np.sort(t) * mut


def random_tree_bd(ns: int, rooted=True, birth=None, death=None,
                   sample=None, mut=None, rng=None,
                   names: list[str] | None = None) -> TreeNode:
    """Random labeled history with optional birth-death branch lengths
    (evolver options 1/2)."""
    rng = rng if rng is not None else np.random.default_rng()
    root, internals = random_labeled_history(ns, rooted, rng, names)
    if birth is not None:
        ages = bd_ages(ns, birth, death, sample, mut, rng)
        # internals[] is ordered youngest-first (coalescences toward the
        # past)
        for node, age in zip(internals, ages[:len(internals)]):
            node.age = age

        def set_blen(n, parent_age):
            n.blen = (parent_age - (n.age or 0.0)
                      if parent_age is not None else None)
            for c in n.children:
                set_blen(c, n.age or 0.0)

        set_blen(root, None)
        if not rooted:
            # the trifurcation stands in for a root at the oldest age;
            # the third son's branch spans both root-adjacent segments
            # (reference: BranchLengthBD, src/treesub.c:8598-8601)
            phantom = ages[-1]
            third = root.children[2]
            third.blen = (2 * phantom - (root.age or 0.0)
                          - (third.age or 0.0))
    return root


# ---------------------------------------------------------------------------
# species-addition construction and enumeration
# ---------------------------------------------------------------------------


def num_trees(ns: int, rooted=False) -> int:
    """(2ns-5)!! unrooted topologies; x(2ns-3) rooted."""
    n = 1
    for i in range(ns - 3):
        n *= 2 * i + 3
    if rooted:
        n *= 2 * ns - 3
    return n


def make_tree_ib(ns: int, Ib: list[int], rooted=False,
                 names: list[str] | None = None) -> TreeNode:
    """Construct the tree selected by the species-addition indices Ib
    (reference: MakeTreeIb, src/treespace.c:6).  Ib[k] in [0, 2k+3) picks
    the branch that species k+3 is added to; for rooted trees a final
    index in [0, 2ns-4) places the root."""
    names = names or default_names(ns)
    center = ns                          # first internal node id
    nxt = ns + 1
    branches = [[center, 0], [center, 1], [center, 2]]
    for k in range(ns - 3):
        tip = k + 3
        u, v = branches[Ib[k]]
        w = nxt
        nxt += 1
        branches[Ib[k]] = [u, w]
        branches.append([w, v])
        branches.append([w, tip])
    if rooted:
        u, v = branches[Ib[ns - 3]]
        root_id = nxt
        nxt += 1
        branches[Ib[ns - 3]] = [root_id, u]
        branches.append([root_id, v])
        root = root_id
    else:
        root = center
    # orient edges away from root, then build TreeNodes
    adj: dict[int, list[int]] = {}
    for u, v in branches:
        adj.setdefault(u, []).append(v)
        adj.setdefault(v, []).append(u)
    nodes: dict[int, TreeNode] = {}

    def build(u: int, parent: int | None) -> TreeNode:
        kids = [build(v, u) for v in adj[u] if v != parent]
        node = TreeNode(name=names[u] if u < ns else "", children=kids,
                        blen=None, label=None, clade_label=None, age=None,
                        annotation=None, index=u)
        return node

    return build(root, None)


def tree_from_index(itree: int, ns: int, rooted=False,
                    names: list[str] | None = None) -> TreeNode:
    """The itree-th tree in the species-addition enumeration order
    (reference: GetTreeI, src/treespace.c:45)."""
    nM = ns - 3 + (1 if rooted else 0)
    M = [0] * nM
    for i in range(nM - 1):
        M[i] = 2 * i + 5
    M[nM - 1] = 1
    for i in range(nM - 2):
        M[nM - 1 - i - 2] *= M[nM - 1 - i - 1]
    Ib = []
    for i in range(nM):
        Ib.append(itree // M[i])
        itree %= M[i]
    if rooted:
        # last index ranges over 2ns-4 branches; enumeration treats it the
        # same way (Ib[nM-1] in [0, 2(ns-3)+3) == [0, 2ns-3)); clip
        pass
    return make_tree_ib(ns, Ib, rooted, names)


def list_trees(ns: int, rooted=False, names: list[str] | None = None):
    """Yield every distinct topology (reference: ListTrees,
    src/treespace.c:122)."""
    for itree in range(num_trees(ns, rooted)):
        yield tree_from_index(itree, ns, rooted, names)


# ---------------------------------------------------------------------------
# partition distances between trees (evolver option 8)
# ---------------------------------------------------------------------------


def tree_distances(trees: list[TreeNode], names: list[str] | None = None):
    """Pairwise (shared, distance) internal-partition counts between trees
    over the same taxa (reference: TreeDistances, src/evolver.c:450).
    Returns (nshared[i,j], rf[i,j]) matrices."""
    if names is None:
        names = sorted(n.name for n in trees[0].walk_pre()
                       if not n.children)
    parts = []
    for t in trees:
        topo = from_treenode(t, names)
        parts.append(tree_partitions(topo))
    n = len(trees)
    shared = np.zeros((n, n), dtype=int)
    rf = np.zeros((n, n), dtype=int)
    for i in range(n):
        for j in range(n):
            s = len(parts[i] & parts[j])
            shared[i, j] = s
            rf[i, j] = len(parts[i]) + len(parts[j]) - 2 * s
    return shared, rf


def tree_distances_file(path: str):
    """Read a tree file and return its pairwise partition-distance
    matrices."""
    text = open(path).read()
    chunks = [c for c in text.split(";") if "(" in c]
    trees = [parse_newick(c.strip() + ";") for c in chunks]
    return tree_distances(trees)
