"""Array-based tree topology for the likelihood engine.

Port of `paml_tpu/core/topology.py` (numpy only): trees are integer
arrays (parent pointers, padded child lists, a postorder schedule).  Tips
are numbered in alignment order, internal nodes ns, ns+1, ... in preorder,
matching the reference's node numbering.  `deroot` and `is_rooted`
(in.BV's unrooted gene trees) are the JAX package's, line for line.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.treeio import TreeNode


@dataclass
class Topology:
    ns: int                      # number of tips
    nnode: int
    root: int
    parent: np.ndarray           # [nnode] int32, -1 at root
    children: np.ndarray         # [nnode, maxk] int32, -1 padded
    postorder: np.ndarray        # [n_internal] internal nodes, children-first
    blen0: np.ndarray            # [nnode] initial branch lengths (above node)
    labels: np.ndarray           # [nnode] int32 branch labels (#i), 0 default
    node_names: list[str]        # [nnode] ('' for unnamed internals)
    ages0: np.ndarray | None = None  # [nnode] node ages from '@' annotations (nan if absent)

    @property
    def n_internal(self) -> int:
        return self.nnode - self.ns

    @property
    def maxk(self) -> int:
        return self.children.shape[1]

    @property
    def nbranch(self) -> int:
        return self.nnode - 1

    def branch_nodes(self) -> np.ndarray:
        """Nodes that own a branch (all but root), in reference print order
        (preorder by parent)."""
        return np.array([i for i in range(self.nnode) if i != self.root],
                        dtype=np.int32)

    def tip_descendants(self) -> list[set]:
        desc: list[set] = [set() for _ in range(self.nnode)]
        for i in range(self.ns):
            desc[i] = {i}
        for node in self.postorder:
            s: set = set()
            for c in self.children[node]:
                if c >= 0:
                    s |= desc[c]
            desc[node] = s
        return desc


def from_treenode(root: TreeNode, names: list[str]) -> Topology:
    """Convert a parsed Newick tree to arrays.  Tips are numbered by their
    position in `names` (alignment order); internal nodes are numbered
    ns, ns+1, ... in preorder (matching the reference's node numbering so
    branch tables print identically)."""
    ns = len(names)
    name_to_idx = {n: i for i, n in enumerate(names)}

    # propagate clade labels ($i) down to branches (reference: '$' labels
    # the whole clade, src/treesub.c:3100 region)
    def push_clade(node: TreeNode, clade: int | None):
        if node.clade_label is not None:
            clade = node.clade_label
        if clade is not None and node.label is None:
            node.label = clade
        for c in node.children:
            push_clade(c, clade)
    push_clade(root, None)

    # assign indices
    counter = [ns]
    order: list[TreeNode] = []

    def assign(node: TreeNode):
        if node.is_tip:
            if node.name not in name_to_idx:
                raise ValueError(f"taxon {node.name!r} not found in alignment")
            node.index = name_to_idx[node.name]
        else:
            node.index = counter[0]
            counter[0] += 1
        order.append(node)
        for c in node.children:
            assign(c)

    assign(root)
    nnode = counter[0]
    n_tips_seen = sum(1 for n in order if n.is_tip)
    if n_tips_seen != ns:
        # tree may use a subset of taxa; renumber tips compactly
        raise ValueError(f"tree has {n_tips_seen} tips but alignment has {ns}")

    maxk = max((len(n.children) for n in order if not n.is_tip), default=2)
    parent = np.full(nnode, -1, dtype=np.int32)
    children = np.full((nnode, maxk), -1, dtype=np.int32)
    blen0 = np.zeros(nnode)
    labels = np.zeros(nnode, dtype=np.int32)
    ages0 = np.full(nnode, np.nan)
    node_names = [""] * nnode
    for n in order:
        node_names[n.index] = n.name
        if n.blen is not None:
            blen0[n.index] = n.blen
        if n.label is not None:
            labels[n.index] = n.label
        if n.age is not None:
            ages0[n.index] = n.age
        for k, c in enumerate(n.children):
            children[n.index, k] = c.index
            parent[c.index] = n.index

    # postorder over internal nodes (children before parents)
    post: list[int] = []

    def walk(node: TreeNode):
        for c in node.children:
            walk(c)
        if not node.is_tip:
            post.append(node.index)

    walk(root)
    return Topology(ns=ns, nnode=nnode, root=root.index, parent=parent,
                    children=children, postorder=np.array(post, dtype=np.int32),
                    blen0=blen0, labels=labels, node_names=node_names,
                    ages0=ages0)


def deroot(topo: Topology) -> Topology:
    """Collapse a binary root into a basal trichotomy (reference: DeRoot,
    src/treesub.c:3290).  The two root-child branches merge; the summed
    length goes on the surviving child."""
    root = topo.root
    kids = [c for c in topo.children[root] if c >= 0]
    if len(kids) != 2:
        return topo
    # keep the internal child as the absorbed one if possible
    a, b = kids
    absorb = a if a >= topo.ns else b        # node whose children move up
    keep = b if absorb == a else a
    if absorb < topo.ns:
        raise ValueError("cannot deroot a 2-taxon tree")
    sub_kids = [c for c in topo.children[absorb] if c >= 0]
    new_children_of_root = sub_kids + [keep]
    maxk = max(topo.maxk, len(new_children_of_root))

    # rebuild arrays without node `absorb`, renumbering nodes > absorb down 1
    def renum(i: int) -> int:
        return i - 1 if i > absorb else i

    nnode = topo.nnode - 1
    parent = np.full(nnode, -1, dtype=np.int32)
    children = np.full((nnode, maxk), -1, dtype=np.int32)
    blen0 = np.zeros(nnode)
    labels = np.zeros(nnode, dtype=np.int32)
    ages0 = np.full(nnode, np.nan)
    node_names = [""] * nnode
    for i in range(topo.nnode):
        if i == absorb:
            continue
        j = renum(i)
        node_names[j] = topo.node_names[i]
        labels[j] = topo.labels[i]
        ages0[j] = topo.ages0[i] if topo.ages0 is not None else np.nan
        blen0[j] = topo.blen0[i]
        if i == root:
            kids_i = new_children_of_root
        else:
            kids_i = [c for c in topo.children[i] if c >= 0]
        for k, c in enumerate(kids_i):
            children[j, k] = renum(c)
            parent[renum(c)] = j
    # merged branch length onto `keep`
    blen0[renum(keep)] = topo.blen0[keep] + topo.blen0[absorb]

    post = []

    def walk(i: int):
        for c in children[i]:
            if c >= 0:
                walk(c)
        if i >= topo.ns:
            post.append(i)

    walk(renum(root))
    return Topology(ns=topo.ns, nnode=nnode, root=renum(root), parent=parent,
                    children=children, postorder=np.array(post, dtype=np.int32),
                    blen0=blen0, labels=labels, node_names=node_names,
                    ages0=ages0)


def is_rooted(topo: Topology) -> bool:
    """Is the root binary (a rooted tree)?"""
    return int((topo.children[topo.root] >= 0).sum()) == 2
