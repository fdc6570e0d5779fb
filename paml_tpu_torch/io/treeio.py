"""Newick tree reading with the reference's annotation grammar.

Port of `paml_tpu/io/treeio.py` (pure Python): `TreeNode`, `parse_newick`,
`read_trees`, `write_newick`, `parse_tip_dates` (TipDate), the fossil-calibration grammar
`parse_calibration` (mcmctree), for several
data sets in one file `read_tree_strings` and `prune_to`, and
`read_tree_sample` (newick lines, a PAML header file or NEXUS).  Branch lengths (``:x``), branch labels (``#i``), clade
labels (``$i``), node ages (``@x``) and quoted annotations are parsed as
there; taxa may be given by name or by 1-based index into the alignment.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class TreeNode:
    name: str = ""
    children: list["TreeNode"] = field(default_factory=list)
    blen: float | None = None
    label: int | None = None        # '#i' branch label (omega/rate class)
    flabel: float | None = None     # raw '#x' value (evolver branch omegas)
    clade_label: int | None = None  # '$i' clade label (applies to whole subtree)
    age: float | None = None        # '@x' node age
    annotation: str | None = None   # raw "'...'" or '[...]' annotation text
    index: int = -1                 # assigned by index_tree

    @property
    def is_tip(self) -> bool:
        return not self.children

    def walk_post(self):
        for c in self.children:
            yield from c.walk_post()
        yield self

    def walk_pre(self):
        yield self
        for c in self.children:
            yield from c.walk_pre()


def _parse_suffix(node: TreeNode, s: str, i: int) -> int:
    """Parse the trailing annotations after a node: labels, age, blen."""
    n = len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
        elif c == "'" or c == '"':
            j = s.index(c, i + 1)
            node.annotation = s[i + 1:j]
            m = re.fullmatch(r"@\s*([0-9.eE+-]+)", node.annotation.strip())
            if m:    # quoted fossil age, e.g. ')  '@0.45'' (reference: @)
                node.age = float(m.group(1))
            i = j + 1
        elif c == "[":
            j = s.index("]", i + 1)
            ann = s[i + 1:j]
            # '[&label]' style or calibration text
            if node.annotation is None:
                node.annotation = ann
            i = j + 1
        elif c == "#":
            # integer labels are branch classes; float labels carry values
            # directly (evolver's per-branch omegas, src/evolver.c:949)
            m = re.match(r"#\s*([0-9.eE+-]+)", s[i:])
            v = float(m.group(1))
            node.flabel = v
            if v == int(v):
                node.label = int(v)
            i += m.end()
        elif c == "$":
            m = re.match(r"\$\s*(\d+)", s[i:])
            node.clade_label = int(m.group(1))
            i += m.end()
        elif c == "@":
            m = re.match(r"@\s*([0-9.eE+-]+)", s[i:])
            node.age = float(m.group(1))
            i += m.end()
        elif c == ":":
            m = re.match(r":\s*([0-9.eE+-]+)", s[i:])
            node.blen = float(m.group(1))
            i += m.end()
        elif c in (">", "<", "="):
            # bare calibration like '>0.06<0.08' attached without quotes
            m = re.match(r"[><=]\s*[0-9.eE+-]+", s[i:])
            node.annotation = (node.annotation or "") + m.group(0)
            i += m.end()
        else:
            break
    return i


def parse_newick(s: str) -> TreeNode:
    s = s.strip().rstrip(";")
    pos = 0

    def parse_node() -> TreeNode:
        nonlocal pos
        node = TreeNode()
        while pos < len(s) and s[pos].isspace():
            pos += 1
        # labels may precede the taxon name (e.g. '#2 2' in the reference's
        # abglobin.trees); consume leading annotations
        while pos < len(s) and s[pos] in "#$@":
            pos = _parse_suffix(node, s, pos)
            while pos < len(s) and s[pos].isspace():
                pos += 1
        if s[pos] == "(":
            pos += 1
            while True:
                node.children.append(parse_node())
                while pos < len(s) and s[pos].isspace():
                    pos += 1
                if s[pos] == ",":
                    pos += 1
                elif s[pos] == ")":
                    pos += 1
                    break
                else:
                    raise ValueError(f"newick parse error at {pos}: {s[pos:pos + 30]!r}")
            # optional internal node name
            m = re.match(r"\s*([A-Za-z0-9_.|/-]+)", s[pos:])
            if m and not re.match(r"\s*[:#$@'\[]", s[pos:]):
                node.name = m.group(1)
                pos += m.end()
        else:
            if s[pos] == "'" or s[pos] == '"':
                q = s[pos]
                j = s.index(q, pos + 1)
                node.name = s[pos + 1:j]
                pos = j + 1
            else:
                m = re.match(r"[^\s,():;#$@\[\]]+", s[pos:])
                if not m:
                    raise ValueError(f"newick parse error at {pos}")
                node.name = m.group(0)
                pos += m.end()
        pos = _parse_suffix(node, s, pos)
        return node

    root = parse_node()
    return root


def read_trees(path: str, names: list[str] | None = None) -> list[TreeNode]:
    """Read a PAML tree file: optional 'ns ntree' header, then ';'-terminated
    trees.  Numeric taxon labels are resolved to names via `names`."""
    with open(path) as f:
        text = f.read()
    # strip C/C++-style comments (the reference's example tree files carry
    # '/* ... */', '/ * ... */' and '// ...' annotations that its scanner
    # skips by searching for '(')
    text = re.sub(r"/\s*\*.*?\*\s*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    # lone '/ ' comments (reference example files, e.g. brown.rooted.trees);
    # a '/' inside a taxon name has no following whitespace and is kept
    text = re.sub(r"/\s[^\n]*", " ", text)

    # optional header: 'ns ntree' or just 'ntree'
    ntree = None
    lines = text.splitlines()
    for i, line in enumerate(lines):
        t = line.strip()
        if not t:
            continue
        m = re.fullmatch(r"(\d+)(?:\s+(\d+))?", t)
        if m:
            ntree = int(m.group(2)) if m.group(2) else int(m.group(1))
            text = "\n".join(lines[i + 1:])
        break

    trees: list[TreeNode] = []
    for chunk in text.split(";"):
        if ntree is not None and len(trees) >= ntree:
            break
        c = chunk.strip()
        if "(" not in c:
            continue
        c = c[c.index("("):]
        tree = parse_newick(c)
        if names is not None:
            _resolve_names(tree, names)
        trees.append(tree)
    return trees


def _resolve_names(tree: TreeNode, names: list[str]) -> None:
    for node in tree.walk_post():
        if node.is_tip:
            if node.name in names:
                continue
            if re.fullmatch(r"\d+", node.name):
                idx = int(node.name) - 1
                if 0 <= idx < len(names):
                    node.name = names[idx]
                    continue
            # tolerate truncated names
            matches = [n for n in names if n.startswith(node.name)]
            if len(matches) == 1:
                node.name = matches[0]
            else:
                raise ValueError(f"taxon {node.name!r} not in alignment")


def write_newick(root: TreeNode, branch_lengths: bool = True,
                 labels: bool = False, ages: bool = False,
                 names: bool = True, digits: int = 6) -> str:
    def fmt(node: TreeNode) -> str:
        if node.is_tip:
            s = node.name if names else str(node.index + 1)
        else:
            s = "(" + ", ".join(fmt(c) for c in node.children) + ")"
            if node.name and names:
                s += node.name
        if labels and node.label is not None:
            s += f" #{node.label}"
        if ages and node.age is not None:
            s += f" @{node.age:.{digits}f}"
        if branch_lengths and node.blen is not None:
            s += f": {node.blen:.{digits}f}"
        return s

    return fmt(root) + ";"


def parse_tip_dates(names: list[str], timeunit: float | None = None):
    """Sampling dates from the last numeric field of each sequence name
    (reference: GetTipDate, treesub.c:3552).  Supports plain numbers
    (e.g. 'P03h1995' -> 1995) and yyyy-mm-dd (converted to day numbers).
    Returns (tip_ages, timeunit, youngest): age = (youngest-date)/timeunit,
    so the most recent tip is age 0."""
    import numpy as np

    dates = []
    for name in names:
        m = re.search(r"([0-9][0-9.\-]*)$", name)
        if not m:
            dates.append(None)
            continue
        tok = m.group(1)
        if "-" in tok.strip("-"):
            import datetime
            parts = [int(x) for x in tok.split("-") if x]
            y, mo, d = (parts + [1, 15])[:3]
            epoch = datetime.date(1970, 1, 1)
            dates.append((datetime.date(y, max(mo, 1), max(d, 1))
                          - epoch).days * 1.0)
        else:
            dates.append(float(tok.rstrip(".-")))
    if any(d is None for d in dates):
        raise ValueError("TipDate model requires a sampling date in every "
                         "sequence name")
    arr = np.array(dates)
    young, old = arr.max(), arr.min()
    if young - old < 1e-100:
        raise ValueError("TipDate: all sequences have the same age")
    if timeunit is None or timeunit <= 0:
        timeunit = (young - old) * 2.5
    ages = (young - arr) / timeunit
    ages[ages < 1e-100] = 0.0
    return ages, timeunit, float(young)


# --- calibration annotation grammar (reference: src/treesub.c:8653) -------

_DIST_RE = re.compile(r"([A-Za-z0-9]+)\s*[({]([^)}]*)[)}]")


def parse_calibration(ann: str):
    """Parse a fossil-calibration annotation into (kind, params).

    Grammar (reference ProcessNodeAnnotation): '>0.06' lower bound,
    '<0.08' upper bound, '>0.06<0.08' joint bounds, 'L{...}', 'U{...}',
    'B{...}', 'G{...}', 'SN{...}', 'ST{...}', 'S2N{...}' densities.
    Returns None for non-calibration annotations.
    """
    if ann is None:
        return None
    a = ann.strip()
    m = _DIST_RE.match(a)
    if m:
        kind = m.group(1).upper()
        params = [float(x) for x in re.split(r"[\s,]+", m.group(2).strip())
                  if x]
        if kind in ("L", "U", "B", "G", "SN", "ST", "S2N"):
            return kind, params
        return None
    lower = re.search(r">\s*([0-9.eE+-]+)", a)
    upper = re.search(r"<\s*([0-9.eE+-]+)", a)
    if lower and upper:
        return "B", [float(lower.group(1)), float(upper.group(1))]
    if lower:
        return "L", [float(lower.group(1))]
    if upper:
        return "U", [float(upper.group(1))]
    return None


def prune_to(root: TreeNode, keep_names) -> TreeNode:
    """Subtree restricted to `keep_names`: drop other tips, collapse
    unary internal nodes (their branch lengths add), like the reference's
    GetSubTreeN (src/treesub.c:3375) used by the ndata maintree modes."""
    import copy

    keep = set(keep_names)

    def rec(node: TreeNode) -> TreeNode | None:
        if node.is_tip:
            return copy.deepcopy(node) if node.name in keep else None
        kids = [rec(c) for c in node.children]
        kids = [k for k in kids if k is not None]
        if not kids:
            return None
        if len(kids) == 1:
            child = kids[0]
            if node.blen is not None or child.blen is not None:
                child.blen = (node.blen or 0.0) + (child.blen or 0.0)
            return child
        new = TreeNode(children=kids, name=node.name, blen=node.blen,
                       label=node.label, clade_label=node.clade_label,
                       age=node.age, annotation=node.annotation)
        return new

    out = rec(root)
    if out is None or out.is_tip:
        raise ValueError("pruned tree has fewer than 2 tips")
    out.blen = None
    return out


def read_tree_sample(path: str) -> list[TreeNode]:
    """Parsed trees from a tree-sample file: plain newick-per-line, a
    PAML 'ns ntree' header file, or NEXUS with a translate table
    (MrBayes .t output).  Used by the clade-support workflow (reference:
    CladeSupport, src/treesub.c:4275, driven from evolver option 9)."""
    text = open(path).read()
    trees = []
    if re.search(r"#\s*NEXUS", text, re.I):
        tr = {}
        m = re.search(r"\btranslate\b(.*?);", text, re.I | re.S)
        if m:
            for ent in m.group(1).split(","):
                toks = ent.split()
                if len(toks) >= 2:
                    tr[toks[0]] = toks[1].strip().strip("'\"")
        for tm in re.finditer(r"\btree\b[^=]*=\s*(?:\[[^\]]*\]\s*)*"
                              r"(\([^;]*\)[^;]*;)", text, re.I | re.S):
            t = parse_newick(tm.group(1))
            if tr:
                for node in t.walk_post():
                    if node.is_tip and node.name in tr:
                        node.name = tr[node.name]
            trees.append(t)
        return trees
    return [parse_newick(s) for s in read_tree_strings(path)]


def read_tree_strings(path: str) -> list[str]:
    """Raw newick strings from a tree file (ignoring 'ns ntree' headers and
    comments) — used by ndata separate_trees where each block may use a
    different taxon set."""
    import re as _re

    text = open(path).read()
    idx = text.find("// end")
    if idx > 0:
        text = text[:idx]
    return [m.group(0) for m in
            _re.finditer(r"\([^;]*\)[^;]*;", text, flags=_re.S)]
