"""evolver: sequence simulation and tree utilities.

Port of `paml_tpu/apps/evolver.py` (reference: src/evolver.c): simulates
nucleotide (JC69..REV+Gamma), codon (M0, per-branch omegas, NSsites and
branch-site) and amino-acid alignments on a fixed tree, reading the
positional .dat configuration files (examples/MCbase.dat, MCcodon.dat,
MCaa.dat; reference parser: Simulate, src/evolver.c:818).

Each `simulate_*` is two halves: `prepare_*` parses the .dat file and
builds the model (the tree, P(t) per node and class [nnode, C, n, n], the
root frequencies, the class weights) on the device, with the codon
model's per-(node, class) matrices as one `pmat_rev_multi` batch; then
`sample_and_write` draws every replicate (`core/simulate`, chunked over
replicates, one `torch.Generator` per replicate) and writes the files.

Modes (matching the reference menu numbers / CLI):
  1 <ns> [ntree seed birth death sample mut]  random unrooted trees
  2 <ns> [...]  random rooted trees
  3 <ns>  list all unrooted trees
  4 <ns>  list all rooted trees
  5 <file>  simulate nucleotide data
  6 <file>  simulate codon data
  7 <file>  simulate amino-acid data
  8 <treefile>  partition distances between trees
  9 <sample> [maintree] [pick1tree]  clade support
  11 <treefile> <keys...>  label clades
Modes 1-4, 8, 9 and 11 write `evolver.out` or print, on the host (numpy's
Generator, `apps/treegen.py`, `apps/bootstrap.py`); only 5-7 sample on the
device.
"""
from __future__ import annotations

import re
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import AA_ORDER, NUC_ORDER, codon_string, sense_codons
from ..core.dgamma import discrete_gamma
from ..core.pmat import pmat_rev, pmat_rev_multi
from ..core.simulate import simulate_chunks, states_to_rows, write_paml_seqs
from ..core.topology import Topology, from_treenode
from ..io.treeio import parse_newick
from ..models import aa as aamod
from ..models import codon as codonmod
from ..models import nuc as nucmod


def _tokens(path: str):
    """Positional tokens from a .dat file: numbers/strings line by line,
    stopping at the '// end of file' or '====' note separator."""
    toks = []
    with open(path) as f:
        text = f.read()
    for sep in ("// end of file", "===", "!!"):
        idx = text.find(sep)
        if idx > 0:
            text = text[:idx]
    # strip '*' comments line-wise BEFORE tree extraction (comments may
    # contain parentheses, e.g. '(mc.paml)')
    stripped = []
    for line in text.splitlines():
        i = line.find("*")
        stripped.append(line[:i] if i >= 0 else line)
    text = "\n".join(stripped)
    # extract tree(s) (parenthesized newick up to ';')
    trees = re.findall(r"\([^;]*\)[^;]*;", text, flags=re.S)
    text_wo = re.sub(r"\([^;]*\)[^;]*;", " ", text, flags=re.S)
    for line in text_wo.splitlines():
        toks.extend(line.split())
    return toks, trees


class _Tok:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def num(self):
        while self.i < len(self.toks):
            t = self.toks[self.i]
            self.i += 1
            try:
                return float(t)
            except ValueError:
                continue
        raise ValueError("ran out of numeric tokens in .dat file")

    def nums(self, k):
        return [self.num() for _ in range(k)]

    def str_tok(self):
        t = self.toks[self.i]
        self.i += 1
        return t


def _prepare_tree(tree_str: str, ns: int, tree_length: float):
    names = []
    tree = parse_newick(tree_str)
    tips = [n for n in tree.walk_post() if n.is_tip]
    for t in tips:
        names.append(t.name)
    topo = from_treenode(tree, names)
    blens = topo.blen0.copy()
    if tree_length > 0:
        s = blens.sum()
        blens = blens * (tree_length / s)
    return topo, names, blens


@dataclass
class SimModel:
    """What a .dat file asks for: the tree and the model, built."""
    kind: str                   # "nuc", "codon" or "aa"
    outfmt: int
    seed: int
    nsites: int                 # sites (codons for codon data)
    nrepl: int
    names: list[str]
    topo: Topology
    blens: np.ndarray           # [nnode] the branch lengths used
    P: torch.Tensor             # [nnode, C, n, n]
    pi: torch.Tensor            # [n] root frequencies
    class_probs: torch.Tensor   # [C] site-class weights
    alphabet: list[str]


def _f64(v, device):
    return torch.as_tensor(np.asarray(v, dtype=np.float64),
                           dtype=torch.float64, device=device)


def _gamma_classes(alpha, ncatG, device):
    if alpha > 0 and ncatG > 1:
        r, w = discrete_gamma(_f64(alpha, device), ncatG)
        return r, w
    one = torch.ones(1, dtype=torch.float64, device=device)
    return one, one


def prepare_nuc(datfile: str, seed=None, *, device="cuda") -> SimModel:
    toks, trees = _tokens(datfile)
    tk = _Tok(toks)
    outfmt = int(tk.num())
    seed_f = int(tk.num())
    ns, ls, nrepl = (int(v) for v in tk.nums(3))
    tree_length = tk.num()
    model_i = int(tk.num())
    model = nucmod.NUC_MODELS[model_i]
    nr = nucmod.N_RATE_PARAMS[model]
    rates = np.array(tk.nums(nr)) if nr else np.zeros(0)
    alpha = tk.num()
    ncatG = int(tk.num())
    pi = np.array(tk.nums(4))
    pi = pi / pi.sum()

    topo, names, blens = _prepare_tree(trees[0], ns, tree_length)
    r, w = _gamma_classes(alpha, ncatG, device)
    ts = _f64(blens, device)[:, None] * r[None, :]
    with torch.no_grad():
        P, pi_root = nucmod.pmats_for_model(
            model, _f64(rates, device), _f64(pi, device), ts)
    return SimModel("nuc", outfmt, seed if seed is not None else abs(seed_f),
                    ls, nrepl, names, topo, blens, P, pi_root, w,
                    list(NUC_ORDER))


def _node_flabels(tree_str: str, topo: Topology, names) -> np.ndarray:
    """Per-node float '#' labels from a (label) tree, mapped onto `topo`
    node indices by clade (tip-name set) so label trees written with a
    different child order still align."""
    tree = parse_newick(tree_str)
    # clade -> node index on the main topology
    desc = topo.tip_descendants()
    clade_to_node = {frozenset(names[i] for i in desc[v]): v
                     for v in range(topo.nnode)}
    vals = np.zeros(topo.nnode)

    def walk(n):
        tipset = set()
        for c in n.children:
            tipset |= walk(c)
        if n.is_tip:
            tipset = {n.name}
        v = clade_to_node.get(frozenset(tipset))
        if v is None:
            raise ValueError("label tree does not match the main tree")
        lab = n.flabel if n.flabel is not None else (
            float(n.label) if n.label is not None else 0.0)
        vals[v] = lab
        return tipset

    walk(tree)
    return vals


def prepare_codon(datfile: str, seed=None, *, device="cuda") -> SimModel:
    """Codon model: M0, per-branch omegas (#-labeled tree), NSsites
    mixtures, and branch-site models (per-class label trees) — the
    reference's compile-time variants (src/evolver.c:5-12, parsing
    :935-1000; mixture normalization Qfactor :1049-1070).

    The model variant is auto-detected from the .dat structure:
    extra label trees => branch-site; '#' labels on the main tree =>
    per-branch omegas; an integer class count + 2K values => NSsites;
    otherwise M0."""
    toks, trees = _tokens(datfile)
    tk = _Tok(toks)
    outfmt = int(tk.num())
    seed_f = int(tk.num())
    ns, ncod, nrepl = (int(v) for v in tk.nums(3))
    tree_length = tk.num()
    topo, names, blens = _prepare_tree(trees[0], ns, tree_length)
    nnode = topo.nnode

    branchsite = len(trees) > 1
    main_tree = parse_newick(trees[0])
    has_branch_labels = any(
        (n.flabel is not None or n.label is not None)
        for n in main_tree.walk_post())

    if branchsite:
        ncatG = int(tk.num())
        freqs = np.array(tk.nums(ncatG))
        if len(trees) - 1 != ncatG:
            raise ValueError(f"branch-site .dat: expected {ncatG} label "
                             f"trees, found {len(trees) - 1}")
        omega_bk = np.stack(
            [_node_flabels(t, topo, names) for t in trees[1:ncatG + 1]],
            axis=1)                                    # [nnode, K]
    elif has_branch_labels:
        ncatG = 1
        freqs = np.ones(1)
        omega_bk = _node_flabels(trees[0], topo, names)[:, None]
    else:
        # peek: NSsites has an integer class count whose freqs sum to 1
        save_i = tk.i
        first = tk.num()
        is_sites = (first == int(first) and 2 <= first <= 64)
        if is_sites:
            ncatG = int(first)
            freqs = np.array(tk.nums(ncatG))
            is_sites = abs(freqs.sum() - 1.0) < 1e-5
        if is_sites:
            omegas = np.array(tk.nums(ncatG))
            omega_bk = np.tile(omegas[None, :], (nnode, 1))
        else:
            tk.i = save_i
            omega = tk.num()
            ncatG = 1
            freqs = np.ones(1)
            omega_bk = np.full((nnode, 1), omega)
    kappa = tk.num()
    f64 = np.array(tk.nums(64))
    icode = int(tk.num()) if tk.i < len(tk.toks) else 0
    sense = sense_codons(icode)
    pi = f64[sense]
    pi = pi / pi.sum()

    G = codonmod.pair_tables(icode, device)
    with torch.no_grad():
        pit = _f64(pi, device)
        s = codonmod.mutation_part(G, _f64(kappa, device))
        # per-(node, class) Q, normalized by the per-node class-mixture
        # mean rate (reference Qfactor / QfactorBS, src/evolver.c:1049-1070)
        rs, ra = (float(v) for v in codonmod.flux(G, s, pit))
        mr_bk = rs + ra * omega_bk                           # [nnode, K]
        qfac_b = 1.0 / (mr_bk * freqs[None, :]).sum(1)       # [nnode]
        Qs = codonmod.build_Q(G, s, _f64(omega_bk.reshape(-1), device), pit)
        ts = np.repeat(blens * qfac_b, ncatG)                # [nnode * K]
        P = pmat_rev_multi(Qs, pit, _f64(ts, device))
    return SimModel("codon", outfmt, seed if seed is not None else abs(seed_f),
                    ncod, nrepl, names, topo, blens,
                    P.reshape(nnode, ncatG, G.n, G.n), pit,
                    _f64(freqs, device), [codon_string(c) for c in sense])


def prepare_aa(datfile: str, seed=None, *, device="cuda") -> SimModel:
    toks, trees = _tokens(datfile)
    tk = _Tok(toks)
    outfmt = int(tk.num())
    seed_f = int(tk.num())
    ns, ls, nrepl = (int(v) for v in tk.nums(3))
    tree_length = tk.num()
    alpha = tk.num()
    ncatG = int(tk.num())
    model_i = int(tk.num())
    rate_file = None
    if model_i in (2, 3):
        rate_file = tk.str_tok()
    pi = np.array(tk.nums(20))
    pi = pi / pi.sum()

    topo, names, blens = _prepare_tree(trees[0], ns, tree_length)
    if model_i == 0:
        S = np.ones((20, 20))
    else:
        S, _ = aamod.load_empirical(rate_file or "jones")
    with torch.no_grad():
        pit = _f64(pi, device)
        Q = aamod.build_aa_Q(_f64(S, device), pit)
        r, w = _gamma_classes(alpha, ncatG, device)
        ts = _f64(blens, device)[:, None] * r[None, :]
        P = pmat_rev(Q, pit, ts)
    return SimModel("aa", outfmt, seed if seed is not None else abs(seed_f),
                    ls, nrepl, names, topo, blens, P, pit, w, list(AA_ORDER))


def sample_and_write(model: SimModel, out="mc.paml", *,
                     device="cuda") -> dict:
    """Draw every replicate and write the files the JAX program writes:
    `out` (nucleotides and amino acids); for codons `out` or `mc.nex`
    (outfmt 2, 3), `siterates.txt` (the true site classes) and
    `ancestral.txt` (internal-node sequences), reference files
    src/evolver.c:174.  Returns the path, the replicate count and the
    seconds spent sampling (until a chunk is on the host) and writing."""
    topo, ns = model.topo, model.topo.ns
    codon = model.kind == "codon"
    seqf = "mc.nex" if codon and model.outfmt in (2, 3) else out
    files = [open(seqf, "w")]
    if codon:
        files += [open("siterates.txt", "w"), open("ancestral.txt", "w")]
    sample_s = write_s = 0.0
    try:
        f = files[0]
        if codon:
            fsid, fanc = files[1:]
            if model.outfmt in (2, 3):
                f.write("#NEXUS\n")
            fsid.write("\nSite class IDs (1-based)\n")
            fanc.write("\nAncestral sequences generated during simulation\n")
        t0 = time.perf_counter()
        for r0, states, classes in simulate_chunks(
                topo, model.P, model.pi, model.nsites, model.nrepl,
                model.class_probs, seed=model.seed, device=device):
            states, classes = states.cpu().numpy(), classes.cpu().numpy()
            t1 = time.perf_counter()
            sample_s += t1 - t0
            for k in range(states.shape[0]):
                rep = r0 + k
                rows = states_to_rows(states[k, :ns], model.alphabet)
                if codon and model.outfmt in (2, 3):
                    f.write(f"\nBEGIN DATA;\n  DIMENSIONS NTAX={ns} "
                            f"NCHAR={3 * model.nsites};\n  FORMAT "
                            f"DATATYPE=DNA GAP=- MISSING=?;\n  MATRIX\n")
                    for nm, r in zip(model.names, rows):
                        f.write(f"  {nm:<20s}  {r}\n")
                    f.write("  ;\nEND;\n")
                else:
                    write_paml_seqs(f, model.names, rows)
                if not codon:
                    continue
                if model.P.shape[1] > 1:
                    fsid.write(f"\nreplicate {rep + 1}\n")
                    fsid.write(" ".join(map(str, (classes[k] + 1).tolist()))
                               + "\n")
                anc_rows = states_to_rows(states[k, ns:], model.alphabet)
                fanc.write(f"\nreplicate {rep + 1}\n")
                for i, r in enumerate(anc_rows):
                    fanc.write(f"node{ns + i + 1:<15d}  {r}\n")
            t0 = time.perf_counter()
            write_s += t0 - t1
    finally:
        for fh in files:
            fh.close()
    return dict(path=seqf, nrepl=model.nrepl, sample_seconds=sample_s,
                write_seconds=write_s)


def simulate_nuc(datfile: str, out="mc.paml", seed=None, *, device="cuda"):
    res = sample_and_write(prepare_nuc(datfile, seed, device=device), out,
                           device=device)
    return res["path"], res["nrepl"]


def simulate_codon(datfile: str, out="mc.paml", seed=None, *,
                   device="cuda"):
    """Codon simulation (`prepare_codon`'s variants).  Outputs: mc.paml
    (or mc.nex), siterates.txt (true site classes), ancestral.txt
    (internal-node sequences)."""
    res = sample_and_write(prepare_codon(datfile, seed, device=device), out,
                           device=device)
    return res["path"], res["nrepl"]


def simulate_aa(datfile: str, out="mc.paml", seed=None, *, device="cuda"):
    res = sample_and_write(prepare_aa(datfile, seed, device=device), out,
                           device=device)
    return res["path"], res["nrepl"]


def clade_support_cli(treefile: str, maintreefile: str | None = None,
                      pick1tree: int = 1) -> dict:
    """Support of the main tree's clades among a tree sample, written as
    a support-labeled tree to evolver.out (reference: CladeSupport,
    src/treesub.c:4275).  With no maintreefile, the first sample tree is
    the main tree."""
    from ..core.topology import from_treenode
    from ..io import treeio
    from .bootstrap import clade_support

    sample = treeio.read_tree_sample(treefile)
    if not sample:
        raise ValueError(f"no trees in {treefile}")
    if maintreefile:
        mains = treeio.read_tree_sample(maintreefile)
        main = mains[min(max(pick1tree, 1), len(mains)) - 1]
    else:
        main = sample[0]
    names = sorted(n.name for n in main.walk_post() if n.is_tip)
    main_topo = from_treenode(main, names)
    topos = [from_treenode(t, names) for t in sample]
    support = clade_support(main_topo, topos)

    # annotate internal nodes of the main tree with their support
    def tipset(node):
        return frozenset(names.index(t.name) for t in node.walk_post()
                         if t.is_tip)
    allset = frozenset(range(len(names)))
    by_part = {}
    for part, s in support.items():
        by_part[part] = s
    for node in main.walk_post():
        if node.is_tip or node is main:
            continue
        ts = tipset(node)
        part = min(ts, allset - ts, key=lambda x: (len(x), sorted(x)))
        if part in by_part:
            node.name = f"{100 * by_part[part]:.1f}"
    with open("evolver.out", "w") as f:
        f.write(treeio.write_newick(main, branch_lengths=False) + "\n")
    for part, s in sorted(support.items(), key=lambda kv: -kv[1]):
        tipnames = " ".join(names[i] for i in sorted(part))
        print(f"{100 * s:6.1f}%  ({tipnames})")
    print(f"support-labeled main tree -> evolver.out "
          f"({len(sample)} sample trees)")
    return support


def label_clades_cli(treefile: str, keys: list[str]) -> None:
    """For each key, select tips whose names contain it and label their
    clade '#i' when monophyletic in the (unrooted) tree — checking the
    complement set too, as the reference does (LabelClades,
    src/evolver.c:271-341)."""
    from ..io import treeio

    trees = treeio.read_tree_sample(treefile)
    tree = trees[0]
    tips = [n for n in tree.walk_post() if n.is_tip]
    names = [n.name for n in tips]
    ns = len(names)
    for ic, key in enumerate(keys):
        chosen = frozenset(i for i, nm in enumerate(names) if key in nm)
        if not chosen:
            print(f"key {key!r}: no matching sequences")
            continue
        found = None
        for node in tree.walk_post():
            if node is tree:
                continue
            ts = frozenset(names.index(t.name) for t in node.walk_post()
                           if t.is_tip)
            if ts == chosen or ts == frozenset(range(ns)) - chosen:
                found = node
                break
        if found is None:
            print(f"key {key!r}: {len(chosen)} seqs are NOT a clade "
                  f"(paraphyletic)")
            continue
        found.label = ic + 1
        print(f"key {key!r}: clade of {len(chosen)} seqs labeled "
              f"#{ic + 1}")
    with open("evolver.out", "w") as f:
        f.write(treeio.write_newick(tree, branch_lengths=False,
                                    labels=True) + "\n")
    print("labeled tree -> evolver.out")


PREPARE = {"5": prepare_nuc, "6": prepare_codon, "7": prepare_aa}


def main(argv, device="cuda"):
    """Modes mirror the reference evolver menu (src/evolver.c:159-168):
    1/2 random unrooted/rooted trees, 3/4 list all unrooted/rooted trees,
    5/6/7 simulate nuc/codon/aa data, 8 partition distances between
    trees, 9 clade support from a tree sample, 11 label clades.  Returns
    `sample_and_write`'s summary for 5-7, None for the others."""
    if len(argv) < 2:
        print(__doc__)
        sys.exit(2)
    mode = argv[0]
    if mode in ("1", "2"):
        from . import treegen
        from ..io.treeio import write_newick
        ns = int(argv[1])
        ntree = int(argv[2]) if len(argv) > 2 else 1
        seed = int(argv[3]) if len(argv) > 3 else 1
        bd = [float(v) for v in argv[4:8]]  # birth death sample mut
        rng = np.random.default_rng(seed)
        out = "evolver.out"
        with open(out, "w") as f:
            for _ in range(ntree):
                if bd:
                    t = treegen.random_tree_bd(
                        ns, rooted=(mode == "2"), birth=bd[0], death=bd[1],
                        sample=bd[2], mut=bd[3], rng=rng)
                else:
                    t, _h = treegen.random_labeled_history(
                        ns, rooted=(mode == "2"), rng=rng)
                f.write(write_newick(t, branch_lengths=bool(bd)) + "\n")
        print(f"{ntree} random {'rooted' if mode == '2' else 'unrooted'} "
              f"tree(s) -> {out}")
        return None
    if mode in ("3", "4"):
        from . import treegen
        from ..io.treeio import write_newick
        ns = int(argv[1])
        out = "evolver.out"
        n = 0
        with open(out, "w") as f:
            for t in treegen.list_trees(ns, rooted=(mode == "4")):
                f.write(write_newick(t, branch_lengths=False) + "\n")
                n += 1
        print(f"{n} {'rooted' if mode == '4' else 'unrooted'} trees -> "
              f"{out}")
        return None
    if mode == "8":
        from . import treegen
        sh, rf = treegen.tree_distances_file(argv[1])
        n = len(sh)
        print("pairwise (shared partitions, partition distance):")
        for i in range(n):
            print(" ".join(f"{sh[i, j]}/{rf[i, j]}" for j in range(n)))
        return None
    if mode == "9":
        # clade support values from a tree sample onto a main tree
        # (reference: `evolver 9 treefile maintreefile <pick1tree>`,
        # src/evolver.c:130-134 -> CladeSupport src/treesub.c:4275).
        # The sample file may be newick-per-line or MrBayes NEXUS .t
        clade_support_cli(argv[1], argv[2] if len(argv) > 2 else None,
                          int(argv[3]) if len(argv) > 3 else 1)
        return None
    if mode == "11":
        # label clades selected by name substrings (reference:
        # LabelClades, src/evolver.c:271; keys passed as CLI args
        # instead of the reference's interactive prompts)
        label_clades_cli(argv[1], argv[2:])
        return None
    prepare = PREPARE.get(mode)
    if prepare is None:
        print(f"unknown evolver mode {mode}; use 1-4 (trees), 5 (nuc), "
              "6 (codon), 7 (aa), 8 (tree distances), 9 (clade support) "
              "or 11 (label clades)")
        sys.exit(2)
    out = argv[2] if len(argv) > 2 else "mc.paml"
    res = sample_and_write(prepare(argv[1], device=device), out,
                           device=device)
    print(f"simulated {res['nrepl']} replicate(s) -> {res['path']}")
    return res
