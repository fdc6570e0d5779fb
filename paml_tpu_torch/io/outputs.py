"""Reference-compatible side-output files.

Port of the codeml and baseml parts of `paml_tpu/io/outputs.py` (numpy
only).  The reference programs write fixed-name auxiliary files next to
the main report; downstream tooling parses them, so the formats follow the
reference's layout closely:

  lnf      per-site log-likelihoods for RELL     (print_lnf_site,
           src/treesub.c:7597-7605; header src/codeml.c:623-689)
  rst      NEB/BEB site tables (lfunNSsites_rate, src/codeml.c:5241) and
           the marginal ancestral reconstruction (AncestralMarginal,
           src/treesub.c:6288)
  rst1     one summary line per dataset (multiruns hook)
  rates    site rates under a rate mixture (lfunRates, src/treesub.c:7314)
  2YN.* 2NG.* 2ML.*
           lower-triangle pairwise matrices of yn00 and codeml's pairwise
           runmodes (src/yn00.c:141-167)
  FigTree.tre
           mcmctree's dated tree with 95% HPD node bars (FigTree.tre block
           of DescriptiveStatisticsSimpleMCMCTREE, src/mcmctree.c)
"""
from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# lnf (per-site log likelihoods; consumed by rell, src/treesub.c:5844)
# --------------------------------------------------------------------------

def write_lnf(path: str, ls: int, fpatt: np.ndarray,
              lnf_trees: list[np.ndarray],
              pattern_text: list[str] | None = None) -> None:
    """lnf_trees: per tree, per-pattern log site likelihood [npatt].

    Header '%6d %6d %6d' = (ntree, ls, npatt); per tree '\\n\\n%2d\\n' then
    one line per pattern (reference: src/codeml.c:623-689,
    src/treesub.c:7597-7605)."""
    npatt = len(fpatt)
    with open(path, "w") as f:
        f.write(f"{len(lnf_trees):6d} {int(ls):6d} {npatt:6d}\n")
        for itree, lnf in enumerate(lnf_trees):
            f.write(f"\n\n{itree + 1:2d}\n")
            for h in range(npatt):
                fh = float(np.exp(lnf[h]))
                f.write(f"\n{h + 1:6d} {float(fpatt[h]):6.0f} "
                        f"{float(lnf[h]):16.10f} {fh:16.12f} "
                        f"{ls * fh:12.4f}  ")
                if pattern_text is not None:
                    f.write(pattern_text[h])
        f.write("\n")


def read_lnf(path: str):
    """Read an lnf file -> (ls, fpatt [npatt], lnf [ntree, npatt])."""
    with open(path) as f:
        toks = f.read().split()
    ntree, ls, npatt = int(toks[0]), int(toks[1]), int(toks[2])
    if ntree < 0:
        ntree = 1
    lnf = np.zeros((ntree, npatt))
    fpatt = np.zeros(npatt)
    i = 3
    for it in range(ntree):
        i += 1                               # tree index
        for h in range(npatt):
            assert int(toks[i]) == h + 1, "lnf: pattern index mismatch"
            fpatt[h] = float(toks[i + 1])
            lnf[it, h] = float(toks[i + 2])
            i += 5                           # idx fpatt lnf fh ls*fh
            # skip pattern text tokens if any: advance to next int == h+2
            while i < len(toks):
                try:
                    v = int(toks[i])
                    if v == h + 2 or (h == npatt - 1 and v == it + 2):
                        break
                except ValueError:
                    pass
                i += 1
    return ls, fpatt, lnf


# --------------------------------------------------------------------------
# rates (site-rate estimates; reference lfunRates, src/treesub.c:7314)
# --------------------------------------------------------------------------

def write_rates(path: str, seqtype: int, rK: np.ndarray, freqK: np.ndarray,
                site_pattern: np.ndarray, post_cls: np.ndarray,
                fpatt: np.ndarray, tree_text: str = "") -> None:
    """The conditional-mean rate and the most probable category of each
    site, from the posterior class probabilities post_cls [K, npatt]
    (the reference's 'Site Freq Data ln(f) Rates' table, the same
    quantities)."""
    rK = np.asarray(rK, float)
    post = np.asarray(post_cls, float)
    re_h = (rK[:, None] * post).sum(0)           # conditional mean rate
    best_h = post.argmax(0)
    kind = {0: "BASE", 1: "CODON", 2: "AA"}.get(seqtype, "BASE")
    with open(path, "w") as f:
        f.write(f"\nEstimated rates for sites from {kind}ML.\n")
        if tree_text:
            f.write(tree_text + "\n")
        K = len(rK)
        f.write(f"\nFrequencies and rates for categories (K={K})")
        f.write("\nrate:" + "".join(f" {v:8.5f}" for v in rK))
        f.write("\nfreq:" + "".join(f" {v:8.5f}" for v in freqK))
        f.write("\n\nSite Freq  Rate (posterior mean)  Best category\n")
        for i, h in enumerate(np.asarray(site_pattern)):
            f.write(f"{i + 1:6d} {float(fpatt[h]):5.0f} {re_h[h]:9.4f} "
                    f"{int(best_h[h]) + 1:7d}\n")
        mre = float((re_h * fpatt).sum() / fpatt.sum())
        f.write(f"\nmean rate = {mre:.5f}\n")


# --------------------------------------------------------------------------
# rst: NEB/BEB site tables and marginal ancestral states
# --------------------------------------------------------------------------

def write_rst_neb(f, site_pattern, post_cls, omegas, fpatt,
                  label="Naive Empirical Bayes (NEB) probabilities") -> None:
    """Per-site class posteriors + posterior-mean omega (reference:
    lfunNSsites_rate, src/codeml.c:5241 output region)."""
    post = np.asarray(post_cls, float)
    w = np.asarray(omegas, float).reshape(-1)
    wmean = (w[:, None] * post).sum(0)
    f.write(f"\n{label} for site classes\n\n")
    f.write("site  " + "".join(f"  p(w={wi:.5g})" for wi in w)
            + "   post-mean w\n")
    for i, h in enumerate(np.asarray(site_pattern)):
        probs = "".join(f" {post[k, h]:11.5f}" for k in range(post.shape[0]))
        f.write(f"{i + 1:5d} {probs}   {wmean[h]:9.5f}\n")


def write_rst_ancestral(f, names, node_ids, best, prob, site_pattern) -> None:
    """The marginal reconstruction table (reference: AncestralMarginal,
    src/treesub.c:6288): the best state and its posterior per internal
    node and site.  best / prob: [n_internal, npatt], best already as
    characters; node_ids: the reference's node numbers."""
    f.write("\nMarginal reconstruction of ancestral sequences\n")
    f.write("(eqn. 4 in Yang et al. 1995 Genetics 141:1641-1650)\n\n")
    f.write("site " + " ".join(f"node#{i}" for i in node_ids) + "\n")
    # each pattern's cells once, then one line per site
    cells = [" ".join(f"{best[j][h]}({prob[j][h]:.3f})"
                      for j in range(len(node_ids)))
             for h in range(len(prob[0]) if len(node_ids) else 0)]
    f.write("".join(f"{i + 1:5d}  {cells[h]}\n"
                    for i, h in enumerate(np.asarray(site_pattern))))


def write_rst1(path: str, values: list, append: bool = False) -> None:
    """One tab-separated summary line per dataset (reference frst1; the
    hook consumed by multiruns, Technical/Simulation/multiruns.c)."""
    with open(path, "a" if append else "w") as f:
        f.write("\t".join(f"{v:.6f}" if isinstance(v, float) else str(v)
                          for v in values) + "\n")


# --------------------------------------------------------------------------
# pairwise matrices: 2YN.*, 2NG.*, 2ML.* (src/yn00.c:141-167)
# --------------------------------------------------------------------------

def write_pairwise_matrix(path: str, names: list[str], pairs,
                          field: str) -> None:
    """Lower-triangle matrix file of one field of the pairs (each with
    0-based `i`, `j`; 0 where a pair lacks the field, as the Bayesian
    pairs lack dN and dS): '%6d\\n' ns, then per row the name and ' %7.4f'
    entries for columns j < i."""
    ns = len(names)
    wname = max(max(len(n) for n in names), 10)
    M = np.zeros((ns, ns))
    for r in pairs:
        M[r.i, r.j] = M[r.j, r.i] = getattr(r, field, 0.0)
    with open(path, "w") as f:
        f.write(f"{ns:6d}\n")
        for i in range(ns):
            f.write(f"{names[i]:<{wname}s} ")
            f.write("".join(f" {M[i, j]:7.4f}" for j in range(i)))
            f.write("\n")
        f.write("\n")


# --------------------------------------------------------------------------
# FigTree tree with posterior mean ages + HPD CIs (mcmctree)
# --------------------------------------------------------------------------

def figtree_newick(parent, children, root, names, ages_mean,
                   hpd_lo=None, hpd_hi=None) -> str:
    """Rooted Newick with branch lengths = mean age differences and
    '[&95%HPD={lo, hi}]' node annotations (reference annotation string,
    mcmctree DescriptiveStatisticsSimpleMCMCTREE)."""
    def ann(i):
        if hpd_lo is None or not any(c >= 0 for c in children[i]):
            return ""
        return f"[&95%HPD={{{hpd_lo[i]:.6g}, {hpd_hi[i]:.6g}}}]"

    def bl(i):
        return ages_mean[parent[i]] - ages_mean[i]

    def build(i):
        kids = [c for c in children[i] if c >= 0]
        if not kids:
            s = names[i]
        else:
            s = "(" + ", ".join(build(c) for c in kids) + ")"
        s += ann(i)
        if i != root:
            s += f": {bl(i):.6f}"
        return s

    return build(root) + ";"


def write_figtree(path: str, newick_annotated: str,
                  timeunit: float | None = None) -> None:
    """NEXUS wrapper (reference: mcmctree.c FigTree.tre block)."""
    with open(path, "w") as f:
        f.write("#NEXUS\nBEGIN TREES;\n\n\tUTREE 1 = ")
        f.write(newick_annotated)
        f.write("\n\nEND;\n")
        if timeunit and timeunit != 1:
            f.write(f"\n[Note for FigTree: Under Time Scale, set Offset = "
                    f"{0.0:.1f}, Scale factor = -{timeunit:.1f}\n")
            f.write("Untick Scale Bar, & tick Tip Labels, Node Bars, "
                    "Scale Axis, Reverse Axis, Show Grid.]\n")
