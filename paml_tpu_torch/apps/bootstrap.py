"""RELL tree support and the tree-comparison table (reference: rell,
src/treesub.c:5844).

Port of `paml_tpu/apps/bootstrap.py` (numpy only): RELL and the
tree-comparison table, the pattern-count bootstrap, tree partitions, the
partition distance and clade support.
"""
from __future__ import annotations

import numpy as np


def rell(site_lnf: np.ndarray, fpatt: np.ndarray, n_boot: int = 10000,
         seed: int = 0):
    """RELL bootstrap proportions for tree support.

    site_lnf: [ntree, H] per-pattern log-likelihoods for each candidate
    tree (the reference reads these from the lnf file).  Resamples pattern
    counts multinomially and counts how often each tree wins.
    Returns (support [ntree], boot_lnL [n_boot, ntree])."""
    rng = np.random.default_rng(seed)
    ntree, H = site_lnf.shape
    ls = int(round(fpatt.sum()))
    p = fpatt / fpatt.sum()
    counts = rng.multinomial(ls, p, size=n_boot)            # [B, H]
    boot = counts @ site_lnf.T                              # [B, ntree]
    best = boot.argmax(1)
    support = np.bincount(best, minlength=ntree) / n_boot
    return support, boot


def tree_comparison(site_lnf: np.ndarray, fpatt: np.ndarray,
                    n_boot: int = 10000, seed: int = 0):
    """Per-tree (lnL, D, SE, pKH, pSH, pRELL) table (reference output after
    multi-tree runs; Kishino & Hasegawa 1989; Shimodaira & Hasegawa 1999
    with the MC correction)."""
    from scipy.stats import norm
    ntree, H = site_lnf.shape
    lnL = site_lnf @ fpatt
    best = int(lnL.argmax())
    ls = fpatt.sum()
    D = lnL - lnL[best]
    # site-wise SE of the difference vs the best tree
    SE = np.zeros(ntree)
    pKH = np.full(ntree, -1.0)
    for i in range(ntree):
        if i == best:
            continue
        d = site_lnf[i] - site_lnf[best]
        mean_d = (d * fpatt).sum() / ls
        var = ((d - mean_d) ** 2 * fpatt).sum() / max(ls - 1, 1)
        SE[i] = np.sqrt(ls * var)
        pKH[i] = norm.cdf(D[i] / SE[i]) if SE[i] > 0 else -1.0
    support, boot = rell(site_lnf, fpatt, n_boot=n_boot, seed=seed)
    # SH with multiple-comparison correction: center each tree's bootstrap
    # lnL, compare observed deficits to the null max-deficit distribution
    R = boot - boot.mean(0)[None, :]                         # [B, ntree]
    pSH = np.full(ntree, -1.0)
    maxR = R.max(1)
    for i in range(ntree):
        if i == best:
            continue
        pSH[i] = float(((maxR - R[:, i]) > -D[i]).mean())
    return dict(lnL=lnL, D=D, SE=SE, pKH=pKH, pSH=pSH, pRELL=support,
                best=best)


def bootstrap_alignment(data, seed: int = 0,
                        n_rep: int = 1):
    """Bootstrap pattern-count resamples (reference: BootstrapSeq).
    Returns list of fpatt vectors (same patterns, resampled counts)."""
    rng = np.random.default_rng(seed)
    ls = int(round(data.fpatt.sum()))
    p = data.fpatt / data.fpatt.sum()
    return [rng.multinomial(ls, p).astype(float) for _ in range(n_rep)]


def tree_partitions(topo) -> set:
    """Set of tip-index bipartitions (frozensets) defined by internal
    branches (reference: Tree2Partition, src/treesub.c:4128)."""
    desc = topo.tip_descendants()
    all_tips = frozenset(range(topo.ns))
    parts = set()
    for node in range(topo.ns, topo.nnode):
        if node == topo.root:
            continue
        s = frozenset(desc[node])
        parts.add(min(s, all_tips - s, key=lambda x: (len(x), sorted(x))))
    return parts


def partition_distance(topo1, topo2) -> int:
    """Robinson-Foulds distance (reference: NSameBranch-based distance,
    src/treesub.c:4560)."""
    p1, p2 = tree_partitions(topo1), tree_partitions(topo2)
    return len(p1 ^ p2)


def clade_support(main_topo, sample_topos) -> dict:
    """Support proportion for each clade of `main_topo` among the sampled
    trees (reference: CladeSupport, src/treesub.c:4275)."""
    main = tree_partitions(main_topo)
    counts = {p: 0 for p in main}
    for t in sample_topos:
        parts = tree_partitions(t)
        for p in main:
            if p in parts:
                counts[p] += 1
    n = max(len(sample_topos), 1)
    return {p: c / n for p, c in counts.items()}
