"""RELL tree support and the tree-comparison table (reference: rell,
src/treesub.c:5844).

Port of `rell` and `tree_comparison` of `paml_tpu/apps/bootstrap.py`
(numpy only).  The sequence bootstrap and clade support of that module wait
for their callers (ROADMAP A14).
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
