"""pamp: parsimony-based rate analysis (Yang & Kumar 1996).

Counterpart of the reference program (src/pamp.c): per-site parsimony
change counts feed three estimators of the gamma shape parameter alpha —
method of moments, the Sullivan et al. (1995) negative-binomial ML, and
the Yang & Kumar (1996) estimator (reference: AlphaMP src/pamp.c:202,
lfunAlpha_Sullivan :233, lfunAlpha_YK96 :249) — plus the parsimony-based
substitution pattern matrix (PatternMP :343).

Port of `paml_tpu/apps/pamp.py`: the change counts and the three
estimators on the host (numpy and scipy, as there); the pattern matrix's
JC69 joint reconstruction (`models/nuc.pmats_for_model`,
`apps/ancestral.joint_reconstruction`) on the device `run` is given.
`pattern_ls` needs least-squares branch lengths from tree search and
raises naming ROADMAP A14.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from scipy.optimize import minimize_scalar
from scipy.special import gammaln

from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from . import ancestral, parsimony


@dataclass
class PampResult:
    n_changes_hist: np.ndarray     # sites with k changes
    mean: float
    var: float
    alpha_mm: float
    alpha_sullivan: float
    alpha_yk96: float
    pattern_matrix: np.ndarray | None = None


def alpha_estimates(changes: np.ndarray, fpatt: np.ndarray, nbranch: int,
                    ncode: int = 4, ncatG: int = 8) -> PampResult:
    maxk = int(changes.max())
    hist = np.zeros(maxk + 1)
    np.add.at(hist, changes, fpatt)
    ntotal = hist.sum()
    mu = (np.arange(maxk + 1) * hist).sum() / ntotal
    var = ((np.arange(maxk + 1) ** 2 * hist).sum()
           - mu * mu * ntotal) / (ntotal - 1)
    alpha_mm = mu * mu / (var - mu) if var > mu else 9.0

    def neg_sullivan(a):
        if a <= 0:
            return 1e300
        lnL = 0.0
        for k in range(maxk + 1):
            if hist[k] == 0:
                continue
            t = -a * math.log(1 + mu / a)
            if k:
                t += (gammaln(k + a) - gammaln(k + 1.0) - gammaln(a)
                      + k * math.log(mu / a / (1 + mu / a)))
            lnL += hist[k] * t
        return -lnL

    r1 = minimize_scalar(neg_sullivan, bounds=(1e-3, 99), method="bounded",
                         options={"xatol": 1e-8})
    a_sull = float(r1.x)

    t_branch = mu / nbranch

    def neg_yk96(a):
        if a <= 0:
            return 1e300
        from scipy.stats import gamma as gdist
        # discrete gamma (mean method) without JAX for speed
        import scipy.special as sps
        K = ncatG
        cuts = sps.gammaincinv(a, np.arange(1, K) / K) / a
        F = sps.gammainc(a + 1, cuts * a)
        Fpad = np.concatenate([[0.0], F, [1.0]])
        rK = np.diff(Fpad) * K
        lnL = 0.0
        n = ncode
        for k in range(maxk + 1):
            if hist[k] == 0:
                continue
            p = 1.0 / n + (n - 1.0) / n * np.exp(-n / (n - 1.0) * rK
                                                 * t_branch)
            prob = np.mean(p ** (nbranch - k)
                           * ((1 - p) / (n - 1.0)) ** k)
            lnL += hist[k] * math.log(max(prob, 1e-300))
        return -lnL

    r2 = minimize_scalar(neg_yk96, bounds=(1e-3, 99), method="bounded",
                         options={"xatol": 1e-8})
    return PampResult(n_changes_hist=hist, mean=mu, var=var,
                      alpha_mm=alpha_mm, alpha_sullivan=a_sull,
                      alpha_yk96=float(r2.x))


def distance_rev(Ft: np.ndarray, alpha: float = 0.0, ls: int = 1000):
    """REV distance from a divergence (F(t)) count matrix (reference:
    DistanceREV, src/pamp.c:574): symmetrize, split into pi and P(t),
    take the matrix log (or the gamma transform when alpha > 0) of the
    eigenvalues, renormalize Q to mean rate 1 and return (t, Q, pi).

    Returns (t, Q [n,n], pi [n], cond) with cond != 0 when F(t) was
    degenerate/modified (the reference's adhockery flags)."""
    n = Ft.shape[0]
    Q = np.array(Ft, float)
    small = 0.1 / max(ls, 1)
    cond = 0
    if Q.sum() - np.trace(Q) < small:
        return 0.0, np.zeros((n, n)), np.full(n, 1.0 / n), 1
    Q = (Q + Q.T) / 2
    Q /= Q.sum()
    pi = Q.sum(1)
    P = np.where(pi[:, None] > small, Q / np.where(pi[:, None] > small,
                                                   pi[:, None], 1.0), Q)
    # eigen of the reversible P via pi-symmetrization
    sq = np.sqrt(np.maximum(pi, 1e-300))
    S = (P * sq[:, None] / sq[None, :])
    S = (S + S.T) / 2
    lam, U = np.linalg.eigh(S)
    lam2 = np.empty_like(lam)
    for i, lv in enumerate(lam):
        if lv <= 0:
            lam2[i] = -300.0            # reference adhockery
            cond = -1
        elif alpha <= 0:
            lam2[i] = math.log(lv)
        else:
            lam2[i] = alpha * (1 - lv ** (-1.0 / alpha))  # gammap
    L = U / sq[:, None]
    R = U.T * sq[None, :]
    Qm = (L * lam2[None, :]) @ R
    t = -float((pi * np.diag(Qm)).sum())
    if t <= 0:
        return 0.0, np.zeros((n, n)), pi, 1
    Qm /= t
    off_mask = ~np.eye(n, dtype=bool)
    Qm[off_mask] = np.maximum(Qm[off_mask], 0.0)   # reference clips offdiag
    return t, Qm, pi, cond


def pattern_ls(topo: Topology, data: seqio.PackedData,
               alpha: float = 0.0):
    """Pairwise REV distances from observed divergence matrices + LS
    branch lengths (reference: PatternLS, src/pamp.c:631).  Its least
    squares come from tree search, which is not ported yet."""
    raise NotImplementedError(
        "pamp.pattern_ls needs treesearch.ls_branch_lengths: ROADMAP A14")


def pattern_matrix(topo: Topology, data: seqio.PackedData, *,
                   device="cuda") -> np.ndarray:
    """Substitution pattern counts from joint parsimony-style
    reconstructions (reference: PatternMP, src/pamp.c:343), here using the
    ML joint reconstruction under JC69-like equal rates."""
    from ..models import nuc
    n = data.nstates
    # quick JC branch lengths ~ 0.1 for reconstruction weighting
    tfull = np.full(topo.nnode, 0.1)
    tfull[topo.root] = 0.0
    pi = torch.full((n,), 1.0 / n, dtype=torch.float64, device=device)
    P, pi_root = nuc.pmats_for_model(
        "JC69", pi.new_zeros(0), pi,
        torch.as_tensor(tfull, device=device)[:, None])
    tips = torch.as_tensor(data.tip_partials, dtype=torch.float64,
                           device=device)
    states, _ = ancestral.joint_reconstruction(P, tips, topo, pi[None, :])
    tips = data.tip_partials.argmax(-1)
    F = np.zeros((n, n))
    for node in range(topo.nnode):
        if node == topo.root:
            continue
        parent = topo.parent[node]
        sp = states[parent - topo.ns]
        sc = (tips[node] if node < topo.ns else states[node - topo.ns])
        np.add.at(F, (sp, sc), data.fpatt)
    return F


def run(seqfile: str, treefile: str, ncatG: int = 8,
        cleandata: bool = True, *, device="cuda") -> PampResult:
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=cleandata)
    trees = treeio.read_trees(treefile, data.names)
    topo = from_treenode(trees[0], data.names)
    changes = parsimony.site_change_counts(topo, data)
    res = alpha_estimates(changes, data.fpatt, topo.nbranch,
                          data.nstates, ncatG)
    res.pattern_matrix = pattern_matrix(topo, data, device=device)
    return res
