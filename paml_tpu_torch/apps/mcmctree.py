"""mcmctree: Bayesian divergence-time estimation.

Port of `paml_tpu/apps/mcmctree.py` (reference: src/mcmctree.c):
birth-death-sampling time prior with fossil calibrations (soft bounds,
gamma, skew-normal/t densities), clock models 1/2/3 (strict, independent
log-normal, geometric Brownian), gamma-Dirichlet locus-rate priors, exact
(usedata=1) and approximate (usedata=2, dos Reis & Yang 2011)
likelihoods, and in.BV generation (usedata=3) by automatic gradients and
Hessians instead of the reference's finite differences.

MCMC: Bactrian proposals in log space with boundary reflection, the five
reference proposal blocks (times, mu/sigma2, branch rates, substitution
parameters, mixing), and burn-in step-length adaptation to Pjump 0.3
(Yang & Rodriguez 2013).  Reference call stack: MCMC(),
src/mcmctree.c:4459.

The priors, the proposals and the chain are host code in float64, copied
from the JAX package with the same numpy Generator and the same order of
draws, so that a chain of this package follows the JAX package's draw for
draw.  The likelihoods run on the device the chain was given, values
only (no autograd graph): every locus's exact likelihood as one batched
level pass (`pruning.lnL_levels_batched`, on the card) or a loop of
per-locus passes (on the host: `EXACT_ROUTE`), every locus's
approximate likelihood as one padded batched quadratic form
(`ApproxBatch`), and the morphological likelihood level by level.  Each
proposal costs one copy to the device and one back.
"""
from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import graphs, optim, pruning
from ..core.topology import Topology, deroot, from_treenode
from ..io import seqio, treeio
from ..models import nuc

# seconds and calls of the chain's parts since import (the in.BV fits and
# Hessians, the likelihood evaluations, the chain, the fossil-error
# constant's Monte Carlo)
SECONDS = {"bv_fit": 0.0, "bv_hessian": 0.0, "lnL_all": 0.0, "chain": 0.0,
           "fossil_constant": 0.0}
COUNTS = {"lnL_all": 0, "iterations": 0}

# the exact likelihood of several loci by device type: "batched" (one
# level pass with a locus axis) or "loop" (one level pass per locus), the
# faster of the two on each (ROADMAP B6; PERF.md)
EXACT_ROUTE = {"cuda": "batched", "cpu": "loop"}

# ---------------------------------------------------------------------------
# calibration densities (reference: lnptCalibrationDensity, mcmctree.c:2924)
# ---------------------------------------------------------------------------


def _ln_calibration_density(t, kind, p):
    if kind == "L":
        a, P, c, tailL = p
        t0 = a * (1 + P)
        s = a * c
        A = 0.5 + 1 / math.pi * math.atan(P / c)
        if t > a:
            z = (t - t0) / s
            return math.log((1 - tailL) / (math.pi * A * s * (1 + z * z)))
        z = P / c
        thetaL = (1 / tailL - 1) / (math.pi * A * c * (1 + z * z))
        return math.log(tailL * thetaL / a) + (thetaL - 1) * math.log(t / a)
    if kind == "U":
        b, tailR = p
        if t < b:
            return math.log((1 - tailR) / b)
        thetaR = (1 - tailR) / (tailR * b)
        return math.log(tailR * thetaR) - thetaR * (t - b)
    if kind == "B":
        a, b, tailL, tailR = p
        if a < t < b:
            return math.log((1 - tailL - tailR) / (b - a))
        if t < a:
            thetaL = (1 - tailL - tailR) * a / (tailL * (b - a))
            return (math.log(tailL * thetaL / a)
                    + (thetaL - 1) * math.log(t / a))
        thetaR = (1 - tailL - tailR) / (tailR * (b - a))
        return math.log(tailR * thetaR) - thetaR * (t - b)
    if kind == "G":
        a, b = p[:2]
        return a * math.log(b) - b * t + (a - 1) * math.log(t) - math.lgamma(a)
    if kind == "SN":
        loc, scale, shape = p[:3]
        z = (t - loc) / scale
        return (math.log(2 / scale) - 0.5 * z * z - 0.5 * math.log(2 * math.pi)
                + _ln_norm_cdf(shape * z))
    if kind == "ST":
        # skew-t density (Azzalini): 2/w * t_v(z) * T_{v+1}(shape * z *
        # sqrt((v+1)/(v+z^2))) — native (reference: PDFSkewT,
        # src/tools.c:3114; CDFt via the incomplete beta function)
        loc, scale, shape, df = p[:4]
        z = (t - loc) / scale
        pdf = (2 / scale * _t_pdf(z, df)
               * _t_cdf(shape * z * math.sqrt((df + 1) / (df + z * z)),
                        df + 1))
        return math.log(max(pdf, 1e-300))
    if kind == "S2N":
        # mixture of two skew normals (reference: lnptCalibrationDensity
        # S2N_F arm, src/mcmctree.c:2982-2985)
        p0, loc1, s1, sh1, loc2, s2, sh2 = p[:7]

        def _sn(t, loc, scale, shape):
            z = (t - loc) / scale
            return (2.0 / scale
                    * math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
                    * _norm_cdf(shape * z))
        pdf = p0 * _sn(t, loc1, s1, sh1) + (1 - p0) * _sn(t, loc2, s2, sh2)
        return math.log(max(pdf, 1e-300))
    raise ValueError(f"calibration kind {kind}")


def _betacf(a, b, x, maxit=200, eps=3e-12):
    """Continued fraction for the incomplete beta (Lentz), host scalars."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < 1e-30:
        d = 1e-30
    d = 1.0 / d
    h = d
    for m in range(1, maxit + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < 1e-30:
            d = 1e-30
        c = 1.0 + aa / c
        if abs(c) < 1e-30:
            c = 1e-30
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < eps:
            break
    return h


def _betainc_host(a, b, x):
    """Regularized incomplete beta I_x(a, b), host scalars (reference:
    IncompleteBeta / CDFBeta, src/tools.c:2680-2778)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    lbeta = (math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b))
    front = math.exp(a * math.log(x) + b * math.log(1.0 - x) - lbeta)
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def _t_pdf(x, df):
    """Student-t density, host scalars."""
    return math.exp(math.lgamma((df + 1) / 2.0) - math.lgamma(df / 2.0)
                    - 0.5 * math.log(df * math.pi)
                    - 0.5 * (df + 1) * math.log1p(x * x / df))


def _t_cdf(x, df):
    """Student-t CDF via the incomplete beta (reference: CDFt,
    src/tools.c:3101)."""
    p = 0.5 * _betainc_host(df / 2.0, 0.5, df / (df + x * x))
    return 1.0 - p if x > 0 else p


def _norm_cdf(x):
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def _ln_norm_cdf(x):
    from scipy.stats import norm
    return norm.logcdf(x)


def _fill_defaults(kind, params):
    """Fill reference default tail probabilities / parameters."""
    p = list(params)
    if kind == "L":                  # L(a, p=0.1, c=1, tailL=0.025)
        while len(p) < 4:
            p.append([None, 0.1, 1.0, 0.025][len(p)])
    elif kind == "U":                # U(b, tailR=0.025)
        while len(p) < 2:
            p.append(0.025)
    elif kind == "B":                # B(a, b, tailL=0.025, tailR=0.025)
        while len(p) < 4:
            p.append(0.025)
    return kind, p


# ---------------------------------------------------------------------------
# BDS kernel (reference: mcmctree.c:2700-2784)
# ---------------------------------------------------------------------------


def _p0t(expmlt, lam, mu, rho):
    return rho * (lam - mu) / (rho * lam + (lam * (1 - rho) - mu) * expmlt)


def _bds_pdf_ln(t, t1, vt1, lam, mu, rho):
    small = 1e-20
    if abs(mu - lam) < small:
        return math.log((1 + rho * lam * t1)
                        / (t1 * (1 + rho * lam * t) ** 2))
    expmlt = math.exp((mu - lam) * t)
    p0 = _p0t(expmlt, lam, mu, rho)
    return math.log(p0 * p0 * lam / (vt1 * rho) * expmlt)


def _bds_cdf(t, t1, vt1, lam, mu, rho):
    small = 1e-20
    if abs(lam - mu) < small:
        return (1 + rho * lam * t1) * t / (t1 * (1 + rho * lam * t))
    expmlt = math.exp((mu - lam) * t)
    if expmlt < 1e10:
        return (rho * lam / vt1 * (1 - expmlt)
                / (rho * lam + (lam * (1 - rho) - mu) * expmlt))
    expmlt = 1 / expmlt
    return (rho * lam / vt1 * (expmlt - 1)
            / (rho * lam * expmlt + (lam * (1 - rho) - mu)))


# ---------------------------------------------------------------------------
# species tree state
# ---------------------------------------------------------------------------


@dataclass
class SpeciesTree:
    topo: Topology
    calibrations: dict                 # node -> (kind, params)
    root_age_prior: tuple | None       # (kind, params) used when root has none
    bds: tuple = (1.0, 1.0, 0.1)       # lambda, mu, rho
    multiplicative: bool = False       # BDS_flag: kernel on all nodes
    psi: float = 0.0                   # BDS fossil-sampling rate (TipDate)
    tip_ages: np.ndarray | None = None  # [ns] nonzero => TipDate model
    # cross-bracing / duplication dating: mirror node -> driver node whose
    # age it shares (reference: stree.duplication, treesub.c:8776-8840)
    mirror_of: dict = field(default_factory=dict)
    # fossil-error model (p_beta, q_beta, nMinCorrect); None = off
    # (reference: data.pfossilerror, UpdatePFossilErrors mcmctree.c:4266)
    pfossilerror: tuple | None = None

    @property
    def ns(self):
        return self.topo.ns

    @property
    def root(self):
        return self.topo.root

    def internal_nodes(self):
        return list(range(self.topo.ns, self.topo.nnode))


def build_species_tree(tree: treeio.TreeNode, names, bds=(1, 1, 0.1),
                       root_age: str | None = None,
                       multiplicative=False,
                       duplication=False) -> SpeciesTree:
    topo = from_treenode(tree, names)
    cals = {}
    labels = {}
    for node in tree.walk_pre():
        ann = node.annotation
        if ann:
            # bracing labels may sit inside the annotation together with a
            # calibration, e.g. '[#1 B{0.5,0.7}]' (dating-cross-bracing)
            m = re.search(r"#\s*(\d+)", ann)
            if m and not node.is_tip:
                labels[node.index] = int(m.group(1))
                ann = (ann[:m.start()] + ann[m.end():]).strip()
        cal = treeio.parse_calibration(ann)
        if cal is not None:
            cals[node.index] = _fill_defaults(*cal)
        if not node.is_tip and node.label:
            labels[node.index] = int(node.label)
    root_prior = None
    if root_age:
        cal = treeio.parse_calibration(root_age)
        if cal is not None:
            root_prior = _fill_defaults(*cal)
    mirror_of: dict = {}
    if duplication:
        # nodes sharing a #k label share one age; the lowest-numbered one
        # drives.  Calibrations are copied to the driver; a calibration on
        # any braced node must agree with the driver's (reference:
        # treesub.c:8776-8840)
        if not labels:
            raise ValueError("duplication dating needs #k node labels")
        groups: dict[int, list] = {}
        for n, k in sorted(labels.items()):
            groups.setdefault(k, []).append(n)
        for k, grp in groups.items():
            if len(grp) < 2:
                raise ValueError(f"label #{k} marks only node {grp[0]}; "
                                 f"cross-bracing needs >= 2 nodes")
            main = grp[0]
            for j in grp[1:]:
                mirror_of[j] = main
                calj = cals.pop(j, None)
                if calj is not None:
                    if main in cals and cals[main] != calj:
                        raise ValueError(
                            f"braced nodes {main} and {j} have different "
                            f"calibrations")
                    cals.setdefault(main, calj)
    return SpeciesTree(topo=topo, calibrations=cals,
                       root_age_prior=root_prior, bds=tuple(bds),
                       multiplicative=multiplicative, mirror_of=mirror_of)


from ..io.treeio import parse_tip_dates  # noqa: E402  (re-export)


def _ln_prior_times_tipdate(st: SpeciesTree, ages: np.ndarray) -> float:
    """Stadler & Yang (2013) Approach 1 birth-death-serial-sampling prior
    on node ages, used for TipDate data (reference:
    lnpriorTimesBDS_Approach1, mcmctree.c:2468)."""
    topo = st.topo
    root = st.root
    lam, mu, rho = st.bds
    psi = st.psi
    t1 = ages[root]
    lnp = 0.0
    if lam <= 0 or mu < 0 or (rho <= 0 and psi <= 0):
        raise ValueError("B-D-S parameters: lambda > 0, mu >= 0, and "
                         "rho > 0 or psi > 0")
    internal = [j for j in st.internal_nodes() if j != root]
    if psi == 0 and abs(lam - mu) < 1e-20:
        c1 = 1 / t1 + rho * lam
        for j in internal:
            c2 = 1 + rho * lam * ages[j]
            lnp += math.log(c1 / (c2 * c2))
    elif psi == 0:
        a = lam - rho * lam - mu
        e = math.exp((mu - lam) * t1)
        c1 = (rho * lam + a * e) / (1 - e)
        for j in internal:
            e = math.exp((mu - lam) * ages[j])
            c2 = (lam - mu) / (rho * lam + a * e)
            c2 *= c2 * e * c1
            lnp += math.log(c2)
    else:
        c1 = math.sqrt((lam - mu - psi) ** 2 + 4 * lam * psi)
        c2 = -(lam - mu - 2 * lam * rho - psi) / c1
        gt1 = 1 / (math.exp(-c1 * t1) * (1 - c2) + (1 + c2))
        for j in internal:
            # z*: the older of the two tips bracketing node j in the
            # ladderized ordering (reference's sons[0]/sons[1] descents)
            k = topo.children[j][0]
            while k >= topo.ns:
                k = topo.children[k][1]
            z0 = ages[k]
            k = topo.children[j][1]
            while k >= topo.ns:
                k = topo.children[k][0]
            zstar = max(z0, ages[k])
            gz = 1 / (math.exp(-c1 * zstar) * (1 - c2) + (1 + c2))
            t = ages[j]
            gt = math.exp(-c1 * t) * (1 - c2) + (1 + c2)
            lnp += -c1 * t + math.log(c1 * (1 - c2)
                                      / (gt * gt * (gt1 - gz)))
    cal = st.calibrations.get(root) or st.root_age_prior
    if cal is None:
        raise ValueError("TipDate model requires bounds on the root age")
    lnp += _ln_calibration_density(t1, cal[0], cal[1])
    return lnp


def _root_calibration(st: SpeciesTree, used) -> tuple | None:
    """Effective root density: the root's own calibration when used (an L
    bound is joined with the RootAge upper bound), else the RootAge prior
    (reference: lnptC root rules, mcmctree.c:3015-3044)."""
    root = st.root
    cal = st.calibrations.get(root) if root in used else None
    if cal is None and st.root_age_prior is not None:
        cal = st.root_age_prior
    elif cal is not None and cal[0] == "L":
        if st.root_age_prior is not None:
            rb = st.root_age_prior[1]
            ub = rb[0] if st.root_age_prior[0] == "U" else rb[1]
            cal = ("B", [cal[1][0], ub, cal[1][3], 0.025])
    return cal


def ln_prior_times(st: SpeciesTree, ages: np.ndarray,
                   pE: float | None = None) -> float:
    """Reference lnpriorTimes (mcmctree.c:3255): lnptC + lnptNCgiventC,
    the BDS Approach-1 density for TipDate data, and the fossil-error
    mixture over used-fossil combinations when pE is given and
    st.pfossilerror is active."""
    if st.tip_ages is not None and st.tip_ages.max() > 0:
        return _ln_prior_times_tipdate(st, ages)
    if (pE is not None and st.pfossilerror is not None
            and st.calibrations):
        return _ln_prior_times_fossil_errors(st, ages, pE)
    return _ln_prior_times_used(st, ages, set(st.calibrations))


def _ln_prior_times_fossil_errors(st: SpeciesTree, ages: np.ndarray,
                                  pE: float) -> float:
    """Mixture over which fossils are in error (excluded), each term
    normalized by the Monte-Carlo feasibility constant of its used-fossil
    combination (reference: lnpriorTimes error arm mcmctree.c:3290-3320,
    getScaleFossilCombination :3056)."""
    from itertools import combinations

    import scipy.special as sps

    nMin = int(st.pfossilerror[2]) if len(st.pfossilerror) > 2 else 0
    fnodes = sorted(st.calibrations)
    nf = len(fnodes)
    pE = min(max(pE, 1e-12), 1 - 1e-12)
    terms = []
    wsum = 0.0
    for nused in range(max(nMin, 0), nf + 1):
        for comb in combinations(fnodes, nused):
            used = set(comb)
            w = (1 - pE) ** nused * pE ** (nf - nused)
            wsum += w
            lnC = _fossil_scale_constant(st, frozenset(used))
            lnpt = _ln_prior_times_used(st, ages, used)
            terms.append(math.log(w) + lnpt - lnC)
    if not terms:
        return -np.inf
    return float(sps.logsumexp(terms)) - math.log(wsum)


def _fossil_scale_constant(st: SpeciesTree, used: frozenset,
                           n_samples: int = 100000) -> float:
    """ln of the feasibility constant: the probability that node ages
    drawn independently from the used calibration densities satisfy the
    ancestor > descendant order (reference: getScaleFossilCombination,
    mcmctree.c:3056, importance sampling with 5e6 replicates — here
    grid-inverse-CDF sampling, cached per combination)."""
    cache = getattr(st, "_fossil_C_cache", None)
    if cache is None:
        cache = {}
        st._fossil_C_cache = cache
    if used in cache:
        return cache[used]
    t0 = time.perf_counter()
    rng = np.random.default_rng(20260819)
    topo = st.topo
    root = st.root
    nodes = sorted(set(used) | {root})
    samples = {}
    for j in nodes:
        cal = (_root_calibration(st, used) if j == root
               else st.calibrations[j])
        if cal is None:              # root unbounded: no constraint value
            samples[j] = None
            continue
        samples[j] = _sample_calibration_density(cal[0], cal[1],
                                                 n_samples, rng)
    feas = np.ones(n_samples, bool)
    for i, a in enumerate(nodes):
        for b in nodes[:i]:
            # is b an ancestor of a (or vice versa)?
            anc, desc = None, None
            k = a
            while k != -1:
                if k == b:
                    anc, desc = b, a
                    break
                k = int(topo.parent[k])
            if anc is None:
                k = b
                while k != -1:
                    if k == a:
                        anc, desc = a, b
                        break
                    k = int(topo.parent[k])
            if anc is None or samples[anc] is None or samples[desc] is None:
                continue
            feas &= samples[anc] > samples[desc]
    C = max(float(feas.mean()), 1.0 / n_samples)
    cache[used] = math.log(C)
    SECONDS["fossil_constant"] += time.perf_counter() - t0
    return cache[used]


def _sample_calibration_density(kind: str, p, size: int, rng) -> np.ndarray:
    """Draw from a calibration density by numeric inverse-CDF on a grid
    (G uses the exact gamma sampler)."""
    if kind == "G":
        return rng.gamma(p[0], 1.0 / p[1], size)
    # support scale
    if kind == "L":
        scale = p[0] * (1 + p[1] + 40 * p[2])
    elif kind == "U":
        scale = (p[0] if p[0] else 1.0) * 8
    elif kind == "B":
        scale = p[1] * 4
    elif kind == "SN":
        scale = abs(p[0]) + 12 * abs(p[1])
    elif kind == "ST":
        scale = abs(p[0]) + 20 * abs(p[1])
    elif kind == "S2N":
        scale = abs(p[1]) + abs(p[4]) + 12 * (abs(p[2]) + abs(p[5]))
    else:
        scale = 10.0
    grid = np.linspace(1e-9, max(scale, 1e-6), 16384)
    lp = np.array([_ln_calibration_density(t, kind, p) for t in grid])
    dens = np.exp(lp - lp.max())
    cdf = np.cumsum(dens)
    cdf /= cdf[-1]
    u = rng.random(size)
    return np.interp(u, cdf, grid)


def _ln_prior_times_used(st: SpeciesTree, ages: np.ndarray,
                         used) -> float:
    topo = st.topo
    root = st.root
    t1 = ages[root]
    lam, mu, rho = st.bds
    lnpt = 0.0

    # --- lnptC: calibration densities (incl. root) ---
    for j in st.internal_nodes():
        if j == root:
            cal = _root_calibration(st, used)
            if cal is not None:
                lnpt += _ln_calibration_density(ages[j], cal[0], cal[1])
            continue
        cal = st.calibrations.get(j) if j in used else None
        if cal is not None:
            lnpt += _ln_calibration_density(ages[j], cal[0], cal[1])

    # cross-bracing: mirrored ages are not free — the BDS/order term is
    # dropped and the prior is the calibration densities alone
    # (reference: lnpriorTimes skips lnptNCgiventC when stree.duplication,
    # mcmctree.c:3273)
    if st.mirror_of:
        return lnpt

    # --- BDS kernel for (non-)calibration nodes ---
    small = 1e-20
    if abs(lam - mu) > small:
        expmlt = math.exp((mu - lam) * t1)
        p0t1 = _p0t(expmlt, lam, mu, rho)
        vt1 = 1 - p0t1 / rho * expmlt
    else:
        p0t1 = rho / (1 + rho * mu * t1)
        vt1 = mu * t1 * p0t1
    noncal = [j for j in st.internal_nodes()
              if j != root and (st.multiplicative or j not in used)]
    for j in noncal:
        lnpt += _bds_pdf_ln(ages[j], t1, vt1, lam, mu, rho)
    if st.multiplicative:
        return lnpt

    # conditional construction: divide by the marginal of calibration ages
    # (eq. 9 in Yang & Rannala 2006; reference mcmctree.c:2850-2900)
    tall = np.sort([ages[j] for j in st.internal_nodes()])
    tc = np.sort([ages[j] for j in st.internal_nodes()
                  if j != root and j in used])
    n1 = len(tall)
    if len(tc):
        ranktc = []
        j = 0
        for i, tci in enumerate(tc):
            if i:
                j = ranktc[i - 1] + 1
            while j < n1 and tall[j] <= tci:
                j += 1
            ranktc.append(j)
        rankprev, cdfprev = 0, 0.0
        for i in range(len(tc) + 1):
            if i < len(tc):
                cdf = _bds_cdf(tc[i], t1, vt1, lam, mu, rho)
                k = ranktc[i] - rankprev - 1
            else:
                cdf = 1.0
                k = n1 - rankprev - 1
            if k > 0:
                if cdf <= cdfprev:
                    return -np.inf
                lnpt += math.lgamma(k + 1.0) - k * math.log(cdf - cdfprev)
            rankprev = ranktc[i] if i < len(tc) else rankprev
            cdfprev = cdf
    return lnpt


def ln_prior_rates_per_locus(st: SpeciesTree, rates: np.ndarray,
                             mu: np.ndarray, sigma2: np.ndarray,
                             ages: np.ndarray, clock: int) -> np.ndarray:
    """Per-locus clock 2/3 branch-rate log priors ([g]); the total is
    their sum (reference: lnpriorRates, mcmctree.c:3751).  The
    factorization over loci powers batched rate/parameter proposals with
    independent per-locus accept/reject."""
    topo = st.topo
    g = rates.shape[1]
    s = topo.ns
    root = st.root
    lnpR = np.full(g, -0.5 * math.log(2 * math.pi) * (2 * s - 2))
    if clock == 2:
        lnpR -= np.log(sigma2) / 2.0 * (2 * s - 2)
        nonroot = np.array([i for i in range(topo.nnode) if i != root])
        r = rates[nonroot]                       # [nb, g]
        zz = np.log(r / mu[None, :]) + sigma2[None, :] / 2
        lnpR += (-zz * zz / (2 * sigma2[None, :]) - np.log(r)).sum(0)
        return lnpR
    if clock == 3:
        for inode in range(topo.nnode):
            kids = [c for c in topo.children[inode] if c >= 0]
            if not kids:
                continue
            dad = topo.parent[inode]
            t = ages[inode]
            tA = 0.0 if inode == root else (ages[dad] - t) / 2
            t1 = (t - ages[kids[0]]) / 2
            t2 = (t - ages[kids[1]]) / 2
            detT = t1 * t2 + tA * (t1 + t2)
            if detT <= 0:
                return np.full(g, -np.inf)
            Ti = np.array([(tA + t2), -tA, (tA + t1)]) / detT
            rA = mu if inode == root else rates[inode]
            r1, r2 = rates[kids[0]], rates[kids[1]]
            y1 = np.log(r1 / rA) + (tA + t1) * sigma2 / 2
            y2 = np.log(r2 / rA) + (tA + t2) * sigma2 / 2
            zz = y1 * y1 * Ti[0] + 2 * y1 * y2 * Ti[1] + y2 * y2 * Ti[2]
            lnpR -= (zz / (2 * sigma2) + np.log(detT * sigma2 ** 2) / 2
                     + np.log(r1 * r2))
        return lnpR
    return np.zeros(g)


def ln_prior_rates(st: SpeciesTree, rates: np.ndarray, mu: np.ndarray,
                   sigma2: np.ndarray, ages: np.ndarray, clock: int) -> float:
    """Total clock 2/3 branch-rate prior (sum of the per-locus terms)."""
    return float(ln_prior_rates_per_locus(st, rates, mu, sigma2, ages,
                                          clock).sum())


def ln_prior_gamma_dirichlet(para: np.ndarray, gD) -> float:
    """Gamma-Dirichlet prior over locus parameters (dos Reis et al. 2014
    eq. 5; reference acceptance terms in UpdateParaRates/mixing)."""
    g = len(para)
    a, b, ad = gD
    s = float(para.sum())
    return ((a - ad * g) * math.log(s) - (b / g) * s
            + (ad - 1) * float(np.log(para).sum()))


# ---------------------------------------------------------------------------
# likelihoods
# ---------------------------------------------------------------------------


@dataclass
class ApproxLocus:
    """(transformed) branch-length MLEs + gradient + Hessian for one locus
    (reference: ReadBlengthGH, mcmctree.c:1266)."""
    names: list[str]
    topo: Topology                  # unrooted gene tree (from in.BV)
    bl: np.ndarray                  # [nb] MLEs (transformed except log)
    gradient: np.ndarray
    hessian: np.ndarray
    transform: str = "arcsin"       # 'none' | 'sqrt' | 'log' | 'arcsin'
    ncode: int = 4

    def transform_gh(self):
        """Apply the branch-length transform to (bl, g, H) in place
        (reference: ReadBlengthGH transform block)."""
        b = self.bl
        g = self.gradient.copy()
        H = self.hessian.copy()
        cJC = (self.ncode - 1.0) / self.ncode
        if self.transform == "none":
            return
        if self.transform == "sqrt":
            dbu = 2 * np.sqrt(b)
            dbu2 = np.full_like(b, 2.0)
        elif self.transform == "log":
            bTlog, elog = 1e-5, 0.1
            e = np.where(b < bTlog, elog, 0.0)
            dbu = b + e
            dbu2 = dbu.copy()
        elif self.transform == "arcsin":
            u = 2 * np.arcsin(np.sqrt(cJC - cJC * np.exp(-b / cJC)))
            s2, c2 = np.sin(u / 2), np.cos(u / 2)
            dbu = s2 * c2 / (1 - s2 * s2 / cJC)
            dbu2 = ((c2 * c2 - s2 * s2) / 2 / (1 - s2 * s2 / cJC)
                    + dbu * dbu / cJC)
        else:
            raise ValueError(self.transform)
        H = H * dbu[:, None] * dbu[None, :]
        H[np.diag_indices_from(H)] = (np.diag(self.hessian) * dbu * dbu
                                      + self.gradient * dbu2)
        g = g * dbu
        if self.transform == "sqrt":
            self.bl = np.sqrt(b)
        elif self.transform == "arcsin":
            self.bl = 2 * np.arcsin(np.sqrt(cJC - cJC * np.exp(-b / cJC)))
        self.gradient, self.hessian = g, H


_TRANSFORMS = ("none", "sqrt", "log", "arcsin")


class ApproxBatch:
    """The approximate likelihood of several loci on the device: each
    locus's (transformed) MLEs, gradient and Hessian padded to the most
    branches, so that every locus's Taylor form is one batched product
    (reference: lnpD_locus_Approx, mcmctree.c:1212).  `lnL(bu)` takes the
    unrooted branch lengths [G, nbmax] of the loci (padding any finite
    value) and returns lnL [G]."""

    def __init__(self, loci, *, device, dtype=torch.float64):
        G = len(loci)
        nbmax = max(len(l.bl) for l in loci)
        bl = np.ones((G, nbmax))
        grad = np.zeros((G, nbmax))
        H = np.zeros((G, nbmax, nbmax))
        mask = np.zeros((G, nbmax), bool)
        for g, l in enumerate(loci):
            nb = len(l.bl)
            bl[g, :nb], grad[g, :nb] = l.bl, l.gradient
            H[g, :nb, :nb] = l.hessian
            mask[g, :nb] = True
        kind = np.array([_TRANSFORMS.index(l.transform) for l in loci])
        cJC = np.array([(l.ncode - 1.0) / l.ncode for l in loci])

        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=device)
        self.G, self.nbmax = G, nbmax
        self.bl, self.grad, self.H = t(bl), t(grad), t(H)
        self.mask = t(mask, torch.bool)
        self.kind = t(kind[:, None], torch.int64)
        self.cJC = t(cJC[:, None])
        # the log transform's floor on branches near 0 (bTlog, elog)
        self.e = t(np.where(bl < 1e-5, 0.1, 0.0))

    def lnL(self, bu: torch.Tensor, rows=slice(None)) -> torch.Tensor:
        """lnL [g] of the loci `rows` at unrooted branch lengths bu [g,
        nbmax] (a tensor on the device)."""
        with torch.inference_mode():
            bl, e, cJC, kind = (self.bl[rows], self.e[rows], self.cJC[rows],
                                self.kind[rows])
            zlog = torch.log((bu + e) / (bl + e))
            zarc = 2 * torch.arcsin(torch.sqrt(torch.clamp_min(
                cJC - cJC * torch.exp(-bu / cJC), 0.0)))
            z = torch.where(kind == 1, torch.sqrt(bu),
                            torch.where(kind == 3, zarc, bu)) - bl
            z = torch.where(kind == 2, zlog, z)
            z = torch.where(self.mask[rows], z, torch.zeros_like(z))
            return ((self.grad[rows] * z).sum(-1)
                    + 0.5 * torch.einsum("gi,gij,gj->g", z, self.H[rows],
                                         z))


def approx_lnL(locus: ApproxLocus, blens: np.ndarray, *,
               device) -> float:
    """Taylor approximation at predicted branch lengths (reference:
    lnpD_locus_Approx, mcmctree.c:1212), one locus on `device`."""
    ab = ApproxBatch([locus], device=device)
    bu = torch.as_tensor(np.asarray(blens, np.float64)[None],
                         device=device)
    return float(ab.lnL(bu)[0])


@dataclass
class MorphLocus:
    """Continuous morphological characters (F73 Brownian-motion model;
    reference: ReadMorphology src/treesub.c:436, lnLmorphF73
    src/mcmctree.c:1089)."""
    names: list
    z: np.ndarray               # [ns, ls] measurements, species-tree order
    popvar: float = 0.0         # population variance added to tip branches
    ldetRm: float = 0.0         # log-det of the character correlation R

    @property
    def ls(self):
        return self.z.shape[1]


def _morph_lnL(topo: Topology, b: torch.Tensor, z: torch.Tensor,
               popvar: float, ldetRm: float) -> torch.Tensor:
    """lnLmorphF73 level by level on b's device: b [nnode] the branch
    length above each node (0 at the root), z [ns, ls]."""
    for node in topo.postorder:
        if int((topo.children[node] >= 0).sum()) != 2:
            raise ValueError("morphological likelihood needs a rooted "
                             "binary tree")
    with torch.inference_mode():
        ns, ls = topo.ns, z.shape[1]
        x = z.new_zeros((topo.nnode, ls))
        x[:ns] = z
        # what each node's branch adds: popvar at a tip, the contrast's
        # correction at an internal node
        extra = b.new_zeros(topo.nnode)
        extra[:ns] = popvar
        lnL = b.new_zeros(())
        bad = torch.zeros((), dtype=torch.bool, device=b.device)
        for level in pruning._levels(topo):
            nodes = torch.as_tensor([v for v, _ in level], device=b.device)
            k0 = torch.as_tensor([k[0] for _, k in level], device=b.device)
            k1 = torch.as_tensor([k[1] for _, k in level], device=b.device)
            v0, v1 = b[k0] + extra[k0], b[k1] + extra[k1]
            vv = v0 + v1
            bad = bad | (vv <= 0).any()
            zz = ((x[k0] - x[k1]) ** 2).sum(1)
            lnL = lnL + (-0.5 * ls * torch.log(2 * math.pi * vv)
                         - zz / (2 * vv) - ldetRm / 2.0).sum()
            x[nodes] = (v0[:, None] * x[k1] + v1[:, None] * x[k0]) \
                / vv[:, None]
            extra[nodes] = v0 * v1 / vv
        return torch.where(bad, torch.full_like(lnL, -math.inf), lnL)


def lnL_morph_F73(topo: Topology, b_by_node: dict, z: np.ndarray,
                  popvar: float, ldetRm: float, *, device) -> float:
    """Felsenstein-1973 independent-contrasts likelihood of continuous
    characters under Brownian motion (reference: lnLmorphF73,
    src/mcmctree.c:1089), on `device`.  b_by_node: branch length (duration
    x rate) above each node; tips get + popvar; each internal node
    contributes a contrast with variance v0+v1 and passes v0*v1/(v0+v1)
    up."""
    b = np.zeros(topo.nnode)
    for i, v in b_by_node.items():
        b[i] = v
    return float(_morph_lnL(
        topo, torch.as_tensor(b, device=device),
        torch.as_tensor(np.asarray(z, float), device=device), popvar,
        ldetRm))


def gene_branch_lengths(st: SpeciesTree, ages: np.ndarray,
                        rates_or_mu, clock: int, locus: int,
                        map_nodes=None) -> dict:
    """Branch lengths b_i = sum of t_seg * r_seg down each branch
    (reference: lnpD_locus, mcmctree.c:1143-1161).  With the gene tree
    equal to the species tree, b_i = (t_dad - t_i) * r_i."""
    topo = st.topo
    out = {}
    for i in range(topo.nnode):
        if i == st.root:
            continue
        dt = ages[topo.parent[i]] - ages[i]
        if clock == 1:
            out[i] = dt * rates_or_mu[locus]
        else:
            out[i] = dt * rates_or_mu[i, locus]
    return out


def rooted_to_unrooted_blens(st: SpeciesTree, b_by_node: dict,
                             branch_order: list) -> np.ndarray:
    """Collapse the two root branches into one (placed on the first root
    son) and return branch lengths in `branch_order` (list of species-tree
    node ids with the root-merged branch marked as ('rootpair', son1))."""
    out = np.zeros(len(branch_order))
    for k, ref in enumerate(branch_order):
        if isinstance(ref, tuple):
            _, s1, s2 = ref
            out[k] = b_by_node[s1] + b_by_node[s2]
        else:
            out[k] = b_by_node[ref]
    return out


class ExactLoci:
    """usedata=1: the exact likelihood of sequence loci on the rooted
    species tree, on the device, values only.  Every locus's class rates
    come from `dgamma.discrete_gamma` over the loci's alphas inside the
    evaluation (E2 on the card), every locus's P(t) from one batched
    closed form (the TN93 family; a loop over loci for the other models),
    and the pruning is `pruning.lnL_levels_batched` over all loci, or one
    `pruning.lnL` per locus (`route`).  The patterns are padded to the
    longest locus (all-ones tips, fpatt 0), as the JAX package's vmap pads
    them (paml_tpu/apps/mcmctree.py:1245-1272).

    On the card an evaluation is replayed from a value-only CUDA graph
    (`graphs.GraphedValue`), as the JAX package jits it per locus (:1217)
    and over all loci (:1272): one graph for each set of loci and route
    asked for (all loci for `lnL_all`, each locus for `lnL_locus`), its
    inputs b [g, nnode], kappa [g] and alpha [g] in static buffers, a call
    one copy in and one copy of lnL and the status word out."""

    def __init__(self, loci, topo: Topology, spec, *, device):
        self.topo, self.model, self.device = topo, spec.model, device
        self.K = spec.ncatG if spec.alpha > 0 else 1
        G = len(loci)
        Hmax = max(l.npatt for l in loci)
        tips = np.ones((G, topo.ns, Hmax, 4))
        fpatt = np.zeros((G, Hmax))
        pis = np.zeros((G, 4))
        for i, l in enumerate(loci):
            tips[i, :, :l.npatt] = l.tip_partials
            fpatt[i, :l.npatt] = l.fpatt
            pis[i] = nuc.model_pi(spec.model, l.base_freqs)
        self.npatt = [l.npatt for l in loci]
        self.tips = torch.as_tensor(tips, device=device)
        self.fpatt = torch.as_tensor(fpatt, device=device)
        self.pis = torch.as_tensor(pis, device=device)
        self._sel = {}         # rows -> their index tensor on the device
        self._graphs = {}      # (rows, route) -> GraphedValue

    def _pmats(self, kappa: torch.Tensor, pis: torch.Tensor, ts):
        """P [G, nnode, K, 4, 4] and the root frequencies [G, 4]."""
        if self.model in nuc.TN93_FAMILY:
            P, _ = nuc.pmats_for_model(self.model, kappa[:, None, None, None],
                                       pis[:, None, None, :], ts)
            return P, pis
        Ps, roots = zip(*(nuc.pmats_for_model(self.model, kappa[g:g + 1],
                                              pis[g], ts[g])
                          for g in range(ts.shape[0])))
        return torch.stack(Ps), torch.stack(roots)

    def _lnl(self, bt: torch.Tensor, kappa: torch.Tensor,
             alpha: torch.Tensor, rows: tuple, route: str) -> torch.Tensor:
        """lnL [g] of the loci `rows` from device tensors b [g, nnode],
        kappa [g] and alpha [g]: no host read."""
        from ..core.dgamma import discrete_gamma

        if len(rows) == len(self.npatt):
            sel = slice(None)
        else:
            if rows not in self._sel:
                self._sel[rows] = torch.as_tensor(rows, device=self.device)
            sel = self._sel[rows]
        with torch.inference_mode():
            if self.K > 1:
                r, w = discrete_gamma(alpha, self.K)           # [g, K]
            else:
                r = w = alpha.new_ones((len(rows), 1))
            ts = bt[:, :, None] * r[:, None, :]
            P, pi_root = self._pmats(kappa, self.pis[sel], ts)
            piC = pi_root[:, None, :].expand(len(rows), self.K, 4)
            if route == "batched":
                return pruning.lnL_levels_batched(P, self.tips[sel],
                                                  self.topo, piC, w,
                                                  self.fpatt[sel])
            if route == "loop":
                return torch.stack([pruning.lnL(
                    P[i], self.tips[g, :, :self.npatt[g]], self.topo,
                    piC[i], w[i], self.fpatt[g, :self.npatt[g]])
                    for i, g in enumerate(rows)])
            raise ValueError(f"exact route {route!r}")

    def lnl(self, b: np.ndarray, kappa: np.ndarray, alpha: np.ndarray,
            rows=None, route: str | None = None,
            graphed: bool | None = None) -> np.ndarray:
        """lnL [g] of the loci `rows` (all by default) at branch lengths b
        [g, nnode] (the root's 0), kappa [g] and alpha [g]; on the card
        from the CUDA graph of these rows and route (captured at the first
        call), or op by op with `graphed` False."""
        rows = tuple(range(len(self.npatt)) if rows is None else rows)
        dev = torch.device(self.device)
        route = route or EXACT_ROUTE[dev.type]
        args = [np.asarray(b, np.float64).reshape(len(rows), self.topo.nnode),
                np.asarray(kappa, np.float64).reshape(-1),
                np.asarray(alpha, np.float64).reshape(-1)]
        if graphed is None:
            graphed = dev.type == "cuda"
        if graphed:
            key = (rows, route)
            if key not in self._graphs:
                self._graphs[key] = graphs.GraphedValue(
                    lambda bt, k, a: self._lnl(bt, k, a, rows, route),
                    [torch.as_tensor(a, device=dev) for a in args])
                optim.GRAPHS["captures"] += 1
            optim.GRAPHS["graphed_evals"] += 1
            return self._graphs[key](*args)
        optim.GRAPHS["eager_evals"] += 1
        t = [torch.as_tensor(a, device=dev) for a in args]
        with graphs.status_sink() as sink:
            out = self._lnl(*t, rows, route)
        return graphs.fetch([out], sink, "exact likelihood")[0].numpy()


def read_BV(path: str, ngene: int, transform: str = "arcsin",
            ncode: int = 4) -> list[ApproxLocus]:
    """Read a reference-format in.BV: per locus, ns, the unrooted gene tree
    with branch lengths, the nb=2ns-3 branch-length MLEs, the gradient,
    'Hessian', and the nb x nb matrix (reference: ReadBlengthGH,
    mcmctree.c:1266).  Vectors in the file are in the reference's ibranch
    order — the textual (preorder) appearance order of non-root nodes in
    the Newick string (treesub.c:3111-3159) — and are permuted here to our
    Topology.branch_nodes() order."""
    text = open(path).read()
    pos = 0
    loci = []
    for _ in range(ngene):
        m = re.search(r"\s*(\d+)\s", text[pos:])
        ns = int(m.group(1))
        pos += m.end()
        end = text.index(";", pos)
        tree_str = text[pos:end + 1]
        pos = end + 1
        node = treeio.parse_newick(tree_str.strip())
        names = [n.name for n in node.walk_pre() if not n.children]
        topo = from_treenode(node, names)
        if ns != topo.ns:
            raise ValueError(f"in.BV: ns {topo.ns} != {ns}")
        nb = 2 * ns - 3
        toks = text[pos:].split()
        need = 2 * nb + 1 + nb * nb
        vals = toks[:need]
        if vals[2 * nb].lower().find("hessian") < 0:
            raise ValueError("in.BV: expected 'Hessian' header")
        bl_ref = np.array([float(v) for v in vals[:nb]])
        grad_ref = np.array([float(v) for v in vals[nb:2 * nb]])
        H_ref = np.array([float(v) for v in vals[2 * nb + 1:need]]
                         ).reshape(nb, nb)
        # advance pos past the consumed tokens
        consumed = 0
        count = 0
        for mt in re.finditer(r"\S+", text[pos:]):
            count += 1
            if count == need:
                consumed = mt.end()
                break
        pos += consumed
        # ibranch order = preorder appearance of non-root nodes
        order = []
        def _pre(n):
            if n.index != topo.root:
                order.append(n.index)
            for c in n.children:
                _pre(c)
        # re-derive each parsed node's topology index by matching tip sets
        _assign_indices(node, topo)
        _pre(node)
        if len(order) != nb:
            raise ValueError("in.BV: branch count mismatch")
        branch_nodes = topo.branch_nodes().tolist()
        perm = np.array([order.index(n) for n in branch_nodes])
        # consistency check: the MLE vector equals the tree's own lengths
        tree_bl = np.array([topo.blen0[n] for n in branch_nodes])
        if not np.allclose(bl_ref[perm], tree_bl, atol=5e-5):
            raise ValueError("in.BV: branch-length vector does not match "
                             "the gene tree")
        al = ApproxLocus(names=names, topo=topo, bl=bl_ref[perm],
                         gradient=grad_ref[perm],
                         hessian=H_ref[np.ix_(perm, perm)],
                         transform=transform, ncode=ncode)
        al.transform_gh()
        loci.append(al)
    return loci


def _assign_indices(root_node, topo: Topology) -> None:
    """Set .index on each TreeNode to its Topology node id (tips by name;
    internals by tip-set identity)."""
    name_to_tip = {n: i for i, n in enumerate(topo.node_names[:topo.ns])}
    desc = topo.tip_descendants()
    clade_to_node = {frozenset(desc[j]): j for j in range(topo.nnode)}

    def walk(n) -> frozenset:
        if not n.children:
            s = frozenset([name_to_tip[n.name]])
        else:
            s = frozenset().union(*(walk(c) for c in n.children))
        n.index = clade_to_node[s]
        return s

    walk(root_node)

# ---------------------------------------------------------------------------
# in.BV generation (usedata=3) — autodiff gradients & Hessians
# ---------------------------------------------------------------------------


def generate_BV(alignments, tree: treeio.TreeNode, names, model="HKY85",
                ncatG=5, alpha0=0.5, fix_alpha=False, cleandata=False,
                outfile="out.BV", *, device):
    """Fit each locus's unrooted branch lengths by ML on `device` and write
    MLEs, gradient and Hessian in the reference in.BV format (reference
    does this by running baseml with finite differences:
    GenerateBlengthGH, mcmctree.c:1424; here the gradient comes from
    autograd and the Hessian from `codeml.hessian` on the objective's
    twice-differentiable route).  Returns per locus (data, unrooted
    topology, MLEs, gradient, Hessian), in `branch_nodes` order."""
    import dataclasses

    from . import codeml
    from .baseml import BasemlSpec, fit_packed, make_objective

    lines = []
    per_locus = []
    for aln in alignments:
        data = seqio.pack(aln, cleandata=cleandata)
        # deroot species tree restricted to this locus's taxa
        topo = from_treenode(tree, data.names)
        utopo = deroot(topo)
        spec = BasemlSpec(model=model, ncatG=ncatG, fix_alpha=fix_alpha,
                          alpha=alpha0, cleandata=cleandata)
        t0 = time.perf_counter()
        res = fit_packed(data, utopo, spec, device=device)
        t1 = time.perf_counter()
        SECONDS["bv_fit"] += t1 - t0
        nb = len(utopo.branch_nodes())
        # gradient/Hessian over the branch-length block only: rebuild the
        # objective with kappa/alpha FIXED at their MLEs so that x = blens
        kappa_mle = (float(res.rate_params[0]) if res.rate_params.size
                     else spec.kappa)
        alpha_mle = (float(res.alpha[0]) if res.alpha is not None
                     else spec.alpha)
        spec_fix = dataclasses.replace(
            spec, fix_kappa=True, kappa=kappa_mle,
            fix_alpha=True, alpha=alpha_mle)
        neg2, *_ = make_objective(data, utopo, spec_fix, device=device)
        tvec = np.asarray(res.x[:nb], dtype=np.float64)
        xt = torch.tensor(tvec, device=device, requires_grad=True)
        (g,) = torch.autograd.grad(neg2(xt), xt)
        grad = -g.cpu().numpy()
        H = -codeml.hessian(neg2, tvec, device=device)
        SECONDS["bv_hessian"] += time.perf_counter() - t1
        bl = res.blens
        per_locus.append((data, utopo, bl, grad, H))

        bn = utopo.branch_nodes().tolist()
        bl_by_node = dict(zip(bn, bl.tolist()))
        nwk = _tree_with_blens(utopo, bl_by_node)
        # the file's vectors in the reference's ibranch order, the textual
        # preorder of the tree's non-root nodes, which `read_BV` reads
        # (the JAX package writes them in branch_nodes order: ROADMAP C)
        o = [bn.index(n) for n in _preorder(utopo)[1:]]
        lines.append(f"\n{data.ns}\n\n{nwk}\n\n")
        lines.append(" ".join(f"{v:.6f}" for v in bl[o]) + "\n\n")
        lines.append(" ".join(f"{v:.6f}" for v in grad[o]) + "\n\n")
        lines.append("Hessian\n\n")
        for row in H[np.ix_(o, o)]:
            lines.append(" ".join(f"{v:.4f}" for v in row) + "\n")
    with open(outfile, "w") as f:
        f.writelines(lines)
    return per_locus


def _preorder(topo: Topology) -> list[int]:
    """Nodes in the order `_tree_with_blens` writes them."""
    out = []

    def walk(i):
        out.append(i)
        for c in topo.children[i]:
            if c >= 0:
                walk(int(c))
    walk(topo.root)
    return out


def _tree_with_blens(topo: Topology, bl: dict) -> str:
    def build(i):
        kids = [c for c in topo.children[i] if c >= 0]
        s = (topo.node_names[i] if not kids
             else "(" + ", ".join(build(c) for c in kids) + ")")
        if i in bl:
            s += f": {bl[i]:.6f}"
        return s
    return build(topo.root) + ";"


# ---------------------------------------------------------------------------
# the MCMC
# ---------------------------------------------------------------------------


@dataclass
class McmcSpec:
    clock: int = 2
    usedata: int = 2
    bds: tuple = (1.0, 1.0, 0.1)
    multiplicative: bool = False
    root_age: str | None = None
    rgene_gamma: tuple = (2.0, 20.0, 1.0)
    sigma2_gamma: tuple = (1.0, 10.0, 1.0)
    kappa_gamma: tuple = (6.0, 2.0)
    alpha_gamma: tuple = (1.0, 1.0)
    model: str = "HKY85"           # usedata=1 substitution model
    ncatG: int = 5
    alpha: float = 0.5             # >0 turns on gamma rates (usedata=1)
    burnin: int = 2000
    sampfreq: int = 5
    nsample: int = 10000
    seed: int = 12345
    cleandata: bool = False
    transform: str = "arcsin"
    finetune: tuple = (0.1, 0.1, 0.1, 0.1, 0.1)
    lnL_beta: float = 1.0          # BayesFactorBeta power-posterior beta
    # (reference: stepping-stones / thermodynamic integration,
    #  mcmctree.c BayesFactorBeta option; 1.0 = ordinary posterior)


class _Bactrian:
    m = 0.95
    s = math.sqrt(1 - 0.95 ** 2)

    def __init__(self, rng):
        self.rng = rng

    def __call__(self):
        z = self.m + self.rng.standard_normal() * self.s
        return -z if self.rng.random() < 0.5 else z


def _reflect(x, a, b, rng):
    if b - a < 1e-200:
        raise ValueError("improper reflect range")
    side = 0
    e = 0.0
    if x < a:
        e, side = a - x, 0
    elif x > b:
        e, side = x - b, 1
    if e:
        n = math.floor(e / (b - a))
        if n % 2 == 1:
            side = 1 - side
        e -= n * (b - a)
        x = (b - e) if side else (a + e)
    while x - a < 1e-200 or b - x < 1e-200:
        x = a + (b - a) * rng.random()
    return x


class MCMCTree:
    """Host-driven MCMC with the likelihoods on `device`."""

    def __init__(self, st: SpeciesTree, loci, spec: McmcSpec, *, device):
        self.st = st
        self.spec = spec
        self.device = device
        self.loci = loci               # list of ApproxLocus (usedata=2)
                                       # or PackedData (usedata=1)
        self.g = len(loci)
        self.rng = np.random.default_rng(spec.seed)
        self.bactrian = _Bactrian(self.rng)
        topo = st.topo
        self.n_int = topo.nnode - topo.ns
        # branch order for approx loci: map species-tree branches onto the
        # unrooted gene-tree branch vector
        if spec.usedata == 2:
            self.branch_orders = [self._match_branches(l) for l in loci]
        self._init_state()
        self._setup_likelihoods()

    # -- setup ---------------------------------------------------------

    def _match_branches(self, locus: ApproxLocus):
        """Map the locus's unrooted branch vector onto species-tree nodes.
        Branch k of the gene tree (node above gene node) corresponds to a
        species-tree node via tip-set identity; the root-adjacent branch of
        the species tree maps to the merged pair."""
        st = self.st
        stopo = st.topo
        gtopo = locus.topo
        sdesc = stopo.tip_descendants()
        sname = [frozenset(stopo.node_names[t] for t in sdesc[i])
                 for i in range(stopo.nnode)]
        gdesc = gtopo.tip_descendants()
        all_tips = frozenset(n for n in gtopo.node_names[:gtopo.ns])
        root_sons = [c for c in stopo.children[st.root] if c >= 0]
        order = []
        for gb in gtopo.branch_nodes():
            tips = frozenset(gtopo.node_names[t] for t in gdesc[gb])
            matched = None
            for i in range(stopo.nnode):
                if i == st.root:
                    continue
                if sname[i] == tips or sname[i] == all_tips - tips:
                    matched = i
                    break
            if matched is None:
                raise ValueError("gene tree branch not in species tree")
            # the branch incident to the species root appears as the
            # merged pair of root-son branches
            if matched in root_sons and (
                    sname[matched] == tips or sname[matched] == all_tips - tips):
                # does this gene branch correspond to the root-spanning
                # branch?  It does iff the OTHER root son's clade is the
                # complement.
                other = root_sons[1] if matched == root_sons[0] else root_sons[0]
                if sname[other] == all_tips - sname[matched]:
                    order.append(("rootpair", root_sons[0], root_sons[1]))
                    continue
            order.append(matched)
        return order

    def _init_state(self):
        st, spec = self.st, self.spec
        topo = st.topo
        rng = self.rng
        ages = np.zeros(topo.nnode)
        if st.tip_ages is not None:
            ages[:topo.ns] = st.tip_ages
        # initialize ages respecting calibrations: root age from prior
        root_cal = st.calibrations.get(st.root) or st.root_age_prior
        if root_cal is not None:
            k, p = root_cal
            t1 = {"B": lambda: (p[0] + p[1]) / 2, "U": lambda: p[0] * 0.9,
                  "L": lambda: p[0] * 1.2, "G": lambda: p[0] / p[1]}.get(
                      k, lambda: 1.0)()
        else:
            t1 = 1.0
        # assign ages proportional to node depth
        depth = np.zeros(topo.nnode, dtype=int)
        for n in topo.postorder:
            kids = [c for c in topo.children[n] if c >= 0]
            depth[n] = 1 + max(depth[c] for c in kids)
        for n in topo.postorder:
            ages[n] = t1 * depth[n] / depth[st.root] \
                * (0.9 + 0.2 * rng.random())
        ages[st.root] = t1
        # push ages inside hard-ish calibration ranges where easy
        for j, (k, p) in st.calibrations.items():
            if k == "B":
                ages[j] = 0.5 * (p[0] + p[1])
        for n in topo.postorder:    # restore ordering
            kids = [c for c in topo.children[n] if c >= 0]
            mx = max(ages[c] for c in kids)
            if ages[n] <= mx:
                ages[n] = mx * 1.1
        # cross-bracing: mirrors start at (and stay at) the driver's age;
        # nudge the drivers up if a mirror's children are older
        if st.mirror_of:
            for _ in range(4):
                for mj, mi in st.mirror_of.items():
                    kids = [c for c in topo.children[mj] if c >= 0]
                    mx = max(ages[c] for c in kids)
                    if ages[mi] <= mx:
                        ages[mi] = mx * 1.05
                    ages[mj] = ages[mi]
                for n in topo.postorder:
                    kids = [c for c in topo.children[n] if c >= 0]
                    mx = max(ages[c] for c in kids)
                    if ages[n] <= mx and n not in st.mirror_of:
                        ages[n] = mx * 1.05
                for mj, mi in st.mirror_of.items():
                    ages[mj] = ages[mi]
        self.ages = ages
        if self.st.pfossilerror is not None:
            pb, qb = self.st.pfossilerror[0], self.st.pfossilerror[1]
            self.Pfossilerr = pb / (pb + qb)
        else:
            self.Pfossilerr = None
        self.mu = np.maximum(rng.gamma(spec.rgene_gamma[0],
                                       1 / spec.rgene_gamma[1], self.g), 1e-4)
        self.sigma2 = np.maximum(rng.gamma(spec.sigma2_gamma[0],
                                           1 / spec.sigma2_gamma[1], self.g),
                                 1e-4)
        self.rates = np.ones((topo.nnode, self.g))
        for i in range(topo.nnode):
            if i != st.root:
                self.rates[i] = self.mu * np.exp(
                    0.3 * rng.standard_normal(self.g))
        self.kappa = np.full(self.g, 4.0)
        self.alpha_g = np.full(self.g, max(spec.alpha, 0.2))

    # -- probability pieces -------------------------------------------

    def lnpT(self):
        return ln_prior_times(self.st, self.ages,
                              getattr(self, "Pfossilerr", None))

    def lnpR(self):
        if self.spec.clock == 1:
            return 0.0
        return ln_prior_rates(self.st, self.rates, self.mu, self.sigma2,
                              self.ages, self.spec.clock)

    def ln_musigma_prior(self):
        lp = ln_prior_gamma_dirichlet(self.mu, self.spec.rgene_gamma)
        if self.spec.clock > 1:
            lp += ln_prior_gamma_dirichlet(self.sigma2,
                                           self.spec.sigma2_gamma)
        return lp

    def _setup_likelihoods(self):
        """The device side of the likelihoods: the exact loci's data
        (usedata=1), the approximate loci's Taylor forms with the map from
        species-tree branches to each gene tree's (usedata=2), the
        morphological loci's measurements."""
        st, spec, dev = self.st, self.spec, self.device
        nnode = st.topo.nnode
        self._exact = self._approx = None
        self._morph_z = {}
        if spec.usedata == 1:
            seq = [i for i, l in enumerate(self.loci)
                   if isinstance(l, seqio.PackedData)]
            self._exact_of = {i: k for k, i in enumerate(seq)}
            if seq:
                self._exact = ExactLoci([self.loci[i] for i in seq], st.topo,
                                        spec, device=dev)
            for i, l in enumerate(self.loci):
                if isinstance(l, MorphLocus):
                    self._morph_z[i] = torch.as_tensor(
                        np.asarray(l.z, float), device=dev)
        elif spec.usedata == 2:
            self._approx = ApproxBatch(self.loci, device=dev)
            # unrooted length k of locus g = b[idx1] + b[idx2], where
            # column nnode of b holds 0
            idx = np.full((2, self.g, self._approx.nbmax), nnode)
            for g, order in enumerate(self.branch_orders):
                for k, ref in enumerate(order):
                    if isinstance(ref, tuple):
                        idx[0, g, k], idx[1, g, k] = ref[1], ref[2]
                    else:
                        idx[0, g, k] = ref
            self._approx_idx = torch.as_tensor(idx, device=dev)

    def _branch_lengths_all(self) -> np.ndarray:
        """b [g, nnode]: every locus's branch lengths (gene_branch_lengths,
        the root's 0)."""
        topo, root = self.st.topo, self.st.root
        par = np.where(np.arange(topo.nnode) == root, root, topo.parent)
        dt = self.ages[par] - self.ages
        if self.spec.clock == 1:
            b = dt[None, :] * self.mu[:, None]
        else:
            b = dt[None, :] * self.rates.T
        b[:, root] = 0.0
        return b

    def _approx_lnL(self, b: np.ndarray, rows=slice(None)) -> np.ndarray:
        """The approximate likelihood of the loci `rows` at species-tree
        branch lengths b [g, nnode]."""
        with torch.inference_mode():
            bz = torch.as_tensor(np.concatenate(
                [b, np.zeros((b.shape[0], 1))], 1), device=self.device)
            idx = self._approx_idx[:, rows]
            bu = bz.gather(1, idx[0]) + bz.gather(1, idx[1])
            return self._approx.lnL(bu, rows).cpu().numpy()

    def lnL_locus(self, locus_i: int) -> float:
        st, spec = self.st, self.spec
        b = gene_branch_lengths(
            st, self.ages, self.mu if spec.clock == 1 else self.rates,
            spec.clock, locus_i)
        if spec.usedata == 0:
            return 0.0
        bv = np.zeros((1, st.topo.nnode))
        for i, v in b.items():
            bv[0, i] = v
        if isinstance(self.loci[locus_i], MorphLocus):
            m = self.loci[locus_i]
            return (float(_morph_lnL(
                st.topo, torch.as_tensor(bv[0], device=self.device),
                self._morph_z[locus_i], m.popvar, m.ldetRm))
                * spec.lnL_beta)
        if spec.usedata == 2:
            return float(self._approx_lnL(
                bv, slice(locus_i, locus_i + 1))[0]) * spec.lnL_beta
        k = self._exact_of[locus_i]
        return float(self._exact.lnl(
            bv, self.kappa[locus_i:locus_i + 1],
            self.alpha_g[locus_i:locus_i + 1], rows=[k])[0]) \
            * spec.lnL_beta

    def lnL_all(self):
        t0 = time.perf_counter()
        spec = self.spec
        exact_all = (spec.usedata == 1 and self.g > 1
                     and len(self._exact_of) == self.g)
        if exact_all:
            out = self._exact.lnl(self._branch_lengths_all(), self.kappa,
                                  self.alpha_g) * spec.lnL_beta
        elif spec.usedata == 2:
            out = self._approx_lnL(self._branch_lengths_all()) \
                * spec.lnL_beta
        else:
            out = np.array([self.lnL_locus(i) for i in range(self.g)])
        SECONDS["lnL_all"] += time.perf_counter() - t0
        COUNTS["lnL_all"] += 1
        return out

    # -- MCMC ----------------------------------------------------------

    def run(self, progress=False):
        t_run = time.perf_counter()
        st, spec = self.st, self.spec
        topo = st.topo
        rng = self.rng
        g = self.g
        n_int = self.n_int
        clock = spec.clock

        # step lengths: times, musigma2 (2g or g), rates (nbranch*g), mixing
        n_ms = g * (2 if clock > 1 else 1)
        nrate_steps = 1 if clock > 1 else 0
        steps = {
            "t": np.full(n_int, spec.finetune[0]),
            "ms": np.full(n_ms, spec.finetune[1]),
            "r": np.full(1, spec.finetune[2]),
            "mix": np.array([spec.finetune[3]]),
            "par": np.full(2 * g, spec.finetune[4]),
        }
        # resume mid-burn-in with the adapted step lengths (the reference
        # saves them in the checkpoint, SaveMCMCstate mcmctree.c:807)
        if getattr(self, "_resume_steps", None) is not None:
            for k, v in self._resume_steps.items():
                if k in steps and len(v) == len(steps[k]):
                    steps[k] = np.asarray(v, float)
        self.steps = steps
        nacc = {k: np.zeros_like(v) for k, v in steps.items()}
        ntry = {k: np.zeros_like(v) for k, v in steps.items()}
        # periodic full-recompute consistency audit (reference:
        # mcmctree.c:4617-4628 aborts on drift)
        audit_every = max(1000, (spec.burnin + spec.sampfreq
                                 * spec.nsample) // 10)

        lnpT = self.lnpT()
        lnpR = self.lnpR()
        lnpDi = self.lnL_all()
        samples = []
        total = spec.burnin + spec.sampfreq * spec.nsample
        next_adjust = spec.burnin // 4 if spec.burnin else 0

        for it in range(-spec.burnin, spec.sampfreq * spec.nsample):
            # ---- update times ----
            mirror_of = st.mirror_of
            mirrors_of: dict[int, list] = {}
            for mj, mi in mirror_of.items():
                mirrors_of.setdefault(mi, []).append(mj)
            for j, node in enumerate(st.internal_nodes()):
                if node in mirror_of:
                    continue      # age driven by the braced main node
                group = [node] + mirrors_of.get(node, [])
                t = self.ages[node]
                tmin, tmax = 0.0, 1e9
                for gn in group:
                    kids = [c for c in topo.children[gn] if c >= 0]
                    tmin = max(tmin, max(self.ages[c] for c in kids))
                    if gn != st.root:
                        tmax = min(tmax,
                                   self.ages[topo.parent[gn]])
                y = math.log(t)
                yb = (math.log(tmin) if tmin > 0 else -99, math.log(tmax))
                ynew = _reflect(y + steps["t"][j] * self.bactrian(),
                                yb[0], yb[1], rng)
                tnew = math.exp(ynew)
                for gn in group:
                    self.ages[gn] = tnew
                lnpTnew = self.lnpT()
                lnacc = (ynew - y) + lnpTnew - lnpT
                lnpRnew = lnpR
                if clock == 3:
                    lnpRnew = self.lnpR()
                    lnacc += lnpRnew - lnpR
                lnpDnew = self.lnL_all()
                lnacc += float(lnpDnew.sum() - lnpDi.sum())
                ntry["t"][j] += 1
                if lnacc >= 0 or rng.random() < math.exp(max(lnacc, -500)):
                    lnpT, lnpR, lnpDi = lnpTnew, lnpRnew, lnpDnew
                    nacc["t"][j] += 1
                else:
                    for gn in group:
                        self.ages[gn] = t

            # ---- update mu / sigma2 ----
            gD_mu = spec.rgene_gamma
            gD_s2 = spec.sigma2_gamma
            for ip in range(2 if clock > 1 else 1):
                para = self.mu if ip == 0 else self.sigma2
                gD = gD_mu if ip == 0 else gD_s2
                for l in range(g):
                    k = ip * g + l
                    pold = para[l]
                    y = math.log(pold)
                    ynew = _reflect(y + steps["ms"][k] * self.bactrian(),
                                    -99, 99, rng)
                    pnew = math.exp(ynew)
                    ssum_old = para.sum()
                    para[l] = pnew
                    ssum_new = ssum_old + pnew - pold
                    lnacc = ((ynew - y)
                             + (gD[0] - gD[2] * g)
                             * math.log(ssum_new / ssum_old)
                             - gD[1] / g * (ssum_new - ssum_old)
                             + (gD[2] - 1) * (ynew - y))
                    lnpRnew = lnpR
                    lnpDnew = lnpDi
                    if ip == 0 and clock == 1:
                        v = self.lnL_locus(l)
                        lnacc += v - lnpDi[l]
                        lnpDnew = lnpDi.copy()
                        lnpDnew[l] = v
                    if clock > 1:
                        lnpRnew = self.lnpR()
                        lnacc += lnpRnew - lnpR
                    ntry["ms"][k] += 1
                    if lnacc >= 0 or rng.random() < math.exp(max(lnacc, -500)):
                        lnpR, lnpDi = lnpRnew, lnpDnew
                        nacc["ms"][k] += 1
                    else:
                        para[l] = pold

            # ---- update branch rates (clock 2/3) ----
            # one batched lnL_all per node: locus likelihoods and the
            # rate prior factorize over loci, so proposals for every
            # locus's rate at this node are accepted/rejected
            # independently (reference loops loci serially,
            # UpdateRates mcmctree.c:3872 — same stationary distribution)
            if clock > 1:
                lnpR_loc = ln_prior_rates_per_locus(
                    st, self.rates, self.mu, self.sigma2, self.ages,
                    clock)
                for node in range(topo.nnode):
                    if node == st.root:
                        continue
                    rold = self.rates[node, :].copy()
                    y = np.log(rold)
                    ynew = np.array(
                        [_reflect(y[l] + steps["r"][0] * self.bactrian(),
                                  -99, 99, rng) for l in range(g)])
                    self.rates[node, :] = np.exp(ynew)
                    lnpR_new = ln_prior_rates_per_locus(
                        st, self.rates, self.mu, self.sigma2, self.ages,
                        clock)
                    lnpD_new = self.lnL_all()
                    lnacc_l = ((ynew - y) + (lnpR_new - lnpR_loc)
                               + (lnpD_new - lnpDi))
                    acc = ((lnacc_l >= 0)
                           | (rng.random(g)
                              < np.exp(np.maximum(lnacc_l, -500))))
                    ntry["r"][0] += g
                    nacc["r"][0] += int(acc.sum())
                    if not acc.all():
                        self.rates[node, ~acc] = rold[~acc]
                        lnpR_new = ln_prior_rates_per_locus(
                            st, self.rates, self.mu, self.sigma2,
                            self.ages, clock)
                        lnpD_new = np.where(acc, lnpD_new, lnpDi)
                    lnpR_loc = lnpR_new
                    lnpDi = lnpD_new
                lnpR = float(lnpR_loc.sum())

            # ---- update substitution parameters (usedata=1) ----
            # batched over loci per parameter (kappa_l/alpha_l touch only
            # locus l's likelihood and an independent gamma prior)
            if spec.usedata == 1:
                for ip, (para, gpr) in enumerate(
                        [(self.kappa, spec.kappa_gamma),
                         (self.alpha_g, spec.alpha_gamma)]):
                    if ip == 1 and spec.alpha == 0:
                        continue
                    pold = para.copy()
                    y = np.log(pold)
                    ynew = np.array(
                        [_reflect(y[l] + steps["par"][ip * g + l]
                                  * self.bactrian(), -99, 99, rng)
                         for l in range(g)])
                    para[:] = np.exp(ynew)
                    lnpD_new = self.lnL_all()
                    lnacc_l = ((ynew - y) + (lnpD_new - lnpDi)
                               + (gpr[0] - 1) * (ynew - y)
                               - gpr[1] * (para - pold))
                    acc = ((lnacc_l >= 0)
                           | (rng.random(g)
                              < np.exp(np.maximum(lnacc_l, -500))))
                    for l in range(g):
                        k = ip * g + l
                        ntry["par"][k] += 1
                        nacc["par"][k] += int(acc[l])
                    if not acc.all():
                        para[~acc] = pold[~acc]
                        lnpD_new = np.where(acc, lnpD_new, lnpDi)
                    lnpDi = lnpD_new

            # ---- mixing ----
            lnc = steps["mix"][0] * self.bactrian()
            c = math.exp(lnc)
            s = topo.ns
            tipdate = (st.tip_ages is not None and st.tip_ages.max() > 0)
            old_ages = self.ages.copy()
            old_mu = self.mu.copy()
            old_rates = self.rates.copy()
            gD = spec.rgene_gamma
            if tipdate:
                # mixingTipDate (mcmctree.c:3997): scale each interior age
                # away from the oldest tip beneath it, preserving the
                # relative positions x_j within each father interval
                changemu = clock == 1
                ndivide = g if changemu else 0
                minages = np.zeros(topo.nnode)
                for j in range(s):
                    tz = self.ages[j]
                    k = topo.parent[j]
                    while k != -1 and tz > minages[k]:
                        minages[k] = tz
                        k = topo.parent[k]
                xprop = {}
                for node in st.internal_nodes():
                    if node == st.root:
                        continue
                    dad = topo.parent[node]
                    xprop[node] = ((self.ages[node] - minages[node])
                                   / (self.ages[dad] - minages[node]))
                lnacc = lnc
                self.ages[st.root] = (minages[st.root]
                                      + (self.ages[st.root]
                                         - minages[st.root]) * c)
                order = [st.root]
                for n in order:
                    order.extend(cc for cc in topo.children[n]
                                 if cc >= s)
                for node in order[1:]:
                    dad = topo.parent[node]
                    told = self.ages[node]
                    self.ages[node] = (minages[node] + xprop[node]
                                       * (self.ages[dad] - minages[node]))
                    lnacc += math.log((self.ages[node] - minages[node])
                                      / (told - minages[node]))
                if changemu:
                    self.mu /= c
                    summu_new = self.mu.sum()
                    summu_old = summu_new * c
                    lnacc += ((gD[0] - gD[2] * g)
                              * math.log(summu_new / summu_old)
                              - gD[1] / g * (summu_new - summu_old)
                              + (gD[2] - 1) * g * (-lnc))
                lnpRnew = lnpR
                if clock > 1:
                    ndivide += g * (2 * s - 2)
                    self.rates[:, :] /= c
                    self.rates[st.root, :] = old_rates[st.root, :]
                    lnpRnew = self.lnpR()
                    lnacc += lnpRnew - lnpR
                lnacc -= ndivide * lnc
                lnpTnew = self.lnpT()
                lnacc += lnpTnew - lnpT
            else:
                ndivide = g
                for node in st.internal_nodes():
                    self.ages[node] *= c
                self.mu /= c
                summu_new = self.mu.sum()
                summu_old = summu_new * c
                lnacc = ((gD[0] - gD[2] * g)
                         * math.log(summu_new / summu_old)
                         - gD[1] / g * (summu_new - summu_old)
                         + (gD[2] - 1) * g * (-lnc))
                lnpRnew = lnpR
                if clock > 1:
                    ndivide += g * (2 * s - 2)
                    self.rates[:, :] /= c
                    self.rates[st.root, :] = old_rates[st.root, :]
                    # rates at root entry unused; keep consistent
                    lnpRnew = self.lnpR()
                    lnacc += lnpRnew - lnpR
                lnpTnew = self.lnpT()
                # distinct internal ages = s-1 minus the mirrored ones
                # (reference: mixing, mcmctree.c:4175)
                lnacc += (lnpTnew - lnpT
                          + (s - 1 - len(st.mirror_of) - ndivide) * lnc)
            lnpDnew_all = self.lnL_all()
            lnacc += float(lnpDnew_all.sum() - lnpDi.sum())
            ntry["mix"][0] += 1
            if (np.isfinite(lnacc)
                    and (lnacc >= 0
                         or rng.random() < math.exp(max(lnacc, -500)))):
                lnpT, lnpR = lnpTnew, lnpRnew
                lnpDi = lnpDnew_all
                nacc["mix"][0] += 1
            else:
                self.ages = old_ages
                self.mu = old_mu
                self.rates = old_rates

            # ---- burn-in step adaptation ----
            if it < 0 and next_adjust and (it + spec.burnin) == next_adjust:
                for kname in steps:
                    pj = np.where(ntry[kname] > 0,
                                  nacc[kname] / np.maximum(ntry[kname], 1),
                                  0.3)
                    st_ = steps[kname]
                    for j in range(len(st_)):
                        if pj[j] < 0.001:
                            st_[j] /= 100
                        elif pj[j] > 0.999:
                            st_[j] = min(99.0, st_[j] * 100)
                        else:
                            st_[j] *= (math.tan(math.pi / 2 * pj[j])
                                       / math.tan(math.pi / 2 * 0.3))
                            st_[j] = min(st_[j], 99.0)
                    nacc[kname][:] = 0
                    ntry[kname][:] = 0
                next_adjust += spec.burnin // 4

            # ---- update the fossil-error probability ----
            # (reference: UpdatePFossilErrors, mcmctree.c:4266)
            if self.Pfossilerr is not None:
                pb, qb = st.pfossilerror[0], st.pfossilerror[1]
                pold = self.Pfossilerr
                pnew = _reflect(pold + steps["mix"][0] * self.bactrian(),
                                1e-9, 1 - 1e-9, rng)
                self.Pfossilerr = pnew
                lnpTnew = self.lnpT()
                lnacc = ((pb - 1) * math.log(pnew / pold)
                         + (qb - 1) * math.log((1 - pnew) / (1 - pold))
                         + lnpTnew - lnpT)
                if lnacc >= 0 or rng.random() < math.exp(max(lnacc, -500)):
                    lnpT = lnpTnew
                else:
                    self.Pfossilerr = pold

            # ---- periodic lnL/prior consistency audit ----
            if (it + spec.burnin) % audit_every == audit_every - 1:
                lnpT2, lnpR2 = self.lnpT(), self.lnpR()
                lnpD2 = self.lnL_all()
                drift = max(abs(lnpT2 - lnpT), abs(lnpR2 - lnpR),
                            float(np.abs(lnpD2 - lnpDi).max()))
                if drift > 1e-3 * max(1.0, abs(float(lnpDi.sum()))):
                    raise RuntimeError(
                        f"MCMC audit failed at it={it}: cached lnP drifted "
                        f"by {drift:.6g} from a full recompute")
                lnpT, lnpR, lnpDi = lnpT2, lnpR2, lnpD2

            # ---- sample ----
            if it >= 0 and it % spec.sampfreq == 0:
                rec = {"lnL": float(lnpDi.sum())}
                if self.Pfossilerr is not None:
                    rec["Pfossilerr"] = self.Pfossilerr
                for j, node in enumerate(st.internal_nodes()):
                    rec[f"t_n{node}"] = self.ages[node]
                for l in range(g):
                    rec[f"mu{l + 1}"] = self.mu[l]
                if clock > 1:
                    for l in range(g):
                        rec[f"sigma2_{l + 1}"] = self.sigma2[l]
                samples.append(rec)
                if progress and len(samples) % 2000 == 0:
                    print(f"  {len(samples)}/{spec.nsample} samples; "
                          f"lnpT {lnpT:.2f} lnL {lnpDi.sum():.2f}")
        self.acceptance = {k: (nacc[k] / np.maximum(ntry[k], 1))
                           for k in steps}
        SECONDS["chain"] += time.perf_counter() - t_run
        COUNTS["iterations"] += total
        return samples


# ---------------------------------------------------------------------------
# posterior summaries (reference: DescriptiveStatistics, tools.c:5779;
# HPDinterval :5677; Eff_IntegratedCorrelationTime :5698)
# ---------------------------------------------------------------------------


def hpd_interval(x: np.ndarray, prob=0.95):
    xs = np.sort(x)
    n = len(xs)
    k = max(1, int(math.floor(prob * n)))
    widths = xs[k:] - xs[:n - k]
    i = int(np.argmin(widths))
    return float(xs[i]), float(xs[i + k])


def ess(x: np.ndarray, maxlag=2000) -> float:
    """Effective sample size via integrated autocorrelation time."""
    x = np.asarray(x, float)
    n = len(x)
    xc = x - x.mean()
    v = float(xc @ xc) / n
    if v == 0:
        return float(n)
    rho_sum = 0.0
    for lag in range(1, min(maxlag, n - 1)):
        r = float(xc[:-lag] @ xc[lag:]) / ((n - lag) * v)
        if r < 0:
            break
        rho_sum += r
    tau = 1 + 2 * rho_sum
    return n / tau


def summarize(samples: list[dict]) -> dict:
    keys = samples[0].keys()
    out = {}
    for k in keys:
        x = np.array([s[k] for s in samples])
        lo, hi = np.quantile(x, [0.025, 0.975])
        h = hpd_interval(x)
        out[k] = dict(mean=float(x.mean()), eq_lo=float(lo), eq_hi=float(hi),
                      hpd_lo=h[0], hpd_hi=h[1], ess=ess(x))
    return out

# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv, device="cuda"):
    """`mcmctree [ctl]` on `device`, or `mcmctree --combine <dir>` /
    `--combine <out> <in1> <in2> ...` (host files only)."""
    from ..io import ctl as ctlmod
    if argv and argv[0] == "--combine":
        import os
        if len(argv) == 2 and os.path.isdir(argv[1]):
            # reference form: mcmctree --combine <directory>
            from .mcmcutils import combine_mcmc_dir
            return combine_mcmc_dir(argv[1])
        from .mcmcutils import combine_mcmc
        out = argv[1]
        n = combine_mcmc(argv[2:], out)
        print(f"combined {len(argv) - 2} chains, {n} samples -> {out}")
        return n
    path = argv[0] if argv else "mcmctree.ctl"
    opts = ctlmod.read_ctl(path)
    return run_ctl(opts, path, device=device)


def run_ctl(opts: dict, ctl_path: str, progress=True, dry_run=False, *,
            device="cuda"):
    """Run an mcmctree control file with the likelihoods on `device`,
    writing mcmc.txt, out.txt, FigTree.tre (or out.BV) into the working
    directory; returns the posterior summaries (None for usedata = 3,
    the spec with `dry_run`)."""
    import re as _re

    from ..io import ctl as ctlmod

    g = ctlmod.OptReader(opts, "mcmctree", ctlmod.MCMCTREE_OPTS)
    seqfile = ctlmod.resolve_path(ctl_path, g("seqfile"))
    treefile = ctlmod.resolve_path(ctl_path, g("treefile"))
    ndata = int(float(g("ndata", "1").split()[0]))
    usedata_toks = g("usedata", "2").split()
    usedata = int(usedata_toks[0])
    clock = int(float(g("clock", "2")))
    bd = [float(x) for x in _re.findall(r"[\d.]+", g("BDparas", "1 1 0.1"))]
    mult = "multiplicative" in g("BDparas", "")
    root_age = g("RootAge", "").strip().strip("'\"") or None
    rg = [float(x) for x in _re.findall(r"[\d.]+", g("rgene_gamma", "2 20 1"))]
    s2 = [float(x) for x in _re.findall(r"[\d.]+", g("sigma2_gamma", "1 10 1"))]
    kg = [float(x) for x in _re.findall(r"[\d.]+", g("kappa_gamma", "6 2"))]
    ag = [float(x) for x in _re.findall(r"[\d.]+", g("alpha_gamma", "1 1"))]
    model_i = int(float(g("model", "4")))
    spec = McmcSpec(
        clock=clock, usedata=usedata, bds=tuple(bd[:3]),
        multiplicative=mult, root_age=root_age,
        rgene_gamma=tuple(rg + [1.0])[:3] if len(rg) < 3 else tuple(rg[:3]),
        sigma2_gamma=tuple(s2 + [1.0])[:3] if len(s2) < 3 else tuple(s2[:3]),
        kappa_gamma=tuple(kg[:2]), alpha_gamma=tuple(ag[:2]),
        model=ctlmod.NUC_MODEL_BY_INDEX[model_i],
        ncatG=int(float(g("ncatG", "5"))),
        alpha=float(g("alpha", "0.5").split()[0]),
        burnin=int(float(g("burnin", "2000"))),
        sampfreq=int(float(g("sampfreq", "5"))),
        nsample=int(float(g("nsample", "10000"))),
        cleandata=bool(int(float(g("cleandata", "0")))),
        seed=abs(int(float(g("seed", "12345")))) or 12345,
        lnL_beta=float(g("BayesFactorBeta", "1")),
    )
    ft = [float(v) for v in _re.findall(r"[\d.eE+-]+",
                                        str(g("finetune", "")))]
    if len(ft) >= 5:
        # 'finetune = 0: .1 .1 ...' — leading 0/1 toggles auto-adjust
        spec.finetune = tuple(ft[-5:])
    g("print")         # sample-verbosity flag; summaries always written
    g("aaRatefile")    # inert for nucleotide dating
    g("icode")
    g.require_off("seqtype", "amino-acid/codon alignments in mcmctree "
                  "(usedata=2 with a codeml-generated in.BV covers this)",
                  off=(0,))
    # consumed later in this function; mark now so validation fails fast
    for _k in ("checkpoint", "mcmcfile", "outfile", "duplication",
               "pfossilerror", "fossilerror", "TipDate"):
        g(_k)
    g.finish()
    if dry_run:            # option-validation only (ctl sweep tests)
        return spec
    alns = seqio.read_alignments(seqfile, seqio.BASE_SEQ, ndata)
    names = alns[0].names
    trees = treeio.read_trees(treefile, names)
    st = build_species_tree(trees[0], names, bds=spec.bds,
                            root_age=spec.root_age,
                            multiplicative=spec.multiplicative,
                            duplication=bool(int(float(
                                g("duplication", "0")))))
    pfe = str(g("pfossilerror", g("fossilerror", "0"))).split()
    if pfe and float(pfe[0]) > 0:
        st.pfossilerror = tuple(float(v) for v in pfe[:3]) \
            if len(pfe) >= 3 else (float(pfe[0]),
                                   float(pfe[1]) if len(pfe) > 1 else 1.0,
                                   0.0)
    tipdate_toks = str(g("TipDate", "0")).split()
    if tipdate_toks and int(float(tipdate_toks[0])):
        timeunit = (float(tipdate_toks[1])
                    if len(tipdate_toks) > 1 else None)
        tip_ages, timeunit, young = parse_tip_dates(names, timeunit)
        st.tip_ages = tip_ages
        if len(bd) > 3:
            st.psi = bd[3]
        spec.transform = "sqrt"        # reference: mcmctree.c:1562
        print(f"TipDate model: date range ({max(young - tip_ages.min() * timeunit, young):.2f}"
              f", {young - tip_ages.max() * timeunit:.2f}) => "
              f"(0, {tip_ages.max():.4f}).  TimeUnit = {timeunit:.2f}.")
    if usedata in (2, 3):
        if usedata == 2 and len(usedata_toks) > 1:
            # read a provided in.BV instead of generating one
            bvpath = ctlmod.resolve_path(ctl_path, usedata_toks[1])
            loci = read_BV(bvpath, ndata, transform=spec.transform)
        else:
            bvfile = "out.BV"
            per_locus = generate_BV(alns, trees[0], names, model=spec.model,
                                    ncatG=spec.ncatG, alpha0=spec.alpha,
                                    fix_alpha=False,
                                    cleandata=spec.cleandata,
                                    outfile=bvfile, device=device)
            if usedata == 3:
                print(f"wrote {bvfile}")
                return None
            loci = []
            for (data, utopo, bl, grad, H) in per_locus:
                al = ApproxLocus(names=data.names, topo=utopo, bl=bl,
                                 gradient=grad, hessian=H,
                                 transform=spec.transform)
                al.transform_gh()
                loci.append(al)
    elif usedata == 1:
        loci = []
        for a in alns:
            if isinstance(a, seqio.MorphAlignment):
                order = [a.names.index(nm) for nm in names]
                loci.append(MorphLocus(names=list(names), z=a.z[order],
                                       popvar=a.popvar, ldetRm=a.ldetRm))
            else:
                loci.append(seqio.pack(a, cleandata=spec.cleandata))
    else:
        loci = [None] * ndata
    mc = MCMCTree(st, loci, spec, device=device)
    ckpt = g("checkpoint", "").split()
    if len(ckpt) >= 1 and ckpt[0] == "2":
        from .mcmcutils import load_state
        load_state(mc, ckpt[2] if len(ckpt) > 2 else "mcmctree.ckpt")
        print("resumed from checkpoint")
    samples = mc.run(progress=progress)
    if len(ckpt) >= 1 and ckpt[0] == "1":
        from .mcmcutils import save_state
        save_state(mc, ckpt[2] if len(ckpt) > 2 else "mcmctree.ckpt",
                   it=len(samples))
    from .mcmcutils import write_mcmc_txt
    write_mcmc_txt(samples, g("mcmcfile", "mcmc.txt"))
    summ = summarize(samples)
    out = g("outfile", "out.txt")
    with open(out, "w") as f:
        f.write("posterior summaries\n")
        f.write(f"{'param':>12s} {'mean':>10s} {'2.5%':>10s} {'97.5%':>10s}"
                f" {'ESS':>8s}\n")
        for k, v in summ.items():
            f.write(f"{k:>12s} {v['mean']:10.4f} {v['eq_lo']:10.4f} "
                    f"{v['eq_hi']:10.4f} {v['ess']:8.1f}\n")
    # FigTree tree with posterior-mean ages and 95% HPD annotations
    # (reference: DescriptiveStatisticsSimpleMCMCTREE FigTree.tre block)
    try:
        from ..io.outputs import figtree_newick, write_figtree
        topo = st.topo
        ages_mean = np.zeros(topo.nnode)
        hpd_lo = np.zeros(topo.nnode)
        hpd_hi = np.zeros(topo.nnode)
        if st.tip_ages is not None:
            ages_mean[:topo.ns] = st.tip_ages
        for n in range(topo.ns, topo.nnode):
            v = summ.get(f"t_n{n}")
            if v is None:
                continue
            ages_mean[n] = v["mean"]
            hpd_lo[n], hpd_hi[n] = v["hpd_lo"], v["hpd_hi"]
        nwk = figtree_newick(topo.parent, topo.children, topo.root,
                             [names[i] if i < topo.ns else ""
                              for i in range(topo.nnode)],
                             ages_mean, hpd_lo, hpd_hi)
        write_figtree("FigTree.tre", nwk)
    except Exception as e:          # FigTree output is best-effort
        print(f"FigTree.tre not written: {e}")
    print(f"summary written to {out}")
    return summ
