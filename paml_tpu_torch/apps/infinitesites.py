"""infinitesites: posterior of divergence times and rates in the
infinite-data limit.

Counterpart of the reference `infinitesites` program (mcmctree.c compiled
with -DINFINITESITES, src/Makefile:20-22).  When every locus has infinite
sites, branch lengths are known exactly, so the posterior of node ages
collapses: under the global clock (clock=1) it is one-dimensional in the
root age (reference: InfinitesitesClock / lnPDFInfinitesitesClock,
src/mcmctree.c:1692/1662); under independent/correlated rates (clock=2/3)
the free variables are the s-1 node ages, the per-locus rate of the first
root-child branch r0, and per-locus mu/sigma2 (reference: Infinitesites /
lnPDFInfinitesitesClock23, src/mcmctree.c:1827/1768).

Fixed branch lengths are read from FixedDsClock1.txt / FixedDsClock23.txt
in the reference's formats (src/mcmctree.c:1875-1911).

Port of `paml_tpu/apps/infinitesites.py`: host scalars in float64 only
(no device), with the JAX package's numpy Generator and order of draws,
so that both packages' chains agree draw for draw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..io import treeio
from .mcmctree import (SpeciesTree, _Bactrian, _reflect,
                       ln_prior_gamma_dirichlet, ln_prior_rates,
                       ln_prior_times)

_OLD_AGE = 999.0
_PJUMP_OPT = 0.3


def _reset_steps(pjump: np.ndarray, steps: np.ndarray) -> None:
    """Yang & Rodriguez 2013 eq. 9 (reference: ResetStepLengths,
    src/tools.c:1503)."""
    for j in range(len(steps)):
        if pjump[j] < 0.001:
            steps[j] /= 100
        elif pjump[j] > 0.999:
            steps[j] = min(99.0, steps[j] * 100)
        else:
            steps[j] *= (math.tan(math.pi / 2 * pjump[j])
                         / math.tan(math.pi / 2 * _PJUMP_OPT))
            steps[j] = min(99.0, steps[j])


# ---------------------------------------------------------------------------
# FixedDs readers
# ---------------------------------------------------------------------------


def read_fixed_ds_clock1(path: str, s: int, g: int) -> np.ndarray:
    """FixedDsClock1.txt: first token = ns, then d11 ... d1,s-1, d21, d31,
    ... dg1 (reference: Infinitesites, src/mcmctree.c:1868-1884)."""
    toks = open(path).read().split()
    if int(toks[0]) != s:
        raise ValueError(f"FixedDs has ns={toks[0]}, species tree has {s}")
    vals = [float(t) for t in toks[1:1 + s - 1 + g - 1]]
    if len(vals) != s - 1 + g - 1:
        raise ValueError("FixedDsClock1.txt too short")
    return np.array(vals)


def read_fixed_ds_clock23(path: str, st: SpeciesTree,
                          names: list[str]) -> np.ndarray:
    """FixedDsClock23.txt: ns then one rooted tree with branch lengths per
    locus, on the species tree.  Returns b[g, nnode] with the two root
    branches summed into the son0 slot and -1 at root/son1 (reference:
    src/mcmctree.c:1893-1911)."""
    text = open(path).read()
    lines = text.split("\n")
    first = lines[0].split()
    s = int(first[0])
    if s != st.ns:
        raise ValueError("wrong number of species in FixedDsClock23.txt")
    body = "\n".join(lines[1:])
    trees = [t for t in body.replace("\r", "").split(";") if "(" in t]
    topo = st.topo
    root = st.root
    sons = [c for c in topo.children[root] if c >= 0]
    out = []
    for tstr in trees:
        node = treeio.parse_newick(tstr.strip() + ";")
        # map nodes of this locus tree onto the species-tree numbering by
        # matching tip-name sets of clades
        blen = _match_branch_lengths(node, st, names)
        b = np.full(topo.nnode, -1.0)
        for j in range(topo.nnode):
            if j == root or j == sons[1]:
                continue
            if j == sons[0]:
                b[j] = blen[sons[0]] + blen[sons[1]]
            else:
                b[j] = blen[j]
        out.append(b)
    return np.array(out)


def _match_branch_lengths(root: treeio.TreeNode, st: SpeciesTree,
                          names: list[str]) -> np.ndarray:
    """Branch lengths of a parsed tree assigned to species-tree node ids by
    clade (tip-set) identity."""
    topo = st.topo
    name_to_tip = {n: i for i, n in enumerate(names)}
    desc = topo.tip_descendants()
    clade_to_node = {frozenset(desc[j]): j for j in range(topo.nnode)}
    blen = np.zeros(topo.nnode)

    def walk(node) -> frozenset:
        if not node.children:
            s = frozenset([name_to_tip[node.name]])
        else:
            s = frozenset().union(*(walk(c) for c in node.children))
        j = clade_to_node.get(s)
        if j is None:
            raise ValueError("locus tree clade not in species tree: use the "
                             "species tree for each locus")
        blen[j] = node.blen or 0.0
        return s

    walk(root)
    return blen


# ---------------------------------------------------------------------------
# clock 1: one-dimensional posterior in the root age
# ---------------------------------------------------------------------------


def ln_pdf_clock1(t1: float, fixed_ds: np.ndarray, st: SpeciesTree,
                  rgene_para) -> tuple[float, np.ndarray, np.ndarray]:
    """Reference: lnPDFInfinitesitesClock (src/mcmctree.c:1662-1690).
    Returns (lnp, ages, rgene)."""
    topo = st.topo
    s, root = topo.ns, st.root
    g = (len(fixed_ds) - (s - 1)) + 1
    ages = np.zeros(topo.nnode)
    ages[root] = t1
    for j in range(s, topo.nnode):
        if j != root:
            ages[j] = t1 * fixed_ds[j - s] / fixed_ds[0]
    lnp = ln_prior_times(st, ages)

    rgene = np.empty(g)
    rgene[0] = fixed_ds[0] / t1
    for i in range(1, g):
        rgene[i] = fixed_ds[s - 1 + i - 1] / t1
    a, b, ad = rgene_para
    summu = float(rgene.sum())
    prodmu = float(np.prod(rgene))
    lnp += ((a - ad * g) * math.log(summu) - b / g * summu
            + (ad - 1) * math.log(prodmu))
    lnp += (2 - s) * math.log(fixed_ds[0] / t1) - g * math.log(t1)  # Jacobian
    return lnp, ages, rgene


def run_clock1(st: SpeciesTree, fixed_ds: np.ndarray, rgene_para,
               burnin=2000, nsample=10000, sampfreq=2, seed=1,
               progress=False):
    """Reference: InfinitesitesClock (src/mcmctree.c:1692).  Multiplier
    proposal on the root age; returns dict with samples and summaries."""
    topo = st.topo
    s, root = topo.ns, st.root
    g = (len(fixed_ds) - (s - 1)) + 1
    rng = np.random.default_rng(seed)
    bact = _Bactrian(rng)
    e = 0.01 + 0.1 * rng.random()

    t = max(fixed_ds[0] * 10, 0.5)       # rough initial root age
    lnp, _, _ = ln_pdf_clock1(t, fixed_ds, st, rgene_para)
    samples = []
    naccept, nround = 0, 0
    for ir in range(-burnin, nsample * sampfreq):
        if ir == 0 or (nround >= 100 and ir < 0 and burnin >= 4
                       and ir % (burnin // 4) == 0):
            pj = np.array([naccept / max(nround, 1)])
            st_arr = np.array([e])
            _reset_steps(pj, st_arr)
            e = float(st_arr[0])
            naccept, nround = 0, 0
        lnc = e * bact()
        tnew = t * math.exp(lnc)
        lnpnew, _, _ = ln_pdf_clock1(tnew, fixed_ds, st, rgene_para)
        lnacc = lnc + lnpnew - lnp
        if lnacc >= 0 or rng.random() < math.exp(lnacc):
            t, lnp = tnew, lnpnew
            naccept += 1
        nround += 1
        if ir >= 0 and (ir + 1) % sampfreq == 0:
            samples.append(t)

    x = np.sort(np.array(samples))
    tmean = float(x.mean())
    t025 = float(x[int(len(x) * 0.025 + 0.5)])
    t975 = float(x[min(int(len(x) * 0.975 + 0.5), len(x) - 1)])
    out = {"t0": np.array(samples), "t0_mean": tmean,
           "t0_CI": (t025, t975), "times": {}, "rates": {}}
    for label, tval in (("mean", tmean), ("low", t025), ("high", t975)):
        _, ages, rgene = ln_pdf_clock1(tval, fixed_ds, st, rgene_para)
        out["times"][label] = ages[s:].copy()
        out["rates"][label] = rgene
    return out


# ---------------------------------------------------------------------------
# clock 2/3: (s-1) ages + per-locus (mu, sigma2, r0)
# ---------------------------------------------------------------------------


@dataclass
class ISState:
    ages: np.ndarray            # [nnode]
    mu: np.ndarray              # [g]
    sigma2: np.ndarray          # [g]
    r0: np.ndarray              # [g] rate of root son0 branch per locus


def _rates_from_fixed(st: SpeciesTree, state: ISState,
                      b: np.ndarray) -> np.ndarray | None:
    """Branch rates implied by fixed lengths + ages (reference:
    lnPDFInfinitesitesClock23, src/mcmctree.c:1768-1800).
    Returns [nnode, g] or None when infeasible."""
    topo = st.topo
    root = st.root
    sons = [c for c in topo.children[root] if c >= 0]
    g = b.shape[0]
    ages = state.ages
    t0 = ages[root] - ages[sons[0]]
    t1 = ages[root] - ages[sons[1]]
    rates = np.ones((topo.nnode, g))
    for locus in range(g):
        for j in range(topo.nnode):
            if j == root:
                continue
            if j == sons[0]:
                rates[j, locus] = state.r0[locus]
                continue
            t = ages[topo.parent[j]] - ages[j]
            if t <= 0:
                return None
            if j == sons[1]:
                num = b[locus, sons[0]] - state.r0[locus] * t0
                if num <= 0 or t1 <= 0:
                    return None
                rates[j, locus] = num / t1
            else:
                rates[j, locus] = b[locus, j] / t
    return rates


def ln_pdf_clock23(st: SpeciesTree, state: ISState, b: np.ndarray,
                   clock: int, rgene_para, sigma2_para) -> float:
    """Reference: lnPDFInfinitesitesClock23 (src/mcmctree.c:1768), plus the
    f(mu_i) and f(sigma2_i) gamma-Dirichlet factors which the reference
    keeps in the acceptance ratios."""
    topo = st.topo
    root = st.root
    sons = [c for c in topo.children[root] if c >= 0]
    g = b.shape[0]
    rates = _rates_from_fixed(st, state, b)
    if rates is None:
        return -np.inf
    lnp = ln_prior_times(st, state.ages)
    lnp += ln_prior_rates(st, rates, state.mu, state.sigma2,
                          state.ages, clock)
    t1 = state.ages[root] - state.ages[sons[1]]
    lnJ = -math.log(t1)
    for j in range(topo.nnode):
        if j in (root, sons[0], sons[1]):
            continue
        lnJ -= math.log(state.ages[topo.parent[j]] - state.ages[j])
    lnp += g * lnJ
    lnp += ln_prior_gamma_dirichlet(state.mu, rgene_para)
    lnp += ln_prior_gamma_dirichlet(state.sigma2, sigma2_para)
    return lnp


def run_clock23(st: SpeciesTree, b: np.ndarray, clock=2,
                rgene_para=(2, 20, 1), sigma2_para=(1, 10, 1),
                burnin=4000, nsample=10000, sampfreq=2, seed=1,
                progress=False):
    """Reference: Infinitesites MCMC over ages, mu, sigma2, r0 plus a
    mixing move (src/mcmctree.c:1940-2082)."""
    topo = st.topo
    s, root = topo.ns, st.root
    sons = [c for c in topo.children[root] if c >= 0]
    g = b.shape[0]
    rng = np.random.default_rng(seed)
    bact = _Bactrian(rng)
    e = np.full(5, 0.1)         # t, mu, r0, mixing, sigma2

    # initial ages: root from mean tree depth; proportional interior ages
    ages = _initial_ages(st, b)
    mu = np.full(g, rgene_para[0] / rgene_para[1])
    sigma2 = np.full(g, sigma2_para[0] / sigma2_para[1])
    r0 = np.empty(g)
    for i in range(g):
        r0[i] = b[i, sons[0]] / (ages[root] - ages[sons[0]]) * rng.random()
    state = ISState(ages=ages, mu=mu, sigma2=sigma2, r0=r0)
    lnp = ln_pdf_clock23(st, state, b, clock, rgene_para, sigma2_para)
    if not np.isfinite(lnp):
        raise RuntimeError("bad initial state for infinitesites clock23")

    naccept = np.zeros(5)
    nround = 0
    samples = []
    for ir in range(-burnin, nsample * sampfreq):
        if ir == 0 or (nround >= 100 and ir < 0 and burnin >= 4
                       and ir % (burnin // 4) == 0):
            _reset_steps(naccept / max(nround, 1), e)
            naccept[:] = 0
            nround = 0
        # --- single-variable sweeps ---
        for ip in range(s - 1 + 3 * g):
            lnacc = 0.0
            if ip < s - 1:                       # node age
                node = s + ip
                kids = [c for c in topo.children[node] if c >= 0]
                lo = max(state.ages[k] for k in kids)
                hi = (_OLD_AGE if node == root
                      else state.ages[topo.parent[node]])
                if node == root:
                    for i in range(g):
                        maxt0 = b[i, sons[0]] / state.r0[i]
                        hi = min(hi, state.ages[sons[0]] + maxt0)
                elif node == sons[0]:
                    for i in range(g):
                        maxt0 = b[i, sons[0]] / state.r0[i]
                        lo = max(lo, state.ages[root] - maxt0)
                old = state.ages[node]
                state.ages[node] = _reflect(old + e[0] * bact(), lo, hi, rng)
                which, old_slot = 0, ("age", node, old)
            elif ip < s - 1 + g:                 # mu multiplier
                i = ip - (s - 1)
                lnc = e[1] * bact()
                lnacc = lnc
                old = state.mu[i]
                state.mu[i] *= math.exp(lnc)
                which, old_slot = 1, ("mu", i, old)
            elif ip < s - 1 + 2 * g:             # sigma2 multiplier
                i = ip - (s - 1 + g)
                lnc = e[4] * bact()
                lnacc = lnc
                old = state.sigma2[i]
                state.sigma2[i] *= math.exp(lnc)
                which, old_slot = 4, ("sigma2", i, old)
            else:                                # r0, bounded
                i = ip - (s - 1 + 2 * g)
                t0 = state.ages[root] - state.ages[sons[0]]
                hi = b[i, sons[0]] / t0
                old = state.r0[i]
                state.r0[i] = _reflect(old + e[2] * bact(), 0.0, hi, rng)
                which, old_slot = 2, ("r0", i, old)
            lnpnew = ln_pdf_clock23(st, state, b, clock,
                                    rgene_para, sigma2_para)
            lnacc += lnpnew - lnp
            if lnacc >= 0 or rng.random() < math.exp(lnacc):
                lnp = lnpnew
                w = (s - 1) if which == 0 else g
                naccept[which] += 1.0 / w
            else:
                kind, i, old = old_slot
                if kind == "age":
                    state.ages[i] = old
                elif kind == "mu":
                    state.mu[i] = old
                elif kind == "sigma2":
                    state.sigma2[i] = old
                else:
                    state.r0[i] = old
        # --- mixing: ages *= c, mu /= c, r0 /= c ---
        lnc = e[3] * bact()
        c = math.exp(lnc)
        lnacc = (s - 1 - g - g) * lnc
        old_ages = state.ages.copy()
        old_mu = state.mu.copy()
        old_r0 = state.r0.copy()
        state.ages[s:] = state.ages[s:] * c
        state.mu /= c
        state.r0 /= c
        lnpnew = ln_pdf_clock23(st, state, b, clock,
                                rgene_para, sigma2_para)
        lnacc += lnpnew - lnp
        if np.isfinite(lnpnew) and (lnacc >= 0
                                    or rng.random() < math.exp(lnacc)):
            lnp = lnpnew
            naccept[3] += 1
        else:
            state.ages = old_ages
            state.mu = old_mu
            state.r0 = old_r0
        nround += 1
        if ir >= 0 and (ir + 1) % sampfreq == 0:
            row = {"lnp": lnp}
            for j in range(s, topo.nnode):
                row[f"t_n{j + 1}"] = state.ages[j]
            for i in range(g):
                row[f"mu_L{i + 1}"] = state.mu[i]
            for i in range(g):
                row[f"sigma2_L{i + 1}"] = state.sigma2[i]
            for i in range(g):
                row[f"r_left_L{i + 1}"] = state.r0[i]
            samples.append(row)
        if progress and (ir + 1) % max(1, (nsample * sampfreq) // 10) == 0:
            pj = naccept / max(nround, 1)
            print(f"\r{(ir + 1) / (nsample * sampfreq) * 100:3.0f}%  "
                  + " ".join(f"{p:4.2f}" for p in pj)
                  + f"  lnp {lnp:9.3f}", end="", flush=True)
    if progress:
        print()
    return samples


def _initial_ages(st: SpeciesTree, b: np.ndarray) -> np.ndarray:
    """Initial node ages proportional to mean root-to-node path length of
    the fixed branch lengths, scaled to a root age satisfying soft bounds
    when present."""
    topo = st.topo
    root = st.root
    sons = [c for c in topo.children[root] if c >= 0]
    depth = np.zeros(topo.nnode)
    order = [root]
    for j in order:
        for c in topo.children[j]:
            if c >= 0:
                order.append(c)
    meanb = np.where(b.mean(axis=0) > 0, b.mean(axis=0), 0.0)
    for j in order[1:]:
        dad = topo.parent[j]
        bj = meanb[j]
        if j == sons[0]:
            bj = meanb[j] / 2
        elif j == sons[1]:
            bj = meanb[sons[0]] / 2
        depth[j] = depth[dad] + bj
    height = max(depth.max(), 1e-9)
    root_age = 1.0
    cal = st.calibrations.get(root) or st.root_age_prior
    if cal is not None:
        p = cal[1]
        root_age = {"L": lambda: p[0] * 1.2,
                    "U": lambda: p[0] * 0.8,
                    "B": lambda: (p[0] + p[1]) / 2,
                    "G": lambda: p[0] / p[1],
                    "SN": lambda: p[0], "ST": lambda: p[0]}.get(
                        cal[0], lambda: 1.0)()
    ages = (height - depth) / height * root_age
    ages[:topo.ns] = 0.0
    return ages


# ---------------------------------------------------------------------------
# ctl driver
# ---------------------------------------------------------------------------


def run_ctl(opts: dict, ctl_path: str, progress=True):
    """Run infinitesites from an mcmctree ctl file (the reference binary is
    mcmctree compiled -DINFINITESITES and reads the same ctl)."""
    import os

    from .mcmctree import build_species_tree
    base = os.path.dirname(os.path.abspath(ctl_path))
    treefile = os.path.join(base, opts.get("treefile", "species.trees"))
    clock = int(opts.get("clock", 1))
    seed = int(opts.get("seed", -1))
    if seed <= 0:
        seed = np.random.SeedSequence().entropy % (2 ** 31)
    burnin = int(opts.get("burnin", 2000))
    nsample = int(opts.get("nsample", 10000))
    sampfreq = int(opts.get("sampfreq", 2))
    rgene = [float(x) for x in str(opts.get("rgene_gamma", "2 20 1")).split()]
    sigma2 = [float(x) for x in
              str(opts.get("sigma2_gamma", "1 10 1")).split()]
    while len(rgene) < 3:
        rgene.append(1.0)
    while len(sigma2) < 3:
        sigma2.append(1.0)
    bds = [float(x) for x in str(opts.get("BDparas", "1 1 0.1")).split()]

    text = open(treefile).read().split("\n")
    # first line "ns ntree"; tree on a later line
    names = None
    tree_lines = [ln for ln in text if "(" in ln]
    tree = treeio.parse_newick(tree_lines[0].strip())
    names = [n.name for n in tree.walk_pre() if not n.children]
    st = build_species_tree(tree, names, bds=bds[:3],
                            root_age=opts.get("RootAge"))
    ndata = int(str(opts.get("ndata", "1")).split()[0])
    if clock == 1:
        ds = read_fixed_ds_clock1(os.path.join(base, "FixedDsClock1.txt"),
                                  st.ns, ndata)
        return run_clock1(st, ds, rgene[:3], burnin=burnin,
                          nsample=nsample, sampfreq=sampfreq, seed=seed,
                          progress=progress)
    b = read_fixed_ds_clock23(os.path.join(base, "FixedDsClock23.txt"),
                              st, names)
    return run_clock23(st, b, clock=clock, rgene_para=rgene[:3],
                       sigma2_para=sigma2[:3], burnin=burnin,
                       nsample=nsample, sampfreq=sampfreq, seed=seed,
                       progress=progress)
