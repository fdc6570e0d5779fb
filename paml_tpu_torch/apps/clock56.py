"""clock 5/6: ML divergence-time estimation from heterogeneous multi-locus
data (Yang 2004, Acta Zoologica Sinica 50:645-656).

Port of `paml_tpu/apps/clock56.py` (reference: DatingHeteroData,
src/treesub.c:10100; lnLfunHeteroData :9491; funSS_AHRS :9535;
AdHocRateSmoothing :9769; GetInitialsClock56Step3 :9687; SetBranchRates
:9620; ReadTreeSeqs :8933).  Loci may contain different taxa subsets;
gene trees are pruned from the species tree and fossil calibrations are
point ages fixed with '@' in the species tree.

Each step is one objective on the device the caller names, with autograd
gradients for the fits (replacing ming2's finite differences) and the
Hessian of `codeml.hessian` on the objectives' twice-differentiable route
for the SEs and step 1's branch-length curvatures (replacing minB's
approximate curvature).  Nucleotide loci take the level route
(`pruning.class_site_lnf` below 16 states); codon loci take the
hand-written kernels on the card (B3/B4 for clean state codes, B1/B2
with gaps), through `codeml.make_codon_objective` in step 1 and
`pmat_rev` + `pruning.lnL` in step 3.  Every fit's objective (step 1's,
the AHRS objective, step 3's) makes its tables on the device when it is
built and declares itself `capturable`: on the card each fit replays
one CUDA graph, as the JAX package's `jit` compiles it.

clock = 5: global clock, one rate per locus.
clock = 6: AHRS local clock —
  step 1  per-locus no-clock branch lengths + curvature variances;
  step 2  rate smoothing: one set of species ages + per-(locus, node)
          rates + per-locus nu under a weighted-LS + GBM objective;
  step 3  collapse rates into nbrate groups per locus (beta-spaced
          cutpoints) and re-fit ages + per-group rates by ML.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import cuda_pruning, pruning
from ..core.dgamma import discrete_gamma
from ..core.optim import FitResult, maximize
from ..core.pmat import pmat_rev
from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from ..models import codon as codonmod
from ..models import nuc
from . import baseml as baseml_app
from . import codeml as codeml_app

SMALL_AGE_FRAC = 1e-20


# ---------------------------------------------------------------------------
# species tree + gene-tree pruning
# ---------------------------------------------------------------------------

@dataclass
class GeneTree:
    topo: Topology                 # rooted gene tree
    ipop: np.ndarray               # gene node -> species node
    data: seqio.PackedData


@dataclass
class HeteroData:
    sp_topo: Topology
    fixed_ages: dict               # species node -> fixed (fossil) age
    loci: list                     # list[GeneTree]


def prune_to_taxa(sp_root: treeio.TreeNode, keep: set[str]) -> treeio.TreeNode:
    """Prune a species tree (with .index assigned) to a taxa subset,
    collapsing unary nodes (reference: GenerateGtree/GetSubTreeN,
    src/treesub.c:9041/:3375).  Each surviving node carries .sp_index,
    the species-tree node it maps to (the reference's nodes[].ipop)."""
    def rec(node: treeio.TreeNode):
        if node.is_tip:
            if node.name not in keep:
                return None
            t = treeio.TreeNode(name=node.name)
            t.sp_index = node.index
            return t
        kids = [k for k in (rec(c) for c in node.children) if k is not None]
        if not kids:
            return None
        if len(kids) == 1:
            return kids[0]
        t = treeio.TreeNode(name="", children=kids)
        t.sp_index = node.index
        return t
    out = rec(sp_root)
    if out is None or out.is_tip:
        raise ValueError("locus shares <2 taxa with the species tree")
    return out


def read_tree_seqs(treefile: str, seqfile: str, ngene: int,
                   seqtype: int = seqio.BASE_SEQ,
                   cleandata: bool = False, icode: int = 0) -> HeteroData:
    """Read the species tree (with '@' fossil ages) and `ngene` stacked
    alignments; construct pruned gene trees (reference: ReadTreeSeqs,
    src/treesub.c:8933)."""
    alns = seqio.read_alignments(seqfile, seqtype, ndata=ngene)
    all_names = sorted({n for a in alns for n in a.names})
    trees = treeio.read_trees(treefile, all_names)
    sp_root = trees[0]
    sp_topo = from_treenode(sp_root, all_names)   # assigns .index
    fixed = {}
    for node in sp_root.walk_pre():
        if node.age is not None and node.children:
            fixed[node.index] = float(node.age)
    loci = []
    for aln in alns:
        g_root = prune_to_taxa(sp_root, set(aln.names))
        data = seqio.pack(aln, cleandata=cleandata, icode=icode)
        topo = from_treenode(g_root, data.names)
        ipop = np.zeros(topo.nnode, dtype=np.int64)
        for n in g_root.walk_pre():
            ipop[n.index] = n.sp_index
        loci.append(GeneTree(topo=topo, ipop=ipop, data=data))
    return HeteroData(sp_topo=sp_topo, fixed_ages=fixed, loci=loci)


# ---------------------------------------------------------------------------
# node-age parametrization (proportion transform with fossil point fixes)
# ---------------------------------------------------------------------------

def make_ages_fn(sp_topo: Topology, fixed_ages: dict, device=None,
                 dtype=torch.float64):
    """Ages from unconstrained-in-(0,1) proportions: in preorder,
    age(n) = agelow(n) + (age(father) - agelow(n)) * x_n for free internal
    nodes, with fossil nodes fixed (reference: SetAge, src/treesub.c:3714;
    bounds from AdHocRateSmoothing, :9895).  agelow(n) is the largest
    fossil age in n's subtree.  Returns (ages_of(x)->[nnode], x0, bounds,
    free_nodes); ages_of sets the free nodes one depth level at a time,
    from index and age tables made on `device` now, or on another device
    at ages_of's first call there (an evaluation copies nothing from the
    host, so a CUDA graph can hold it)."""
    nnode, root, ns = sp_topo.nnode, int(sp_topo.root), sp_topo.ns
    agelow = np.zeros(nnode)
    for n in sp_topo.postorder:
        m = 0.0
        for c in sp_topo.children[n]:
            if c < 0:
                continue
            m = max(m, fixed_ages.get(int(c), agelow[int(c)]))
        agelow[n] = m
    preorder = []
    stack = [root]
    while stack:
        n = stack.pop()
        preorder.append(n)
        for c in sp_topo.children[n]:
            if c >= ns:
                stack.append(int(c))
    free = [n for n in preorder if n != root and n not in fixed_ages]
    root_free = root not in fixed_ages
    idx = {n: (1 if root_free else 0) + i for i, n in enumerate(free)}
    parent = sp_topo.parent
    depth = {root: 0}
    for n in preorder[1:]:
        depth[n] = depth[int(parent[n])] + 1
    # the free nodes by depth: (nodes, parents, agelow, x index) per level
    levels = []
    for d in sorted({depth[n] for n in free}):
        lv = [n for n in free if depth[n] == d]
        levels.append((np.array(lv), parent[lv].astype(np.int64),
                       agelow[lv], np.array([idx[n] for n in lv])))
    base = np.zeros(nnode)
    for n, a in fixed_ages.items():
        if n >= ns:
            base[n] = a

    made = {}      # (device, dtype) -> (base, root, the levels' tables)

    def tables(xa):
        key = (xa.device, xa.dtype)
        if key not in made:
            def i(a):
                return torch.as_tensor(a, dtype=torch.int64,
                                       device=xa.device)

            def f(a):
                return torch.as_tensor(a, dtype=xa.dtype, device=xa.device)
            made[key] = (f(base), i([root]),
                         [(i(nodes), i(pa), f(low), i(xi))
                          for nodes, pa, low, xi in levels])
        return made[key]

    if device is not None:
        tables(torch.empty(0, dtype=dtype, device=device))

    def ages_of(xa):
        ages, root_t, levels_t = tables(xa)
        if root_free:
            ages = ages.index_put((root_t,), xa[:1])
        for nodes, pa, low, xi in levels_t:
            ages = ages.index_put((nodes,), low + (ages[pa] - low) * xa[xi])
        return ages

    x0, bounds = [], []
    if root_free:
        lo = max(agelow[root] * 1.0001, 1e-5)
        x0.append(max(agelow[root] * 1.5, 0.1))
        bounds.append((lo, max(agelow[root] * 10, 50.0)))
    x0 += [0.6 + 0.02 * (i % 5) for i in range(len(free))]
    bounds += [(1e-5, 1 - 1e-5)] * len(free)
    return ages_of, np.array(x0), bounds, ([root] if root_free else []) + free


# ---------------------------------------------------------------------------
# step 3 (and the whole of clock 5): joint ML of ages and rates
# ---------------------------------------------------------------------------

@dataclass
class Clock56Spec:
    """The JAX package's `Clock56Spec`, field for field."""
    model: str = "HKY85"
    clock: int = 5
    seqtype: int = seqio.BASE_SEQ  # BASE_SEQ or CODON_SEQ
    icode: int = 0                 # genetic code (codon data)
    codonf: str = "Fequal"         # codon-frequency model (codon data)
    fix_omega: bool = False        # codon data: per-locus omega
    omega: float | list = 0.4
    fix_kappa: bool = False
    kappa: float | list = 2.0
    fix_alpha: bool = True
    alpha: float | list = 0.0
    ncatG: int = 5
    use_median: bool = False
    nbrate: int = 4                # rate groups per locus (clock 6)
    nu_prior: float = 0.001        # nu_AHRS exponential-prior scale
    cleandata: bool = False
    getSE: bool = False
    seed: int = 1


@dataclass
class Clock56Result:
    lnL: float
    ages: np.ndarray               # species-node ages
    rates: list                    # per locus: [nbrate] rates
    kappa: np.ndarray | None
    alpha: np.ndarray | None
    np: int
    sp_topo: Topology = None
    labels: list = None            # per locus: branch-group label per node
    SEs: np.ndarray | None = None
    fit: FitResult = None
    step2: dict | None = None
    omega: np.ndarray | None = None  # per locus (codon data)


def _per_gene_param(val, g: int, G: int) -> float:
    arr = np.atleast_1d(np.asarray(val, dtype=np.float64))
    return float(arr[g % len(arr)] if len(arr) > 1 else arr[0])


def make_step3_objective(hd: HeteroData, spec: Clock56Spec,
                         labels: list, nbrate: list, *, device,
                         dtype=torch.float64):
    """Joint objective over species ages + per-(locus, group) rates +
    per-locus kappa/omega/alpha (reference: lnLfunHeteroData,
    treesub.c:9491; codon loci use the same routine's per-gene
    data.kappa/data.omega with the M0 codon model).  Returns (neg_lnl,
    unpack, (x0 of the ages, their bounds), dims); neg_lnl(x) is the fit's
    route, `neg_lnl.twice(x)` the route that is differentiable twice and
    `neg_lnl.terms(x)` its loci's pruning inputs (`codeml.hessian`, which
    takes every locus at once: codon loci on the card through the
    kernels)."""
    device = torch.device(device)
    ages_of, xa0, xab, _ = make_ages_fn(hd.sp_topo, hd.fixed_ages, device,
                                        dtype)
    nxa = len(xa0)
    G = len(hd.loci)
    is_codon = spec.seqtype == seqio.CODON_SEQ
    if is_codon:
        graph = codonmod.codon_graph(spec.icode)
        Gt = codonmod.pair_tables(spec.icode, device)
        nr1 = 0 if spec.fix_kappa else 1
        nw = 0 if spec.fix_omega else 1
    else:
        graph = None
        nr1 = nuc.N_RATE_PARAMS[spec.model] if not spec.fix_kappa else 0
        nw = 0
    est_alpha = (spec.ncatG > 1) and not spec.fix_alpha
    K = spec.ncatG if (est_alpha or np.any(np.asarray(spec.alpha) > 0)) else 1
    roff = np.concatenate([[0], np.cumsum(nbrate)]).astype(int)
    ntot_r = int(roff[-1])

    def tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    consts = []
    for g, gt in enumerate(hd.loci):
        topo = gt.topo
        lab = np.asarray(labels[g], dtype=np.int64)
        if is_codon:
            fcodon, f3x4, f1x4 = codonmod.count_codon_freqs(
                gt.data.tip_partials, gt.data.fpatt, graph,
                gt.data.pos_masks)
            pig = codonmod.codon_pi(spec.codonf, fcodon, f3x4, f1x4, graph)
            pf3x4 = codonmod.mg_pf3x4(spec.codonf, f3x4, f1x4)
            if pf3x4 is not None:
                pf3x4 = tensor(pf3x4)
            tips = codeml_app._codon_tips(gt.data.tip_partials, device,
                                          dtype)
            cuda_pruning.check_tips(tips, graph.n)
        else:
            pig = nuc.model_pi(spec.model, gt.data.base_freqs)
            pf3x4 = None
            tips = baseml_app._nuc_tips(gt.data.tip_partials, device, dtype)
        consts.append((
            tensor(gt.ipop, torch.int64),
            tensor(gt.ipop[topo.parent.clip(0)], torch.int64),
            tensor(lab + roff[g], torch.int64),
            tensor(np.arange(topo.nnode) == topo.root, torch.bool),
            tips,
            tensor(gt.data.fpatt),
            tensor(pig),
            pf3x4,
            # the fixed kappa (or nucleotide rate) and omega of the gene
            tensor([_per_gene_param(spec.kappa, g, G)]),
            tensor(_per_gene_param(spec.omega, g, G)),
        ))

    def unpack(x):
        ages = ages_of(x[:nxa])
        k = nxa
        r = x[k:k + ntot_r]
        k += ntot_r
        kap = x[k:k + nr1 * G] if nr1 else None
        k += nr1 * G
        om = x[k:k + G] if nw else None
        k += nw * G
        al = x[k:k + G] if est_alpha else None
        return ages, r, kap, om, al

    # the class rates and weights of a fixed alpha, once
    fixed_rw = []
    for g in range(G):
        if K > 1 and not est_alpha:
            rw = discrete_gamma(torch.tensor(_per_gene_param(spec.alpha, g, G),
                                             dtype=dtype, device=device), K,
                                use_median=spec.use_median)
        else:
            rw = (torch.ones(1, dtype=dtype), torch.ones(1, dtype=dtype))
        fixed_rw.append(tuple(v.to(device) for v in rw))

    def class_rates(g, al):
        if est_alpha:
            return discrete_gamma(al[g], K, use_median=spec.use_median)
        return fixed_rw[g]

    def loci_terms(x, twice=False):
        """Each locus's (P, root frequencies per class, class weights, tips,
        topology, fpatt) at x; with `twice` P(t) by the route that is
        differentiable twice."""
        x = x.to(dtype)
        ages, r, kap, om, al = unpack(x)
        terms = []
        for g, gt in enumerate(hd.loci):
            (ipop, ipop_pa, rlab, is_root, tips, fpatt, pig, pf3x4,
             kfix, ofix) = consts[g]
            dt = ages[ipop_pa] - ages[ipop]          # [nnode]
            ts = torch.where(is_root, torch.zeros_like(dt), dt * r[rlab])
            rr, w = class_rates(g, al)
            if is_codon:
                kg = kap[g:g + 1] if nr1 else kfix
                og = om[g] if nw else ofix
                s = codonmod.mutation_part(Gt, kg, pf3x4)
                Q = codonmod.build_Q(Gt, s, og, pig)
                mr = codonmod.mean_rate(Gt, s, og, pig)
                P = pmat_rev(Q, pig, ts[:, None] * rr[None, :] / mr, twice)
                pi_root = pig
            else:
                rates_g = kap[g * nr1:(g + 1) * nr1] if nr1 else kfix
                P, pi_root = nuc.pmats_for_model(
                    spec.model, rates_g, pig, ts[:, None] * rr[None, :],
                    None, twice)
            piC = pi_root.expand(rr.shape[0], pi_root.shape[-1])
            terms.append((P, piC, w, tips, gt.topo, fpatt))
        return terms

    def neg_lnl(x, twice=False):
        lnf = pruning.class_site_lnf_twice if twice else \
            pruning.class_site_lnf
        total = x.new_zeros((), dtype=dtype)
        for P, piC, w, tips, topo, fpatt in loci_terms(x, twice):
            total = total + pruning.lnL(P, tips, topo, piC, w, fpatt,
                                        lnf=lnf)
        return -total

    # the fit's route reads nothing on the host: a CUDA graph can hold it
    neg_lnl.capturable = True
    neg_lnl.twice = lambda x, patterns=slice(None): neg_lnl(x, True)
    # the Hessian's kernel route (`codeml.hessian`), codon loci on the card
    neg_lnl.terms = lambda x: loci_terms(x, True)
    # what `codeml.hessian` reads: one pass over every locus's patterns
    neg_lnl.topo, neg_lnl.fpatt = hd.loci[0].topo, consts[0][5]
    neg_lnl.n_states = graph.n if is_codon else 4
    neg_lnl.n_classes = lambda x: K
    neg_lnl.pattern_chunks = False
    return neg_lnl, unpack, (xa0, xab), (nxa, ntot_r, nr1, nw, G, est_alpha)


def _fit_joint(hd, spec, labels, nbrate, rate_init, age_x0=None, *,
               device):
    neg_lnl, unpack, (xa0, xab), dims = make_step3_objective(
        hd, spec, labels, nbrate, device=device)
    nxa, ntot_r, nr1, nw, G, est_alpha = dims
    if age_x0 is not None:
        xa0 = age_x0
    x0 = list(xa0) + list(rate_init)
    bounds = list(xab) + [(1e-7, 999.0)] * ntot_r
    for g in range(G):
        x0 += [_per_gene_param(spec.kappa, g, G)] * nr1
        bounds += [(1e-4, 999.0)] * nr1
    if nw:
        for g in range(G):
            x0.append(_per_gene_param(spec.omega, g, G))
            bounds.append((1e-4, 999.0))
    if est_alpha:
        for g in range(G):
            a0 = _per_gene_param(spec.alpha, g, G)
            x0.append(a0 if a0 > 0 else 0.5)
            bounds.append((0.005, 99.0))
    res = maximize(neg_lnl, np.array(x0), bounds, device=device)
    with torch.no_grad():
        ages, r, kap, om, al = (None if v is None else v.cpu().numpy()
                                for v in unpack(torch.as_tensor(
                                    res.x, device=device)))
    ses = None
    if spec.getSE:
        H = codeml_app.hessian(neg_lnl, res.x, device=device)
        cov = np.linalg.pinv(H)
        ses = np.sqrt(np.maximum(np.diag(cov), 0.0))
    roff = np.concatenate([[0], np.cumsum(nbrate)]).astype(int)
    return Clock56Result(
        lnL=res.lnL, ages=ages,
        rates=[r[roff[g]:roff[g + 1]] for g in range(G)],
        kappa=(kap.reshape(G, nr1) if nr1 else None),
        alpha=(al if est_alpha else None),
        omega=(om if nw else None),
        np=len(res.x), sp_topo=hd.sp_topo, labels=labels, SEs=ses, fit=res)


def fit_clock5(hd: HeteroData, spec: Clock56Spec | None = None, *,
               device) -> Clock56Result:
    """Global clock over heterogeneous loci: one rate per locus
    (reference: DatingHeteroData with com.clock==5, treesub.c:10160)."""
    spec = spec or Clock56Spec(clock=5)
    G = len(hd.loci)
    labels = [np.zeros(gt.topo.nnode, dtype=np.int64) for gt in hd.loci]
    rng = np.random.RandomState(spec.seed)
    rate_init = 0.2 + rng.uniform(size=G)      # GetInitialsClock56Step3
    return _fit_joint(hd, spec, labels, [1] * G, rate_init, device=device)


# ---------------------------------------------------------------------------
# clock 6: AHRS
# ---------------------------------------------------------------------------

def _step1_locus(gt: GeneTree, spec: Clock56Spec, g: int, G: int, *,
                 device):
    """No-clock branch lengths + curvature variances on the rooted gene
    tree (reference: AdHocRateSmoothing step 1, treesub.c:9797-9877).
    Returns (b[nnode], varb[nnode], lnL, rates, alpha): b/varb indexed by
    gene node, with the two root-son branches symmetrized to (t0+t1)/2 and
    the merged-branch variance stored at the root slot."""
    if spec.seqtype == seqio.CODON_SEQ:
        cspec = codeml_app.CodemlSpec(
            codonf=spec.codonf, icode=spec.icode,
            fix_kappa=spec.fix_kappa,
            kappa=_per_gene_param(spec.kappa, g, G),
            fix_omega=spec.fix_omega,
            omega=_per_gene_param(spec.omega, g, G),
            fix_alpha=spec.fix_alpha,
            alpha=_per_gene_param(spec.alpha, g, G))
        neg_lnl, unpack, _classes, x0, bounds, _pi = \
            codeml_app.make_codon_objective(gt.data, gt.topo, cspec,
                                            device=device)
        res = maximize(neg_lnl, x0, bounds, device=device)
        with torch.no_grad():
            t, rates, _ppi, _theta = unpack(torch.as_tensor(res.x,
                                                            device=device))
        alpha = np.zeros(0)
    else:
        bspec = baseml_app.BasemlSpec(
            model=spec.model, ncatG=spec.ncatG,
            fix_alpha=spec.fix_alpha,
            alpha=_per_gene_param(spec.alpha, g, G),
            fix_kappa=spec.fix_kappa,
            kappa=_per_gene_param(spec.kappa, g, G))
        neg_lnl, unpack, x0, bounds = baseml_app.make_objective(
            gt.data, gt.topo, bspec, device=device)
        res = maximize(neg_lnl, x0, bounds, device=device)
        with torch.no_grad():
            t, _, rates, alpha = unpack(torch.as_tensor(res.x,
                                                        device=device))
        alpha = alpha.cpu().numpy()
    bn = gt.topo.branch_nodes()
    # exact per-branch curvature: the diagonal of d2(-lnL)/db2 (replacing
    # minB's quadratic-fit curvature, treesub.c:8039)
    nb_ = len(bn)
    d2 = np.diag(codeml_app.hessian(neg_lnl, res.x, device=device))[:nb_]
    nnode = gt.topo.nnode
    b = np.zeros(nnode)
    varb = np.full(nnode, 999.0)
    tnp = t.cpu().numpy()
    for k, n in enumerate(bn):
        b[n] = tnp[k]
        varb[n] = (1.0 / d2[k]) if (tnp[k] > 1e-8 and d2[k] > 0) else 999.0
    root = int(gt.topo.root)
    sons = [int(c) for c in gt.topo.children[root] if c >= 0]
    son0, son1 = sons[0], sons[1]
    t0, t1 = b[son0], b[son1]
    varb[root] = varb[son0 if t0 > t1 else son1]
    b[son0] = b[son1] = (t0 + t1) / 2
    return b, varb, res.lnL, rates.cpu().numpy(), alpha


def _mean_rate(gt: GeneTree, b: np.ndarray, fixed_ages: dict) -> float:
    """Rough per-locus rate from fossil nodes: mean tip-to-node path /
    age (reference: GetMeanRate, treesub.c:9718)."""
    topo = gt.topo
    mr, nf = 0.0, 0
    for n in range(topo.ns, topo.nnode):
        sp = int(gt.ipop[n])
        age = fixed_ages.get(sp, 0.0)
        if age <= 0:
            continue
        depths, stack = [], [(int(c), b[int(c)]) for c in topo.children[n]
                             if c >= 0]
        while stack:
            m, d = stack.pop()
            if m < topo.ns:
                depths.append(d)
            else:
                stack += [(int(c), d + b[int(c)])
                          for c in topo.children[m] if c >= 0]
        if depths:
            mr += float(np.mean(depths)) / age
            nf += 1
    return mr / nf if nf else 0.05


def make_ahrs_objective(hd: HeteroData, step1, nu_prior: float, *, device,
                        dtype=torch.float64):
    """AHRS smoothing objective (reference: funSS_AHRS, treesub.c:9535):
    weighted LS of predicted vs estimated branch lengths (trapezoid of
    node rates) + the GBM rate-change penalty + an exponential prior on
    each locus' nu.  Parameters: [ages | per-locus non-root node rates |
    per-locus nu].  Each locus's sums are one vector expression over its
    branches, from tables made once on the device (`capturable`)."""
    device = torch.device(device)
    ages_of, xa0, xab, _ = make_ages_fn(hd.sp_topo, hd.fixed_ages, device,
                                        dtype)
    nxa = len(xa0)
    root_age_guess = max(list(hd.fixed_ages.values()) + [1.0])
    smallage = root_age_guess * SMALL_AGE_FRAC

    def tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    consts = []
    offs = [0]
    for g, gt in enumerate(hd.loci):
        topo = gt.topo
        root = int(topo.root)
        sons = [int(c) for c in topo.children[root] if c >= 0]
        nonroot = np.array([n for n in range(topo.nnode) if n != root])
        b, varb, _, _, _ = step1[g]
        # the LS branches: every non-root branch but the two at the root,
        # whose sum is one merged branch
        ls = np.array([j for j in nonroot if j not in sons])
        consts.append(dict(
            nn=topo.nnode, root=root, son0=sons[0], son1=sons[1],
            root_t=tensor([root], torch.int64),
            ipop=tensor(gt.ipop, torch.int64),
            nonroot=tensor(nonroot, torch.int64),
            pa_nonroot=tensor(topo.parent[nonroot], torch.int64),
            ls=tensor(ls, torch.int64),
            pa_ls=tensor(topo.parent[ls], torch.int64),
            b_ls=tensor(b[ls]), varb_ls=tensor(varb[ls]),
            b_root=float(b[sons[0]] + b[sons[1]]),
            varb_root=float(varb[root])))
        offs.append(offs[-1] + len(nonroot))
    nrates = offs[-1]

    def neg(x):
        x = x.to(dtype)
        ages = ages_of(x[:nxa])
        total = x.new_zeros(())
        for g, c in enumerate(consts):
            root, son0, son1 = c["root"], c["son0"], c["son1"]
            rflat = x[nxa + offs[g]:nxa + offs[g + 1]]
            nu = x[nxa + nrates + g]
            a = ages[c["ipop"]]
            t0 = a[root] - a[son0]
            t1 = a[root] - a[son1]
            r = x.new_zeros(c["nn"]).index_put((c["nonroot"],), rflat)
            r_root = (r[son0] * t1 + r[son1] * t0) / (t0 + t1)
            r = r.index_put((c["root_t"],), r_root[None])
            # lnLb: weighted LS over branches (root pair merged)
            j, pa = c["ls"], c["pa_ls"]
            be = (a[pa] - a[j]) * (r[pa] + r[j]) / 2
            total = total + ((be - c["b_ls"]) ** 2
                             / (2 * c["varb_ls"])).sum()
            be_root = ((a[root] - a[son0]) * (r_root + r[son0]) / 2
                       + (a[root] - a[son1]) * (r_root + r[son1]) / 2)
            total = total + (be_root - c["b_root"]) ** 2 \
                / (2 * c["varb_root"])
            # lnLr: GBM penalty, exactly the reference's expression
            j, pa = c["nonroot"], c["pa_nonroot"]
            t = torch.clamp_min(a[pa] - a[j], smallage)
            y = torch.log(r[j] / r[pa]) + t * nu / 2
            total = total + (y * y / (2 * t * nu) - torch.log(r[j])
                             - torch.log(2 * torch.pi * t * nu) / 2).sum()
            total = total + nu / nu_prior + torch.log(nu)
        return total
    # every table is made above, on the device: a CUDA graph can hold it
    neg.capturable = True

    return neg, ages_of, (xa0, xab), nrates, offs


def fit_clock6(hd: HeteroData, spec: Clock56Spec | None = None, *,
               device) -> Clock56Result:
    """AHRS 3-step local-clock dating (reference: AdHocRateSmoothing +
    DatingHeteroData, treesub.c:9769/:10100)."""
    spec = spec or Clock56Spec(clock=6)
    G = len(hd.loci)
    rng = np.random.RandomState(spec.seed)

    # step 1: per-locus no-clock branch lengths + variances
    step1 = [_step1_locus(hd.loci[g], spec, g, G, device=device)
             for g in range(G)]
    mr = [_mean_rate(hd.loci[g], step1[g][0], hd.fixed_ages)
          for g in range(G)]

    # step 2: rate smoothing
    neg, ages_of, (xa0, xab), nrates, offs = make_ahrs_objective(
        hd, step1, spec.nu_prior, device=device)
    x0 = list(xa0)
    bounds = list(xab)
    for g in range(G):
        n_g = offs[g + 1] - offs[g]
        x0 += list(mr[g] * (0.8 + 0.4 * rng.uniform(size=n_g)))
        bounds += [(0.001, 99.0)] * n_g
    x0 += list(0.001 + 0.1 * rng.uniform(size=G))
    bounds += [(1e-6, 99.0)] * G
    res2 = maximize(neg, np.array(x0), bounds, device=device)
    x2 = res2.x
    with torch.no_grad():
        ages2 = ages_of(torch.as_tensor(x2[:len(xa0)],
                                        device=device)).cpu().numpy()

    # collapse node rates into branch-rate groups per locus
    labels, rate_init, nbrate_list = [], [], []
    for g, gt in enumerate(hd.loci):
        topo = gt.topo
        root = int(topo.root)
        nonroot = [n for n in range(topo.nnode) if n != root]
        r = np.zeros(topo.nnode)
        r[nonroot] = x2[len(xa0) + offs[g]:len(xa0) + offs[g + 1]]
        a = ages2[gt.ipop]
        sons = [int(c) for c in topo.children[root] if c >= 0]
        t0, t1 = a[root] - a[sons[0]], a[root] - a[sons[1]]
        r[root] = (r[sons[0]] * t1 + r[sons[1]] * t0) / (t0 + t1)
        # SetBranchRates (treesub.c:9620): tips average with the father
        for n in range(topo.ns):
            r[n] = (r[n] + r[int(topo.parent[n])]) / 2
        rb = r[nonroot]
        minr, maxr = rb.min(), rb.max()
        nb = min(spec.nbrate, len(nonroot))
        if maxr - minr < 1e-9 or nb < 2:
            nb = 1
            cut = np.array([maxr])
        else:
            beta = min(0.25 + 0.25 * np.log(nb), 0.99)
            cut = minr + (maxr - minr) * beta ** (nb - 1.0
                                                  - np.arange(nb))
        lab = np.zeros(topo.nnode, dtype=np.int64)
        means = np.zeros(nb)
        counts = np.zeros(nb)
        for n in nonroot:
            jgrp = int(np.searchsorted(cut[:-1], r[n], side="right"))
            lab[n] = jgrp
            means[jgrp] += r[n]
            counts[jgrp] += 1
        # drop empty groups, renumbering labels
        keep = np.where(counts > 0)[0]
        remap = {int(old): i for i, old in enumerate(keep)}
        for n in nonroot:
            lab[n] = remap[int(lab[n])]
        means = means[keep] / counts[keep]
        labels.append(lab)
        nbrate_list.append(len(keep))
        rate_init += list(means * (0.9 + 0.2 * rng.uniform(size=len(keep))))

    # step 3: joint ML with grouped rates; start ages at step-2 estimates
    age_x0 = x2[:len(xa0)] * (0.9 + 0.2 * rng.uniform(size=len(xa0)))
    age_x0 = np.clip(age_x0, [b[0] for b in xab], [b[1] for b in xab])
    out = _fit_joint(hd, spec, labels, nbrate_list, rate_init,
                     age_x0=age_x0, device=device)
    out.step2 = {"ages": ages2, "nu": x2[len(xa0) + nrates:],
                 "objective": res2.lnL}
    return out


def fit(treefile: str, seqfile: str, ngene: int,
        spec: Clock56Spec | None = None, *, device) -> Clock56Result:
    spec = spec or Clock56Spec()
    hd = read_tree_seqs(treefile, seqfile, ngene, seqtype=spec.seqtype,
                        cleandata=spec.cleandata, icode=spec.icode)
    if spec.clock == 5:
        return fit_clock5(hd, spec, device=device)
    return fit_clock6(hd, spec, device=device)
