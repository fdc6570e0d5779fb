"""baseml: maximum likelihood for nucleotide alignments.

Port of `paml_tpu/apps/baseml.py` (reference: src/baseml.c): the eleven
models of `models/nuc.py`, discrete gamma (mean or median method),
basemlg's continuous gamma, Mgene 0-4 with `rgene` and `Malpha`, clocks
1-3 and TipDate (`core/clockparam.py`), the free-rate models nparK 1-4 and
the auto-discrete-gamma rate HMM (`core/hmm.py`), REVu / UNRESTu step
matrices, and the nonhomogeneous models nhomo 1-5.  Multi-gene (option G)
semantics follow the reference (SetPGene, src/baseml.c:1428): Mgene = 0
shares everything and frees per-gene rates `rgene`; 2 per-gene
(observed) frequencies; 3 per-gene rate parameters; 4 both; 1 separate
analyses per gene (`fit_separate`).

The parameter vector keeps the JAX package's layout (`unpack`), so the
same x means the same model in both packages.  Fits run in float64 on the
device the caller names, as one `core/optim.maximize` stage (the JAX
package's f32 stage is TPU machinery).  With 4 states the pruning runs
the level path on the card (`pruning.class_site_lnf`'s rule below 16
states), as the JAX package keeps nucleotides off its kernels.

An objective has the two routes of `apps/codeml.py`: `neg_lnl(x)` the
fit's, differentiable once; `neg_lnl.twice(x, patterns)` the Hessian's
(`codeml.hessian`), differentiable twice.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import pruning
from ..core.clockparam import make_clock_times
from ..core.dgamma import discrete_gamma, gammaincinv
from ..core.hmm import autod_gamma, hmm_lnL
from ..core.optim import FitResult, maximize, simplex_decode
from ..core.pmat import pmat_rev_multi, pmat_rev_multi_twice
from ..core.pmat import pmat_tn93, tn93_alphas
from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from ..models import nuc
from . import codeml

# reference bounds: SetxBound, src/baseml.c:1458
BLEN_MIN, BLEN_MAX = 4e-6, 50.0
RATE_MIN, RATE_MAX = 1e-5, 999.0
RGENE_MIN, RGENE_MAX = 1e-4, 999.0
ALPHA_MIN, ALPHA_MAX = 0.005, 999.0


@dataclass
class BasemlSpec:
    """The JAX package's `BasemlSpec`, field for field."""
    model: str = "JC69"
    ncatG: int = 1               # >1 turns on discrete gamma
    fix_alpha: bool = True
    alpha: float = 0.0
    fix_kappa: bool = False
    kappa: float = 5.0
    Mgene: int = 0
    Malpha: bool = False         # separate alpha per gene
    clock: int = 0               # 0 none; 1 global; 2 local (rates by label)
    tipdate: bool = False        # dated tips: absolute ages + mutation rate
    tipdate_timeunit: float | None = None
    fix_rho: bool = True         # AdG rate autocorrelation (rho)
    rho: float = 0.0
    nparK: int = 0               # 1: free rates; 2: free rates + freqs
    continuous_gamma: bool = False   # basemlg: continuous-gamma rates
    nhomo: int = 0               # 1: est pi; 2: branch kappas; 3/4/5: branch pis
    cleandata: bool = False
    use_median: bool = False     # discrete-gamma median option
    getSE: bool = False
    step_matrix: np.ndarray | None = None   # REVu/UNRESTu constraints
    n_user_rates: int = 0


@dataclass
class BasemlResult:
    """The JAX package's `BasemlResult`, field for field."""
    lnL: float
    blens: np.ndarray            # per-branch MLEs, indexed by branch node
    branch_nodes: np.ndarray
    rate_params: np.ndarray
    rgene: np.ndarray
    alpha: np.ndarray | None
    pi: np.ndarray
    np: int
    topo: Topology = None
    SEs: np.ndarray | None = None
    fit: FitResult = None
    x: np.ndarray = None


def _n_rate_params(spec: BasemlSpec) -> int:
    if spec.model in ("REVu", "UNRESTu"):
        return spec.n_user_rates
    n = nuc.N_RATE_PARAMS[spec.model]
    if spec.fix_kappa and spec.model in ("K80", "F84", "HKY85", "T92", "TN93"):
        n = 0
    return n


def _nuc_tips(tip_partials: np.ndarray, device, dtype) -> torch.Tensor:
    """Tip data on the device: int32 state codes [ns, H] when the data are
    codes or every cell is resolved (the tip product becomes a gather),
    else the partials [ns, H, 4]."""
    tips = np.asarray(tip_partials)
    if tips.ndim == 3 and ((tips != 0).sum(-1) == 1).all() \
            and (tips.max(-1) == 1).all():
        tips = tips.argmax(-1)
    if tips.ndim == 2:
        return torch.as_tensor(tips.astype(np.int32), device=device)
    return torch.as_tensor(tips, dtype=dtype, device=device)


def _decode_rows(x: torch.Tensor) -> torch.Tensor:
    """`simplex_decode` of each row of x [m, k-1] -> [m, k]."""
    return torch.stack([simplex_decode(row) for row in x])


def make_nhomo_objective(data: seqio.PackedData, topo: Topology,
                         spec: BasemlSpec, *, device, dtype=torch.float64):
    """Nonhomogeneous models (reference: nhomo options, src/baseml.c:1201):
    nhomo = 1 one estimated pi; 2 per-branch kappas; 3 (N1) per-tip pis,
    one internal set and the root's; 4 (N2) per-node pis; 5 pi sets by
    branch label.  Each branch's Q takes the pi set of its child node,
    normalized to mean rate 1; the root set is the root distribution.
    Returns (neg_lnl, unpack, x0, bounds)."""
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = torch.as_tensor(branch_nodes, dtype=torch.long, device=device)
    nnode = topo.nnode
    model = spec.model
    nh = spec.nhomo
    nr1 = nuc.N_RATE_PARAMS[model] if not spec.fix_kappa else (
        nuc.N_RATE_PARAMS[model] if model in ("TN93", "REV") else 0)
    tips = torch.as_tensor(np.asarray(data.tip_partials), dtype=dtype,
                           device=device)
    fpatt = torch.as_tensor(np.asarray(data.fpatt), dtype=dtype,
                            device=device)

    # the pi set of each node (that of the branch above it; the root's set
    # is the root distribution)
    if nh == 1:
        pi_set = np.zeros(nnode, dtype=np.int64)
        n_pi, root_set = 1, 0
    elif nh == 2:
        pi_set = np.zeros(nnode, dtype=np.int64)
        n_pi, root_set = 0, 0
    elif nh == 4:
        pi_set = np.arange(nnode, dtype=np.int64)
        n_pi, root_set = nnode, int(topo.root)
    elif nh == 3:
        pi_set = np.full(nnode, topo.ns, dtype=np.int64)
        pi_set[:topo.ns] = np.arange(topo.ns)
        root_set = topo.ns + 1
        pi_set[topo.root] = root_set
        n_pi = topo.ns + 2
    elif nh == 5:
        labels = topo.labels.astype(np.int64)
        nonroot = [n for n in range(nnode) if n != topo.root]
        nbtype = int(labels[nonroot].max()) + 1
        pi_set = labels.copy()
        root_lab = int(labels[topo.root])
        if 0 <= root_lab < nbtype:     # the root shares a branch set
            root_set, n_pi = root_lab, nbtype
        else:                          # the root is a set of its own
            root_set, n_pi = nbtype, nbtype + 1
        pi_set[topo.root] = root_set
    else:
        raise ValueError(f"nhomo {nh}")
    # rate sets: nhomo 2 one kappa per branch; nhomo >= 3 with fix_kappa 0
    # rates per branch, with fix_kappa 2 per branch label; else shared
    fixk = int(spec.fix_kappa)
    if nh == 2:
        n_rate_sets, nr1 = nb, 1
    elif nh >= 3 and fixk == 0:
        n_rate_sets = nb
    elif nh >= 3 and fixk == 2:
        n_rate_sets = int(topo.labels[[n for n in range(nnode)
                                       if n != topo.root]].max()) + 1
    else:
        n_rate_sets = 1
    nrate = nr1 * n_rate_sets
    rate_set = np.zeros(nnode, dtype=np.int64)
    if n_rate_sets == nb:
        rate_set[branch_nodes] = np.arange(nb)
    elif n_rate_sets > 1:
        rate_set = np.clip(topo.labels.astype(np.int64), 0,
                           n_rate_sets - 1)
    pi_set_t = torch.as_tensor(pi_set, device=device)
    rate_set_t = torch.as_tensor(rate_set, device=device)
    obs = np.asarray(data.base_freqs)
    obs_t = torch.as_tensor(obs, dtype=dtype, device=device)

    def unpack(x):
        t = x[:nb]
        rates = (x[nb:nb + nrate].reshape(n_rate_sets, nr1) if nrate
                 else x.new_full((1, max(nr1, 1)), spec.kappa))
        k = nb + nrate
        pis = (_decode_rows(x[k:k + 3 * n_pi].reshape(n_pi, 3)) if n_pi
               else obs_t.to(x.device)[None, :])
        return t, rates, pis

    def branch_P(x, twice=False):
        t, rates, pis = unpack(x)
        tfull = x.new_zeros(nnode).index_put((bn,), t)
        pi_b = pis[pi_set_t] if n_pi else pis[0].expand(nnode, 4)
        # with no free rates the one row serves every branch (the JAX
        # package's clamped index)
        r_b = rates[rate_set_t] if nrate else rates[0].expand(nnode, -1)
        if model in nuc.TN93_FAMILY:
            kap = r_b if nr1 else x.new_full((nnode, 1), spec.kappa)
            a1, a2, b = tn93_alphas(model, pi_b, kap)
            P = pmat_tn93(pi_b, a1, a2, b, tfull)
        else:
            Q = nuc.build_rev_Q(r_b, pi_b)
            pmat = pmat_rev_multi_twice if twice else pmat_rev_multi
            P = pmat(Q, pi_b, tfull)
        pi_root = pis[root_set] if n_pi else obs_t.to(x.device)
        return P[:, None], pi_root[None, :]

    def neg_lnl(x):
        P, piC = branch_P(x.to(dtype))
        return -pruning.lnL(P, tips, topo, piC, P.new_ones(1), fpatt)

    neg_lnl.tips, neg_lnl.fpatt, neg_lnl.topo = tips, fpatt, topo

    t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
    if not (t0 > 0).any():
        t0 = np.full(nb, 0.1)
    x0 = list(np.maximum(t0, BLEN_MIN * 2))
    bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    r1 = ([spec.kappa] + [1.0] * (nr1 - 1)) if nr1 else []
    x0 += r1 * n_rate_sets
    bounds += [(RATE_MIN, RATE_MAX)] * nrate
    if n_pi:
        # each pi set starts from the observed frequencies of the tips it
        # governs (the reference seeds nhomo pis from per-sequence counts,
        # src/baseml.c:1237-1247); sets without tips from the global ones
        tipf = np.asarray(data.tip_partials, float)          # [ns, H, 4]
        fw = np.asarray(data.fpatt, float)[None, :, None]
        per_tip = (tipf / np.maximum(tipf.sum(2, keepdims=True), 1e-9)
                   * fw).sum(1)
        per_tip /= np.maximum(per_tip.sum(1, keepdims=True), 1e-9)
        for k in range(n_pi):
            members = [n for n in range(topo.ns) if pi_set[n] == k]
            pk = per_tip[members].mean(0) if members else obs
            x0 += list(np.log(np.maximum(pk[:3], 1e-8) / max(pk[3], 1e-8)))
        bounds += [(-19.0, 9.0)] * (3 * n_pi)
    return neg_lnl, unpack, np.array(x0), bounds


def _gamma_quadrature():
    """basemlg's continuous gamma as a composite Gauss-Legendre rule on the
    gamma-CDF scale: 9 panels, denser in the heavy right tail (reproduces
    the reference basemlg's analytic integration to ~1e-6 lnL).  Returns
    (u [144], w [144])."""
    bks = [0, .1, .3, .6, .85, .96, .995, .9995, 1 - 2e-5, 1]
    un, wn = np.polynomial.legendre.leggauss(16)
    us, ws = [], []
    for a, b in zip(bks[:-1], bks[1:]):
        us.append((un + 1) / 2 * (b - a) + a)
        ws.append(wn / 2 * (b - a))
    return np.clip(np.concatenate(us), 1e-12, 1 - 1e-12), np.concatenate(ws)


def make_objective(data: seqio.PackedData, topo: Topology, spec: BasemlSpec,
                   *, device, dtype=torch.float64):
    """(neg_lnl, unpack, x0, bounds) as in the JAX package; neg_lnl maps a
    1-D float64 tensor x on `device` to -lnL.  The parameter layout
    mirrors the reference (GetInitials, src/baseml.c:1149): [branch
    lengths or clock times | rgene (ngene - 1) | rate parameters |
    alpha(s) | free rates ... | rho].

    neg_lnl carries `twice(x, patterns)`, and with one gene and no rate
    HMM `model_at(x)` -> (P, piC, class weights, class rates),
    `site_loglik(x)` [H] and `class_posterior(x)` -> (posteriors [C, H],
    rates, weights)."""
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    clock = spec.clock
    n_rate_cls = 0
    if clock >= 1:
        # rooted tree; root age and node proportions, absolute ages with
        # TipDate or '@' fossils (reference: SetBranch, src/treesub.c:3770;
        # SetAge / GetAgeLow :3713-3766; GetBranchRate :3682)
        tip_ages = (treeio.parse_tip_dates(data.names,
                                           spec.tipdate_timeunit)[0]
                    if spec.tipdate else None)
        clock_fn, n_time, _, _, cinfo = make_clock_times(topo, clock,
                                                         tip_ages)
        absrate, agelow = cinfo["absrate"], cinfo["agelow"]
        free_int, root_fossil = cinfo["free_int"], cinfo["root_fossil"]
        labels = topo.labels
        n_rate_cls = int(labels.max()) if clock in (2, 3) else 0
    G = data.ngene if spec.Mgene != 1 else 1
    per_gene_rates = spec.Mgene >= 3 and G > 1
    per_gene_pi = spec.Mgene in (2, 4) and G > 1
    nr1 = _n_rate_params(spec)
    nrate = nr1 * (G if per_gene_rates else 1)
    nrgene = G - 1
    est_alpha = ((spec.ncatG > 1) or spec.continuous_gamma) \
        and not spec.fix_alpha
    nparK = spec.nparK
    if nparK >= 1:
        # the rate-class HMM never uses alpha and rho; the reference
        # coerces them fixed (src/baseml.c:1077)
        est_alpha = False
        spec = dataclasses.replace(spec, fix_alpha=True, fix_rho=True,
                                   rho=0.0)
    nalpha = (G if (est_alpha and spec.Malpha) else (1 if est_alpha else 0))
    adg = (not spec.fix_rho) or spec.rho > 0
    if (adg or nparK) and G > 1:
        raise ValueError("AdG/nparK rate models need a single gene")
    est_rho = adg and not spec.fix_rho

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pi_g = [tensor(nuc.model_pi(spec.model, data.gene_freqs[g]
                                if per_gene_pi else data.base_freqs))
            for g in range(G)]
    gene_slices = [data.gene_slice(g) for g in range(G)]
    tips_all = _nuc_tips(data.tip_partials, device, dtype)
    tips_g = [tips_all[:, sl] for sl in gene_slices]
    fpatt_all = tensor(data.fpatt)
    fpatt_g = [fpatt_all[sl] for sl in gene_slices]
    fixed_kappa = tensor([spec.kappa])
    step = spec.step_matrix
    if spec.continuous_gamma:
        cg_u, cg_w = (tensor(v) for v in _gamma_quadrature())
    model = spec.model
    K = spec.ncatG
    use_median = spec.use_median
    nnode = topo.nnode
    bn = torch.as_tensor(branch_nodes, dtype=torch.long, device=device)
    site_pattern = torch.as_tensor(np.asarray(data.site_pattern),
                                   dtype=torch.long, device=device)

    def branch_lengths(x):
        """(tfull [nnode]: the branch length above each node, the number
        of parameters used)."""
        if clock == 0:
            return x.new_zeros(nnode).index_put((bn,), x[:nb]), nb
        return clock_fn(x), n_time

    def unpack_k(x):
        tfull, k = branch_lengths(x)
        k_used = k
        if clock == 3 and n_rate_cls:
            k += G * n_rate_cls
        rgene = torch.cat([x.new_ones(1), x[k:k + nrgene]])
        k += nrgene
        rates = x[k:k + nrate] if nrate else fixed_kappa.to(x.device)
        k += nrate
        alpha = x[k:k + nalpha] if nalpha else x.new_full((1,), spec.alpha)
        return tfull, k_used, rgene, rates, alpha

    def unpack(x):
        tfull, _, rgene, rates, alpha = unpack_k(x)
        return tfull[bn], rgene, rates, alpha

    def class_rates(a_g):
        """(rates, weights) of the rate classes at shape a_g."""
        if spec.continuous_gamma:
            return gammaincinv(a_g, cg_u) / a_g, cg_w
        if K > 1:
            return discrete_gamma(a_g, K, use_median=use_median)
        return a_g.new_ones(1), a_g.new_ones(1)

    def neg_lnl(x, twice=False, patterns=slice(None)):
        """-lnL of the patterns in `patterns` (the fit's route, or with
        `twice` the route that is differentiable twice; the rate HMM ties
        the sites together and takes every pattern, which
        `neg_lnl.pattern_chunks` says)."""
        x = x.to(dtype)
        tfull, k_used, rgene, rates, alpha = unpack_k(x)
        if adg or nparK:
            return neg_ratehmm(x, tfull, rates, alpha, twice)
        lnf = pruning.class_site_lnf_twice if twice else \
            pruning.class_site_lnf
        if clock == 3 and n_rate_cls:
            # combined analysis (Yang & Yoder 2003): per-gene rates of the
            # labelled branch classes (reference: GetBranchRate,
            # src/treesub.c:3705-3707); class 0 folds into rgene
            cls = x[k_used:k_used + G * n_rate_cls].reshape(G, n_rate_cls)
            lab = torch.as_tensor(labels.astype(np.int64), device=x.device)
        p0 = patterns.start or 0
        p1 = data.npatt if patterns.stop is None else patterns.stop
        total = x.new_zeros(())
        for g in range(G):
            lo = max(gene_slices[g].start, p0) - gene_slices[g].start
            hi = min(gene_slices[g].stop, p1) - gene_slices[g].start
            if hi <= lo:
                continue
            a_g = alpha[g if nalpha == G and G > 1 else 0]
            r, w = class_rates(a_g)
            rates_g = (rates[g * nr1:(g + 1) * nr1] if per_gene_rates
                       else rates)
            tg = tfull
            if clock == 3 and n_rate_cls:
                tg = tfull * torch.cat([x.new_ones(1), cls[g]])[lab]
            ts = tg[:, None] * (r[None, :] * rgene[g])
            P, pi_root = nuc.pmats_for_model(model, rates_g, pi_g[g], ts,
                                             step, twice)
            piC = pi_root.expand(r.shape[0], 4)
            total = total + pruning.lnL(P, tips_g[g][:, lo:hi], topo, piC,
                                        w, fpatt_g[g][lo:hi], lnf=lnf)
        return -total

    def neg_ratehmm(x, tfull, rates, alpha, twice):
        """The AdG rate HMM over sites, or the nparK free-rate models: 1
        rK, 2 rK + fK, 3 rK + MK (doubly stochastic), 4 rK + MK with free
        rows (reference: lfunAdG, src/treesub.c:7447; the nparK arms of
        SetParameters, src/baseml.c:1392-1424)."""
        n_mk = ((K - 1) * (K - 1) if nparK == 3
                else K * (K - 1) if nparK == 4 else 0)
        n_npark = ((K - 1) + (K - 1 if nparK == 2 else 0) + n_mk
                   if nparK else 0)
        k = x.shape[0] - (1 if est_rho else 0) - (1 if est_alpha else 0) \
            - n_npark
        M = None
        if nparK:
            rfree = x[k:k + K - 1]
            kk = k + K - 1
            if nparK == 2:
                w = simplex_decode(x[kk:kk + K - 1])
            elif nparK >= 3:
                nrow = K - 1 if nparK == 3 else K
                rows = _decode_rows(x[kk:kk + nrow * (K - 1)].reshape(
                    nrow, K - 1))
                if nparK == 3:
                    # doubly stochastic: the last row is 1 - column sums
                    M = torch.cat([rows, (1.0 - rows.sum(0))[None, :]])
                    w = x.new_full((K,), 1.0 / K)
                else:
                    M = rows
                    # its stationary distribution (reference: PtoPi)
                    eye = torch.eye(K, dtype=x.dtype, device=x.device)
                    A = torch.cat([(M.T - eye)[:K - 1], x.new_ones((1, K))])
                    bvec = x.new_zeros(K)
                    bvec[K - 1] = 1.0
                    w = torch.linalg.solve(A, bvec)
            else:
                w = x.new_full((K,), 1.0 / K)
            rlast = (1.0 - (w[:K - 1] * rfree).sum()) / w[K - 1]
            r = torch.cat([rfree, torch.clamp_min(rlast, 1e-6)[None]])
        else:
            rho_v = x[-1] if est_rho else x.new_tensor(spec.rho)
            r, w, M = autod_gamma(alpha[0], rho_v, K)
        ts = tfull[:, None] * r[None, :]
        P, pi_root = nuc.pmats_for_model(model, rates, pi_g[0], ts, step,
                                         twice)
        piC = pi_root.expand(K, 4)
        lnf_fn = pruning.class_site_lnf_twice if twice else \
            pruning.class_site_lnf
        lnf = lnf_fn(P, tips_g[0], topo, piC)                # [K, H]
        if nparK in (1, 2):
            # independent rate classes (reference plfun = lfundG)
            site_ln = torch.logsumexp(lnf + torch.log(w)[:, None], dim=0)
            return -(fpatt_g[0] * site_ln).sum()
        return -hmm_lnL(lnf[:, site_pattern], M, w)

    neg_lnl.twice = lambda x, patterns=slice(None): neg_lnl(x, True, patterns)
    neg_lnl.tips, neg_lnl.fpatt, neg_lnl.topo = tips_all, fpatt_all, topo
    neg_lnl.n_states = 4
    neg_lnl.pattern_chunks = not (adg or nparK)
    neg_lnl.n_classes = lambda x: (
        K if (adg or nparK) else
        cg_u.shape[0] if spec.continuous_gamma else max(K, 1))

    # initial values
    if clock >= 1:
        root0 = (agelow[topo.root] * 1.5 + 0.2) if absrate else 0.2
        x0 = ([] if root_fossil else [root0]) \
            + [0.6 + 0.3 * (i % 2) * 0.2 for i in range(len(free_int))]
        bounds = ([] if root_fossil else
                  [(agelow[topo.root] + 1e-6 if absrate else 1e-5,
                    max(50.0, agelow[topo.root] * 10))]) \
            + [(1e-6, 1 - 1e-6)] * len(free_int)
        if absrate:
            x0.append(0.1)                      # rate00 per time unit
            bounds.append((1e-5, 99.0))
        if clock == 2 and n_rate_cls:
            x0 += [1.0] * n_rate_cls
            bounds += [(1e-4, 99.0)] * n_rate_cls
        if clock == 3 and n_rate_cls:
            x0 += [1.0] * (G * n_rate_cls)
            bounds += [(1e-4, 99.0)] * (G * n_rate_cls)
    else:
        t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
        if not (t0 > 0).any():
            t0 = np.full(nb, 0.1)
        t0 = np.maximum(t0, BLEN_MIN * 2)
        x0 = list(t0)
        bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    x0 += [1.0] * nrgene
    bounds += [(RGENE_MIN, RGENE_MAX)] * nrgene
    r1 = {"TN93": [spec.kappa, spec.kappa]}.get(model)
    if r1 is None:
        if model in ("REV",):
            r1 = [spec.kappa] + [1.0] * 4
        elif model in ("REVu", "UNRESTu", "UNREST"):
            r1 = [1.0] * nr1
        else:
            r1 = [spec.kappa] * nr1
    x0 += r1 * (G if per_gene_rates else 1)
    bounds += [(RATE_MIN, RATE_MAX)] * nrate
    x0 += [spec.alpha if spec.alpha > 0 else 0.5] * nalpha
    bounds += [(ALPHA_MIN, ALPHA_MAX)] * nalpha
    if nparK:
        x0 += list(np.linspace(0.3, 1.5, K - 1))
        bounds += [(RATE_MIN, RATE_MAX)] * (K - 1)
        if nparK == 2:
            x0 += [0.0] * (K - 1)
            bounds += [(-19.0, 9.0)] * (K - 1)
        elif nparK in (3, 4):
            nrow = K - 1 if nparK == 3 else K
            x0 += [0.0] * (nrow * (K - 1))
            bounds += [(-19.0, 9.0)] * (nrow * (K - 1))
    if est_rho:
        x0.append(spec.rho if spec.rho > 0 else 0.3)
        bounds.append((-0.2, 0.99))
    if G == 1 and not (adg or nparK):

        def model_at(x):
            """(P, piC, class weights, class rates) at x (one gene)."""
            x = torch.as_tensor(x, device=device).to(dtype)
            tfull, _, _, rates, alpha = unpack_k(x)
            r, w = class_rates(alpha[0])
            P, pi_root = nuc.pmats_for_model(
                model, rates, pi_g[0], tfull[:, None] * r[None, :], step)
            return P, pi_root.expand(r.shape[0], 4), w, r

        def site_loglik(x):
            P, piC, w, _ = model_at(x)
            return pruning.site_loglik(P, tips_g[0], topo, piC, w)

        def class_posterior(x):
            P, piC, w, r = model_at(x)
            return (pruning.site_class_posterior(P, tips_g[0], topo, piC, w),
                    r, w)

        neg_lnl.model_at = model_at
        neg_lnl.site_loglik = site_loglik
        neg_lnl.class_posterior = class_posterior
    return neg_lnl, unpack, np.array(x0), bounds


def rho_rate(data: seqio.PackedData, topo: Topology, spec: BasemlSpec, x,
             *, device) -> dict:
    """Continuous-gamma rate factors per site pattern and the rate
    'correlation' diagnostics (reference: RhoRate, src/basemlg.c:451, Yang
    and Wang): posterior-mean rates per pattern and the variance
    decomposition (Vr, Vr0, PEV, RHO); the 'accurate' variant enumerates
    all 4^ns patterns when ns < 8, else uses the observed patterns with
    the model's weights."""
    spec_cg = dataclasses.replace(spec, continuous_gamma=True)
    neg, unpack, _, _ = make_objective(data, topo, spec_cg, device=device)
    xt = torch.as_tensor(np.asarray(x, float), device=device)
    with torch.no_grad():
        alpha = float(unpack(xt)[3].reshape(-1)[0])
        post, r, w = neg.class_posterior(xt)
        post, r = post.cpu().numpy(), r.cpu().numpy()
        lnf = neg.site_loglik(xt).cpu().numpy()
    rh = (r[:, None] * post).sum(0)                      # [H] E[r | pattern]
    fobs = np.asarray(data.fpatt, float)
    ls = fobs.sum()
    mrh0 = float((rh * fobs).sum() / ls)
    vrh0 = float((rh ** 2 * fobs).sum() / ls) - mrh0 ** 2
    ns = data.ns
    if ns < 8:
        # accurate: enumerate all 4^ns patterns
        H = 4 ** ns
        states = np.indices((4,) * ns).reshape(ns, H)
        with torch.no_grad():
            P, piC, wq, rq = neg.model_at(xt)
            lnf_all = pruning.class_site_lnf(
                P, torch.as_tensor(states.astype(np.int32), device=device),
                topo, piC).cpu().numpy()
        wlog = lnf_all + np.log(wq.cpu().numpy())[:, None]
        m = wlog.max(0)
        fh = np.exp(m) * np.exp(wlog - m).sum(0)         # [H]
        posth = np.exp(wlog - m) / np.exp(wlog - m).sum(0)
        rh_all = (rq.cpu().numpy()[:, None] * posth).sum(0)
        vr = float((fh * rh_all ** 2).sum()) - 1.0
    else:
        fh = np.exp(lnf)
        vr = float((fh * rh ** 2).sum()) - 1.0
    return dict(rates=rh, lnf=lnf, alpha=alpha,
                Vr=vr, Vr0=vrh0, mrh0=mrh0,
                PEV=1.0 / alpha - vr, PEV0=1.0 / alpha - vrh0,
                RHO=math.sqrt(max(vr, 0.0) * alpha),
                RHO0=math.sqrt(max(vrh0, 0.0) * alpha))


def fit(seqfile: str, treefile: str, spec: BasemlSpec | None = None, *,
        device, tree_index: int = 0) -> BasemlResult:
    """Read a nucleotide alignment and a tree file, then `fit_packed`."""
    spec = spec or BasemlSpec()
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata)
    trees = treeio.read_trees(treefile, data.names)
    topo = from_treenode(trees[tree_index], data.names)
    return fit_packed(data, topo, spec, device=device)


def npark_starts(spec: BasemlSpec, x0: np.ndarray):
    """The extra starts of a free-rate fit (nparK): these mixtures and
    rate HMMs are multimodal in the order of the rates and (nparK >= 3)
    in the transition structure."""
    K = spec.ncatG
    n_extra = {0: 0, 1: 0, 2: K - 1, 3: (K - 1) * (K - 1),
               4: K * (K - 1)}[spec.nparK]
    off = len(x0) - (K - 1) - n_extra
    multi = []
    for rr in (np.linspace(0.05, 0.8, K - 1), np.linspace(0.8, 3.0, K - 1),
               np.full(K - 1, 1.0), np.linspace(0.05, 3.0, K - 1)):
        s = x0.copy()
        s[off:off + K - 1] = rr
        multi.append(s)
    if spec.nparK >= 3:
        # a sticky diagonal: strong rate persistence
        nrow = K - 1 if spec.nparK == 3 else K
        for rr in (np.linspace(0.05, 3.0, K - 1),
                   np.linspace(0.8, 3.0, K - 1)):
            s = x0.copy()
            s[off:off + K - 1] = rr
            mk0 = off + K - 1
            for i in range(nrow):
                if i < K - 1:
                    s[mk0 + i * (K - 1) + i] = 2.5
            multi.append(s)
    return multi


def fit_packed(data: seqio.PackedData, topo: Topology, spec: BasemlSpec, *,
               device, objective=None) -> BasemlResult:
    """Fit a nucleotide model in float64 on `device` (scipy L-BFGS-B over
    the device's value + gradient), with the JAX package's multi-starts;
    SEs (getSE) by `codeml.standard_errors`.  `objective`: what
    `make_objective` returned for these arguments, where the caller goes
    on using it after the fit."""
    if spec.nhomo:
        return _fit_nhomo(data, topo, spec, device=device)
    neg_lnl, unpack, x0, bounds = objective or make_objective(
        data, topo, spec, device=device)
    multi = npark_starts(spec, x0) if spec.nparK else None
    res = maximize(neg_lnl, x0, bounds, device=device, multi_start=multi)
    with torch.no_grad():
        t, rgene, rates, alpha = (v.cpu().numpy() for v in unpack(
            torch.as_tensor(res.x, device=device)))
    ses = (codeml.standard_errors(neg_lnl, res.x, device=device)
           if spec.getSE else None)
    return BasemlResult(
        lnL=res.lnL, blens=t, branch_nodes=topo.branch_nodes(),
        rate_params=rates, rgene=rgene,
        alpha=alpha if (spec.ncatG > 1 or spec.continuous_gamma) else None,
        pi=nuc.model_pi(spec.model, data.base_freqs), np=len(res.x),
        topo=topo, SEs=ses, fit=res, x=np.asarray(res.x))


def fit_separate(seqfile: str, treefile: str, spec: BasemlSpec, *,
                 device) -> list[BasemlResult]:
    """Mgene = 1: an independent analysis per gene (reference:
    MultipleGenes, src/treesub.c:5170)."""
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    results = []
    for g in range(aln.ngene):
        sel = np.where(aln.site_gene == g)[0]
        sub = seqio.Alignment(aln.names, ["".join(r[i] for i in sel)
                                          for r in aln.rows], aln.seqtype)
        data = seqio.pack(sub, cleandata=spec.cleandata)
        trees = treeio.read_trees(treefile, data.names)
        topo = from_treenode(trees[0], data.names)
        results.append(fit_packed(data, topo,
                                  dataclasses.replace(spec, Mgene=0),
                                  device=device))
    return results


def nhomo_starts(data: seqio.PackedData, topo: Topology, x0: np.ndarray):
    """The extra starts of a nonhomogeneous fit on a small problem: its
    surface is multimodal (per-branch pis trade against per-branch rates,
    with optima at simplex boundaries), and two structured starts guard
    the basin; None on a large problem."""
    nb = len(topo.branch_nodes())
    if data.npatt * nb >= 20_000:
        return None
    multi = []
    rng = np.random.default_rng(0)
    for scale in (0.75, 1.5):
        s = x0.copy()
        s[:nb] = np.maximum(s[:nb] * scale, BLEN_MIN * 2)
        s[nb:] += rng.normal(0, 0.4, len(s) - nb)
        multi.append(s)
    return multi


def _fit_nhomo(data, topo, spec, *, device):
    neg_lnl, unpack, x0, bounds = make_nhomo_objective(data, topo, spec,
                                                       device=device)
    res = maximize(neg_lnl, x0, bounds, device=device,
                   multi_start=nhomo_starts(data, topo, x0))
    with torch.no_grad():
        t, rates, pis = (v.cpu().numpy() for v in unpack(
            torch.as_tensor(res.x, device=device)))
    return BasemlResult(
        lnL=res.lnL, blens=t, branch_nodes=topo.branch_nodes(),
        rate_params=rates, rgene=np.ones(1), alpha=None, pi=pis,
        np=len(res.x), topo=topo, SEs=None, fit=res, x=np.asarray(res.x))
