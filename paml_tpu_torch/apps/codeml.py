"""codeml: maximum likelihood for codon alignments (site, branch and
branch-site models).

Port of the codon slice of `paml_tpu/apps/codeml.py`: one omega per site
class and branch type, class frequencies, and mixture normalization through
the two flux scalars per branch type (reference: Qfactor_NS,
src/codeml.c:2580-2663); the site classes ride the class axis of the
pruning engine (reference: fhK / lfundG, src/treesub.c:7608-7760), and each
branch takes the P(t) of its type.

Covered: seqtype 1; model 0 with NSsites 0-13 and 22 (M0, M1a, M2a, M3,
M4, M5-M13 whose omegas are quantiles of a distribution, M2a_rel); model 1
(free ratios) and model 2 (branch labels #i) with NSsites 0; model 2 with
NSsites 2 and 3 (branch-site models A and B); model 3 with NSsites 2 and 3
(clade models C and D); CodonFreq Fequal, F1x4, F3x4, F61 (`Fcodon`),
F1x4MG, F3x4MG and the mutation-selection models FMutSel0 and FMutSel
(with estFreq: a staged fit), with hkyREV; fix_blength 0, 1 and 2; clocks
1-3 and TipDate; standard errors (`standard_errors`); the pattern axis in
chunks (`n_chunks`).  Amino-acid data, aaDist and Mgene raise
NotImplementedError naming their ROADMAP item.

The parameter vector keeps the JAX package's layout (`unpack`), so the same
x means the same model in both packages.  Fits run in float64 on the
device the caller names.

An objective has two routes.  `neg_lnl(x)` is the fit's: P(t) from the
eigendecomposition with its hand-written backward, pruning through
`pruning.class_site_lnf` (the CUDA kernels on the card), differentiable
once.  `neg_lnl.twice(x)` is the Hessian's: P(t) from
`pmat.pmat_rev_multi_twice` and the level pass under plain autograd
(`pruning.class_site_lnf_twice`), differentiable twice; on the card its
calls are counted apart (`pruning.TWICE_CALLS`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from dataclasses import replace as _dc_replace

import numpy as np
import torch

from ..core import cuda_pruning, dgamma, pruning, tipcodes
from ..core.clockparam import make_clock_times
from ..core.optim import FitResult, maximize, simplex_decode
from ..core.pmat import pmat_rev_multi, pmat_rev_multi_twice
from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from ..models import codon as codonmod

# reference bounds (SetxBound, src/codeml.c:1583 region)
BLEN_MIN, BLEN_MAX = 4e-6, 50.0
KAPPA_MIN, KAPPA_MAX = 1e-4, 999.0
OMEGA_MIN, OMEGA_MAX = 1e-4, 999.0     # M0 omega (rateb)
W_MIN, W_MAX = 1e-6, 999.0             # NSsites omegas
P_MIN, P_MAX = 1e-5, 0.99999           # raw proportions
PQ_MIN, PQ_MAX = 0.005, 99.0           # beta p, q
TRANS_MIN, TRANS_MAX = -99.0, 99.0     # transformed proportions

NSSITES_NONE, M1A, M2A, M3, M4, M5, M7, M8 = 0, 1, 2, 3, 4, 5, 7, 8
M6, M9, M10, M11, M12, M13 = 6, 9, 10, 11, 12, 13
M2A_REL = 22

CODON_FREQS = ("Fequal", "F1x4", "F3x4", "Fcodon", "F1x4MG", "F3x4MG",
               "FMutSel0", "FMutSel")

# seconds spent in the Hessian route (`standard_errors`) since import
SECONDS = {"hessian": 0.0}


@dataclass
class CodemlSpec:
    """The JAX package's `CodemlSpec`, field for field."""
    seqtype: int = 1             # 1 codon, 2 aa
    model: int = 0               # 0 one-ratio; 1 free-ratio; 2 branch labels
    NSsites: int = 0
    codonf: str = "F3x4"         # Fequal F1x4 F3x4 Fcodon (F61) F1x4MG F3x4MG
    icode: int = 0
    ncatG: int = 3               # classes for M3; beta categories for M7/M8
    fix_kappa: bool = False
    kappa: float = 2.0
    fix_omega: bool = False
    omega: float = 0.4
    Mgene: int = 0
    clock: int = 0               # 0 none; 1 global; 2 local (#i labels);
                                 # '@' fossil ages give absolute rates
    fix_blength: int = 0         # 0 ignore tree lengths; 1 initials; 2 fixed
    aaDist: int = 0
    omegaAA: str | None = None
    fix_alpha: bool = True
    alpha: float = 0.0
    cleandata: bool = False
    hkyREV: bool = False
    estFreq: bool = False        # ML-estimate frequency/fitness params
    getSE: bool = False
    aa_model: str = "Empirical_F"
    aa_rate_file: str | None = None
    tipdate: bool = False        # dated tips (names end in _YYYY): clock
    tipdate_timeunit: float | None = None   # with absolute ages + rate


@dataclass
class CodemlResult:
    lnL: float
    np: int
    blens: np.ndarray
    branch_nodes: np.ndarray
    kappa: np.ndarray
    params: dict
    pi: np.ndarray
    topo: Topology = None
    fit: FitResult = None
    x: np.ndarray = None
    spec: CodemlSpec = None
    site_class_post: np.ndarray | None = None
    class_omegas: np.ndarray | None = None
    class_freqs: np.ndarray | None = None


def _codonf(spec: CodemlSpec) -> str:
    return "Fcodon" if spec.codonf == "F61" else spec.codonf


def check_slice(spec: CodemlSpec, data: seqio.PackedData | None = None):
    """Raise NotImplementedError, naming its ROADMAP item, for a setting
    this package does not cover yet."""
    if spec.seqtype != 1 or spec.aaDist or (data is not None
                                            and data.ngene > 1):
        raise NotImplementedError(
            "paml_tpu_torch does not cover amino-acid data, aaDist and "
            "Mgene: ROADMAP A9")
    if _codonf(spec) not in CODON_FREQS:
        raise ValueError(f"unknown codonf {spec.codonf}")


def _n_btypes(topo: Topology, model: int) -> int:
    if model == 0:
        return 1
    if model == 1:
        return topo.nnode - 1          # free ratios: one per branch
    return int(topo.labels.max()) + 1


# --- NSsites class builders ------------------------------------------------

def _medians(K: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(K, dtype=like.dtype, device=like.device) + 0.5) / K


def beta_median_quantiles(p, q, K: int):
    """Raw median quantiles of beta(p, q) over K classes, with no mean
    rescaling (reference: DiscreteNSsites, src/codeml.c:2860-2871)."""
    return dgamma.betaincinv(p, q, _medians(K, p))


def gamma_median_quantiles(alpha, beta, K: int):
    return dgamma.gammaincinv(alpha, _medians(K, alpha)) / beta


def cdf_quantiles(cdf, K: int, lo=1e-7, hi=99.0, iters=70,
                  second_order: bool = False):
    """Median quantiles of an arbitrary omega distribution: a bisection on
    plain numbers, then two Newton steps that carry the parameters'
    gradients (reference: Quantile(CDFdN_dS) in DiscreteNSsites,
    src/codeml.c:2873-2877).  `cdf` maps omegas, a numpy array or a CPU
    tensor, to CDF values; on a tensor it may depend on parameters in its
    closure.  With `second_order` (the Hessian route) the Newton steps'
    pdf keeps its graph; otherwise it is a constant, which leaves the
    first derivative at the root exact."""
    p = (np.arange(K) + 0.5) / K
    l, h = np.full(K, lo), np.full(K, hi)
    for _ in range(iters):
        m = (l + h) / 2
        below = cdf(m) < p
        l, h = np.where(below, m, l), np.where(below, h, m)
    x = torch.as_tensor((l + h) / 2, dtype=torch.float64)
    pt = torch.as_tensor(p, dtype=torch.float64)
    for _ in range(2):
        with torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_(True)
            c = cdf(xg)
            (pdf,) = torch.autograd.grad(c.sum(), xg,
                                         create_graph=second_order,
                                         retain_graph=True)
        if xg is not x:
            # the pdf came from a leaf copy of x; the step's own CDF keeps
            # to the parameters' graph
            c = cdf(x)
        x = torch.clamp(x - (c - pt) / torch.clamp_min(pdf, 1e-12), lo, hi)
    return x


def _is_t(x):
    return isinstance(x, torch.Tensor)


def _cdf_beta(x, p, q):
    if _is_t(x):
        return dgamma.betainc(p, q, torch.clamp(x, 1e-12, 1.0 - 1e-12))
    from scipy.special import betainc
    return betainc(p, q, np.clip(x, 1e-12, 1.0 - 1e-12))


def _cdf_gamma(x, a, b):
    if _is_t(x):
        return dgamma.gammainc(a, b * torch.clamp_min(x, 0.0))
    from scipy.special import gammainc
    return gammainc(a, b * np.maximum(x, 0.0))


def _ndtr(x):
    if _is_t(x):
        return torch.special.ndtr(x)
    from scipy.special import ndtr
    return ndtr(x)


def nssites_mixture_cdf(NSsites: int, theta):
    """CDF of the continuous part of the omega distribution for models
    M6/M9-M13 (reference: CDFdN_dS, src/codeml.c:2916-2983).  theta: a CPU
    tensor (the CDF then takes tensors and carries gradients) or a numpy
    array (plain numbers, for the bisection)."""
    t = _is_t(theta)
    where = torch.where if t else np.where
    exp = torch.exp if t else np.exp

    def floor(v, lo):
        return torch.clamp_min(v, lo) if t else np.maximum(v, lo)

    if NSsites == M6:          # 2gamma: p0, a1, b1, a2 (=b2)
        p0, a1, b1, a2 = theta[0], theta[1], theta[2], theta[3]
        return lambda x: (p0 * _cdf_gamma(x, a1, b1)
                          + (1 - p0) * _cdf_gamma(x, a2, a2))
    if NSsites == M9:          # beta&gamma: p0, p, q, a, b
        p0, p, q, a, b = (theta[i] for i in range(5))
        return lambda x: (p0 * _cdf_beta(x, p, q)
                          + (1 - p0) * _cdf_gamma(x, a, b))
    if NSsites == M10:         # beta&gamma+1
        p0, p, q, a, b = (theta[i] for i in range(5))
        return lambda x: where(
            x <= 1.0, p0 * _cdf_beta(x, p, q),
            p0 + (1 - p0) * _cdf_gamma(x - 1.0, a, b))
    if NSsites == M11:         # beta&normal>1: p0, p, q, mu, s
        p0, p, q, mu, s = (theta[i] for i in range(5))
        z1 = floor(_ndtr((mu - 1.0) / s), 1e-12)
        return lambda x: where(
            x <= 1.0, p0 * _cdf_beta(x, p, q),
            p0 + (1 - p0) * (1.0 - _ndtr((mu - x) / s) / z1))
    if NSsites == M12:         # 0&2normal (continuous part): p0,p1,mu2,s1,s2
        p1, mu2, s1, s2 = theta[1], theta[2], theta[3], theta[4]
        return lambda x: (1.0
                          - p1 * _ndtr(-(x - 1.0) / s1) / _ndtr(1.0 / s1)
                          - (1 - p1) * _ndtr(-(x - mu2) / s2)
                          / floor(_ndtr(mu2 / s2), 1e-12))
    if NSsites == M13:         # 3normal: t0, t1 (transformed), mu2,s0,s1,s2
        e0, e1 = exp(theta[0]), exp(theta[1])
        z = e0 + e1 + 1.0
        f0, f1 = e0 / z, e1 / z
        f2 = 1.0 - f0 - f1
        mu2, s0, s1, s2 = theta[2], theta[3], theta[4], theta[5]
        return lambda x: (1.0 - f0 * 2.0 * _ndtr(-x / s0)
                          - f1 * _ndtr(-(x - 1.0) / s1) / _ndtr(1.0 / s1)
                          - f2 * _ndtr(-(x - mu2) / s2)
                          / floor(_ndtr(mu2 / s2), 1e-12))
    raise ValueError(f"NSsites {NSsites}")


def _mixture_quantiles(NSsites: int, theta: torch.Tensor, K: int,
                       second_order: bool = False):
    """K median quantiles of M6/M9-M13's continuous part, on theta's
    device; computed on the host (K numbers)."""
    th = theta.to("cpu")
    cdf_t = nssites_mixture_cdf(NSsites, th)
    cdf_n = nssites_mixture_cdf(NSsites, th.detach().numpy())

    def cdf(x):
        return cdf_t(x) if _is_t(x) else cdf_n(x)
    return cdf_quantiles(cdf, K, second_order=second_order).to(theta.device)


def nssites_nparams(NSsites: int, ncatG: int, fix_omega: bool) -> int:
    """Number of distribution parameters after kappa."""
    if NSsites == M1A:
        return 2                       # p0, w0
    if NSsites in (M2A, M2A_REL):
        return 3 + (0 if fix_omega else 1)   # p0, p1 (transformed), w0, [w2]
    if NSsites == M3:
        return (ncatG - 1) + ncatG
    if NSsites == M4:
        return ncatG - 1               # freqs model: fixed omegas
    if NSsites == M5:
        return 2                       # alpha, beta
    if NSsites == M7:
        return 2                       # p, q
    if NSsites == M8:
        return 3 + (0 if fix_omega else 1)   # p0, p, q, [ws]
    if NSsites == M6:
        return 4                       # p0, a1, b1, a2
    if NSsites in (M9, M10, M11, M12):
        return 5
    if NSsites == M13:
        return 6
    raise ValueError(f"NSsites {NSsites} not supported")


def nssites_classes(NSsites: int, theta: torch.Tensor, ncatG: int,
                    fix_omega: bool, omega_fix: float,
                    second_order: bool = False):
    """(omegas [K], freqs [K]) from the distribution parameter vector;
    `second_order` as in `cdf_quantiles`."""
    one = theta.new_ones(())

    def equal(K):
        return theta.new_full((K,), 1.0 / K)

    if NSsites == M1A:
        p0, w0 = theta[0], theta[1]
        return torch.stack([w0, one]), torch.stack([p0, 1.0 - p0])
    if NSsites in (M2A, M2A_REL):
        p = simplex_decode(theta[:2])
        w2 = theta.new_tensor(omega_fix) if fix_omega else theta[3]
        return torch.stack([theta[2], one, w2]), p
    if NSsites == M3:
        p = simplex_decode(theta[:ncatG - 1])
        return theta[ncatG - 1:ncatG - 1 + ncatG], p
    if NSsites == M4:
        p = simplex_decode(theta[:ncatG - 1])
        return theta.new_tensor([0.0, 1 / 3, 2 / 3, 1.0, 3.0]), p
    if NSsites == M5:
        return (gamma_median_quantiles(theta[0], theta[1], ncatG),
                equal(ncatG))
    if NSsites == M7:
        return (beta_median_quantiles(theta[0], theta[1], ncatG),
                equal(ncatG))
    if NSsites == M8:
        p0 = theta[0]
        w = beta_median_quantiles(theta[1], theta[2], ncatG)
        ws = theta.new_tensor(omega_fix) if fix_omega else theta[3]
        return (torch.cat([w, ws[None]]),
                torch.cat([equal(ncatG) * p0, (1.0 - p0)[None]]))
    if NSsites in (M6, M9, M10, M11, M13):
        return (_mixture_quantiles(NSsites, theta, ncatG, second_order),
                equal(ncatG))
    if NSsites == M12:
        # spike at 0 (freq p0) + ncatG-1 classes from the 2-normal mixture
        # (reference: DiscreteNSsites NS02normal shift, src/codeml.c:2888)
        p0 = theta[0]
        K = ncatG - 1
        wc = _mixture_quantiles(NSsites, theta, K, second_order)
        return (torch.cat([theta.new_zeros(1), wc]),
                torch.cat([p0[None], equal(K) * (1 - p0)]))
    raise ValueError(f"NSsites {NSsites}")


def nssites_x0_bounds(NSsites: int, ncatG: int, fix_omega: bool,
                      omega0: float):
    if NSsites == M1A:
        return [0.7, 0.2], [(P_MIN, P_MAX), (W_MIN, 1.0)]
    if NSsites in (M2A, M2A_REL):
        x0 = [1.0, 0.5, 0.2]
        b = [(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, 1.0)]
        if not fix_omega:
            x0.append(max(2.0, omega0))
            b.append((1.0 if NSsites == M2A else W_MIN, W_MAX))
        return x0, b
    if NSsites == M3:
        x0 = [0.0] * (ncatG - 1) + list(np.linspace(0.1, 1.2, ncatG))
        return x0, ([(TRANS_MIN, TRANS_MAX)] * (ncatG - 1)
                    + [(W_MIN, W_MAX)] * ncatG)
    if NSsites == M4:
        return [0.0] * (ncatG - 1), [(TRANS_MIN, TRANS_MAX)] * (ncatG - 1)
    if NSsites == M5:
        return [0.6, 1.0], [(0.02, 49.0)] * 2
    if NSsites == M7:
        return [0.5, 1.2], [(PQ_MIN, PQ_MAX)] * 2
    if NSsites == M8:
        x0 = [0.9, 0.5, 1.2]
        b = [(P_MIN, P_MAX), (PQ_MIN, PQ_MAX), (PQ_MIN, PQ_MAX)]
        if not fix_omega:
            x0.append(2.0)
            b.append((1.0, W_MAX))
        return x0, b
    # reference initials/bounds: GetInitialsNSsites/SetxBound,
    # src/codeml.c:2277-2313/:1980-2013
    if NSsites == M6:
        return ([0.5, 1.0, 1.1, 1.2],
                [(P_MIN, P_MAX)] + [(0.02, 49.0)] * 3)
    if NSsites == M9:
        return ([0.9, 0.4, 1.2, 1.1, 1.1],
                [(P_MIN, P_MAX)] + [(PQ_MIN, PQ_MAX)] * 4)
    if NSsites == M10:
        return ([0.9, 0.4, 1.2, 0.1, 1.1],
                [(P_MIN, P_MAX)] + [(PQ_MIN, PQ_MAX)] * 4)
    if NSsites == M11:
        return ([0.95, 0.4, 1.2, 1.1, 1.1],
                [(P_MIN, P_MAX)] + [(PQ_MIN, PQ_MAX)] * 2
                + [(1.0, 9.0), (PQ_MIN, PQ_MAX)])
    if NSsites == M12:
        return ([0.8, 0.3, 0.2, 5.0, 1.1],
                [(P_MIN, P_MAX)] * 2 + [(1e-4, 29.0)] * 3)
    if NSsites == M13:
        return ([0.77, 0.22, 0.2, 0.5, 5.0, 1.1],
                [(-49.0, 49.0)] * 2 + [(1e-4, 29.0)] * 4)
    raise ValueError(f"NSsites {NSsites}")


def nssites_extra_starts(NSsites: int, ncatG: int, fix_omega: bool):
    """Additional theta starting points for multimodal NSsites surfaces."""
    if NSsites == M3:
        outs = []
        for ws in ([0.01, 0.2, 0.9], [0.05, 0.5, 3.0], [0.3, 1.0, 5.0]):
            w = (list(np.linspace(ws[0], ws[-1], ncatG)) if ncatG != 3
                 else list(ws))
            outs.append([0.0] * (ncatG - 1) + w)
        return outs
    if NSsites in (M2A, M2A_REL):
        out = [[2.0, 0.3, 0.05], [0.0, -1.0, 0.5]]
        if not fix_omega:
            out = [o + [w2] for o, w2 in zip(out, [5.0, 1.5])]
        return out
    if NSsites == M8:
        out = [[0.99, 0.2, 1.0], [0.7, 1.0, 2.0]]
        if not fix_omega:
            out = [o + [w2] for o, w2 in zip(out, [3.0, 1.3])]
        return out
    return {
        M7: [[0.2, 0.8], [2.0, 2.0]],
        M1A: [[0.9, 0.05]],
        M5: [[1.1, 1.1]],
        M6: [[0.9, 0.5, 0.6, 2.0], [0.2, 2.0, 2.0, 0.5]],
        M9: [[0.5, 1.0, 2.0, 0.5, 0.5]],
        M10: [[0.5, 1.0, 2.0, 0.5, 1.0]],
        M11: [[0.7, 0.3, 1.5, 1.5, 0.5]],
        M12: [[0.3, 0.7, 1.5, 1.0, 0.5]],
        M13: [[0.0, 0.0, 1.5, 1.0, 1.0, 0.5]],
    }.get(NSsites, [])


# --- objective -------------------------------------------------------------

def _codon_tips(tip_partials: np.ndarray, device, dtype):
    """Tip data on the device: int32 state codes [ns, H] when the data are
    codes already or every tip cell is resolved (the tip product becomes a
    gather), else `TipCodes`: the codes and the table of the distinct
    ambiguous cells (gaps, codons with an N), built once here."""
    tips_np = np.asarray(tip_partials)
    if tips_np.ndim == 2:
        return torch.as_tensor(tips_np.astype(np.int32), device=device)
    tc = tipcodes.encode(tips_np)
    if tc.n_amb == 0:
        return tc.codes.to(device)
    return tc.to(device, dtype)


def _nkappa(spec: CodemlSpec) -> int:
    return 0 if spec.fix_kappa else (5 if spec.hkyREV else 1)


def make_codon_objective(data: seqio.PackedData, topo: Topology,
                         spec: CodemlSpec, *, device,
                         dtype=torch.float64, n_chunks: int = 1):
    """(neg_lnl, unpack, classes_for, x0, bounds, pi) as in the JAX package;
    neg_lnl maps a 1-D tensor x on `device` to -lnL.  With n_chunks > 1
    the patterns are evaluated in that many equal chunks
    (`pruning.lnL_chunked`), so memory holds one chunk's buffers.

    neg_lnl carries `model_at(x)`, `twice(x)` (the same value by the route
    that is differentiable twice), `site_loglik(x)` [H] and
    `class_posterior(x)` [K, H], its data (`tips`, `fpatt`, `topo`) and the
    data's frequencies (`pi_np`, `pf3x4`)."""
    check_slice(spec, data)
    device = torch.device(device)
    codonf = _codonf(spec)
    graph = codonmod.codon_graph(spec.icode)
    fcodon, f3x4, f1x4 = codonmod.count_codon_freqs(
        data.tip_partials, data.fpatt, graph, data.pos_masks)
    pi_np = codonmod.codon_pi(codonf, fcodon, f3x4, f1x4, graph)
    pf3x4 = codonmod.mg_pf3x4(codonf, f3x4, f1x4)
    pi = torch.as_tensor(pi_np, dtype=dtype, device=device)
    tips = _codon_tips(data.tip_partials, device, dtype)
    fpatt = torch.as_tensor(data.fpatt, dtype=dtype, device=device)
    # once here, not at every kernel launch (two host syncs)
    cuda_pruning.check_tips(tips, graph.n)
    if n_chunks > 1:
        tips_c, fpatt_c = pruning.split_patterns(tips, fpatt, n_chunks)

    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = torch.as_tensor(branch_nodes, dtype=torch.int64, device=device)
    nnode, n = topo.nnode, graph.n
    B = _n_btypes(topo, spec.model)
    NS, ncatG = spec.NSsites, spec.ncatG
    nkappa = _nkappa(spec)

    # clock >= 1: branch lengths come from node ages (reference: SetBranch
    # src/treesub.c:3770; '@' fossils give absolute rates)
    if spec.clock >= 1:
        tip_ages = None
        if spec.tipdate:
            # dated tips (reference: GetTipDate, src/treesub.c:3552): ages
            # from sequence-name suffixes; absolute-rate clock
            tip_ages = treeio.parse_tip_dates(data.names,
                                              spec.tipdate_timeunit)[0]
        clock_fn, n_time, xt0, tbounds, _ = make_clock_times(
            topo, spec.clock, tip_ages)
    elif spec.fix_blength == 2:
        n_time = 0               # branch lengths fixed at the tree's values
    else:
        n_time = nb

    # FMutSel/FMutSel0 frequency parameters (reference: com.npi,
    # src/codeml.c:1576-1588): 3 mutation-bias pi_TCA ratios, plus with
    # estFreq the fitness parameters (60 codon / 19 aa, last fixed at 0)
    is_fmutsel = codonf in ("FMutSel", "FMutSel0")
    nfit = 0
    if is_fmutsel and spec.estFreq:
        nfit = 19 if codonf == "FMutSel0" else n - 1
    npi = (3 + nfit) if is_fmutsel else 0
    if is_fmutsel:
        G = codonmod.pair_tables(spec.icode, device)
    else:
        T = codonmod.dense_tables(spec.icode, device, dtype)

    # branch type per node (root entry unused)
    if spec.model == 1:
        btype = np.zeros(nnode, dtype=np.int64)
        btype[branch_nodes] = np.arange(nb)
    else:
        btype = topo.labels.astype(np.int64)
    btype_t = torch.as_tensor(btype, device=device)
    nodes_t = torch.arange(nnode, device=device)

    if NS == NSSITES_NONE:
        n_theta = 0
        if spec.model == 0:
            n_w = 0 if spec.fix_omega else 1
        else:
            n_w = B - 1 if spec.fix_omega else B
    elif spec.model == 2:
        # branch-site A (NS=2): p0,p1 (transformed), w0, [w2]; B (NS=3):
        # p0,p1, w0,w1,w2
        n_theta = (3 + (0 if spec.fix_omega else 1)) if NS == M2A else 5
        n_w = 0
    elif spec.model == 3:
        # clade C (NS=2): p0,p1, w0, w2..w_{2+B-1}; D (NS=3): (ncatG-1)
        # transformed p's, ncatG-1 shared w's, B clade w's
        n_theta = ((3 + B) if NS == M2A
                   else (ncatG - 1) + (ncatG - 1) + B)
        n_w = 0
    else:
        n_theta = nssites_nparams(NS, ncatG, spec.fix_omega)
        n_w = 0

    def unpack(x):
        t = x[:n_time]
        k = n_time
        kappa = x[k:k + nkappa] if nkappa else torch.as_tensor(
            [spec.kappa] * (5 if spec.hkyREV else 1), dtype=dtype,
            device=x.device)
        k += nkappa
        ppi = x[k:k + npi]
        k += npi
        theta = x[k:k + n_theta + n_w]
        return t, kappa, ppi, theta

    def classes_for(theta, second_order: bool = False):
        """W [B, K] (omega per branch type and site class), freqs [K] and
        the scale mode; `second_order` as in `cdf_quantiles`."""
        one = theta.new_ones(())
        if NS == NSSITES_NONE:
            if spec.model == 0:
                w = (theta.new_tensor(spec.omega) if spec.fix_omega
                     else theta[0])
                W = w.reshape(1, 1)
            else:
                ws = theta[:n_w]
                if spec.fix_omega:
                    # the last branch type has the fixed omega
                    ws = torch.cat([ws, theta.new_tensor([spec.omega])])
                W = ws.reshape(B, 1)
            return W, theta.new_ones(1), "per_Q"
        if spec.model == 0:
            omegas, freqs = nssites_classes(NS, theta, ncatG,
                                            spec.fix_omega, spec.omega,
                                            second_order)
            return omegas.reshape(1, -1), freqs, "mixture"
        if spec.model == 2 and NS in (M2A, M3):
            # branch-site models A (NSsites=2) and B (NSsites=3)
            p = simplex_decode(theta[:2])       # p0, p1 renormalized
            if NS == M2A:
                w0, w1 = theta[2], one
                w2 = (theta.new_tensor(spec.omega) if spec.fix_omega
                      else theta[3])
            else:
                w0, w1, w2 = theta[2], theta[3], theta[4]
            t01 = p[0] + p[1]
            freqs = torch.stack([p[0], p[1], (1 - t01) * p[0] / t01,
                                 (1 - t01) * p[1] / t01])
            # rows: branch type 0 = background, 1 = foreground
            W = torch.stack([torch.stack([w0, w1, w0, w1]),
                             torch.stack([w0, w1, w2, w2])])
            return W, freqs, "mixture"
        if spec.model == 3 and NS in (M2A, M3):
            # clade models C (NSsites=2) and D (NSsites=3)
            if NS == M2A:      # model C: w0, 1, w_b per clade
                p = simplex_decode(theta[:2])
                base = [theta[2], one]
                per_type = theta[3:3 + B]
            else:              # model D: w0..w_{K-2} shared, w_{K-1} per clade
                K = ncatG
                p = simplex_decode(theta[:K - 1])
                base = [theta[(K - 1) + i] for i in range(K - 1)]
                per_type = theta[2 * (K - 1):2 * (K - 1) + B]
            W = torch.stack([torch.stack(base + [per_type[b]])
                             for b in range(B)])
            return W, p, "mixture"
        raise ValueError(f"model {spec.model} with NSsites {NS}")

    def model_at(x, twice: bool = False):
        """P [nnode, K, n, n], root frequencies per class [K, n] and class
        weights [K] at parameter vector x; with `twice` P(t) comes from
        the route that is differentiable twice."""
        x = x.to(dtype)
        t, kappa, ppi, theta = unpack(x)
        W, freqs, scale_mode = classes_for(theta, twice)
        Bc, K = W.shape
        w_flat = W.reshape(-1)                              # [B*K]
        kap = kappa if spec.hkyREV else kappa[0]
        if is_fmutsel:
            pf = torch.cat([ppi[:3], ppi.new_ones(1)])
            pf = pf / pf.sum()
            pi_d = codonmod.fmutsel_pi(codonf, pf, ppi[3:] if nfit else None,
                                       fcodon, G)
            s = codonmod.mutation_part(G, kap, pf.expand(3, 4), spec.hkyREV)
            s = s * codonmod.fmutsel_multiplier(G, pf, pi_d, data.ls)
            rs, ra = codonmod.flux(G, s, pi_d)
            Qs = codonmod.build_Q(G, s, w_flat, pi_d)       # [B*K, n, n]
        else:
            pi_d = pi
            s_d = codonmod.mutation_dense(T, kap, pf3x4, spec.hkyREV)
            rs, ra = codonmod.flux_dense(T, s_d, pi)
            Qs = codonmod.build_Q_dense(T, s_d, w_flat, pi)
        if scale_mode == "per_Q":
            scale = 1.0 / (rs + ra * w_flat)
        else:
            wbar = torch.sum(W * freqs[None, :], dim=1)     # [B]
            scale = (1.0 / (rs + ra * wbar)).repeat_interleave(K)
        if spec.clock >= 1:
            tfull = clock_fn(t)
        elif spec.fix_blength == 2:
            tfull = torch.as_tensor(topo.blen0, dtype=dtype, device=device)
        else:
            tfull = torch.zeros(nnode, dtype=dtype,
                                device=device).index_put((bn,), t)
        ts = tfull[:, None] * scale[None, :]                # [nnode, B*K]
        pmat = pmat_rev_multi_twice if twice else pmat_rev_multi
        P_all = pmat(Qs, pi_d, ts).reshape(nnode, Bc, K, n, n)
        # each branch takes the P of its type
        P = P_all[:, 0] if Bc == 1 else P_all[nodes_t, btype_t]
        return P, pi_d.expand(K, n), freqs

    def neg_lnl(x):
        P, piC, freqs = model_at(x)
        if n_chunks > 1:
            return -pruning.lnL_chunked(P, tips_c, topo, piC, freqs, fpatt_c)
        return -pruning.lnL(P, tips, topo, piC, freqs, fpatt)

    def neg_lnl_twice(x, patterns: slice = slice(None)):
        """-lnL of the patterns in `patterns`, by the route that is
        differentiable twice."""
        P, piC, freqs = model_at(x, twice=True)
        tp = (tipcodes.TipCodes(tips.codes[:, patterns], tips.amb)
              if isinstance(tips, tipcodes.TipCodes) else tips[:, patterns])
        return -pruning.lnL(P, tp, topo, piC, freqs, fpatt[patterns],
                            lnf=pruning.class_site_lnf_twice)

    def site_loglik_fn(x):
        """Per-pattern log site likelihood [H] at x (for the lnf file and
        RELL; reference: print_lnf_site, src/treesub.c:7597)."""
        P, piC, freqs = model_at(x)
        return pruning.site_loglik(P, tips, topo, piC, freqs)

    def class_posterior_fn(x):
        """Posterior P(class | pattern) [K, H] at x (NEB; reference:
        lfunNSsites_rate, src/codeml.c:5241)."""
        P, piC, freqs = model_at(x)
        return pruning.site_class_posterior(P, tips, topo, piC, freqs)

    neg_lnl.model_at = model_at
    neg_lnl.twice = neg_lnl_twice
    neg_lnl.site_loglik = site_loglik_fn
    neg_lnl.class_posterior = class_posterior_fn
    neg_lnl.tips, neg_lnl.fpatt, neg_lnl.topo = tips, fpatt, topo
    neg_lnl.pi_np, neg_lnl.pf3x4 = pi_np, pf3x4
    neg_lnl.n_classes = lambda x: classes_for(unpack(x)[3])[0].shape[1]

    # x0 / bounds
    if spec.clock >= 1:
        x0, bounds = list(xt0), list(tbounds)
    elif spec.fix_blength == 2:
        x0, bounds = [], []
    else:
        t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
        if not (t0 > 0).any():
            t0 = np.full(nb, 0.1)
        t0 = np.maximum(t0, BLEN_MIN * 2)
        x0 = list(t0)
        bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    if nkappa:
        x0 += [spec.kappa] * nkappa
        bounds += [(KAPPA_MIN, KAPPA_MAX)] * nkappa
    if is_fmutsel:
        # pi_TCA ratios to pi_G (reference initials, src/codeml.c:2108-2110)
        x0 += list(np.asarray(f1x4[:3]) / max(float(f1x4[3]), 1e-6))
        bounds += [(OMEGA_MIN, OMEGA_MAX)] * 3     # rateb, SetxBound default
        if nfit:
            if codonf == "FMutSel0":
                piAA = codonmod.observed_piAA(fcodon, graph)
                nsyn = np.bincount(graph.aa, minlength=20).astype(float)
                x0 += list(np.log((piAA[:19] / nsyn[:19] + 1e-3)
                                  / (piAA[19] / nsyn[19] + 1e-3)))
            else:
                x0 += list(np.log((np.asarray(fcodon[:-1]) + 1e-3)
                                  / (float(fcodon[-1]) + 1e-3)))
            bounds += [(-29.0, 29.0)] * nfit       # codeml.c:1925-1927
    if NS == NSSITES_NONE:
        x0 += [spec.omega] * n_w
        bounds += [(OMEGA_MIN, OMEGA_MAX)] * n_w
    elif spec.model == 0:
        th0, thb = nssites_x0_bounds(NS, ncatG, spec.fix_omega, spec.omega)
        x0 += th0
        bounds += thb
    elif spec.model == 2:   # branch-site A / B
        if NS == M2A:
            x0 += [1.0, 0.5, 0.2]
            bounds += [(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, 1.0)]
            if not spec.fix_omega:
                x0 += [2.0]
                bounds += [(1.0, W_MAX)]
        else:
            x0 += [1.0, 0.5, 0.2, 0.8, 2.0]
            bounds += [(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, W_MAX)] * 3
    elif spec.model == 3:
        if NS == M2A:   # clade C
            x0 += [1.0, 0.5, 0.2] + [1.0] * B
            bounds += ([(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, 1.0)]
                       + [(W_MIN, W_MAX)] * B)
        else:           # clade D
            x0 += [0.0] * (ncatG - 1) + [0.2, 0.8] + [1.0] * B
            bounds += ([(TRANS_MIN, TRANS_MAX)] * (ncatG - 1)
                       + [(1e-4, 1.0), (0.01, 1.5)] + [(W_MIN, W_MAX)] * B)
    return neg_lnl, unpack, classes_for, np.array(x0), bounds, pi_np


# the Hessian route's memory: the scaled partials of one pattern chunk
# (nnode x classes x states x patterns) are held some twenty times over by
# the graph of the gradient, and once more per Hessian row of a block, so a
# chunk's partials times (20 + rows of a block) stay within this many bytes
# (on the card 32 GiB of an H100's 80: fewer chunks, each pass longer)
HESSIAN_BYTES = {"cpu": 1 << 31, "cuda": 1 << 35}
HESSIAN_ROWS = 16       # Hessian rows per backward pass


def hessian(neg_lnl, x, *, device) -> np.ndarray:
    """The Hessian of -lnL at x [np, np] by double backward through
    `neg_lnl.twice`: the gradient with its graph, then the rows in blocks
    of HESSIAN_ROWS, each block one batched backward pass; summed over
    pattern chunks sized to HESSIAN_BYTES by the objective's states
    (`n_states`, 64 by default), unless its `pattern_chunks` is false (a
    rate HMM over the sites takes them all at once)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    xt = torch.tensor(np.asarray(x, dtype=np.float64), device=device,
                      requires_grad=True)
    H, n_par = neg_lnl.fpatt.shape[0], len(x)
    per_pattern = (neg_lnl.topo.nnode * neg_lnl.n_classes(xt.detach())
                   * getattr(neg_lnl, "n_states", 64) * 8
                   * (20 + HESSIAN_ROWS))
    step = (max(64, HESSIAN_BYTES[device.type] // per_pattern)
            if getattr(neg_lnl, "pattern_chunks", True) else H)
    eye = torch.eye(n_par, dtype=torch.float64, device=device)
    hess = torch.zeros_like(eye)
    for h0 in range(0, H, step):
        v = neg_lnl.twice(xt, slice(h0, min(h0 + step, H)))
        (g,) = torch.autograd.grad(v, xt, create_graph=True)
        for r0 in range(0, n_par, HESSIAN_ROWS):
            rows = slice(r0, min(r0 + HESSIAN_ROWS, n_par))
            (block,) = torch.autograd.grad(g, xt, eye[rows],
                                           retain_graph=True,
                                           is_grads_batched=True)
            hess[rows] += block
    out = hess.cpu().numpy()
    SECONDS["hessian"] += time.perf_counter() - t0
    return out


def standard_errors(neg_lnl, x, *, device) -> np.ndarray:
    """SEs of the MLEs from the observed information matrix (the Hessian
    of -lnL by automatic differentiation; replaces the reference's
    finite-difference Hessian / HessianSKT2004, src/treesub.c:7241).
    Parameters pinned at bounds give near-singular information; pinv keeps
    the rest usable."""
    H = hessian(neg_lnl, x, device=device)
    cov = np.linalg.pinv((H + H.T) / 2)
    return np.sqrt(np.clip(np.diag(cov), 0.0, None))


def _theta_starts(x0: np.ndarray, thetas, nth: int):
    multi = []
    for th in thetas:
        if len(th) != nth:
            continue
        s = x0.copy()
        s[-nth:] = th
        multi.append(s)
    return multi


def multi_starts(spec: CodemlSpec, topo: Topology, x0: np.ndarray):
    """Extra starting points of the fit, or None (the JAX package's
    `fit_packed`, paml_tpu/apps/codeml.py:1387-1433)."""
    if spec.NSsites and spec.model == 0:
        return _theta_starts(
            x0, nssites_extra_starts(spec.NSsites, spec.ncatG,
                                     spec.fix_omega),
            nssites_nparams(spec.NSsites, spec.ncatG, spec.fix_omega))
    if spec.NSsites == M2A and spec.model == 3:
        # clade model C: vary w0 and the per-clade omegas
        nth = len(x0) - len(topo.branch_nodes()) - _nkappa(spec)
        return _theta_starts(
            x0, ([2.0, 1.0, 0.01] + [3.0, 0.1][:nth - 3],
                 [0.0, 0.0, 0.3] + [0.5, 1.5][:nth - 3],
                 [1.0, -0.5, 0.05] + [1.0, 0.05][:nth - 3]), nth)
    if spec.clock == 2:
        # local-clock rate classes sit on a (duration x rate) ridge; spread
        # rate starts so the optimizer can reach a boundary optimum
        # (reference rateb upper bound 999, SetxBound)
        _, n_time, _, _, cinfo = make_clock_times(topo, 2)
        ncls = cinfo["n_rate_cls"]
        if not ncls:
            return None
        multi = []
        for rv in (30.0, 300.0, 999.0):
            s = x0.copy()
            s[n_time - ncls:n_time] = rv
            multi.append(s)
        return multi
    if spec.NSsites == M2A and spec.model == 2:
        # branch-site A: vary the class proportions and foreground omega
        fixw = spec.fix_omega
        return _theta_starts(
            x0, ([2.0, 1.0, 0.05] + ([] if fixw else [5.0]),
                 [0.0, 0.0, 0.5] + ([] if fixw else [1.2]),
                 [1.5, -0.5, 0.01] + ([] if fixw else [10.0])),
            3 if fixw else 4)
    return None


def fit(seqfile: str, treefile: str, spec: CodemlSpec | None = None, *,
        device, tree_index: int = 0) -> CodemlResult:
    """Read a codon alignment and a tree file, then `fit_packed`."""
    spec = spec or CodemlSpec()
    check_slice(spec)
    aln = seqio.read_alignment(seqfile, seqio.CODON_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata, icode=spec.icode)
    trees = treeio.read_trees(treefile, data.names)
    topo = from_treenode(trees[tree_index], data.names)
    return fit_packed(data, topo, spec, device=device)


def _staged_estfreq_starts(data, topo, spec, x0, device):
    """The staged start of an FMutSel / FMutSel0 fit with estFreq: the
    60-fitness (resp. 19-fitness) surface is ridged, so the full model
    starts from the estFreq = 0 optimum (branch lengths, kappa, pi_TCA,
    omega) with fitness initials chosen so that its frequencies are that
    optimum's exactly (the same information the reference's
    GetInitialsCodon uses, src/codeml.c:2111-2122).  Returns (x0, extra
    starts)."""
    res0 = fit_packed(data, topo, _dc_replace(spec, estFreq=False),
                      device=device)
    i2 = len(topo.branch_nodes()) + _nkappa(spec) + 3
    nfit0 = len(x0) - len(res0.x)
    graph = codonmod.codon_graph(spec.icode)
    pf0 = np.append(res0.x[i2 - 3:i2], 1.0)
    pf0 /= pf0.sum()
    mut3 = codonmod._mut3(pf0, graph)
    pi0 = np.asarray(res0.pi, float)
    if _codonf(spec) == "FMutSel":
        f = np.log(np.maximum(pi0, 1e-300) / mut3)
        fit_init = f[:-1] - f[-1]
    else:
        mutbias = np.zeros(20)
        np.add.at(mutbias, graph.aa, mut3)
        piAA0 = np.zeros(20)
        np.add.at(piAA0, graph.aa, pi0)
        f = np.log(np.maximum(piAA0, 1e-300) / mutbias)
        fit_init = f[:19] - f[19]
    fit_init = np.clip(fit_init, -28.0, 28.0)
    staged = np.concatenate([res0.x[:i2], fit_init, res0.x[i2:]])
    multi = [np.concatenate([res0.x[:i2], x0[i2:i2 + nfit0], res0.x[i2:]]),
             x0.copy()]
    return staged, multi


def fit_packed(data: seqio.PackedData, topo: Topology, spec: CodemlSpec, *,
               device, objective=None) -> CodemlResult:
    """Fit a codon model in float64 on `device` (scipy L-BFGS-B over the
    device's value + gradient), with the multi-starts of `multi_starts`.
    `objective`: what `make_codon_objective` returned for these arguments,
    where the caller goes on using it after the fit."""
    neg_lnl, unpack, classes_for, x0, bounds, pi_np = objective or \
        make_codon_objective(data, topo, spec, device=device)
    is_fmutsel = _codonf(spec) in ("FMutSel", "FMutSel0")
    multi = None
    if is_fmutsel and spec.estFreq:
        x0, multi = _staged_estfreq_starts(data, topo, spec, x0, device)
    more = multi_starts(spec, topo, x0)
    if more is not None:
        multi = more
    res = maximize(neg_lnl, x0, bounds, device=device, multi_start=multi)
    with torch.no_grad():
        t, kappa, ppi, theta = unpack(torch.as_tensor(res.x,
                                                      dtype=torch.float64))
        W, freqs, _ = classes_for(theta)
    params = {"theta": theta.numpy(), "W": W.numpy(),
              "freqs": freqs.numpy()}
    if is_fmutsel:
        ppi_np = ppi.numpy()
        pf = np.append(ppi_np[:3], 1.0)
        pf /= pf.sum()
        params["pf_TCAG"] = pf
        params["fitness"] = ppi_np[3:]
        pi_np = codonmod.fmutsel_pi(
            _codonf(spec), torch.as_tensor(pf),
            torch.as_tensor(ppi_np[3:]) if len(ppi_np) > 3 else None,
            pi_np, codonmod.pair_tables(spec.icode, "cpu")).numpy()
    return CodemlResult(
        lnL=res.lnL, np=len(res.x), blens=t.numpy(),
        branch_nodes=topo.branch_nodes(), kappa=kappa.numpy(),
        params=params, pi=pi_np, topo=topo, fit=res, x=np.asarray(res.x),
        spec=spec, class_omegas=W.numpy(), class_freqs=freqs.numpy())
