"""codeml: maximum likelihood for codon and amino-acid alignments.

Port of `paml_tpu/apps/codeml.py`.  Codon models: one omega per site
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
chunks (`n_chunks`).  Amino-acid data (seqtype 2, and codons translated,
seqtype 3): Poisson, EqualInput, Empirical, Empirical_F, FromCodon, REVaa_0,
REVaa with discrete-gamma rates (`make_aa_objective`) and FromCodon0 on the
codon chain (`make_fromcodon0_objective`).  aaDist: the chemical-distance
omegas, AAClasses from OmegaAA.dat and the fitness models FIT1 / FIT2
(`make_aadist_objective`).  Several genes (Mgene 0, 2, 3, 4:
`make_codon_mgene_objective`; 1: `fit_mgene_separate`).  `fit_packed`
dispatches among them as the JAX package does.

The parameter vector keeps the JAX package's layout (`unpack`), so the same
x means the same model in both packages.  Fits run on the device the
caller names, in float64 unless the caller asks for float32 (`dtype`, as
in the JAX package's `fit_packed`; P(t) then by uniformization and the
float32 instances of the kernels).

An objective has two routes.  `neg_lnl(x)` is the fit's: P(t) from the
eigendecomposition with its hand-written backward, pruning through
`pruning.class_site_lnf` (the CUDA kernels on the card), differentiable
once.  The Hessian's (`hessian`) takes P(t) from
`pmat.pmat_rev_multi_twice`, differentiable twice: on the card, at 16
states or more, through the kernels and their tangents
(`neg_lnl.terms(x)`, `_hessian_kernels`); elsewhere by `neg_lnl.twice(x)`,
the level pass under plain autograd (`pruning.class_site_lnf_twice`, whose
calls on the card are counted apart, `pruning.TWICE_CALLS`).
"""
from __future__ import annotations

import contextlib
import os
import re
import time
from dataclasses import dataclass
from dataclasses import replace as _dc_replace

import numpy as np
import torch

from ..constants import AA_ORDER
from ..core import (cuda_pruning, cuda_quantile, dgamma, graphs, pruning,
                    tipcodes)
from ..core.clockparam import make_clock_times
from ..core.optim import FitResult, maximize, simplex_decode
from ..core.pmat import pmat_rev, pmat_rev_multi, pmat_rev_multi_twice
from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from ..models import aa as aamod
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
M4_OMEGAS = (0.0, 1 / 3, 2 / 3, 1.0, 3.0)

CODON_FREQS = ("Fequal", "F1x4", "F3x4", "Fcodon", "F1x4MG", "F3x4MG",
               "FMutSel0", "FMutSel")

# the alignment reader's data type of each codeml seqtype
SEQTYPES = {1: seqio.CODON_SEQ, 2: seqio.AA_SEQ, 3: seqio.CODON2AA_SEQ}

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


def check_slice(spec: CodemlSpec):
    """Raise ValueError for a codon-frequency model that does not exist."""
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
    closure.  `second_order` as in `newton_quantiles`."""
    p = (np.arange(K) + 0.5) / K
    l, h = np.full(K, lo), np.full(K, hi)
    for _ in range(iters):
        m = (l + h) / 2
        below = cdf(m) < p
        l, h = np.where(below, m, l), np.where(below, h, m)
    return newton_quantiles(cdf, torch.as_tensor((l + h) / 2,
                                                 dtype=torch.float64),
                            lo, hi, second_order)


def newton_quantiles(cdf, x, lo=1e-7, hi=99.0, second_order: bool = False):
    """Two Newton steps from the bracketed median quantiles x [K] (no
    gradient) of the distribution whose CDF, a function of tensors on x's
    device, is `cdf`; the values are the JAX package's steps, and the
    gradients those of the parameters in the CDF's closure.

    The first step runs on values.  The second starts from its result x1
    as a constant and reads the CDF F and the pdf F_x there, the pdf
    keeping the parameters' graph: the gradient is the derivative of that
    step at x1, -F_theta / F_x + (F - p) F_x,theta / F_x^2, at a root the
    implicit-function derivative.  A target on a point of zero density
    (M10 / M11 with p0 on a median target: the bracket ends on the kink
    at omega = 1, where the beta part's pdf is 0) sends the first step
    far past the root with a pdf clamped at 1e-12; the second step then
    starts where F - p is not small, and a pdf held constant there (the
    implicit derivative at x1, not the step's) or one whose graph runs
    back through x1 (the JAX package's, x1's derivative 1 / 1e-12) would
    give a gradient that the function's own differences do not show.

    With `second_order` (the Hessian route) both steps' pdfs keep their
    graphs in x and in the parameters, which exact second derivatives at
    a root need."""
    K = x.shape[0]
    pt = (torch.arange(K, dtype=torch.float64, device=x.device) + 0.5) / K
    if second_order:
        for _ in range(2):
            with torch.enable_grad():
                xg = x if x.requires_grad else x.detach().requires_grad_(True)
                c = cdf(xg)
                (pdf,) = torch.autograd.grad(c.sum(), xg, create_graph=True,
                                             retain_graph=True)
            if xg is not x:
                c = cdf(x)
            x = torch.clamp(x - (c - pt) / torch.clamp_min(pdf, 1e-12), lo,
                            hi)
        return x
    x = x.detach()
    for last in (False, True):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            c = cdf(xg)
            (pdf,) = torch.autograd.grad(c.sum(), xg, create_graph=last)
        c = c.detach()
        if last:
            # the step's CDF with the parameters' graph alone; without one,
            # the pdf's graph (which holds the leaf xg) goes too
            c = cdf(x)
            if not c.requires_grad:
                pdf = pdf.detach()
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
    device and in its dtype, computed in float64.  On the card the
    bracket is E2's (`cuda_quantile.mix_quantiles`, the end of
    `cdf_quantiles`' bisection) and the Newton steps run there through
    `dgamma`'s functions on the card; on the CPU the host route
    (`cdf_quantiles` on numpy values)."""
    e2 = dgamma._e2(theta)
    if e2 is not None:
        th = theta.to(torch.float64)
        x, info = e2.mix_quantiles(NSsites, th.detach(), K)
        graphs.report_status(info[..., 0], "the mixture quantiles")
        with dgamma.third_partials_as_zero():
            return newton_quantiles(
                nssites_mixture_cdf(NSsites, th), x, cuda_quantile.MIX_LO,
                cuda_quantile.MIX_HI, second_order).to(theta.dtype)
    th = theta.to("cpu", torch.float64)
    cdf_t = nssites_mixture_cdf(NSsites, th)
    cdf_n = nssites_mixture_cdf(NSsites, th.detach().numpy())

    def cdf(x):
        return cdf_t(x) if _is_t(x) else cdf_n(x)
    return cdf_quantiles(cdf, K, second_order=second_order).to(
        theta.device, theta.dtype)


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
        w2 = theta.new_full((), omega_fix) if fix_omega else theta[3]
        return torch.stack([theta[2], one, w2]), p
    if NSsites == M3:
        p = simplex_decode(theta[:ncatG - 1])
        return theta[ncatG - 1:ncatG - 1 + ncatG], p
    if NSsites == M4:
        p = simplex_decode(theta[:ncatG - 1])
        return torch.stack([theta.new_full((), w) for w in M4_OMEGAS]), p
    if NSsites == M5:
        return (gamma_median_quantiles(theta[0], theta[1], ncatG),
                equal(ncatG))
    if NSsites == M7:
        return (beta_median_quantiles(theta[0], theta[1], ncatG),
                equal(ncatG))
    if NSsites == M8:
        p0 = theta[0]
        w = beta_median_quantiles(theta[1], theta[2], ncatG)
        ws = theta.new_full((), omega_fix) if fix_omega else theta[3]
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


def _blen_x0(topo: Topology, fill: float = 0.1) -> np.ndarray:
    """Initial branch lengths: the tree's (at least 2 BLEN_MIN), or `fill`
    on every branch when the tree has none."""
    branch_nodes = topo.branch_nodes()
    t0 = np.clip(topo.blen0[branch_nodes], 0.0, BLEN_MAX)
    if not (t0 > 0).any():
        t0 = np.full(len(branch_nodes), fill)
    return np.maximum(t0, BLEN_MIN * 2)


def _scatter_t(t: torch.Tensor, bn: torch.Tensor, nnode: int):
    """Branch lengths [nb] to a length per node [nnode] (the root's 0)."""
    return t.new_zeros(nnode).index_put((bn,), t)


def make_codon_objective(data: seqio.PackedData, topo: Topology,
                         spec: CodemlSpec, *, device,
                         dtype=torch.float64, n_chunks: int = 1):
    """(neg_lnl, unpack, classes_for, x0, bounds, pi) as in the JAX package;
    neg_lnl maps a 1-D tensor x on `device` to -lnL.  With n_chunks > 1
    the patterns are evaluated in that many equal chunks
    (`pruning.lnL_chunked`), so memory holds one chunk's buffers.

    neg_lnl carries `model_at(x)`, `twice(x)` (the same value by the route
    that is differentiable twice), `terms(x)` (the Hessian's kernel route:
    [(P, pi, class weights, tips, topo, fpatt)], P(t) differentiable
    twice), `site_loglik(x)` [H] and
    `class_posterior(x)` [K, H], its data (`tips`, `fpatt`, `topo`) and the
    data's frequencies (`pi_np`, `pf3x4`)."""
    check_slice(spec)
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
    # the evaluation's constants on the device once: a copy from the host
    # in every evaluation would be a host sync, which a CUDA graph cannot
    # record
    pf3x4_t = None if pf3x4 is None else torch.as_tensor(
        pf3x4, dtype=dtype, device=device)
    fcodon_t = torch.as_tensor(fcodon, dtype=dtype, device=device)
    blen_fixed = (torch.as_tensor(topo.blen0, dtype=dtype, device=device)
                  if spec.fix_blength == 2 else None)

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
            topo, spec.clock, tip_ages, device=device, dtype=dtype)
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
        kappa = x[k:k + nkappa] if nkappa else torch.full(
            (5 if spec.hkyREV else 1,), spec.kappa, dtype=dtype,
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
                w = (theta.new_full((), spec.omega) if spec.fix_omega
                     else theta[0])
                W = w.reshape(1, 1)
            else:
                ws = theta[:n_w]
                if spec.fix_omega:
                    # the last branch type has the fixed omega
                    ws = torch.cat([ws, theta.new_full((1,), spec.omega)])
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
                w2 = (theta.new_full((), spec.omega) if spec.fix_omega
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
                                       fcodon_t, G)
            s = codonmod.mutation_part(G, kap, pf.expand(3, 4), spec.hkyREV)
            s = s * codonmod.fmutsel_multiplier(G, pf, pi_d, data.ls)
            rs, ra = codonmod.flux(G, s, pi_d)
            Qs = codonmod.build_Q(G, s, w_flat, pi_d)       # [B*K, n, n]
        else:
            pi_d = pi
            s_d = codonmod.mutation_dense(T, kap, pf3x4_t, spec.hkyREV)
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
            tfull = blen_fixed
        else:
            tfull = _scatter_t(t, bn, nnode)
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
        return -pruning.lnL(P, _pattern_slice(tips, patterns), topo, piC,
                            freqs, fpatt[patterns],
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
    # the Hessian's kernel route (`hessian`): the mixture's one term, its
    # P(t) by the route that is differentiable twice
    neg_lnl.terms = lambda x: [(*model_at(x, twice=True), tips, topo,
                                fpatt)]
    neg_lnl.site_loglik = site_loglik_fn
    neg_lnl.class_posterior = class_posterior_fn
    neg_lnl.tips, neg_lnl.fpatt, neg_lnl.topo = tips, fpatt, topo
    neg_lnl.pi_np, neg_lnl.pf3x4 = pi_np, pf3x4
    neg_lnl.n_classes = lambda x: classes_for(unpack(x)[3])[0].shape[1]
    # an evaluation reads nothing on the host (the clock's node ages
    # included): the fits may replay it from a CUDA graph (`optim.graphed`)
    neg_lnl.capturable = True

    # x0 / bounds
    if spec.clock >= 1:
        x0, bounds = list(xt0), list(tbounds)
    elif spec.fix_blength == 2:
        x0, bounds = [], []
    else:
        x0 = list(_blen_x0(topo))
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


def _pattern_slice(tips, patterns: slice):
    """The tips of the patterns in `patterns` (contiguous int32 codes, or
    TipCodes sharing the table)."""
    if isinstance(tips, tipcodes.TipCodes):
        return tipcodes.TipCodes(tips.codes[:, patterns].contiguous(),
                                 tips.amb)
    return tips[:, patterns].contiguous()


# The Hessian's memory.  Plain route (`neg_lnl.twice`): the scaled partials
# of one pattern chunk (nnode x classes x states x patterns) are held some
# twenty times over by the graph of the gradient, and once more per Hessian
# row of a block.  Kernel route (`_hessian_kernels`): the forward's residual
# S (an internal node's partials), H1's Sd (S once per row of a block) and
# the mixture's small tensors; H2's dP slabs and adjoint slots do not grow
# with the patterns.  A chunk's partials times (20 + rows of a block),
# resp. (2 + rows of a block), stay within this many bytes (on the card 32
# GiB of an H100's 80: fewer chunks, each pass longer).
HESSIAN_BYTES = {"cpu": 1 << 31, "cuda": 1 << 35}
HESSIAN_ROWS = 16       # Hessian rows per backward pass


def hessian(neg_lnl, x, *, device) -> np.ndarray:
    """The Hessian of -lnL at x [np, np].  Objectives with `terms` whose
    pruning passes take the kernels (`pruning.uses_twice_kernels`: CUDA,
    16 states or more) go through `_hessian_kernels`; the others by
    double backward through `neg_lnl.twice`: the gradient with its graph,
    then the rows in blocks of HESSIAN_ROWS, each block one batched
    backward pass; summed over pattern chunks sized to HESSIAN_BYTES by
    the objective's states (`n_states`, 64 by default), unless its
    `pattern_chunks` is false (a rate HMM over the sites takes them all at
    once)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    xt = torch.tensor(np.asarray(x, dtype=np.float64), device=device,
                      requires_grad=True)
    with _deterministic():
        terms = neg_lnl.terms(xt) if hasattr(neg_lnl, "terms") else None
        if terms and all(pruning.uses_twice_kernels(t[0]) for t in terms):
            hess = _hessian_kernels(terms, xt)
        else:
            del terms
            hess = _hessian_twice(neg_lnl, xt)
    out = hess.cpu().numpy()
    SECONDS["hessian"] += time.perf_counter() - t0
    return out


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms while a Hessian's autograd runs,
    so that the SEs repeat bit for bit: on the card the backward of an
    index (the level pass's `P[nodes]`, the branch types' `P_all[nodes,
    types]`, clock 5 / 6's ages and rates), of a gather and of a scatter
    would otherwise add with atomics, in an order that changes from run to
    run (`tools/torch_hessian_repeat_probe.py`).  An operation without a
    deterministic implementation would warn, not stop the program (none
    does on the Hessians' paths).  Uninitialized memory is left as it is
    (the mode would fill every `torch.empty` first: a quarter of a
    Hessian's CPU time).  Every backward pass runs on this thread: the
    autograd engine adds the gradients that meet at a node in the order of
    their nodes' sequence numbers, which each thread counts for itself; a
    double backward on the card made its nodes on the engine's device
    thread and the model's forward made its own here, and as the two
    counts drifted apart from one Hessian to the next the order of such a
    sum flipped and the Hessian's last bits with it (a process's third
    Hessian one ulp from its first two).  The previous settings are
    restored on the way out."""
    det = torch.utils.deterministic
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with torch.autograd.set_multithreading_enabled(False):
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


def _hessian_twice(neg_lnl, xt):
    """`hessian` by double backward through `neg_lnl.twice`."""
    H, n_par = neg_lnl.fpatt.shape[0], xt.numel()
    per_pattern = (neg_lnl.topo.nnode * neg_lnl.n_classes(xt.detach())
                   * getattr(neg_lnl, "n_states", 64) * 8
                   * (20 + HESSIAN_ROWS))
    step = (max(64, HESSIAN_BYTES[xt.device.type] // per_pattern)
            if getattr(neg_lnl, "pattern_chunks", True) else H)
    eye = torch.eye(n_par, dtype=torch.float64, device=xt.device)
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
    return hess


def _mixture(lnf, w, fpatt):
    """-lnL of one chunk from its pruning pass, as `pruning.lnL` mixes it:
    (z, w, gz, gw), z and w leaves standing for lnf [C, H] and the class
    weights [C], gz and gw the gradient with its graph."""
    z = lnf.detach().requires_grad_()
    w = w.detach().requires_grad_()
    v = -torch.sum(fpatt * torch.logsumexp(z + torch.log(w)[:, None], dim=0))
    gz, gw = torch.autograd.grad(v, (z, w), create_graph=True)
    return z, w, gz, gw


def _grads(outputs, inputs, grad_outputs, **kw):
    """autograd.grad over the outputs that carry a graph, zeros (batched
    like the grad_outputs) for inputs that none reaches."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs)
             if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], inputs,
                              [g for _, g in pairs], allow_unused=True,
                              **kw)
    lead = grad_outputs[0].shape[:1] if kw.get("is_grads_batched") else ()
    return [torch.zeros(lead + i.shape, dtype=i.dtype, device=i.device)
            if g is None else g for g, i in zip(got, inputs)]


def _hessian_kernels(terms, xt):
    """`hessian` through the pruning kernels.  -lnL = sum over terms of
    phi(K(P, pi), w), with M(x) = (P, pi, w) per term from the model
    (autograd, differentiable twice), K the pruning pass
    (`cuda_pruning.ClassSiteLnfKernelTwice`) and phi the mixture over the
    classes and the patterns (`_mixture`).  With c = dF/dM (B2/B4's dP, dpi
    and phi's dw, over every pattern chunk):

      H E = d^2<c, M(x)>/dx^2 E + J_M^T (d^2F/dM^2 J_M E)

    for a block E of HESSIAN_ROWS unit rows: J_M E comes from q = d<c,
    M>/dx (its derivative in c), and d^2F/dM^2 J_M E per chunk from H1
    (lnf's tangent), the mixture's second derivatives (autograd: the
    tangent of phi's gradient gz, gw) and H2 (the adjoint's tangent, gz's
    included).  The model's and the mixture's parts are batched backward
    passes (`is_grads_batched`) with no kernel in them; the kernels take
    the block's directions as a batch.  The pattern chunks are sized to
    HESSIAN_BYTES by S and Sd."""
    n_par = xt.numel()
    eye = torch.eye(n_par, dtype=torch.float64, device=xt.device)
    hess = torch.zeros_like(eye)
    M, c = [], []
    chunks = []
    for P, piC, w, tips, topo, fpatt in terms:
        args = [t.detach().double().contiguous() for t in (P, piC, w)]
        C, n = P.shape[1], P.shape[-1]
        H = fpatt.shape[0]
        per_pattern = topo.nnode * C * n * 8 * (2 + HESSIAN_ROWS)
        step = max(64, HESSIAN_BYTES[xt.device.type] // per_pattern)
        parts = [(_pattern_slice(tips, slice(h0, h0 + step)),
                  fpatt[h0:h0 + step].double())
                 for h0 in range(0, H, step)]
        cP, cpi, cw = (torch.zeros_like(a) for a in args)
        for tp, fp in parts:
            route = cuda_pruning.ClassSiteLnfKernelTwice(args[0], tp, topo,
                                                         args[1])
            _, _, gz, gw = _mixture(route.lnf, args[2], fp)
            dP, dpi = route.adjoint(gz.detach())
            cP += dP
            cpi += dpi
            cw += gw.detach()
        M += [P, piC, w]
        c += [cP, cpi, cw]
        chunks.append((args, topo, parts))
    c = [t.requires_grad_() for t in c]
    (q,) = torch.autograd.grad(
        sum((m.double() * ci).sum() for m, ci in zip(M, c)
            if m.requires_grad), xt, create_graph=True)
    for r0 in range(0, n_par, HESSIAN_ROWS):
        E = eye[r0:r0 + HESSIAN_ROWS]
        Md = _grads([q], c, [E], retain_graph=True, is_grads_batched=True)
        b = [torch.zeros_like(t) for t in Md]
        for k, (args, topo, parts) in enumerate(chunks):
            Pd, pid, wd = Md[3 * k:3 * k + 3]
            for tp, fp in parts:
                route = cuda_pruning.ClassSiteLnfKernelTwice(
                    args[0], tp, topo, args[1])
                z, wl, gz, gw = _mixture(route.lnf, args[2], fp)
                zd = route.tan_fwd(Pd, pid)
                gzd, gwd = _grads([gz, gw], [z, wl], [zd, wd],
                                  is_grads_batched=True)
                dPd, dpid = route.tan_bwd(gz.detach(), gzd)
                b[3 * k] += dPd
                b[3 * k + 1] += dpid
                b[3 * k + 2] += gwd
        (hess[r0:r0 + HESSIAN_ROWS],) = _grads(
            [q] + M, [xt], [E] + [bi.to(m.dtype) for bi, m in zip(b, M)],
            retain_graph=True, is_grads_batched=True)
    return hess


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
        device, tree_index: int = 0, dtype=None) -> CodemlResult:
    """Read an alignment and a tree file, then `fit_packed`."""
    spec = spec or CodemlSpec()
    check_slice(spec)
    aln = seqio.read_alignment(seqfile, SEQTYPES[spec.seqtype])
    data = seqio.pack(aln, cleandata=spec.cleandata, icode=spec.icode)
    trees = treeio.read_trees(treefile, data.names)
    topo = from_treenode(trees[tree_index], data.names)
    return fit_packed(data, topo, spec, device=device, dtype=dtype)


def _staged_estfreq_starts(data, topo, spec, x0, device, dtype):
    """The staged start of an FMutSel / FMutSel0 fit with estFreq: the
    60-fitness (resp. 19-fitness) surface is ridged, so the full model
    starts from the estFreq = 0 optimum (branch lengths, kappa, pi_TCA,
    omega) with fitness initials chosen so that its frequencies are that
    optimum's exactly (the same information the reference's
    GetInitialsCodon uses, src/codeml.c:2111-2122).  Returns (x0, extra
    starts)."""
    res0 = fit_packed(data, topo, _dc_replace(spec, estFreq=False),
                      device=device, dtype=dtype)
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
               device, dtype=None, objective=None) -> CodemlResult:
    """Fit a model on `device` (scipy L-BFGS-B over the device's value +
    gradient): amino-acid data (`fit_aa_packed`), aaDist (`_fit_aadist`),
    several genes with Mgene other than 1 (`fit_codon_mgene`; a
    ValueError with branch or NSsites models, as the reference), else a
    codon model with the multi-starts of `multi_starts`.  The objective
    computes in `dtype` (None: float64, what the JAX package's None gives
    off a TPU; torch.float32 runs the float32 path), the optimizer and
    the result's fields in float64.  `objective`: what
    `make_codon_objective` returned for these arguments, where the caller
    goes on using it after the fit."""
    dtype = torch.float64 if dtype is None else dtype
    if spec.seqtype in (2, 3):
        return fit_aa_packed(data, topo, spec, device=device, dtype=dtype)
    if spec.aaDist:
        return _fit_aadist(data, topo, spec, device=device, dtype=dtype)
    if data.ngene > 1 and spec.Mgene != 1:
        if spec.model or spec.NSsites:
            raise ValueError("Mgene>0 with branch/NSsites models is not "
                             "supported (the reference zerrors too)")
        return fit_codon_mgene(data, topo, spec, spec.Mgene, device=device,
                               dtype=dtype)
    neg_lnl, unpack, classes_for, x0, bounds, pi_np = objective or \
        make_codon_objective(data, topo, spec, device=device, dtype=dtype)
    is_fmutsel = _codonf(spec) in ("FMutSel", "FMutSel0")
    multi = None
    if is_fmutsel and spec.estFreq:
        x0, multi = _staged_estfreq_starts(data, topo, spec, x0, device,
                                           dtype)
    more = multi_starts(spec, topo, x0)
    if more is not None:
        multi = more
    res = maximize(neg_lnl, x0, bounds, device=device, multi_start=multi)
    with torch.no_grad(), graphs.status_sink() as sink:
        # decoded on the fit's device: the class omegas' quantiles by the
        # fit's own route (E2 on the card), read back in one copy
        parts = unpack(torch.as_tensor(res.x, dtype=torch.float64,
                                       device=device))
        W, freqs, _ = classes_for(parts[3])
    t, kappa, ppi, theta, W, freqs = graphs.fetch([*parts, W, freqs], sink,
                                                  "the fit's classes")
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


# --- amino-acid data (seqtype 2 and 3) ----------------------------------------

def _neg_lnl(model_at, tips, fpatt, topo):
    """neg_lnl(x, lnf=pruning.class_site_lnf): -lnL at x through the
    pruning pass `lnf` (the plain version's for a check on the card), of
    the model that model_at(x) -> (P, root frequencies, class weights)
    gives; it carries model_at, tips, fpatt and topo."""
    def neg_lnl(x, lnf=pruning.class_site_lnf):
        P, piC, w = model_at(x)
        return -pruning.lnL(P, tips, topo, piC, w, fpatt, lnf=lnf)

    neg_lnl.model_at = model_at
    neg_lnl.tips, neg_lnl.fpatt, neg_lnl.topo = tips, fpatt, topo
    return neg_lnl


def make_aa_objective(data: seqio.PackedData, topo: Topology,
                      spec: CodemlSpec, *, device, dtype=torch.float64):
    """(neg_lnl, unpack, x0, bounds, pi) of an amino-acid model (reference:
    eigenQaa, src/codeml.c:3400; lfun / lfundG over 20 states), with
    discrete-gamma rates through ncatG (aaml's fix_alpha / alpha; a fixed
    alpha is taken at no less than 0.5).  Parametric exchangeabilities:
    FromCodon (the codon chain aggregated, kappa estimated, omega fixed;
    src/codeml.c:3419,3487), REVaa (189 free rates) and REVaa_0 (the
    one-step pairs alone), src/codeml.c:3424-3436.

    neg_lnl(x, lnf=pruning.class_site_lnf) maps a tensor x on `device` to
    -lnL through the pruning pass `lnf`; it carries `model_at(x)` -> (P
    [nnode, K, 20, 20], root frequencies [K, 20], class weights [K]) and
    its `tips`, `fpatt`, `topo`."""
    device = torch.device(device)
    f64 = dict(dtype=dtype, device=device)
    model = spec.aa_model
    parametric = model in ("FromCodon", "REVaa", "REVaa_0")
    if parametric:
        pi_np = np.asarray(data.base_freqs, float)
        pi_np = pi_np / pi_np.sum()
        graph = codonmod.codon_graph(spec.icode)
        # the index tables and constants on the device once
        if model == "FromCodon":
            nrate = 0 if spec.fix_kappa else 1
            fixed_kappa = torch.as_tensor(spec.kappa, **f64)
            tables = aamod.from_codon_tables(spec.omega, pi_np, graph,
                                             device=device, dtype=dtype)

            def S_of(rates):
                kap = rates[0] if nrate else fixed_kappa
                return aamod.from_codon_S(kap, spec.omega, pi_np, graph,
                                          device=device, dtype=dtype,
                                          tables=tables)
            Sjones = None
        else:
            g = graph if model == "REVaa_0" else None
            nrate = aamod.n_revaa_rates(model, graph)
            tables = aamod.revaa_tables(g, device)

            def S_of(rates):
                return aamod.revaa_S(rates, g, tables)
            Sjones, _ = aamod.load_empirical(spec.aa_rate_file or "jones")
    else:
        S_static, pi_np = aamod.model_S_pi(model, spec.aa_rate_file,
                                           data.base_freqs)
        nrate = 0
        Q_static = aamod.build_aa_Q(torch.as_tensor(S_static, **f64),
                                    torch.as_tensor(pi_np, **f64))
    pi = torch.as_tensor(pi_np, **f64)
    tips = _codon_tips(data.tip_partials, device, dtype)
    cuda_pruning.check_tips(tips, 20)
    fpatt = torch.as_tensor(data.fpatt, **f64)
    nb = len(topo.branch_nodes())
    bn = torch.as_tensor(topo.branch_nodes(), device=device)
    use_gamma = (not spec.fix_alpha) or spec.alpha > 0
    K = spec.ncatG if use_gamma else 1
    est_alpha = use_gamma and not spec.fix_alpha

    def unpack(x):
        t = x[:nb]
        rates = x[nb:nb + nrate]
        k = nb + nrate
        alpha = x[k] if est_alpha else x.new_full((), max(spec.alpha, 0.5))
        return t, rates, alpha

    def model_at(x):
        x = x.to(dtype)
        t, rates, alpha = unpack(x)
        Q = aamod.build_aa_Q(S_of(rates), pi) if parametric else Q_static
        if K > 1:
            r, w = dgamma.discrete_gamma(alpha, K)
        else:
            r = w = x.new_ones(1)
        ts = _scatter_t(t, bn, topo.nnode)[:, None] * r[None, :]
        return pmat_rev(Q, pi, ts), pi.expand(K, 20), w

    neg_lnl = _neg_lnl(model_at, tips, fpatt, topo)
    # an evaluation reads nothing on the host (the gamma rates from E2 on
    # the card, FromCodon's and REVaa's tables made above): the fits may
    # replay it from a CUDA graph
    neg_lnl.capturable = True
    x0 = list(_blen_x0(topo))
    bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    if parametric and model == "FromCodon" and nrate:
        x0.append(spec.kappa)
        bounds.append((KAPPA_MIN, KAPPA_MAX))
    elif parametric and nrate:
        # initials from the empirical matrix, scaled so that the reference
        # pair (19, 9) is 1 (reference: GetInitials,
        # src/codeml.c:2384-2392)
        ii, jj = aamod.aa_pairs_lower()
        ref = Sjones[aamod.IJ_AA_REF[0], aamod.IJ_AA_REF[1]]
        vals = Sjones[ii, jj] / max(ref, 1e-8)
        isref = (ii == aamod.IJ_AA_REF[0]) & (jj == aamod.IJ_AA_REF[1])
        if model == "REVaa_0":
            fill = (aamod.aa_1step(graph) > 0) & ~isref
        else:
            fill = ~isref
        x0 += list(np.clip(vals[fill], 1e-4, 999.0))
        bounds += [(OMEGA_MIN, OMEGA_MAX)] * nrate
    if est_alpha:
        x0.append(spec.alpha if spec.alpha > 0 else 0.5)
        bounds.append((0.005, 99.0))
    return neg_lnl, unpack, np.array(x0), bounds, pi_np


def make_fromcodon0_objective(data: seqio.PackedData, topo: Topology,
                              spec: CodemlSpec, *, device,
                              dtype=torch.float64):
    """FromCodon0 (aa model 5): the amino acids become ambiguous codon
    data, each tip cell the indicator of its synonymous codons (M [20, 61]),
    and the likelihood runs on the 61-state codon chain with kappa and
    omega free and pi the codon frequencies equal within a family
    (reference: src/codeml.c:498-556, com.pi <- fb61 and the z[] + 64
    recoding).  Returns what `make_aa_objective` does; model_at gives one
    class of 61 states."""
    device = torch.device(device)
    f64 = dict(dtype=dtype, device=device)
    graph = codonmod.codon_graph(spec.icode)
    G = codonmod.pair_tables(spec.icode, device)
    faa = np.asarray(data.base_freqs, float)
    faa = faa / faa.sum()
    fb61 = aamod.aa2codonf(faa, graph)
    M = np.zeros((20, graph.n))
    M[graph.aa, np.arange(graph.n)] = 1.0
    tips = _codon_tips(np.asarray(data.tip_partials) @ M, device, dtype)
    cuda_pruning.check_tips(tips, graph.n)
    pi_np = fb61 / fb61.sum()
    pi = torch.as_tensor(pi_np, **f64)
    fpatt = torch.as_tensor(data.fpatt, **f64)
    nb = len(topo.branch_nodes())
    bn = torch.as_tensor(topo.branch_nodes(), device=device)
    nkappa = 0 if spec.fix_kappa else 1
    nomega = 0 if spec.fix_omega else 1

    def unpack(x):
        t = x[:nb]
        kap = x[nb] if nkappa else x.new_full((), spec.kappa)
        om = x[nb + nkappa] if nomega else x.new_full((), spec.omega)
        return t, kap, om

    def model_at(x):
        x = x.to(dtype)
        t, kap, om = unpack(x)
        s = codonmod.mutation_part(G, kap)
        Q = codonmod.build_Q(G, s, om, pi)
        mr = codonmod.mean_rate(G, s, om, pi)
        ts = _scatter_t(t, bn, topo.nnode)[:, None] / mr
        return pmat_rev(Q, pi, ts), pi.expand(1, graph.n), x.new_ones(1)

    neg_lnl = _neg_lnl(model_at, tips, fpatt, topo)
    # an evaluation reads nothing on the host: the fits may replay it
    # from a CUDA graph
    neg_lnl.capturable = True
    x0 = list(_blen_x0(topo, 0.3)) + [spec.kappa] * nkappa \
        + [spec.omega] * nomega
    bounds = ([(BLEN_MIN, BLEN_MAX)] * nb
              + [(KAPPA_MIN, KAPPA_MAX)] * nkappa
              + [(OMEGA_MIN, OMEGA_MAX)] * nomega)
    return neg_lnl, unpack, np.array(x0), bounds, pi_np


def fit_aa_packed(data: seqio.PackedData, topo: Topology, spec: CodemlSpec,
                  *, device, dtype=torch.float64) -> CodemlResult:
    """Fit an amino-acid model (FromCodon0 on the codon chain) on `device`,
    the objective in `dtype`."""
    if spec.aa_model == "FromCodon0":
        neg_lnl, unpack, x0, bounds, pi_np = make_fromcodon0_objective(
            data, topo, spec, device=device, dtype=dtype)
        res = maximize(neg_lnl, x0, bounds, device=device)
        with torch.no_grad():
            t, kap, om = unpack(torch.as_tensor(res.x, dtype=torch.float64))
        return CodemlResult(
            lnL=res.lnL, np=len(res.x), blens=t.numpy(),
            branch_nodes=topo.branch_nodes(),
            kappa=np.asarray([float(kap)]), params={"omega": float(om)},
            pi=pi_np, topo=topo, fit=res, x=np.asarray(res.x), spec=spec)
    neg_lnl, unpack, x0, bounds, pi_np = make_aa_objective(
        data, topo, spec, device=device, dtype=dtype)
    res = maximize(neg_lnl, x0, bounds, device=device)
    with torch.no_grad():
        t, rates, alpha = unpack(torch.as_tensor(res.x, dtype=torch.float64))
    kap = rates.numpy() if spec.aa_model == "FromCodon" else np.zeros(0)
    return CodemlResult(
        lnL=res.lnL, np=len(res.x), blens=t.numpy(),
        branch_nodes=topo.branch_nodes(), kappa=kap,
        params={"alpha": float(alpha), "rates": rates.numpy()},
        pi=pi_np, topo=topo, fit=res, x=np.asarray(res.x), spec=spec)


# --- aaDist, AAClasses and the fitness models ---------------------------------

# the AAchem p and v rows normalized by their maxima (reference:
# src/codeml.c:201, :1632-1634)
AACHEM_P = np.array([8.1, 10.5, 11.6, 13, 5.5, 10.5, 12.3, 9, 10.4, 5.2,
                     4.9, 11.3, 5.7, 5.2, 8, 9.2, 8.6, 5.4, 6.2, 5.9]) / 13.0
AACHEM_V = np.array([31, 124, 56, 54, 55, 85, 83, 3, 96, 111,
                     111, 119, 105, 132, 32.5, 32, 61, 170, 136, 84]) / 170.0

AADIST_FILES = {1: "grantham", 2: "miyata", 3: "g1974c", 4: "g1974p",
                5: "g1974v", 6: "g1974a"}

_INT_RE = re.compile(r"\s*(-?\d+)")


def parse_omega_aa(text: str, graph) -> tuple[int, np.ndarray]:
    """OmegaAA.dat (reference: GetOmegaAA, src/codeml.c:4079): (number of
    omega classes, class of each amino-acid pair [20, 20]); class 0 is the
    background.

    The file is read as a stream: its first integer is the number of
    classes ncls, then exactly ncls - 1 class lines `i: PAIRS...` follow,
    and nothing after them is read (the trailing `0: all others` line and
    any commentary are never consumed).  Pairs not one nucleotide step
    apart are ignored, a pair named twice is an error.  An ncls below 1 or
    above 64 selects the general model: one omega per one-step pair."""
    one_step = np.zeros((20, 20), dtype=bool)
    aa_i = graph.aa[graph.pi_idx]
    aa_j = graph.aa[graph.pj_idx]
    ns = aa_i != aa_j
    one_step[aa_i[ns], aa_j[ns]] = True
    one_step |= one_step.T

    def read_int(pos):
        m = _INT_RE.match(text, pos)
        if not m:
            raise ValueError("OmegaAA.dat: expected an integer")
        return int(m.group(1)), m.end()

    ncls, pos = read_int(0)
    cls = np.zeros((20, 20), dtype=np.int64)
    if ncls < 1 or ncls > 64:         # general model: one w per 1-step pair
        k = 0
        for i in range(20):
            for j in range(i):
                if one_step[i, j]:
                    cls[i, j] = cls[j, i] = k
                    k += 1
        return k, cls
    for iomega in range(1, ncls):     # the file declares classes 1..ncls-1
        j, pos = read_int(pos)
        if j != iomega:
            raise ValueError(
                f"err data file OmegaAA.dat: expected class {iomega}, "
                f"got {j}")
        if pos >= len(text) or text[pos] != ":":
            raise ValueError("OmegaAA.dat: expected ':' after class number")
        pos += 1
        eol = text.find("\n", pos)
        line = text[pos:] if eol < 0 else text[pos:eol]
        pos = len(text) if eol < 0 else eol + 1
        i = 0
        while i < len(line):
            if not line[i].isalpha():
                i += 1
                continue
            if i + 1 >= len(line) or not line[i + 1].isalpha():
                raise ValueError("OmegaAA.dat: dangling aa in pair")
            try:
                a = AA_ORDER.index(line[i].upper())
                b = AA_ORDER.index(line[i + 1].upper())
            except ValueError:
                raise ValueError(
                    f"OmegaAA.dat: aa not found in pair {line[i:i + 2]!r}")
            i += 2
            if a == b:
                continue              # "This pair has no effect"
            if not one_step[a, b]:
                continue              # unreachable in one step: ignored
            if cls[a, b]:
                raise ValueError(
                    f"OmegaAA.dat: pair {line[i - 2:i]!r} already specified")
            cls[a, b] = cls[b, a] = iomega
    return ncls, cls


def make_aadist_objective(data: seqio.PackedData, topo: Topology,
                          spec: CodemlSpec, *, device, dtype=torch.float64):
    """(neg_lnl, unpack, x0, bounds, pi) of an aaDist model (reference:
    GetOmega, src/codeml.c:3020): +-1..6 chemical-distance omegas w = b
    exp(-a d) (+, geometric) or b (1 - a d) (-, linear); 7 AAClasses (an
    omega class per amino-acid pair from OmegaAA.dat, crossed with the
    branch types under model = 2); 11 / 12 the fitness models FIT1 / FIT2
    (Yang et al. 1998), which also tilt the codon frequencies.  neg_lnl
    as in `make_aa_objective`; model_at gives one class of 61 states."""
    device = torch.device(device)
    f64 = dict(dtype=dtype, device=device)
    codonf = _codonf(spec)
    graph = codonmod.codon_graph(spec.icode)
    G = codonmod.pair_tables(spec.icode, device)
    fcodon, f3x4, f1x4 = codonmod.count_codon_freqs(
        data.tip_partials, data.fpatt, graph, data.pos_masks)
    pi_np = codonmod.codon_pi(codonf, fcodon, f3x4, f1x4, graph)
    pf3x4 = codonmod.mg_pf3x4(codonf, f3x4, f1x4)
    pi = torch.as_tensor(pi_np, **f64)
    tips = _codon_tips(data.tip_partials, device, dtype)
    cuda_pruning.check_tips(tips, graph.n)
    fpatt = torch.as_tensor(data.fpatt, **f64)
    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = torch.as_tensor(branch_nodes, device=device)
    nnode = topo.nnode
    nkappa = _nkappa(spec)
    B = _n_btypes(topo, spec.model)
    btype = (topo.labels.astype(np.int64) if spec.model == 2
             else np.zeros(nnode, dtype=np.int64))
    btype_t = torch.as_tensor(btype, device=device)
    nodes_t = torch.arange(nnode, device=device)
    aa_i, aa_j = G.aa[G.pi_idx], G.aa[G.pj_idx]
    nonsyn = ~G.is_syn
    ad = spec.aaDist
    if ad in (11, 12):                      # FIT1 / FIT2
        if B > 1:
            raise NotImplementedError(
                "FIT1/FIT2 with branch types is not supported (the "
                "fitness models tilt the equilibrium frequencies, which "
                "cannot differ per branch under one reversible chain)")
        n_pom = (4 + (ad == 12)) * B
        chem_p = torch.as_tensor(AACHEM_P, **f64)
        chem_v = torch.as_tensor(AACHEM_V, **f64)
        # the frequencies tilted by fitness (reference: getpcodonClass,
        # src/codeml.c:2049-2086: pi_fit(i) = pi0(i) / paa0(aa_i)
        # paaClass(aa_i), paaClass proportional to exp(2 fit))
        paa0_np = np.zeros(20)
        np.add.at(paa0_np, graph.aa, pi_np)
        paa0 = torch.as_tensor(np.maximum(paa0_np, 1e-300), **f64)
    elif ad == 7:                           # AAClasses
        text = spec.omegaAA or ""
        if text and "\n" not in text and len(text) < 4096 \
                and os.path.exists(text):
            with open(text) as f:
                text = f.read()
        n_omega, cls = parse_omega_aa(text, graph)
        edge_cls = torch.as_tensor(cls[graph.aa[graph.pi_idx],
                                       graph.aa[graph.pj_idx]],
                                   device=device)
        n_pom = n_omega * B
    else:                                   # +-1..6 chemical distances
        D = aamod.load_distance(AADIST_FILES[abs(ad)])
        D = D / D.max()                     # reference: GetDaa normalization
        edge_d = torch.as_tensor(D[graph.aa[graph.pi_idx],
                                   graph.aa[graph.pj_idx]], **f64)
        n_pom = 2 * B

    def unpack(x):
        t = x[:nb]
        k = nb
        kappa = x[k:k + nkappa] if nkappa else x.new_full(
            (5 if spec.hkyREV else 1,), spec.kappa)
        k += nkappa
        pom = x[k:k + n_pom].reshape(B, -1)
        return t, kappa, pom

    def fitness(pom_b):
        return (-pom_b[0] * (chem_p - pom_b[1]) ** 2
                - pom_b[2] * (chem_v - pom_b[3]) ** 2)

    def w_pair_of(pom_b):
        if ad in (11, 12):
            fit = fitness(pom_b)
            w = torch.exp(-fit[aa_i] - fit[aa_j])
            if ad == 12:
                w = w * pom_b[4]
        elif ad == 7:
            w = pom_b[edge_cls]
        else:
            w = pom_b[0] * edge_d
            w = torch.exp(-w) if ad > 0 else torch.clamp_min(1.0 - w, 1e-8)
            w = w * pom_b[1]
        return torch.where(nonsyn, w, torch.ones_like(w))

    def model_at(x):
        x = x.to(dtype)
        t, kappa, pom = unpack(x)
        s = codonmod.mutation_part(G, kappa if spec.hkyREV else kappa[0],
                                   pf3x4, spec.hkyREV)
        if ad in (11, 12):
            paaC = torch.exp(2.0 * fitness(pom[0]))
            paaC = paaC / paaC.sum()
            pi_use = pi / paa0[G.aa] * paaC[G.aa]
        else:
            pi_use = pi
        Qs, scales = [], []
        for b in range(B):
            w_pair = w_pair_of(pom[b])
            Qs.append(codonmod.build_Q_pair(G, s, w_pair, pi_use))
            scales.append(1.0 / codonmod.mean_rate_pair(G, s, w_pair,
                                                        pi_use))
        ts = _scatter_t(t, bn, nnode)[:, None] * torch.stack(scales)[None]
        P_all = pmat_rev_multi(torch.stack(Qs), pi_use, ts)  # [nnode, B..]
        P = P_all[:, :1] if B == 1 else P_all[nodes_t, btype_t][:, None]
        return P, pi_use[None, :], x.new_ones(1)

    neg_lnl = _neg_lnl(model_at, tips, fpatt, topo)
    # an evaluation reads nothing on the host: the fits may replay it
    # from a CUDA graph
    neg_lnl.capturable = True
    x0 = list(_blen_x0(topo))
    bounds = [(BLEN_MIN, BLEN_MAX)] * nb
    if nkappa:
        x0 += [spec.kappa] * nkappa
        bounds += [(KAPPA_MIN, KAPPA_MAX)] * nkappa
    if ad in (11, 12):
        per = [0.5, 0.5, 0.5, 0.5] + ([spec.omega] if ad == 12 else [])
    elif ad == 7:
        per = [spec.omega] * (n_pom // B)
    else:
        per = [0.5, spec.omega]
    x0 += per * B
    bounds += [(OMEGA_MIN, OMEGA_MAX)] * n_pom
    return neg_lnl, unpack, np.array(x0), bounds, pi_np


def aadist_starts(spec: CodemlSpec, topo: Topology, x0: np.ndarray,
                  bounds) -> list[np.ndarray]:
    """The extra starts of an aaDist fit: the (kappa, omega class) surface
    is multimodal (mtCDNAape under aaDist = 7 has a local optimum with
    kappa at its bound some 900 lnL below the global one), so the starts
    spread over kappa x a scale of the omega parameters, as the
    reference's advice to rerun from new initials."""
    nb = len(topo.branch_nodes())
    n_pom = len(x0) - nb - _nkappa(spec)
    lo = [b[0] for b in bounds]
    hi = [b[1] for b in bounds]
    multi = []
    for kap in ([None] if spec.fix_kappa or spec.hkyREV
                else [None, 5.0, 20.0]):
        for scale in (1.0, 0.1, 3.0):
            if kap is None and scale == 1.0:
                continue               # x0 itself
            st = x0.copy()
            if kap is not None:
                st[nb] = kap
            st[-n_pom:] = np.asarray(x0[-n_pom:]) * scale
            multi.append(np.clip(st, lo, hi))
    return multi


def _fit_aadist(data, topo, spec, *, device,
                dtype=torch.float64) -> CodemlResult:
    neg_lnl, unpack, x0, bounds, pi_np = make_aadist_objective(
        data, topo, spec, device=device, dtype=dtype)
    res = maximize(neg_lnl, x0, bounds, device=device,
                   multi_start=aadist_starts(spec, topo, x0, bounds))
    with torch.no_grad():
        t, kappa, pom = unpack(torch.as_tensor(res.x, dtype=torch.float64))
    return CodemlResult(
        lnL=res.lnL, blens=t.numpy(), branch_nodes=topo.branch_nodes(),
        kappa=kappa.numpy(), params={"pomega": pom.numpy()}, pi=pi_np,
        np=len(res.x), topo=topo, fit=res, x=np.asarray(res.x), spec=spec)


# --- several genes (Mgene) -----------------------------------------------------

def make_codon_mgene_objective(data: seqio.PackedData, topo: Topology,
                               spec: CodemlSpec, Mgene: int, *, device,
                               dtype=torch.float64):
    """Multi-gene codon M0 (reference: SetPGene, src/codeml.c:2421;
    MultipleGenes, src/treesub.c:5170; the ctl's 'codon: 0:rates,
    1:separate, 2:diff pi, 3:diff kappa, 4:all diff').  x: t[nb],
    rgene[ngene - 1], then one (kappa, omega) set (Mgene 0 / 2) or one per
    gene (3 / 4).  pi pooled for Mgene 0 / 3, per gene for 2 / 4; each
    gene's Q normalized by its own mean rate, its branch lengths scaled by
    rgene_g (gene 0 has rate 1).  Each gene's likelihood is a pruning pass
    of its own over its patterns.  Returns (neg_lnl, unpack, x0, bounds,
    the frequencies of each gene); neg_lnl as in `make_aa_objective`, with
    no model_at."""
    if Mgene not in (0, 2, 3, 4):
        raise ValueError(f"Mgene {Mgene} not handled here (1 = separate)")
    device = torch.device(device)
    f64 = dict(dtype=dtype, device=device)
    codonf = _codonf(spec)
    graph = codonmod.codon_graph(spec.icode)
    G = codonmod.pair_tables(spec.icode, device)
    ngene = data.ngene
    per_pi = Mgene in (2, 4)
    per_rates = Mgene in (3, 4)
    pis, pfs, tips_g, fpatt_g = [], [], [], []
    for g in range(ngene):
        sl = data.gene_slice(g)
        if per_pi:
            pm = data.pos_masks[:, sl] if data.pos_masks is not None \
                else None
            fc, f3, f1 = codonmod.count_codon_freqs(
                data.tip_partials[:, sl], data.fpatt[sl], graph, pm)
        else:
            fc, f3, f1 = codonmod.count_codon_freqs(
                data.tip_partials, data.fpatt, graph, data.pos_masks)
        pis.append(codonmod.codon_pi(codonf, fc, f3, f1, graph))
        pfs.append(codonmod.mg_pf3x4(codonf, f3, f1))
        tips_g.append(_codon_tips(data.tip_partials[:, sl], device, dtype))
        cuda_pruning.check_tips(tips_g[-1], graph.n)
        fpatt_g.append(torch.as_tensor(data.fpatt[sl], **f64))
    pis_t = [torch.as_tensor(p, **f64) for p in pis]
    nb = len(topo.branch_nodes())
    bn = torch.as_tensor(topo.branch_nodes(), device=device)
    nkappa1 = _nkappa(spec)
    nsets = ngene if per_rates else 1
    nrgene = ngene - 1

    def fixed_omega(gset):
        # reference: with Mgene >= 3 and fix_omega only the last
        # partition's omega is fixed (codeml.c:2425)
        return spec.fix_omega and (not per_rates or gset == nsets - 1)

    def unpack(x):
        t = x[:nb]
        rgene = torch.cat([x.new_ones(1), x[nb:nb + nrgene]])
        k = nb + nrgene
        kaps, oms = [], []
        for gset in range(nsets):
            if nkappa1:
                kaps.append(x[k:k + nkappa1])
                k += nkappa1
            else:
                kaps.append(x.new_full((5 if spec.hkyREV else 1,),
                                       spec.kappa))
            if fixed_omega(gset):
                oms.append(x.new_full((), spec.omega))
            else:
                oms.append(x[k])
                k += 1
        return t, rgene, kaps, oms

    def neg_lnl(x, lnf=pruning.class_site_lnf):
        x = x.to(dtype)
        t, rgene, kaps, oms = unpack(x)
        tfull = _scatter_t(t, bn, topo.nnode)
        total = x.new_zeros(())
        for g in range(ngene):
            gset = g if per_rates else 0
            kap, om = kaps[gset], oms[gset]
            s = codonmod.mutation_part(G, kap if spec.hkyREV else kap[0],
                                       pfs[g], spec.hkyREV)
            Q = codonmod.build_Q(G, s, om, pis_t[g])
            mr = codonmod.mean_rate(G, s, om, pis_t[g])
            P = pmat_rev(Q, pis_t[g], (tfull * rgene[g] / mr)[:, None])
            total = total + pruning.lnL(P, tips_g[g], topo,
                                        pis_t[g].expand(1, graph.n),
                                        x.new_ones(1), fpatt_g[g], lnf=lnf)
        return -total

    neg_lnl.tips, neg_lnl.fpatt, neg_lnl.topo = tips_g, fpatt_g, topo
    # an evaluation reads nothing on the host: the fits may replay it
    # from a CUDA graph
    neg_lnl.capturable = True
    x0 = list(_blen_x0(topo)) + [1.0] * nrgene
    bounds = [(BLEN_MIN, BLEN_MAX)] * nb + [(0.01, 99.0)] * nrgene
    for gset in range(nsets):
        x0 += [spec.kappa] * nkappa1
        bounds += [(KAPPA_MIN, KAPPA_MAX)] * nkappa1
        if not fixed_omega(gset):
            x0 += [spec.omega]
            bounds += [(OMEGA_MIN, OMEGA_MAX)]
    return neg_lnl, unpack, np.array(x0), bounds, pis


def gene_slice(data: seqio.PackedData, g: int) -> seqio.PackedData:
    """One gene of a multi-gene PackedData (reference: MultipleGenes'
    in-place pointer shuffle, src/treesub.c:5170)."""
    sl = data.gene_slice(g)
    lg = (int(data.lgene[g]) if data.lgene is not None
          else int(np.asarray(data.fpatt[sl]).sum()))
    return _dc_replace(
        data, tip_partials=data.tip_partials[:, sl],
        fpatt=data.fpatt[sl], ls=lg, ngene=1,
        posG=np.array([0, sl.stop - sl.start]),
        pos_masks=(data.pos_masks[:, sl] if data.pos_masks is not None
                   else None),
        site_pattern=None, pattern_site=None, lgene=None)


def fit_mgene_separate(data: seqio.PackedData, topo: Topology,
                       spec: CodemlSpec, *, device,
                       dtype=None) -> list[CodemlResult]:
    """Mgene = 1: an independent fit per gene (reference: MultipleGenes,
    src/treesub.c:5170)."""
    return [fit_packed(gene_slice(data, g), topo, spec, device=device,
                       dtype=dtype)
            for g in range(data.ngene)]


def fit_codon_mgene(data: seqio.PackedData, topo: Topology,
                    spec: CodemlSpec, Mgene: int, *, device,
                    dtype=torch.float64) -> CodemlResult:
    neg_lnl, unpack, x0, bounds, pis = make_codon_mgene_objective(
        data, topo, spec, Mgene, device=device, dtype=dtype)
    res = maximize(neg_lnl, x0, bounds, device=device)
    with torch.no_grad():
        t, rgene, kaps, oms = unpack(torch.as_tensor(res.x,
                                                     dtype=torch.float64))
    return CodemlResult(
        lnL=res.lnL, np=len(res.x), blens=t.numpy(),
        branch_nodes=topo.branch_nodes(),
        kappa=np.asarray([float(k[0]) for k in kaps]),
        params={"rgene": rgene.numpy(),
                "omegas": np.asarray([float(o) for o in oms])},
        pi=pis[0], topo=topo, fit=res, x=np.asarray(res.x), spec=spec)
