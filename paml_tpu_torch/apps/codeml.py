"""codeml: maximum likelihood for codon alignments (M0 and NSsites).

Port of the codon slice of `paml_tpu/apps/codeml.py`: one omega per site
class, class frequencies, and mixture normalization through the two flux
scalars (reference: Qfactor_NS, src/codeml.c:2580-2663); the site classes
ride the class axis of the pruning engine (reference: fhK / lfundG,
src/treesub.c:7608-7760).

Covered: seqtype 1, model 0, NSsites 0 (M0), 1 (M1a), 2 (M2a) and 3 (M3);
CodonFreq Fequal, F1x4, F3x4, F61 (`Fcodon`), F1x4MG and F3x4MG, with
hkyREV; fix_blength 0, 1 and 2.  Every other setting raises
NotImplementedError naming its ROADMAP item.

The parameter vector keeps the JAX package's layout (`unpack`), so the same
x means the same model in both packages.  Fits run in float64 on the
device the caller names.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import pruning
from ..core.optim import FitResult, maximize, simplex_decode
from ..core.pmat import pmat_rev_multi
from ..core.topology import Topology, from_treenode
from ..io import seqio, treeio
from ..models import codon as codonmod

# reference bounds (SetxBound, src/codeml.c:1583 region)
BLEN_MIN, BLEN_MAX = 4e-6, 50.0
KAPPA_MIN, KAPPA_MAX = 1e-4, 999.0
OMEGA_MIN, OMEGA_MAX = 1e-4, 999.0     # M0 omega (rateb)
W_MIN, W_MAX = 1e-6, 999.0             # NSsites omegas
P_MIN, P_MAX = 1e-5, 0.99999           # raw proportions
TRANS_MIN, TRANS_MAX = -99.0, 99.0     # transformed proportions

NSSITES_NONE, M1A, M2A, M3 = 0, 1, 2, 3

CODON_FREQS = ("Fequal", "F1x4", "F3x4", "Fcodon", "F1x4MG", "F3x4MG")


@dataclass
class CodemlSpec:
    """The JAX package's `CodemlSpec`, field for field."""
    seqtype: int = 1             # 1 codon, 2 aa
    model: int = 0               # 0 one-ratio; 1 free-ratio; 2 branch labels
    NSsites: int = 0
    codonf: str = "F3x4"         # Fequal F1x4 F3x4 Fcodon (F61) F1x4MG F3x4MG
    icode: int = 0
    ncatG: int = 3               # classes for M3
    fix_kappa: bool = False
    kappa: float = 2.0
    fix_omega: bool = False
    omega: float = 0.4
    Mgene: int = 0
    clock: int = 0
    fix_blength: int = 0         # 0 ignore tree lengths; 1 initials; 2 fixed
    aaDist: int = 0
    omegaAA: str | None = None
    fix_alpha: bool = True
    alpha: float = 0.0
    cleandata: bool = False
    hkyREV: bool = False
    estFreq: bool = False
    getSE: bool = False
    aa_model: str = "Empirical_F"
    aa_rate_file: str | None = None
    tipdate: bool = False
    tipdate_timeunit: float | None = None


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
    todo = []
    if spec.seqtype != 1 or spec.aaDist or (data is not None
                                            and data.ngene > 1):
        todo.append("amino-acid data, aaDist and Mgene: ROADMAP A9")
    if spec.model != 0:
        todo.append(f"model = {spec.model}: ROADMAP A4")
    if spec.NSsites not in (NSSITES_NONE, M1A, M2A, M3):
        todo.append(f"NSsites = {spec.NSsites}: ROADMAP A2")
    if spec.codonf in ("FMutSel", "FMutSel0") or spec.estFreq:
        todo.append(f"CodonFreq {spec.codonf}: ROADMAP A5")
    elif _codonf(spec) not in CODON_FREQS:
        raise ValueError(f"unknown codonf {spec.codonf}")
    if spec.clock or spec.tipdate:
        todo.append("clocks and TipDate: ROADMAP A6")
    if spec.getSE:
        todo.append("getSE: ROADMAP A3")
    if todo:
        raise NotImplementedError("paml_tpu_torch does not cover "
                                  + "; ".join(todo))


# --- NSsites class builders ------------------------------------------------

def nssites_nparams(NSsites: int, ncatG: int, fix_omega: bool) -> int:
    """Number of distribution parameters after kappa."""
    if NSsites == M1A:
        return 2                       # p0, w0
    if NSsites == M2A:
        return 3 + (0 if fix_omega else 1)   # p0, p1 (transformed), w0, [w2]
    if NSsites == M3:
        return (ncatG - 1) + ncatG
    raise NotImplementedError(f"NSsites {NSsites}: ROADMAP A2")


def nssites_classes(NSsites: int, theta: torch.Tensor, ncatG: int,
                    fix_omega: bool, omega_fix: float):
    """(omegas [K], freqs [K]) from the distribution parameter vector."""
    one = theta.new_ones(())
    if NSsites == M1A:
        p0, w0 = theta[0], theta[1]
        return torch.stack([w0, one]), torch.stack([p0, 1.0 - p0])
    if NSsites == M2A:
        p = simplex_decode(theta[:2])
        w2 = theta.new_tensor(omega_fix) if fix_omega else theta[3]
        return torch.stack([theta[2], one, w2]), p
    if NSsites == M3:
        p = simplex_decode(theta[:ncatG - 1])
        return theta[ncatG - 1:ncatG - 1 + ncatG], p
    raise NotImplementedError(f"NSsites {NSsites}: ROADMAP A2")


def nssites_x0_bounds(NSsites: int, ncatG: int, fix_omega: bool,
                      omega0: float):
    if NSsites == M1A:
        return [0.7, 0.2], [(P_MIN, P_MAX), (W_MIN, 1.0)]
    if NSsites == M2A:
        x0 = [1.0, 0.5, 0.2]
        b = [(TRANS_MIN, TRANS_MAX)] * 2 + [(W_MIN, 1.0)]
        if not fix_omega:
            x0.append(max(2.0, omega0))
            b.append((1.0, W_MAX))
        return x0, b
    if NSsites == M3:
        x0 = [0.0] * (ncatG - 1) + list(np.linspace(0.1, 1.2, ncatG))
        return x0, ([(TRANS_MIN, TRANS_MAX)] * (ncatG - 1)
                    + [(W_MIN, W_MAX)] * ncatG)
    raise NotImplementedError(f"NSsites {NSsites}: ROADMAP A2")


def nssites_extra_starts(NSsites: int, ncatG: int, fix_omega: bool):
    """Additional theta starting points for multimodal NSsites surfaces."""
    if NSsites == M3:
        outs = []
        for ws in ([0.01, 0.2, 0.9], [0.05, 0.5, 3.0], [0.3, 1.0, 5.0]):
            w = (list(np.linspace(ws[0], ws[-1], ncatG)) if ncatG != 3
                 else list(ws))
            outs.append([0.0] * (ncatG - 1) + w)
        return outs
    if NSsites == M2A:
        out = [[2.0, 0.3, 0.05], [0.0, -1.0, 0.5]]
        if not fix_omega:
            out = [o + [w2] for o, w2 in zip(out, [5.0, 1.5])]
        return out
    if NSsites == M1A:
        return [[0.9, 0.05]]
    return []


# --- objective -------------------------------------------------------------

def _codon_tips(tip_partials: np.ndarray, device, dtype) -> torch.Tensor:
    """Tip data on the device: int32 state codes [ns, H] when every tip is
    resolved (the tip product becomes a gather), else [ns, H, n] partials."""
    tips_np = np.asarray(tip_partials)
    if tips_np.ndim == 3 and tips_np.shape[0] and \
            (tips_np.sum(-1) == 1).all() and tips_np.max() == 1:
        return torch.as_tensor(tips_np.argmax(-1).astype(np.int32),
                               device=device)
    return torch.as_tensor(tips_np, dtype=dtype, device=device)


def make_codon_objective(data: seqio.PackedData, topo: Topology,
                         spec: CodemlSpec, *, device,
                         dtype=torch.float64):
    """(neg_lnl, unpack, classes_for, x0, bounds, pi) as in the JAX package;
    neg_lnl maps a 1-D tensor x on `device` to -lnL."""
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
    T = codonmod.dense_tables(spec.icode, device, dtype)

    branch_nodes = topo.branch_nodes()
    nb = len(branch_nodes)
    bn = torch.as_tensor(branch_nodes, dtype=torch.int64, device=device)
    nnode, n = topo.nnode, graph.n
    NS, ncatG = spec.NSsites, spec.ncatG
    nkappa = 0 if spec.fix_kappa else (5 if spec.hkyREV else 1)
    n_time = 0 if spec.fix_blength == 2 else nb
    if NS == NSSITES_NONE:
        n_theta = 0 if spec.fix_omega else 1
    else:
        n_theta = nssites_nparams(NS, ncatG, spec.fix_omega)

    def unpack(x):
        t = x[:n_time]
        k = n_time
        kappa = x[k:k + nkappa] if nkappa else torch.as_tensor(
            [spec.kappa] * (5 if spec.hkyREV else 1), dtype=dtype,
            device=x.device)
        k += nkappa
        theta = x[k:k + n_theta]
        return t, kappa, theta

    def classes_for(theta):
        """W [1, K], freqs [K] and the scale mode."""
        if NS == NSSITES_NONE:
            w = (theta.new_tensor(spec.omega) if spec.fix_omega
                 else theta[0])
            return w.reshape(1, 1), theta.new_ones(1), "per_Q"
        omegas, freqs = nssites_classes(NS, theta, ncatG, spec.fix_omega,
                                        spec.omega)
        return omegas.reshape(1, -1), freqs, "mixture"

    def model_at(x):
        """P [nnode, K, n, n], root frequencies per class [K, n] and class
        weights [K] at parameter vector x."""
        x = x.to(dtype)
        t, kappa, theta = unpack(x)
        W, freqs, scale_mode = classes_for(theta)
        K = W.shape[1]
        s_d = codonmod.mutation_dense(
            T, kappa if spec.hkyREV else kappa[0], pf3x4, spec.hkyREV)
        rs, ra = codonmod.flux_dense(T, s_d, pi)
        w_flat = W.reshape(-1)                              # [K]
        Qs = codonmod.build_Q_dense(T, s_d, w_flat, pi)     # [K, n, n]
        if scale_mode == "per_Q":
            scale = 1.0 / (rs + ra * w_flat)
        else:
            wbar = torch.sum(W * freqs[None, :], dim=1)     # [1]
            scale = (1.0 / (rs + ra * wbar)).repeat_interleave(K)
        if spec.fix_blength == 2:
            tfull = torch.as_tensor(topo.blen0, dtype=dtype, device=device)
        else:
            tfull = torch.zeros(nnode, dtype=dtype,
                                device=device).index_put((bn,), t)
        ts = tfull[:, None] * scale[None, :]                # [nnode, K]
        P = pmat_rev_multi(Qs, pi, ts)                      # [nnode,K,n,n]
        return P, pi.expand(K, n), freqs

    def neg_lnl(x):
        P, piC, freqs = model_at(x)
        return -pruning.lnL(P, tips, topo, piC, freqs, fpatt)

    neg_lnl.model_at = model_at
    neg_lnl.tips, neg_lnl.fpatt, neg_lnl.topo = tips, fpatt, topo

    # x0 / bounds
    if spec.fix_blength == 2:
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
    if NS == NSSITES_NONE:
        x0 += [spec.omega] * n_theta
        bounds += [(OMEGA_MIN, OMEGA_MAX)] * n_theta
    else:
        th0, thb = nssites_x0_bounds(NS, ncatG, spec.fix_omega, spec.omega)
        x0 += th0
        bounds += thb
    return neg_lnl, unpack, classes_for, np.array(x0), bounds, pi_np


def fit(seqfile: str, treefile: str, spec: CodemlSpec | None = None, *,
        device, tree_index: int = 0) -> CodemlResult:
    """Read a PHYLIP codon alignment and a tree file, then `fit_packed`."""
    spec = spec or CodemlSpec()
    check_slice(spec)
    aln = seqio.read_alignment(seqfile, seqio.CODON_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata, icode=spec.icode)
    trees = treeio.read_trees(treefile, data.names)
    topo = from_treenode(trees[tree_index], data.names)
    return fit_packed(data, topo, spec, device=device)


def fit_packed(data: seqio.PackedData, topo: Topology, spec: CodemlSpec, *,
               device) -> CodemlResult:
    """Fit a codon model in float64 on `device` (scipy L-BFGS-B over the
    device's value + gradient), with the NSsites multi-start."""
    neg_lnl, unpack, classes_for, x0, bounds, pi_np = \
        make_codon_objective(data, topo, spec, device=device)
    multi = None
    if spec.NSsites:
        extras = nssites_extra_starts(spec.NSsites, spec.ncatG,
                                      spec.fix_omega)
        n_theta = nssites_nparams(spec.NSsites, spec.ncatG, spec.fix_omega)
        multi = []
        for th in extras:
            if len(th) != n_theta:
                continue
            s = x0.copy()
            s[-n_theta:] = th
            multi.append(s)
    res = maximize(neg_lnl, x0, bounds, device=device, multi_start=multi)
    with torch.no_grad():
        t, kappa, theta = unpack(torch.as_tensor(res.x,
                                                 dtype=torch.float64))
        W, freqs, _ = classes_for(theta)
    params = {"theta": theta.numpy(), "W": W.numpy(),
              "freqs": freqs.numpy()}
    return CodemlResult(
        lnL=res.lnL, np=len(res.x), blens=t.numpy(),
        branch_nodes=topo.branch_nodes(), kappa=kappa.numpy(),
        params=params, pi=pi_np, topo=topo, fit=res, x=np.asarray(res.x),
        spec=spec, class_omegas=W.numpy(), class_freqs=freqs.numpy())
