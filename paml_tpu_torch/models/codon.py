"""Codon substitution models (the codeml codon family).

Port of `paml_tpu/models/codon.py`.  The numpy half is copied as it is:
the codon graph (`codon_graph`), data-derived codon frequencies
(`count_codon_freqs`, `codon_pi`, `mg_pf3x4`) and the dense [n, n] pair
tables (`_dense_tables`).  The per-evaluation half is PyTorch: the dense,
scatter-free Q build (`mutation_dense`, `build_Q_dense`, `flux_dense`) of
the models whose frequencies are data, and the pair form
(`mutation_part`, `flux`, `build_Q` over the single-difference pairs) of
the mutation-selection models FMutSel / FMutSel0, whose frequencies are
parameters (`fmutsel_pi`, `fmutsel_multiplier`), and of the models with an
omega per pair (`build_Q_pair`, `mean_rate_pair`: aaDist).  NSsites class matrices
are Q_k = Qsyn + omega_k * Qnonsyn; all class normalizations come from the
two flux scalars (rs, ra).  `branch_dnds` is the report's dN and dS per
branch.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..constants import geneticcode_table, sense_codons

CODON_FREQ_MODELS = ["Fequal", "F1x4", "F3x4", "Fcodon",
                     "F1x4MG", "F3x4MG", "FMutSel0", "FMutSel"]


@dataclass(frozen=True)
class CodonGraph:
    icode: int
    n: int                     # number of sense codons
    sense: np.ndarray          # [n] codon index 0..63
    aa: np.ndarray             # [n] amino-acid index
    pos_nt: np.ndarray         # [n, 3] nucleotide (TCAG idx) at each position
    # single-difference pairs, i < j (indices into the sense list):
    pi_idx: np.ndarray         # [m]
    pj_idx: np.ndarray         # [m]
    pos: np.ndarray            # [m] changed codon position 0..2
    nt_i: np.ndarray           # [m] nucleotide in codon i at pos
    nt_j: np.ndarray           # [m]
    is_ts: np.ndarray          # [m] transition?
    gtr_class: np.ndarray      # [m] 0..5 = TC TA TG CA CG AG
    is_syn: np.ndarray         # [m]
    # unchanged positions (for Muse-Gaut multipliers): values and which row
    unch_pos: np.ndarray       # [m, 2] codon-position index of unchanged
    unch_nt: np.ndarray        # [m, 2] nucleotide at those positions


@lru_cache(maxsize=None)
def codon_graph(icode: int = 0) -> CodonGraph:
    sense = sense_codons(icode)
    tab = geneticcode_table(icode)
    n = len(sense)
    pos_nt = np.stack([sense // 16, (sense // 4) % 4, sense % 4], axis=1)
    aa = tab[sense]

    pi_l, pj_l, pos_l, nti_l, ntj_l = [], [], [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            diff = np.nonzero(pos_nt[i] != pos_nt[j])[0]
            if len(diff) != 1:
                continue
            p = int(diff[0])
            pi_l.append(i)
            pj_l.append(j)
            pos_l.append(p)
            nti_l.append(int(pos_nt[i, p]))
            ntj_l.append(int(pos_nt[j, p]))
    pi_idx = np.array(pi_l, dtype=np.int32)
    pj_idx = np.array(pj_l, dtype=np.int32)
    pos = np.array(pos_l, dtype=np.int32)
    nt_i = np.array(nti_l, dtype=np.int32)
    nt_j = np.array(ntj_l, dtype=np.int32)
    # transitions: T<->C (0,1) or A<->G (2,3)
    s = nt_i + nt_j
    is_ts = (s == 1) | (s == 5)
    # GTR class by sorted changed pair: TC TA TG CA CG AG
    lo = np.minimum(nt_i, nt_j)
    hi = np.maximum(nt_i, nt_j)
    gtr_map = {(0, 1): 0, (0, 2): 1, (0, 3): 2, (1, 2): 3, (1, 3): 4, (2, 3): 5}
    gtr_class = np.array([gtr_map[(int(a), int(b))] for a, b in zip(lo, hi)],
                         dtype=np.int32)
    is_syn = aa[pi_idx] == aa[pj_idx]
    other = np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int32)
    unch_pos = other[pos]                                   # [m, 2]
    unch_nt = pos_nt[pi_idx[:, None], unch_pos]             # [m, 2]
    return CodonGraph(icode=icode, n=n, sense=sense, aa=aa, pos_nt=pos_nt,
                      pi_idx=pi_idx, pj_idx=pj_idx, pos=pos,
                      nt_i=nt_i, nt_j=nt_j, is_ts=np.asarray(is_ts),
                      gtr_class=gtr_class, is_syn=np.asarray(is_syn),
                      unch_pos=unch_pos, unch_nt=unch_nt)


# ---------------------------------------------------------------------------
# codon frequencies from data (reference: InitializeCodon, src/codeml.c:3772)
# ---------------------------------------------------------------------------

def count_codon_freqs(tip_partials: np.ndarray, fpatt: np.ndarray,
                      graph: CodonGraph, pos_masks: np.ndarray | None = None):
    """Pooled codon counts over all species/sites -> (fcodon [n],
    f3x4 [3, 4], f1x4 [4]).

    With ambiguity characters present and `pos_masks` given ([ns, H, 3, 4]
    raw per-position nucleotide sets), ambiguous sites are resolved by the
    reference's 20-round iteration (InitializeCodon + AddCodonFreqSeqGene,
    src/codeml.c:3798-3768): each ambiguous codon's count is distributed
    over its compatible sense codons (resp. bases) in proportion to the
    current frequency estimates.

    tip_partials may also be integer state codes [ns, H] (clean data)."""
    tip_partials = np.asarray(tip_partials)
    if tip_partials.ndim == 2:
        ns = tip_partials.shape[0]
        fcodon = np.bincount(tip_partials.reshape(-1),
                             weights=np.tile(np.asarray(fpatt, float), ns),
                             minlength=graph.n)
        fcodon = fcodon / max(fcodon.sum(), 1e-300)
        f3 = np.zeros((3, 4))
        for p in range(3):
            for b in range(4):
                f3[p, b] = fcodon[graph.pos_nt[:, p] == b].sum()
        f1 = f3.mean(0)
        return (fcodon, f3 / f3.sum(1, keepdims=True), f1 / f1.sum())
    resolved = tip_partials.sum(-1) == 1
    w = tip_partials * (resolved[..., None] * fpatt[None, :, None])
    fcodon = w.sum((0, 1))
    fcodon = fcodon / max(fcodon.sum(), 1e-300)

    def marginals(fc):
        f3 = np.zeros((3, 4))
        for p in range(3):
            for b in range(4):
                f3[p, b] = fc[graph.pos_nt[:, p] == b].sum()
        f1 = f3.mean(0)
        return f3 / f3.sum(1, keepdims=True), f1 / f1.sum()

    f3x4, f1x4 = marginals(fcodon)

    has_ambig = not bool(resolved.all())
    if has_ambig and pos_masks is not None:
        # initial per-position counts from resolved positions of ALL sites
        fb3 = (pos_masks * (pos_masks.sum(-1, keepdims=True) == 1)
               * fpatt[None, :, None, None]).sum((0, 1)).astype(float)
        fb3 = fb3 / np.maximum(fb3.sum(1, keepdims=True), 1e-300)
        fb4 = fb3.mean(0)
        fb4 = fb4 / fb4.sum()
        fc0, f30, f40 = fcodon.copy(), fb3.copy(), fb4.copy()
        flat_sets = tip_partials > 0                       # [ns, H, n]
        for _ in range(20):
            # codon counts: distribute over compatible sense codons
            denom = flat_sets @ fc0                        # [ns, H]
            denom = np.maximum(denom, 1e-300)
            contrib = (flat_sets * fc0[None, None, :]
                       * (fpatt[None, :] / denom)[..., None])
            fc = contrib.sum((0, 1))
            fc = fc / max(fc.sum(), 1e-300)
            # per-position counts: distribute over compatible bases
            f3 = np.zeros((3, 4))
            f4 = np.zeros(4)
            for p in range(3):
                sel = pos_masks[:, :, p, :]                # [ns, H, 4]
                d3 = np.maximum(sel @ f30[p], 1e-300)
                f3[p] = (sel * f30[p][None, None, :]
                         * (fpatt[None, :] / d3)[..., None]).sum((0, 1))
                d4 = np.maximum(sel @ f40, 1e-300)
                f4 += (sel * f40[None, None, :]
                       * (fpatt[None, :] / d4)[..., None]).sum((0, 1))
            f3 = f3 / np.maximum(f3.sum(1, keepdims=True), 1e-300)
            f4 = f4 / max(f4.sum(), 1e-300)
            d = max(np.abs(fc - fc0).max(), np.abs(f3 - f30).max(),
                    np.abs(f4 - f40).max())
            fc0, f30, f40 = fc, f3, f4
            if d < 1e-8:
                break
        fcodon, f3x4, f1x4 = fc0, f30, f40
    return fcodon, f3x4, f1x4


def codon_pi(codonf: str, fcodon, f3x4, f1x4, graph: CodonGraph) -> np.ndarray:
    """Equilibrium codon frequencies under the frequency model."""
    n = graph.n
    if codonf == "Fequal":
        pi = np.full(n, 1.0 / n)
    elif codonf in ("Fcodon", "FMutSel0", "FMutSel"):
        pi = np.asarray(fcodon, dtype=np.float64).copy()
    elif codonf in ("F3x4", "F3x4MG"):
        pi = (f3x4[0][graph.pos_nt[:, 0]] * f3x4[1][graph.pos_nt[:, 1]]
              * f3x4[2][graph.pos_nt[:, 2]])
    elif codonf in ("F1x4", "F1x4MG"):
        pi = (f1x4[graph.pos_nt[:, 0]] * f1x4[graph.pos_nt[:, 1]]
              * f1x4[graph.pos_nt[:, 2]])
    else:
        raise ValueError(f"unknown codonf {codonf}")
    return pi / pi.sum()


def mg_pf3x4(codonf: str, f3x4, f1x4) -> np.ndarray | None:
    """Position-specific frequency table used by the Muse-Gaut multiplier.
    F1x4MG/FMutSel use the position-averaged table (reference writes the
    1x4 table into all three rows, src/codeml.c:3884-3893)."""
    if codonf in ("F3x4MG",):
        return np.asarray(f3x4)
    if codonf in ("F1x4MG", "FMutSel0", "FMutSel"):
        return np.tile(np.asarray(f1x4)[None, :], (3, 1))
    return None



@lru_cache(maxsize=None)
def _dense_tables(icode: int):
    """Dense [n, n] constant tables for scatter-free Q construction.

    TPU scatters serialize; with these masks the per-evaluation Q build
    is pure elementwise/gather work (reference semantics identical to
    eigenQcodon's pair loop, src/codeml.c:3229-3301)."""
    g = codon_graph(icode)
    n = g.n

    def dense(vals, fill=0.0, dt=np.float64):
        D = np.full((n, n), fill, dt)
        D[g.pi_idx, g.pj_idx] = vals
        D[g.pj_idx, g.pi_idx] = vals
        return D

    ts = dense(g.is_ts.astype(np.float64))
    tv = dense((~g.is_ts).astype(np.float64))
    syn = dense(g.is_syn.astype(np.float64))
    nonsyn = dense((~g.is_syn).astype(np.float64))
    gtr = dense(g.gtr_class, fill=6, dt=np.int32)   # 6 = not a pair -> 0
    pairm = dense(np.ones(len(g.pi_idx)))
    # Muse-Gaut divisor index tables: the two unchanged positions of the
    # pair (both orientations share them); 0s off-pairs (divisor -> 1)
    up0 = dense(g.unch_pos[:, 0], dt=np.int32)
    up1 = dense(g.unch_pos[:, 1], dt=np.int32)
    un0 = dense(g.unch_nt[:, 0], dt=np.int32)
    un1 = dense(g.unch_nt[:, 1], dt=np.int32)
    return dict(ts=ts, tv=tv, syn=syn, nonsyn=nonsyn, gtr=gtr,
                pair=pairm, up0=up0, up1=up1, un0=un0, un1=un1)



@dataclass(frozen=True)
class DenseTables:
    """`_dense_tables` as tensors on one device (built once per objective,
    so an evaluation copies nothing from the host)."""
    ts: torch.Tensor
    tv: torch.Tensor
    syn: torch.Tensor
    nonsyn: torch.Tensor
    gtr: torch.Tensor
    up0: torch.Tensor
    up1: torch.Tensor
    un0: torch.Tensor
    un1: torch.Tensor


def dense_tables(icode: int, device, dtype=torch.float64) -> DenseTables:
    T = _dense_tables(icode)

    def f(name):
        return torch.as_tensor(T[name], dtype=dtype, device=device)

    def i(name):
        return torch.as_tensor(T[name], dtype=torch.int64, device=device)

    return DenseTables(ts=f("ts"), tv=f("tv"), syn=f("syn"),
                       nonsyn=f("nonsyn"), gtr=i("gtr"), up0=i("up0"),
                       up1=i("up1"), un0=i("un0"), un1=i("un1"))


def mutation_dense(T: DenseTables, kappa: torch.Tensor, pf3x4=None,
                   hkyrev: bool = False) -> torch.Tensor:
    """Dense symmetric mutation exchangeabilities [n, n] (zero off the
    1-difference pairs).  kappa: [1] HKY kappa or [5] GTR rates (TC TA TG
    CA CG, AG = 1); pf3x4: [3, 4] Muse-Gaut table or None."""
    dtype = T.ts.dtype
    if hkyrev:
        rates7 = torch.cat([kappa.reshape(-1).to(dtype),
                            torch.ones(1, dtype=dtype, device=kappa.device),
                            torch.zeros(1, dtype=dtype, device=kappa.device)])
        s = rates7[T.gtr]
    else:
        s = kappa.reshape(()).to(dtype) * T.ts + T.tv
    if pf3x4 is not None:
        pf = torch.as_tensor(pf3x4, dtype=dtype, device=T.ts.device)
        f1 = pf[T.up0, T.un0]
        f2 = pf[T.up1, T.un1]
        # off-pair cells have s == 0 but would divide 0/0 when a position
        # frequency is exactly zero; clamp the denominator
        s = s / torch.clamp_min(f1 * f2, torch.finfo(dtype).tiny)
    return s


def build_Q_dense(T: DenseTables, s_dense: torch.Tensor, omega,
                  pi: torch.Tensor) -> torch.Tensor:
    """Unnormalized Q [..., n, n] from a dense mutation matrix; omega may
    carry a batch shape [...] (one Q per site class)."""
    omega = torch.as_tensor(omega, dtype=s_dense.dtype,
                            device=s_dense.device)[..., None, None]
    Q = s_dense * (T.syn + omega * T.nonsyn) * pi[None, :]
    return Q - torch.diag_embed(Q.sum(-1))


def flux_dense(T: DenseTables, s_dense: torch.Tensor, pi: torch.Tensor):
    """(rs, ra): synonymous and nonsynonymous flux at omega = 1, so the
    mean rate of Q(omega) is rs + omega * ra."""
    base = pi[:, None] * s_dense * pi[None, :]
    return (base * T.syn).sum(), (base * T.nonsyn).sum()


# ---------------------------------------------------------------------------
# the pair form: Q over the single-difference pairs (i < j)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PairTables:
    """The index arrays of `CodonGraph` as tensors on one device."""
    n: int
    pi_idx: torch.Tensor       # [m] int64
    pj_idx: torch.Tensor
    is_ts: torch.Tensor        # [m] bool
    is_syn: torch.Tensor
    gtr_class: torch.Tensor    # [m] int64
    unch_pos: torch.Tensor     # [m, 2] int64
    unch_nt: torch.Tensor
    pos_nt: torch.Tensor       # [n, 3] int64
    aa: torch.Tensor           # [n] int64


def pair_tables(icode: int, device) -> PairTables:
    g = codon_graph(icode)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.bool,
                               device=device)

    return PairTables(n=g.n, pi_idx=i(g.pi_idx), pj_idx=i(g.pj_idx),
                      is_ts=b(g.is_ts), is_syn=b(g.is_syn),
                      gtr_class=i(g.gtr_class), unch_pos=i(g.unch_pos),
                      unch_nt=i(g.unch_nt), pos_nt=i(g.pos_nt), aa=i(g.aa))


def mutation_part(G: PairTables, kappa: torch.Tensor, pf3x4=None,
                  hkyrev: bool = False) -> torch.Tensor:
    """Symmetric mutation exchangeabilities s [m] of the single-difference
    pairs.  kappa: HKY kappa (one element) or [5] GTR rates (TC TA TG CA
    CG, AG = 1); pf3x4: [3, 4] table of the Muse-Gaut divisors, or None."""
    if hkyrev:
        s = torch.cat([kappa.reshape(-1), kappa.new_ones(1)])[G.gtr_class]
    else:
        s = torch.where(G.is_ts, kappa.reshape(()), kappa.new_ones(()))
    if pf3x4 is not None:
        pf = torch.as_tensor(pf3x4, dtype=s.dtype, device=s.device)
        s = s / (pf[G.unch_pos[:, 0], G.unch_nt[:, 0]]
                 * pf[G.unch_pos[:, 1], G.unch_nt[:, 1]])
    return s


# FMutSel / FMutSel0 mutation-selection models (Yang & Nielsen 2008;
# reference: GetCodonFreqs src/codeml.c:2689, GetMutationMultiplier :3060)

def observed_piAA(fcodon, graph: CodonGraph) -> np.ndarray:
    """Observed amino-acid frequencies pooled from codon frequencies."""
    piAA = np.zeros(20)
    np.add.at(piAA, graph.aa, np.asarray(fcodon))
    return piAA / piAA.sum()


def _mut3(pf, G):
    """Per-codon mutation-bias product pf[b0] pf[b1] pf[b2] ([n]); G is a
    `PairTables` (tensors) or a `CodonGraph` (numpy)."""
    return pf[G.pos_nt[:, 0]] * pf[G.pos_nt[:, 1]] * pf[G.pos_nt[:, 2]]


def fmutsel_pi(codonf: str, pf: torch.Tensor, fit, fcodon_obs,
               G: PairTables) -> torch.Tensor:
    """Equilibrium codon frequencies under FMutSel / FMutSel0.

    pf: [4] normalized mutation-bias nucleotide frequencies.  fit: the
    estimated fitnesses, [n - 1] per codon (FMutSel) or [19] per amino
    acid (FMutSel0), the last one fixed at 0, or None for estFreq = 0.
    Reference: GetCodonFreqs, src/codeml.c:2689-2755."""
    mut3 = _mut3(pf, G)
    obs = torch.as_tensor(fcodon_obs, dtype=pf.dtype, device=pf.device)
    if codonf == "FMutSel":
        if fit is None:
            # npi = 3: the codon frequencies stay at the observed values
            pi = obs
        else:
            pi = mut3 * torch.exp(torch.cat([fit, fit.new_zeros(1)]))
    elif codonf == "FMutSel0":
        if fit is None:
            # npi = 3: mutation bias within a family x observed amino-acid
            # frequencies (codeml.c:2737-2752)
            piAA = obs.new_zeros(20).index_add(0, G.aa, obs)
            piAA = piAA / piAA.sum()
            mutbias = mut3.new_zeros(20).index_add(0, G.aa, mut3)
            pi = mut3 / mutbias[G.aa] * piAA[G.aa]
        else:
            pi = mut3 * torch.exp(torch.cat([fit, fit.new_zeros(1)])[G.aa])
    else:
        raise ValueError(codonf)
    return pi / pi.sum()


def fmutsel_multiplier(G: PairTables, pf: torch.Tensor, pi: torch.Tensor,
                       ls: int) -> torch.Tensor:
    """Fixation-probability multiplier of the single-difference pairs [m].

    eF_i = max(pi_i, small) / mut3_i; the pair factor is (ln eF_a - ln
    eF_b) / (eF_a - eF_b), with the neutral limit 1 / eF_a (reference:
    GetMutationMultiplier, src/codeml.c:3074-3084).  The division by the
    unchanged positions' frequencies is `mutation_part`'s, through the
    tiled pf3x4 table."""
    small = min(1e-6, 1.0 / max(int(ls), 1))
    eF = torch.clamp_min(pi, small) / _mut3(pf, G)
    ea, eb = eF[G.pi_idx], eF[G.pj_idx]
    d = ea - eb
    far = d.abs() > 1e-10
    # ln ea - ln eb as -log1p(-d / ea): the difference of two logs cancels
    # to ~eps / (d / ea) relative, which float32 cannot afford
    ratio = -torch.log1p(-d / ea) / torch.where(far, d, torch.ones_like(d))
    return torch.where(far, ratio, 1.0 / ea)


def selection_coefficients(graph: CodonGraph, pf, pi, kappa, omega,
                           hkyrev: bool, ls: int) -> dict:
    """Per-pair 2Ns selection coefficients and the mutation and
    substitution flux under FMutSel, host numpy (reference:
    SelectionCoefficients, src/codeml.c:3089).  For each single-difference
    pair (a, b) = (pi_idx, pj_idx): Ns_ba = ln(eF_a / eF_b), the 2Ns of b
    -> a, eF = max(pi, small) / mut3; qmut_ba = pi_b q pf[nt_i] (and
    qmut_ab); qsub = qmut x 2Ns / (1 - e^-2Ns), 1 in the neutral limit;
    qsubw the same times omega on nonsynonymous pairs."""
    pf = np.asarray(pf, float)
    pi = np.asarray(pi, float)
    small = min(1e-6, 1.0 / max(int(ls), 1))
    eF = np.maximum(pi, small) / _mut3(pf, graph)
    a, b = graph.pi_idx, graph.pj_idx
    Ns_ba = np.log(eF[a] / eF[b])
    if hkyrev:
        rates6 = np.concatenate([np.asarray(kappa, float).reshape(-1),
                                 [1.0]])
        q = rates6[graph.gtr_class]
    else:
        q = np.where(graph.is_ts, float(np.asarray(kappa).reshape(-1)[0]),
                     1.0)
    qmut_ba = pi[b] * q * pf[graph.nt_i]
    qmut_ab = pi[a] * q * pf[graph.nt_j]
    nz = np.abs(Ns_ba) > 1e-20
    with np.errstate(divide="ignore", invalid="ignore"):   # where's unused side
        qsub_ba = qmut_ba * np.where(nz, Ns_ba / (1 - np.exp(-Ns_ba)), 1.0)
        qsub_ab = qmut_ab * np.where(nz, -Ns_ba / (1 - np.exp(Ns_ba)), 1.0)
    wfac = np.where(graph.is_syn, 1.0, float(omega))
    return {
        "Ns_ba": Ns_ba, "qmut_ba": qmut_ba, "qmut_ab": qmut_ab,
        "qsub_ba": qsub_ba, "qsub_ab": qsub_ab,
        "qsubw_ba": qsub_ba * wfac, "qsubw_ab": qsub_ab * wfac,
        "is_syn": np.asarray(graph.is_syn),
    }


def flux(G: PairTables, s: torch.Tensor, pi: torch.Tensor):
    """(rs, ra): synonymous and nonsynonymous flux at omega = 1."""
    contrib = s * (pi[G.pi_idx] * pi[G.pj_idx]) * 2.0
    zero = torch.zeros_like(contrib)
    return (torch.where(G.is_syn, contrib, zero).sum(),
            torch.where(G.is_syn, zero, contrib).sum())


def build_Q(G: PairTables, s: torch.Tensor, omega: torch.Tensor,
            pi: torch.Tensor) -> torch.Tensor:
    """Unnormalized Q [..., n, n] from the pair exchangeabilities; omega
    may carry a batch shape [...] (one Q per site class)."""
    omega = torch.as_tensor(omega, dtype=s.dtype, device=s.device)
    return build_Q_pair(G, s, torch.where(G.is_syn, omega.new_ones(()),
                                          omega[..., None]), pi)


def mean_rate(G: PairTables, s: torch.Tensor, omega, pi: torch.Tensor):
    """Mean rate of Q(omega): rs + omega ra (`flux`)."""
    rs, ra = flux(G, s, pi)
    return rs + omega * ra


def build_Q_pair(G: PairTables, s: torch.Tensor, w_pair: torch.Tensor,
                 pi: torch.Tensor) -> torch.Tensor:
    """Unnormalized Q [..., n, n] with an omega factor per single-difference
    pair, w_pair [..., m], 1 on the synonymous pairs (reference: GetOmega
    inside eigenQcodon, src/codeml.c:3298-3301, for aaDist, AAClasses and
    the fitness models)."""
    vals = s * w_pair
    Q = vals.new_zeros(vals.shape[:-1] + (G.n, G.n))
    Q[..., G.pi_idx, G.pj_idx] = vals * pi[G.pj_idx]
    Q[..., G.pj_idx, G.pi_idx] = vals * pi[G.pi_idx]
    return Q - torch.diag_embed(Q.sum(-1))


def mean_rate_pair(G: PairTables, s: torch.Tensor, w_pair: torch.Tensor,
                   pi: torch.Tensor) -> torch.Tensor:
    """Mean rate of `build_Q_pair`'s Q."""
    return torch.sum(s * w_pair * pi[G.pi_idx] * pi[G.pj_idx] * 2.0)


def branch_dnds(rs: float, ra: float, omega: float, t: float, ls: int):
    """dN and dS of one branch (reference: eigenQcodon mode = 2,
    src/codeml.c:3357-3377): the expected counts S and N of synonymous and
    nonsynonymous sites and dS, dN for a branch of length t (substitutions
    per codon) under omega, from the two flux scalars of `flux`."""
    w = float(omega)
    mr = rs + w * ra
    rho_s, rho_a = rs / (rs + ra), ra / (rs + ra)
    S, N = rho_s * 3 * ls, rho_a * 3 * ls
    if t <= 0 or mr <= 0:
        return dict(t=float(t), S=S, N=N, w=w, dN=0.0, dS=0.0)
    dS = t * (rs / mr) / (3 * rho_s)
    dN = t * (w * ra / mr) / (3 * rho_a)
    return dict(t=float(t), S=S, N=N, w=(dN / dS if dS > 0 else -1.0),
                dN=dN, dS=dS)
