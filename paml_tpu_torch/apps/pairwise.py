"""Pairwise maximum-likelihood estimation (runmode = -2) and its Bayesian
counterpart (runmode = -3).

Port of `paml_tpu/apps/pairwise.py`:

- Codon pairs: Goldman & Yang (1994) ML of (t, kappa, omega) per pair with
  dN/dS decomposition (reference: PairwiseCodon, src/codeml.c:4344; the
  dS/dN algebra follows eigenQcodon mode=2, :3355-3380).
- Amino-acid pairs: ML distance under an empirical model (reference:
  PairwiseAA, src/codeml.c:5034).
- Nucleotide pairwise distances (closed forms, for baseml's distance
  matrices; reference: SeqDivergence, src/treesub.c:1965).
- Bayesian pairwise dN/dS on a 32 x 32 quadrature grid (BayesPairwise,
  src/codeml.c:4612) and the sliding-window scan (SlidingWindow, :5970).

Each pair is one scipy L-BFGS-B fit through `core/optim.maximize`, in the
JAX package's pair order, from its starts and within its bounds; the
objective (codon Q, the spectral P(t), the pair's log-likelihood) runs on
the device the caller names, and so do the Bayesian grid (one
`pmat_rev_multi` over the 32 omega values x 32 times) and its curvature.
A program's pairs (or windows) share one slot of fixed buffers, filled
between fits and padded to the largest pattern count with weight 0, and
one objective per fit kind: on the card each objective replays one CUDA
graph for the whole program (`optim.GraphCache`), as the JAX package's
`jit` compiles it once per shape.
The curvature is the exact Hessian of the JAX package, taken here by
`torch.autograd.functional.hessian` through `pmat_rev(..., twice=True)`
(`matrix_exp`): the spectral route's backward is differentiable once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.optim import GraphCache, maximize
from ..core.pmat import pmat_rev, pmat_rev_multi
from ..io import seqio
from ..models import aa as aamod
from ..models import codon as codonmod


@dataclass
class MLPair:
    i: int
    j: int
    t: float
    kappa: float
    omega: float
    lnL: float
    S: float = 0.0
    N: float = 0.0
    dS: float = 0.0
    dN: float = 0.0


def _pair_patterns(data: seqio.PackedData, i: int, j: int):
    """Collapse the pair's site patterns; sites where either sequence is
    ambiguous are dropped (pairwise deletion, the reference behavior for
    unclean data: PairwiseCodon, src/codeml.c:4372)."""
    ok = ((data.tip_partials[i].sum(-1) == 1)
          & (data.tip_partials[j].sum(-1) == 1))
    si = data.tip_partials[i, ok].argmax(-1)
    sj = data.tip_partials[j, ok].argmax(-1)
    key = si * data.nstates + sj
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.bincount(inv, weights=data.fpatt[ok], minlength=len(uniq))
    return (uniq // data.nstates).astype(np.int64), \
        (uniq % data.nstates).astype(np.int64), w


class _Slot:
    """Fixed buffers on a device, filled from the host between fits: views
    of one int64 and one float64 buffer (`ints` and `floats` name their
    shapes), each filled by one copy, from pinned memory on the card, which
    makes no host sync.  An objective that reads only such views reads the
    same memory for every pair, so one CUDA graph of it serves them all."""

    def __init__(self, device, ints: dict, floats: dict):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self._copied = None
        self._host, self.views, self._bufs = {}, {}, []
        for spec, dt in ((ints, torch.int64), (floats, torch.float64)):
            sizes = [int(np.prod(shape)) for shape in spec.values()]
            host = torch.zeros(sum(sizes), dtype=dt, pin_memory=pin)
            dev = torch.zeros(sum(sizes), dtype=dt, device=self.device)
            k = 0
            for (name, shape), n in zip(spec.items(), sizes):
                self._host[name] = host.numpy()[k:k + n]
                self.views[name] = dev[k:k + n].view(shape)
                k += n
            self._bufs.append((host, dev))

    def fill(self, **arrays) -> None:
        """Each named view's leading entries from the array, the rest 0."""
        if self._copied is not None:
            self._copied.synchronize()     # the last fill's copies are done
        for name, arr in arrays.items():
            h, arr = self._host[name], np.asarray(arr).reshape(-1)
            h[:arr.size] = arr
            h[arr.size:] = 0
        for host, dev in self._bufs:
            dev.copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()


def _max_patterns(data, pairs) -> int:
    """The largest collapsed pattern count over the pairs (the slot's
    length: `_pair_patterns` is host numpy, so it is known before any
    fit)."""
    return max(len(_pair_patterns(data, i, j)[2]) for i, j in pairs)


class _CodonPair:
    """The codon model of one pair (or window) on a device, in a slot of
    fixed buffers: the frequencies, the Muse-Gaut divisors and the pair's
    collapsed patterns, padded to `hmax` patterns (default: this pair's
    count) with state 0 and weight 0, and the fixed kappa and 1.0 as 0-d
    tensors.  `load` fills the slot with another pair between fits;
    `loglik` reads only the slot, so one objective, and one CUDA graph of
    it, serves every pair of a program, on the card and on the CPU
    alike."""

    def __init__(self, data, i, j, codonf, G, graph, device, floor_fcodon,
                 hmax=None, kappa=2.0):
        self.codonf, self.G, self.graph = codonf, G, graph
        self.floor_fcodon = floor_fcodon
        self.device = torch.device(device)
        self.hmax = hmax or _max_patterns(data, [(i, j)])
        floats = {"w": (self.hmax,), "pi": (G.n,)}
        # the Muse-Gaut models' divisors (which models have them does not
        # depend on the frequencies)
        if codonmod.mg_pf3x4(codonf, np.ones((3, 4)), np.ones(4)) is not None:
            floats["pf3x4"] = (3, 4)
        self.slot = _Slot(self.device, {"a": (self.hmax,), "b": (self.hmax,)},
                          floats)
        v = self.slot.views
        self.ia, self.ib, self.wp, self.pi = v["a"], v["b"], v["w"], v["pi"]
        self.pf3x4 = v.get("pf3x4")
        self.logpi = torch.zeros_like(self.pi)
        self.kappa = self.f64(kappa)
        self.one = self.f64(1.0)
        self.load(data, i, j)

    def load(self, data, i, j) -> None:
        """Fill the slot with pair (i, j) of data (its own frequencies, as
        the reference recomputes com.pi per pair: PairwiseCodon,
        src/codeml.c:4448); the pair's patterns stay on the host as a, b,
        w."""
        pm = data.pos_masks[[i, j]] if data.pos_masks is not None else None
        fcodon, f3x4, f1x4 = codonmod.count_codon_freqs(
            data.tip_partials[[i, j]], data.fpatt, self.graph, pm)
        pi_np = codonmod.codon_pi(self.codonf, fcodon, f3x4, f1x4,
                                  self.graph)
        if self.floor_fcodon and self.codonf == "Fcodon":
            pi_np = np.maximum(pi_np, 1e-15)
            pi_np /= pi_np.sum()
        self.a, self.b, self.w = _pair_patterns(data, i, j)
        if len(self.w) > self.hmax:
            raise ValueError(f"pair ({i + 1}, {j + 1}): {len(self.w)} "
                             f"patterns, the slot holds {self.hmax}")
        arrays = dict(a=self.a, b=self.b, w=self.w, pi=pi_np)
        if self.pf3x4 is not None:
            arrays["pf3x4"] = codonmod.mg_pf3x4(self.codonf, f3x4, f1x4)
        self.slot.fill(**arrays)
        torch.log(torch.clamp_min(self.pi, 1e-300), out=self.logpi)

    @property
    def aj(self):
        """The pair's own patterns (unpadded views of the slot)."""
        return self.ia[:len(self.w)]

    @property
    def bj(self):
        return self.ib[:len(self.w)]

    @property
    def wj(self):
        return self.wp[:len(self.w)]

    def f64(self, v):
        return torch.as_tensor(v, dtype=torch.float64, device=self.device)

    def scaled_Q(self, kap, om, s=None):
        """Q / mean rate for one omega, or [W, n, n] for an omega vector."""
        if s is None:
            s = codonmod.mutation_part(self.G, kap, self.pf3x4)
        Q = codonmod.build_Q(self.G, s, om, self.pi)
        mr = codonmod.mean_rate(self.G, s, om, self.pi)
        return Q / mr[..., None, None]

    def loglik(self, t, kap, om, twice=False):
        """The pair's log-likelihood over the whole slot (the padding's
        weight 0 adds nothing)."""
        P = pmat_rev(self.scaled_Q(kap, om), self.pi, t[None], twice)[0]
        lp = (self.logpi[self.ia]
              + torch.log(torch.clamp_min(P[self.ia, self.ib], 1e-300)))
        return torch.sum(self.wp * lp)


def pairwise_codon(data: seqio.PackedData, codonf: str = "F3x4",
                   icode: int = 0, kappa0: float = 2.0, omega0: float = 0.4,
                   fix_kappa: bool = False, *, device="cuda") -> list[MLPair]:
    """ML (t, kappa, omega) of every pair, in the JAX package's order: one
    slot for the program, loaded pair by pair, and one objective, which on
    the card replays one CUDA graph for every pair."""
    graph = codonmod.codon_graph(icode)
    G = codonmod.pair_tables(icode, device)
    ls = data.ls
    pairs = [(i, j) for i in range(data.ns) for j in range(i)]
    cp = _CodonPair(data, *pairs[0], codonf, G, graph, device, False,
                    hmax=_max_patterns(data, pairs), kappa=kappa0)

    def neg_lnl(x):
        kap = cp.kappa if fix_kappa else x[1]
        return -cp.loglik(x[0], kap, x[-1])
    neg_lnl.capturable = True

    x0 = np.array([0.5, omega0] if fix_kappa else [0.5, kappa0, omega0])
    bounds = ([(4e-6, 50), (1e-4, 99)] if fix_kappa
              else [(4e-6, 50), (1e-4, 999), (1e-4, 99)])
    out = []
    with GraphCache() as cache:
        for i, j in pairs:
            cp.load(data, i, j)
            res = maximize(neg_lnl, x0, bounds, device=device, cache=cache)
            t = float(res.x[0])
            kap = kappa0 if fix_kappa else float(res.x[1])
            om = float(res.x[-1])
            # dS/dN decomposition: flux at omega=1 (reference eigenQcodon
            # mode=2: rs0/ra0 site proportions; dS = t*rs/mr / (3 rs0)),
            # read back once
            with torch.no_grad():
                s = codonmod.mutation_part(G, cp.kappa.new_full((), kap),
                                           cp.pf3x4)
                rs, ra = torch.stack(codonmod.flux(G, s, cp.pi)).tolist()
            mr = rs + om * ra
            p_s = rs / (rs + ra)
            S = p_s * 3 * ls
            N = (1 - p_s) * 3 * ls
            dS = t * (rs / mr) / (3 * p_s)
            dN = t * (om * ra / mr) / (3 * (1 - p_s))
            out.append(MLPair(i=i, j=j, t=t, kappa=kap, omega=om,
                              lnL=res.lnL, S=S, N=N, dS=dS, dN=dN))
    return out


def pairwise_aa(data: seqio.PackedData, aa_model: str = "Empirical_F",
                rate_file: str | None = None, *,
                device="cuda") -> list[MLPair]:
    """ML distance of every pair under one amino-acid Q: the pairs'
    patterns in one slot, one objective (one CUDA graph on the card)."""
    S, pi_np = aamod.model_S_pi(aa_model, rate_file, data.base_freqs)
    pi = torch.as_tensor(pi_np, dtype=torch.float64, device=device)
    Q = aamod.build_aa_Q(torch.as_tensor(S, dtype=torch.float64,
                                         device=device), pi)
    logpi = torch.log(torch.clamp_min(pi, 1e-300))
    pairs = [(i, j) for i in range(data.ns) for j in range(i)]
    hmax = _max_patterns(data, pairs)
    slot = _Slot(device, {"a": (hmax,), "b": (hmax,)}, {"w": (hmax,)})
    aj, bj, wj = (slot.views[k] for k in "abw")

    def neg_lnl(x):
        P = pmat_rev(Q, pi, x[0][None])[0]
        lp = logpi[aj] + torch.log(torch.clamp_min(P[aj, bj], 1e-300))
        return -torch.sum(wj * lp)
    neg_lnl.capturable = True

    out = []
    with GraphCache() as cache:
        for i, j in pairs:
            a, b, w = _pair_patterns(data, i, j)
            slot.fill(a=a, b=b, w=w)
            res = maximize(neg_lnl, np.array([0.3]), [(4e-6, 50)],
                           device=device, cache=cache)
            out.append(MLPair(i=i, j=j, t=float(res.x[0]), kappa=0.0,
                              omega=0.0, lnL=res.lnL))
    return out


# --- closed-form nucleotide distances (reference: SeqDivergence) ----------

def nuc_distance(data: seqio.PackedData, i: int, j: int,
                 model: str = "K80", alpha: float = 0.0):
    """Pairwise nucleotide distance with optional gamma correction.

    Supported closed forms: JC69, K80, F81, F84, TN93 (reference:
    SeqDivergence, src/treesub.c:1965).  Returns (distance, kappa-ish)."""
    a_st = data.tip_partials[i].argmax(-1)
    b_st = data.tip_partials[j].argmax(-1)
    w = data.fpatt
    n = w.sum()
    F = np.zeros((4, 4))
    np.add.at(F, (a_st, b_st), w)
    F = (F + F.T) / (2 * n)
    P_ts = F[0, 1] + F[2, 3]      # T<->C + A<->G
    P_ts *= 2
    Pdiff = 1 - np.trace(F)
    Q_tv = Pdiff - P_ts
    pi4 = F.sum(1)

    def gam(x, power):
        """(1-x)^{-power} correction: log if alpha==0 else gamma."""
        if x <= 0:
            return np.inf
        if alpha <= 0:
            return -np.log(x)
        return alpha * (x ** (-1 / alpha) - 1)

    if model == "JC69":
        p = Pdiff
        d = 0.75 * gam(1 - 4 * p / 3, 1)
        return d, None
    if model == "K80":
        a = 1 - 2 * P_ts - Q_tv
        b = 1 - 2 * Q_tv
        d = 0.5 * gam(a, 1) + 0.25 * gam(b, 1)
        kap = (0.5 * gam(a, 1) - 0.25 * gam(b, 1)) / max(0.25 * gam(b, 1),
                                                         1e-10)
        return d, kap
    if model == "F81":
        E = 1 - float(pi4 @ pi4)
        d = E * gam(1 - Pdiff / E, 1)
        return d, None
    if model in ("F84", "HKY85", "TN93"):
        from .yn00 import distance_F84
        k, t, se, st = distance_F84(n, P_ts, Q_tv, pi4)
        return t, k
    raise ValueError(f"distance model {model}")


def distance_matrix(data: seqio.PackedData, model="K80", alpha=0.0):
    ns = data.ns
    D = np.zeros((ns, ns))
    for i in range(ns):
        for j in range(i):
            d, _ = nuc_distance(data, i, j, model, alpha)
            D[i, j] = D[j, i] = d
    return D


# --- Bayesian pairwise estimation (runmode = -3) ---------------------------

@dataclass
class BayesPair:
    """Posterior summaries of (t, omega) for one sequence pair."""
    i: int
    j: int
    E_t: float
    E_w: float
    SE_t: float
    SE_w: float
    cov_tw: float
    corr_tw: float
    p_w_gt1: float
    t_center: float      # quadrature center (MLE or MAP)
    w_center: float
    kappa: float
    lnL: float


def _logistic_values(z, m, s):
    return torch.exp(m + s * torch.log((1.0 + z) / (1.0 - z)))


def bayes_pairwise_codon(data: seqio.PackedData, codonf: str = "F3x4",
                         icode: int = 0, kappa0: float = 2.0,
                         omega0: float = 0.4,
                         hyperpar=(1.1, 1.1, 1.1, 2.2),
                         npoints: int = 32, *,
                         device="cuda") -> list[BayesPair]:
    """Bayesian pairwise dN/dS (reference: BayesPairwise,
    src/codeml.c:4612; Angelis, dos Reis & Yang 2014).

    Posterior of (t, w) under independent gamma priors
    t ~ G(hyperpar[0], hyperpar[1]), w ~ G(hyperpar[2], hyperpar[3]) with
    kappa fixed at its MLE.  The 2-D integral uses Gauss-Legendre
    quadrature after the reference's logistic change of variables centered
    on the MLE (or the MAP when the MLE is extreme), with scale set from
    the curvature.  Unlike the reference (finite-difference Hessians and
    NG86 delta-method variances, EstVariances src/codeml.c:4843), the
    curvature here is the exact autodiff Hessian; this only moves the
    quadrature grid, not the target posterior.  P[w>1 | x] follows the
    reference's substitution u = ((1-a)z + 1 + a)/2 that re-maps the grid
    onto {w > 1} (src/codeml.c:4703-4752)."""
    from .yn00 import _path_tables, _tables

    graph = codonmod.codon_graph(icode)
    G = codonmod.pair_tables(icode, device)
    a_t, b_t, a_w, b_w = (float(v) for v in hyperpar)
    glnodes, glweights = np.polynomial.legendre.leggauss(npoints)
    zq = torch.as_tensor(glnodes, dtype=torch.float64, device=device)
    Tt, PTt = _tables(icode), _path_tables(icode)

    lg_t = a_t * math.log(b_t) - math.lgamma(a_t)
    lg_w = a_w * math.log(b_w) - math.lgamma(a_w)

    def logprior(t, w):
        lt = -b_t * t + (a_t - 1) * torch.log(t) + lg_t
        lw = -b_w * w + (a_w - 1) * torch.log(w) + lg_w
        return lt + lw

    def np_of(v):
        return v.detach().cpu().numpy()

    # one slot and two objectives for the program: the ML fit of (t,
    # kappa, omega), and the MAP fit of (t, omega) at the slot's kappa
    pairs = [(i, j) for i in range(data.ns) for j in range(i)]
    cp = _CodonPair(data, *pairs[0], codonf, G, graph, device, True,
                    hmax=_max_patterns(data, pairs))
    kapj = cp.kappa

    def neg_lnl(x):
        return -cp.loglik(x[0], x[1], x[2])
    neg_lnl.capturable = True

    def neg_logpost(x, twice=False):
        return -(cp.loglik(x[0], kapj, x[1], twice) + logprior(x[0], x[1]))
    neg_logpost.capturable = True

    out = []
    cache = GraphCache()      # the two objectives' graphs, closed at the end
    try:
        for i, j in pairs:
            cp.load(data, i, j)
            a, b, w = cp.a, cp.b, cp.w
            identical = bool((a == b).all())

            # --- ML fit (t, kappa, omega) -----------------------------------
            res = maximize(neg_lnl, np.array([0.5, kappa0, omega0]),
                           [(4e-6, 50), (1e-4, 999), (1e-4, 99)],
                           device=device, cache=cache)
            t_ml, kap, w_ml = (float(v) for v in res.x)
            if identical:
                kap = 2.0           # reference: k fixed at 2 (codeml.c:4638)
            kapj.fill_(kap)

            # NG86 proportions of synonymous/nonsynonymous differences for
            # the saturation gate (reference requires 0 < pS < 0.74 and
            # 0 < pN < 0.74 before the MLE-centered grid, codeml.c:4645)
            nd_s = PTt["ng_sd"][a, b] @ w
            nd_n = PTt["ng_nd"][a, b] @ w
            Sng = ((Tt["ng_syn"][a] + Tt["ng_syn"][b]) * 3.0 / 18.0) @ w
            Nng = (3.0 * (1 - (Tt["ng_nstop"][a] + Tt["ng_nstop"][b])
                          / 18.0)) @ w - Sng
            y_ng = w.sum() * 3.0 / max(Sng + Nng, 1e-300)
            Sng, Nng = Sng * y_ng, Nng * y_ng
            pS = nd_s / Sng if Sng > 0 else 0.0
            pN = nd_n / Nng if Nng > 0 else 0.0

            moderate = (0 < pS < 0.74 and 0 < pN < 0.74
                        and 0.001 < t_ml < 10 and 0.005 < w_ml < 5
                        and not identical)
            if moderate:
                tc, wc = t_ml, w_ml

                def curv(x):
                    return -cp.loglik(x[0], kapj, x[1], twice=True)
            else:
                x0 = np.array([min(t_ml, 1.0),
                               a_w / b_w if identical else min(w_ml, 0.5)])
                rmap = maximize(neg_logpost, x0,
                                [(1e-5, 100), (1e-5, 200)], device=device,
                                cache=cache)
                tc, wc = (float(v) for v in rmap.x)

                def curv(x):
                    return neg_logpost(x, twice=True)
            H = torch.autograd.functional.hessian(curv, cp.f64([tc, wc]))
            H = np_of(H).astype(np.float64)
            # positive-definiteness needs H[0,0] > 0 as well as det > 0
            # (a negative-definite 2x2 also has det > 0); unusable
            # curvature falls back to unit scales (reference var>0 && det>0
            # check, codeml.c:4678)
            if np.linalg.det(H) > 0 and H[0, 0] > 0:
                cov = np.linalg.inv(H)
            else:
                d = np.diag(H)
                cov = np.diag(np.where(d > 1e-8, 1.0 / np.maximum(d, 1e-8),
                                       1.0))
            var_t = max(float(cov[0, 0]), 1e-10)
            var_w = max(float(cov[1, 1]), 1e-10)

            m1, s1 = np.log(tc), np.sqrt(var_t) / tc
            m2, s2 = np.log(wc), np.sqrt(var_w) / wc

            # --- the 2-D quadrature: one P(t) batch per grid ----------------
            t_vals = _logistic_values(zq, m1, s1)            # [nt]
            w_vals = _logistic_values(zq, m2, s2)            # [nw]

            FL = 1.0 / (1.0 + np.exp(m2 / s2))   # P(log w < 0) logistic
            setp = FL > 1 - 1e-5 or FL < 1e-5
            alpha = 2 * FL - 1
            u = ((1 - alpha) * zq + 1 + alpha) / 2.0
            wp_vals = _logistic_values(u, m2, s2)            # [nw]

            with torch.no_grad():
                s_grid = codonmod.mutation_part(G, kapj, cp.pf3x4)

                def grid_logpost(w_axis, cp=cp, s_grid=s_grid,
                                 t_vals=t_vals):
                    Qs = cp.scaled_Q(None, w_axis, s_grid)     # [nw, n, n]
                    ts = t_vals[:, None].expand(-1, w_axis.shape[0])
                    P = pmat_rev_multi(Qs, cp.pi, ts)         # [nt, nw, n, n]
                    lp = (cp.logpi[cp.aj]
                          + torch.log(torch.clamp_min(
                              P[:, :, cp.aj, cp.bj], 1e-300)))
                    ll = (lp @ cp.wj).T                       # [nw, nt]
                    return ll + logprior(t_vals[None, :], w_axis[:, None])

                lpost = np_of(grid_logpost(w_vals))
                lpost_p = None if setp else np_of(grid_logpost(wp_vals))
            if not np.isfinite(lpost).any():
                raise FloatingPointError(
                    f"BayesPairwise: non-finite posterior grid for pair "
                    f"({i + 1}, {j + 1}); data may be saturated")
            lref = lpost[np.isfinite(lpost)].max()
            tg, wg = np_of(t_vals), np_of(w_vals)
            jac = ((2 * tg * s1)[None, :] * (2 * wg * s2)[:, None]
                   / ((1 - glnodes ** 2)[None, :]
                      * (1 - glnodes ** 2)[:, None]))
            r = np.exp(lpost - lref) * jac
            wwq = np.outer(glweights, glweights)
            norm = float((wwq * r).sum())
            if not (norm > 0 and np.isfinite(norm)):
                raise FloatingPointError(
                    f"BayesPairwise: posterior mass underflowed for pair "
                    f"({i + 1}, {j + 1}); grid missed the posterior mode")
            tg, wg = tg[None, :], wg[:, None]
            E_w = float((wwq * r * wg).sum()) / norm
            E_t = float((wwq * r * tg).sum()) / norm
            E_w2 = float((wwq * r * wg ** 2).sum()) / norm
            E_t2 = float((wwq * r * tg ** 2).sum()) / norm
            E_tw = float((wwq * r * wg * tg).sum()) / norm
            var_tp = max(E_t2 - E_t ** 2, 0.0)
            var_wp = max(E_w2 - E_w ** 2, 0.0)
            cov_tw = E_tw - E_t * E_w
            corr = (cov_tw / np.sqrt(var_tp * var_wp)
                    if var_tp > 0 and var_wp > 0 else 0.0)

            if setp:
                p_gt1 = 0.0 if FL > 0.5 else 1.0
            else:
                up, wpg = np_of(u), np_of(wp_vals)
                jac_p = ((2 * np_of(t_vals) * s1)[None, :]
                         * (2 * wpg * s2)[:, None] * (1 - alpha)
                         / ((1 - glnodes ** 2)[None, :]
                            * (1 - up ** 2)[:, None] * 2.0))
                q = np.exp(lpost_p - lref) * jac_p
                p_gt1 = float((wwq * q).sum()) / norm
                p_gt1 = min(max(p_gt1, 0.0), 1.0)

            out.append(BayesPair(
                i=i, j=j, E_t=E_t, E_w=E_w,
                SE_t=float(np.sqrt(var_tp)), SE_w=float(np.sqrt(var_wp)),
                cov_tw=float(cov_tw), corr_tw=float(corr),
                p_w_gt1=p_gt1, t_center=tc, w_center=wc,
                kappa=kap, lnL=res.lnL))
    finally:
        cache.close()
    return out


# --- sliding-window positive selection scan (runmode -2, 2 seqs) -----------

@dataclass
class WindowResult:
    start: int          # 0-based first site (codon) of the window
    length: int
    lnL0: float         # omega fixed at 1
    lnL1: float         # omega free
    omega: float
    t: float
    significant: bool   # w > 1 and 2*dlnL > 2.71 (5%, chi2_1 mixture)


def sliding_window_codon(data: seqio.PackedData, wlen: int, offset: int,
                         codonf: str = "F3x4", icode: int = 0,
                         kappa0: float = 2.0, *,
                         device="cuda") -> tuple[list[WindowResult], bool]:
    """Sliding-window test for positive selection on a sequence pair
    (reference: SlidingWindow, src/codeml.c:5970).  For each window the
    pair is refit with omega free vs omega = 1; a window is flagged when
    omega > 1 and 2*(lnL1 - lnL0) > 2.71.  Unlike the reference (which
    stops at the first significant window), all windows are scanned.

    Requires exactly 2 sequences, clean data, one gene."""
    if data.ns != 2:
        raise ValueError("sliding window needs exactly 2 sequences")
    if data.seqtype != 1:
        raise ValueError("sliding window requires codon data (seqtype=1)")
    if not getattr(data, "cleandata", True):
        raise ValueError("sliding window requires cleandata=1 (the "
                         "reference zerrors on ambiguous data)")
    if data.ngene > 1:
        raise ValueError("one gene only for sliding window analysis")
    if data.site_pattern is None:
        raise ValueError("site->pattern map missing")
    graph = codonmod.codon_graph(icode)
    G = codonmod.pair_tables(icode, device)
    sp = data.site_pattern
    ls = data.ls

    subs = []
    for wstart in range(0, ls - wlen + 1, offset):
        fpatt_w = np.bincount(sp[wstart:wstart + wlen],
                              minlength=len(data.fpatt)).astype(np.float64)
        keep = fpatt_w > 0
        subs.append((wstart, seqio.PackedData(
            names=data.names, seqtype=data.seqtype, nstates=data.nstates,
            tip_partials=data.tip_partials[:, keep],
            fpatt=fpatt_w[keep], ls=wlen,
            pos_masks=(data.pos_masks[:, keep]
                       if data.pos_masks is not None else None),
            icode=data.icode)))
    if not subs:
        return [], False
    # window-local frequencies, as the reference recomputes com.pi; the
    # pair (1, 0), as the JAX package orders it; one slot for every window
    cp = _CodonPair(subs[0][1], 1, 0, codonf, G, graph, device, False,
                    hmax=max(_max_patterns(sub, [(1, 0)])
                             for _, sub in subs))

    def neg_lnl0(x):                    # omega fixed at 1
        return -cp.loglik(x[0], x[1], cp.one)
    neg_lnl0.capturable = True

    def neg_lnl1(x):
        return -cp.loglik(x[0], x[1], x[2])
    neg_lnl1.capturable = True

    results: list[WindowResult] = []
    positive = False
    with GraphCache() as cache:
        for wstart, sub in subs:
            cp.load(sub, 1, 0)
            r0 = maximize(neg_lnl0, np.array([0.3, kappa0]),
                          [(4e-6, 50), (1e-4, 999)], device=device,
                          cache=cache)
            r1 = maximize(neg_lnl1, np.array([0.3, kappa0, 0.5]),
                          [(4e-6, 50), (1e-4, 999), (1e-4, 99)],
                          device=device, cache=cache)
            om1 = float(r1.x[2])
            sig = om1 > 1 and 2 * (r1.lnL - r0.lnL) > 2.71
            positive = positive or sig
            results.append(WindowResult(
                start=wstart, length=wlen, lnL0=r0.lnL, lnL1=r1.lnL,
                omega=om1, t=float(r1.x[0]), significant=sig))
    return results, positive
