"""NEB and BEB site posteriors for positive-selection inference.

Port of `paml_tpu/apps/beb.py`.

NEB (naive empirical Bayes): site-class posteriors at the MLEs
(reference: lfunNSsites_rate, src/codeml.c:5241).

BEB (Bayes empirical Bayes, Yang, Wong & Nielsen 2005): integrates over a
grid prior on the NSsites distribution parameters, reusing per-omega site
likelihoods (reference: lfunNSsites_M2M8, src/codeml.c:6387, grid setup
get_grid_para_like_M2M8 :6234, get_pclassM_iw_M2M8 :6307, ternary
triangle grid GetIndexTernary, src/tools.c).  Supported: M2a and M8, and
branch-site model A.

The 21 (M2a) / 20 (M8) per-omega pattern likelihoods come from one pruning
pass, the omegas riding the class axis (`_per_omega_loglik`): on the card
it is one forward launch of the pruning kernels, without their residual.
The grid mixing stays on the same device.  A grid point g gives class k
the weight pcl[g, k] and the omega of index iw[g, k]; with the [ngrid, nw]
matrix M[g, r] = sum_k pcl[g, k] [iw[g, k] = r], the marginal likelihood
of every grid point and pattern is the product M fhK, and the posterior
over the omega library is fhK * (M^T (wgt / fh)): two small matrix
products in place of the [ngrid, classes, patterns] array.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import dgamma, pruning
from ..core.pmat import pmat_rev_multi
from ..core.topology import Topology
from ..io import seqio
from ..models import codon as codonmod
from . import codeml

# seconds spent in `beb` and `beb_branchsite_A` since import
SECONDS = {"beb": 0.0}


@dataclass
class SitePosteriors:
    method: str                  # "NEB" or "BEB"
    class_post: np.ndarray       # [K, H] P(class | pattern)
    class_omegas: np.ndarray     # [K] omega per class (NEB) or the library
    mean_w: np.ndarray           # [H] posterior mean omega per pattern
    se_w: np.ndarray | None      # [H] posterior sd (BEB)
    p_positive: np.ndarray       # [H] P(omega > 1 | pattern)


class _Frozen:
    """What stays at the MLE while omega varies: the data's frequencies,
    the tips on the device, branch lengths, kappa's mutation matrix and
    the two flux scalars.  `neg`: the objective of the same data, tree and
    spec on `device` (`codeml.make_codon_objective`), whose coded tips and
    frequencies are then used again instead of being made anew."""

    def __init__(self, data, topo, spec, x_mle, device, neg=None):
        dtype = torch.float64
        if neg is None:
            neg = codeml.make_codon_objective(data, topo, spec,
                                              device=device)[0]
        self.pi_np, pf3x4, self.tips = neg.pi_np, neg.pf3x4, neg.tips
        self.n = len(self.pi_np)
        self.pi = torch.as_tensor(self.pi_np, dtype=dtype, device=device)
        branch_nodes = topo.branch_nodes()
        nb = len(branch_nodes)
        nkappa = codeml._nkappa(spec)
        kappa = torch.as_tensor(
            x_mle[nb:nb + nkappa] if nkappa else [spec.kappa], dtype=dtype,
            device=device)
        self.T = codonmod.dense_tables(spec.icode, device, dtype)
        self.s = codonmod.mutation_dense(
            self.T, kappa if spec.hkyREV else kappa[0], pf3x4, spec.hkyREV)
        rs, ra = codonmod.flux_dense(self.T, self.s, self.pi)
        self.rs, self.ra = float(rs), float(ra)
        self.tfull = torch.zeros(topo.nnode, dtype=dtype, device=device)
        self.tfull[torch.as_tensor(branch_nodes, device=device)] = \
            torch.as_tensor(x_mle[:nb], dtype=dtype, device=device)
        self.topo, self.fpatt = topo, neg.fpatt

    def P(self, omegas, qfactor):
        """P [nnode, K, n, n] for the omegas [K]; qfactor scales the
        branch lengths: a number, or one per node [nnode]."""
        om = torch.as_tensor(omegas, dtype=self.pi.dtype,
                             device=self.pi.device)
        Qs = codonmod.build_Q_dense(self.T, self.s, om, self.pi)
        qf = torch.as_tensor(qfactor, dtype=self.pi.dtype,
                             device=self.pi.device)
        ts = (self.tfull * qf)[:, None].expand(-1, len(om))
        return pmat_rev_multi(Qs, self.pi, ts)

    def lnf(self, P):
        """log f(x_h | class) [K, H] by one pruning pass."""
        with torch.no_grad():
            return pruning.class_site_lnf(
                P, self.tips, self.topo,
                self.pi.expand(P.shape[1], self.n).contiguous())


def _per_omega_loglik(data: seqio.PackedData, topo: Topology, spec,
                      x_mle, omegas, qfactor, *, device, neg=None):
    """log f(x_h | w) for each w in `omegas`, with branch lengths, kappa
    and the mixture Q-scale frozen at the MLE: ([K, H] tensor on `device`,
    the codon frequencies)."""
    fz = _Frozen(data, topo, spec, x_mle, device, neg)
    return fz.lnf(fz.P(omegas, qfactor)), fz.pi_np


def neb(data: seqio.PackedData, topo: Topology, spec, res, *,
        device, neg=None) -> SitePosteriors:
    """NEB site-class posteriors at the MLEs (model 0 NSsites); `neg` as
    in `_Frozen`."""
    W, freqs = res.params["W"], res.params["freqs"]
    omegas = W.reshape(-1)
    wbar = float((W * freqs[None, :]).sum(1)[0])
    fz = _Frozen(data, topo, spec, res.x, device, neg)
    lnf = fz.lnf(fz.P(omegas, 1.0 / (fz.rs + fz.ra * wbar))).cpu().numpy()
    post = lnf + np.log(np.maximum(freqs, 1e-300))[:, None]
    post = np.exp(post - post.max(0, keepdims=True))
    post /= post.sum(0, keepdims=True)
    mean_w = (post * omegas[:, None]).sum(0)
    p_pos = post[omegas > 1.0].sum(0)
    return SitePosteriors("NEB", post, omegas, mean_w, None, p_pos)


def _ternary_grid(n1d: int):
    """Centroids of the n1d^2 triangles of the ternary graph (reference:
    GetIndexTernary)."""
    idx = np.arange(n1d * n1d)
    ix = np.floor(np.sqrt(idx)).astype(int)
    iy = idx - ix * ix
    p0 = (1 + (iy // 2) * 3 + (iy % 2)) / (3.0 * n1d)
    p1 = (1 + (n1d - 1 - ix) * 3 + (iy % 2)) / (3.0 * n1d)
    return p0, p1


def _grid_matrix(pcl, iw, nw: int, device) -> torch.Tensor:
    """M [ngrid, nw], M[g, r] = sum_k pcl[g, k] [iw[g, k] = r]."""
    ngrid, K = pcl.shape
    M = torch.zeros((ngrid, nw), dtype=torch.float64, device=device)
    rows = torch.arange(ngrid, device=device)[:, None].expand(ngrid, K)
    M.index_put_((rows, torch.as_tensor(iw, device=device)),
                 torch.as_tensor(pcl, dtype=torch.float64, device=device),
                 accumulate=True)
    return M


def _grid_posterior(M, fhK, fpatt):
    """(wgt [ngrid], the grid points' posterior weights; wgt / fh [ngrid,
    H]; ln f(X), the log marginal likelihood up to fhK's scaling)."""
    fh = torch.clamp_min(M @ fhK, 1e-300)                     # [ngrid, H]
    lnfXs = torch.log(fh) @ fpatt
    mx = lnfXs.max()
    wgt = torch.exp(lnfXs - mx)
    fX = wgt.sum()
    wgt = wgt / fX
    return wgt, wgt[:, None] / fh, float(torch.log(fX) + mx)


def beb(data: seqio.PackedData, topo: Topology, spec, res, n1d: int = 10,
        *, device, neg=None) -> SitePosteriors:
    """BEB for M2a (NSsites=2) or M8 (NSsites=8), model=0; `neg` as in
    `_Frozen`."""
    import time
    if spec.NSsites not in (codeml.M2A, codeml.M8):
        raise ValueError("BEB implemented for NSsites = 2 (M2a) and 8 (M8)")
    t_start = time.perf_counter()
    M2a = spec.NSsites == codeml.M2A

    # frozen Qfactor at the MLE
    W, freqs = res.params["W"], res.params["freqs"]
    wbar = float((W * freqs[None, :]).sum(1)[0])
    fz = _Frozen(data, topo, spec, res.x, device, neg)
    qf = 1.0 / (fz.rs + fz.ra * wbar)

    # omega library rK (reference get_grid_para_like_M2M8)
    w0_grid = (np.arange(n1d) + 0.5) / n1d                    # U(0,1)
    ws_grid = 1.0 + (np.arange(n1d) + 0.5) * 10.0 / n1d       # U(1,11)
    if M2a:
        rK = np.concatenate([w0_grid, [1.0], ws_grid])        # 21
    else:
        rK = np.concatenate([w0_grid, ws_grid])               # 20
    lnf = fz.lnf(fz.P(rK, qf))                                # [nw, H]
    fhK = torch.exp(lnf - lnf.max(0).values[None, :])         # per pattern

    # grid: dim=4 (p0/p1-ternary, w0, w2) for M2a; (p0, p, q, ws) for M8
    if M2a:
        p0t, p1t = _ternary_grid(n1d)                         # [n1d^2]
        # grid axes: (tern, w0, w2)
        G_t, G_w0, G_w2 = (g.ravel() for g in np.meshgrid(
            np.arange(n1d * n1d), np.arange(n1d), np.arange(n1d),
            indexing="ij"))
        pcl = np.stack([p0t[G_t], p1t[G_t], 1 - p0t[G_t] - p1t[G_t]], axis=1)
        iw = np.stack([G_w0, np.full_like(G_w0, n1d), n1d + 1 + G_w2], axis=1)
    else:
        p0g = (np.arange(n1d) + 0.5) / n1d
        pg = (np.arange(n1d) + 0.5) * 2.0 / n1d               # U(0,2)
        qg = (np.arange(n1d) + 0.5) * 2.0 / n1d
        G0, G1, G2, G3 = (g.ravel() for g in np.meshgrid(
            np.arange(n1d), np.arange(n1d), np.arange(n1d), np.arange(n1d),
            indexing="ij"))
        # class weights: p0 * beta-bin probs for k<n1d; 1-p0 for ws.
        # CDFBeta at the bin edges for each (p, q) pair
        edges = np.arange(1, n1d) / n1d
        cdf = dgamma.betainc(*(torch.as_tensor(v, device=device) for v in (
            pg[:, None, None], qg[None, :, None], edges[None, None, :]))
        ).cpu().numpy()
        cdf_full = np.concatenate(
            [np.zeros((n1d, n1d, 1)), cdf, np.ones((n1d, n1d, 1))], axis=2)
        binp = np.diff(cdf_full, axis=2)                      # [p, q, n1d]
        pcl = np.concatenate(
            [p0g[G0][:, None] * binp[G1, G2],                 # [ngrid, n1d]
             (1 - p0g[G0])[:, None]], axis=1)                 # + ws class
        iw = np.concatenate(
            [np.tile(np.arange(n1d), (len(G0), 1)), (n1d + G3)[:, None]],
            axis=1)

    fpatt = fz.fpatt
    M = _grid_matrix(pcl, iw, len(rK), device)
    _, inv_fh, _ = _grid_posterior(M, fhK, fpatt)
    # posterior over the omega library per pattern:
    # P(w_r | h) = sum_g wgt_g M[g, r] fhK[r, h] / fh[g, h]
    post_w = fhK * (M.T @ inv_fh)
    post_w = (post_w / post_w.sum(0, keepdim=True)).cpu().numpy()

    mean_w = (post_w * rK[:, None]).sum(0)
    var_w = (post_w * (rK[:, None] - mean_w[None, :]) ** 2).sum(0)
    p_pos = post_w[rK > 1.0].sum(0)
    if M2a:
        class_post = np.stack([post_w[:n1d].sum(0), post_w[n1d],
                               post_w[n1d + 1:].sum(0)])
    else:
        class_post = np.stack([post_w[:n1d].sum(0), post_w[n1d:].sum(0)])
    SECONDS["beb"] += time.perf_counter() - t_start
    return SitePosteriors("BEB", class_post, rK, mean_w, np.sqrt(var_w),
                          p_pos)


def _branchsite_P_sets(fz: _Frozen, topo: Topology, res, w0g, w2g):
    """P [nnode, 121, n, n] of branch-site model A's (wback, wfore) sets,
    in the order of the reference's fhK table: the background branches
    take a set's wback, the foreground branches its wfore; branch lengths,
    kappa and the per-branch-type Qfactor frozen at the MLE mixture."""
    device, n1d = fz.pi.device, len(w0g)
    W, freqs = res.params["W"], res.params["freqs"]      # [2, 4], [4]
    wbar = (W * freqs[None, :]).sum(1)                   # [2]
    qf = 1.0 / (fz.rs + fz.ra * wbar)                    # [2]
    btype = topo.labels.astype(np.int64)
    # 21 distinct omegas: w0 bins (0..9), w1=1 (10), w2 bins (11..20)
    vals = np.concatenate([w0g, [1.0], w2g])             # [21]
    P_all = fz.P(vals, qf[np.clip(btype, 0, 1)])         # [nnode, 21, n, n]
    back_idx = np.concatenate([
        np.arange(n1d), [n1d],
        np.repeat(np.arange(n1d), n1d),                  # class 2a: w0_i
        np.full(n1d, n1d)])                              # class 2b: w1=1
    fore_idx = np.concatenate([
        np.arange(n1d), [n1d],
        n1d + 1 + np.tile(np.arange(n1d), n1d),          # class 2a: w2_j
        n1d + 1 + np.arange(n1d)])                       # class 2b: w2_j
    fore = torch.as_tensor(btype >= 1, device=device)[:, None, None, None]
    return torch.where(
        fore, P_all[:, torch.as_tensor(fore_idx, device=device)],
        P_all[:, torch.as_tensor(back_idx, device=device)]).contiguous()


def beb_branchsite_A(data: seqio.PackedData, topo: Topology, spec, res,
                     n1d: int = 10, *, device, neg=None):
    """BEB for branch-site model A (reference: lfunNSsites_ACD,
    src/codeml.c:6827; grid/prior setup get_grid_para_like_ACD :6629 and
    get_pclassM_iw_ACD :6767).

    Integral dimension 4 (p0, p1 on the ternary graph; w0 ~ U(0,1);
    w2 ~ U(1,11)), each on n1d bins.  f(x_h|w) is computed for the
    121 = n1d + 1 + n1d^2 + n1d (wback, wfore) sets under the branch
    model with branch lengths, kappa and the per-branch-type Qfactor
    frozen at the MLE (the reference's BayesEB = 2 scale rule).

    Returns dict with postSite [4, H] (classes 0, 1, 2a, 2b), pos_prob
    [H] (= P(class 2a or 2b | x_h), the 'Prob(w>1)' of the output),
    post_w0/post_w2 grid marginals and post_p0p1; `neg` as in `_Frozen`."""
    import time
    t_start = time.perf_counter()
    fz = _Frozen(data, topo, spec, res.x, device, neg)
    w0g = (np.arange(n1d) + 0.5) / n1d
    w2g = 1.0 + (np.arange(n1d) + 0.5) * 10.0 / n1d
    P_sets = _branchsite_P_sets(fz, topo, res, w0g, w2g)
    nsets = P_sets.shape[1]                              # 121
    lnf = fz.lnf(P_sets)                                 # [121, H]
    del P_sets
    fhK = torch.exp(lnf - lnf.max(0).values[None, :])
    fpatt = fz.fpatt

    # grid: (ternary p0p1 [n1d^2], w0 [n1d], w2 [n1d]) -> ngrid = n1d^4
    p0t, p1t = _ternary_grid(n1d)
    G_t, G_w0, G_w2 = (g.ravel() for g in np.meshgrid(
        np.arange(n1d * n1d), np.arange(n1d), np.arange(n1d),
        indexing="ij"))
    p0, p1 = p0t[G_t], p1t[G_t]
    p2 = 1.0 - p0 - p1
    t01 = p0 + p1
    pclassM = np.stack([p0, p1, p2 * p0 / t01, p2 * p1 / t01],
                       axis=1)                           # [ngrid, 4]
    iw = np.stack([G_w0,
                   np.full_like(G_w0, n1d),
                   n1d + 1 + G_w0 * n1d + G_w2,
                   n1d + 1 + n1d * n1d + G_w2], axis=1)  # [ngrid, 4]

    M = _grid_matrix(pclassM, iw, nsets, device)
    wgt, inv_fh, lnfX = _grid_posterior(M, fhK, fpatt)
    # postSite[k, h] = sum_g wgt_g pclassM[g, k] fhK[iw[g, k], h] / F[g, h]
    postSite = torch.stack([
        (fhK * (_grid_matrix(pclassM[:, k:k + 1], iw[:, k:k + 1], nsets,
                             device).T @ inv_fh)).sum(0)
        for k in range(4)]).cpu().numpy()
    Wg = wgt.cpu().numpy()
    SECONDS["beb"] += time.perf_counter() - t_start
    return dict(postSite=postSite, pos_prob=postSite[2] + postSite[3],
                w0_grid=w0g, w2_grid=w2g,
                post_w0=np.bincount(G_w0, weights=Wg, minlength=n1d),
                post_w2=np.bincount(G_w2, weights=Wg, minlength=n1d),
                post_p0p1=np.bincount(G_t, weights=Wg, minlength=n1d * n1d),
                lnfX=lnfX)


def positive_sites(data: seqio.PackedData, sp: SitePosteriors,
                   cutoff: float = 0.5):
    """(site_index_1based, P(w>1), mean_w) for sites above cutoff, using the
    pattern->site expansion (reference rst output)."""
    out = []
    site_pat = data.site_pattern
    for site in range(len(site_pat)):
        h = site_pat[site]
        if sp.p_positive[h] > cutoff:
            out.append((site + 1, float(sp.p_positive[h]),
                        float(sp.mean_w[h])))
    return out
