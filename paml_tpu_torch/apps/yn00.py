"""yn00: pairwise dN/dS by counting methods (no tree, no ML fit).

Counterpart of the reference program (src/yn00.c): Nei-Gojobori 1986,
Yang-Nielsen 2000 (kappa- and frequency-corrected counting with F84
distances), and the LWL85 / LWL85m / LPB93 family.

Port of `paml_tpu/apps/yn00.py`.  All per-codon and per-codon-pair
quantities (mutation neighborhoods, degeneracy classes, substitution
pathways) are precomputed once per genetic code as dense numpy tables;
per-pair statistics are table lookups accumulated over site patterns, on
the host, as in the JAX package.  The only matrix computation is the
61-state P(t) of the YN00 pathway weighting (GetPMatCodon,
src/yn00.c:593): `models/codon` and `core/pmat.pmat_rev` on the device
that `run` is given, up to 10 times per pair with `weighting = 1`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..constants import geneticcode_table, sense_codons
from ..io import seqio

_BY = np.array([16, 4, 1])


@lru_cache(maxsize=None)
def _tables(icode: int):
    """Static per-code tables."""
    sense = sense_codons(icode)
    tab = geneticcode_table(icode)
    n = len(sense)
    to61 = -np.ones(64, dtype=np.int64)
    to61[sense] = np.arange(n)
    pos_nt = np.stack([sense // 16, (sense // 4) % 4, sense % 4], axis=1)
    aa = tab[sense]

    # mutation neighborhood: for codon i, position p, target base k != b
    # -> (target codon 61-index or -1 stop, syn?, transition?)
    nbr_t = np.full((n, 3, 4), -1, dtype=np.int64)
    nbr_syn = np.zeros((n, 3, 4), dtype=bool)
    nbr_ts = np.zeros((n, 3, 4), dtype=bool)
    for i in range(n):
        for p in range(3):
            b = pos_nt[i, p]
            for k in range(4):
                if k == b:
                    continue
                c2 = sense[i] + (k - b) * _BY[p]
                j = to61[c2]
                nbr_t[i, p, k] = j
                if j >= 0:
                    nbr_syn[i, p, k] = aa[j] == aa[i]
                nbr_ts[i, p, k] = (b + k) in (1, 5)

    # NG86 per-codon: SynSite and nstop counts over the 9 possible changes
    ng_syn = np.zeros(n)
    ng_nstop = np.zeros(n)
    for i in range(n):
        for p in range(3):
            for k in range(4):
                if k == pos_nt[i, p]:
                    continue
                if nbr_t[i, p, k] < 0:
                    ng_nstop[i] += 1
                elif nbr_syn[i, p, k]:
                    ng_syn[i] += 1

    # LWL85 degeneracy class per (codon, position): 0-fold, 2-fold, 4-fold
    fold = np.zeros((n, 3), dtype=np.int64)
    for i in range(n):
        for p in range(3):
            nsame = int(nbr_syn[i, p].sum())
            fold[i, p] = 0 if nsame == 0 else (1 if nsame <= 2 else 2)

    # GetKappa site classes: nondegenerate per (codon, pos); 4-fold at pos 2
    nondeg = np.zeros((n, 3), dtype=bool)
    fourfold = np.zeros(n, dtype=bool)
    for i in range(n):
        for p in range(3):
            nondeg[i, p] = not nbr_syn[i, p].any()
        fourfold[i] = all(nbr_syn[i, 2, k] for k in range(4)
                          if k != pos_nt[i, 2])

    return dict(sense=sense, to61=to61, pos_nt=pos_nt, aa=aa, n=n,
                nbr_t=nbr_t, nbr_syn=nbr_syn, nbr_ts=nbr_ts,
                ng_syn=ng_syn, ng_nstop=ng_nstop, fold=fold,
                nondeg=nondeg, fourfold=fourfold)


@lru_cache(maxsize=None)
def _path_tables(icode: int):
    """Pathway enumeration per unordered codon pair (reference pathway
    logic: difcodonNG src/tools.c:306, CountDiffs src/yn00.c:635).

    Returns per (i, j): for each path k (up to 6): edge list (from, to)
    61-indices, per-path (sts, stv, nts, ntv), stop flag; plus NG86
    averaged (SynDif, AsynDif)."""
    T = _tables(icode)
    n, sense, to61, pos_nt, aa = T["n"], T["sense"], T["to61"], T["pos_nt"], T["aa"]

    max_path = 6
    edges = np.full((n, n, max_path, 3, 2), -1, dtype=np.int64)
    counts = np.zeros((n, n, max_path, 4), dtype=np.float64)   # sts stv nts ntv
    pstop = np.ones((n, n, max_path), dtype=bool)              # path invalid
    nd_tab = np.zeros((n, n), dtype=np.int64)
    ng_sd = np.zeros((n, n))
    ng_nd = np.zeros((n, n))

    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            diff = np.nonzero(pos_nt[i] != pos_nt[j])[0]
            nd = len(diff)
            nd_tab[i, j] = nd
            if nd == 1:
                paths = [[diff[0]]]
            elif nd == 2:
                paths = [[diff[0], diff[1]], [diff[1], diff[0]]]
            else:
                import itertools
                paths = [list(p) for p in itertools.permutations(range(3))]
            sd_tot = nd_tot = 0.0
            nstop = 0
            for k, steps in enumerate(paths):
                cur = sense[i]
                ok = True
                cnt = np.zeros(4)
                es = []
                for p in steps:
                    bcur = (cur // _BY[p]) % 4
                    btgt = pos_nt[j, p]
                    nxt = cur + (btgt - bcur) * _BY[p]
                    es.append((to61[cur], to61[nxt]))
                    if to61[nxt] < 0:
                        ok = False
                        break
                    ts = (bcur + btgt) in (1, 5)
                    syn = aa[to61[cur]] == aa[to61[nxt]]
                    cnt[0 if syn and ts else 1 if syn else 2 if ts else 3] += 1
                    cur = nxt
                if ok:
                    pstop[i, j, k] = False
                    counts[i, j, k] = cnt
                    for e, (a, b) in enumerate(es):
                        edges[i, j, k, e] = (a, b)
                    sd_tot += cnt[0] + cnt[1]
                    nd_tot += cnt[2] + cnt[3]
                else:
                    nstop += 1
            npath = len(paths)
            if npath == nstop:     # all paths through stops (reference fallback)
                if nd == 2:
                    ng_sd[i, j], ng_nd[i, j] = 0.0, 2.0
                else:
                    ng_sd[i, j], ng_nd[i, j] = 1.0, 2.0
            elif nd >= 1:
                ng_sd[i, j] = sd_tot / (npath - nstop)
                ng_nd[i, j] = nd_tot / (npath - nstop)
    return dict(edges=edges, counts=counts, pstop=pstop, nd=nd_tab,
                ng_sd=ng_sd, ng_nd=ng_nd)


# ---------------------------------------------------------------------------


def distance_F84(n, P, Q, pi, want_se=False):
    """F84 distance with K80/JC69 fallbacks (reference: DistanceF84,
    src/yn00.c:769).  Returns (kappa_HKY, t, SEt, status)."""
    maxt, maxkappa = 99.0, 999.0
    Y, R = pi[0] + pi[1], pi[2] + pi[3]
    tc, ag = pi[0] * pi[1], pi[2] * pi[3]
    k_HKY, SEt = -1.0, None
    if P + Q > 1:
        return 1.0, maxt, SEt, 3
    Qsmall = min(1e-10, 0.1 / max(n, 1))
    failF84 = failK80 = failJC69 = 0
    a = b = 0.0
    if Q < Qsmall:
        failF84 = failK80 = 1
    elif Y <= 0 or R <= 0 or (tc <= 0 and ag <= 0):
        failF84 = 1
    else:
        A = tc / Y + ag / R
        B = tc + ag
        C = Y * R
        a = (2 * B + 2 * (tc * R / Y + ag * Y / R) * (1 - Q / (2 * C)) - P) / (2 * A)
        b = 1 - Q / (2 * C)
        if a <= 0 or b <= 0:
            failF84 = 1
    t = None
    if not failF84:
        a = -0.5 * np.log(a)
        b = -0.5 * np.log(b)
        if b <= 0:
            failF84 = 1
        else:
            k_F84 = a / b - 1
            t = 4 * b * (tc * (1 + k_F84 / Y) + ag * (1 + k_F84 / R) + C)
            k_HKY = (B + (tc / Y + ag / R) * k_F84) / B
            if want_se:
                A_ = tc / Y + ag / R
                B_ = tc + ag
                C_ = Y * R
                den = A_ * C_ - C_ * P / 2 - (A_ - B_) * Q / 2
                a2 = A_ * C_ / den
                b2 = A_ * (A_ - B_) / den - (A_ - B_ - C_) / (C_ - Q / 2)
                SEt = np.sqrt((a2 * a2 * P + b2 * b2 * Q
                               - (a2 * P + b2 * Q) ** 2) / n)
    if failF84 and not failK80:
        a = 1 - 2 * P - Q
        b = 1 - 2 * Q
        if a <= 0 or b <= 0:
            failK80 = 1
        else:
            a = -np.log(a)
            b = -np.log(b)
            if b <= 0:
                failK80 = 1
            else:
                k_HKY = (0.5 * a - 0.25 * b) / (0.25 * b)
                t = 0.5 * a + 0.25 * b
            if want_se and not failK80:
                a2 = 1 / (1 - 2 * P - Q)
                b2 = (a2 + 1 / (1 - 2 * Q)) / 2
                SEt = np.sqrt((a2 * a2 * P + b2 * b2 * Q
                               - (a2 * P + b2 * Q) ** 2) / n)
    if failK80:
        Pj = P + Q
        if Pj >= 0.75:
            failJC69 = 1
            Pj = 0.75 * (n - 1.0) / n
        t = -0.75 * np.log(1 - Pj * 4 / 3.0)
        t = min(t, maxt)
        if want_se:
            SEt = np.sqrt(9 * Pj * (1 - Pj) / n) / (3 - 4 * Pj)
    k_HKY = min(k_HKY, maxkappa)
    return k_HKY, t, SEt, failF84 + failK80 + failJC69


@dataclass
class PairResult:
    i: int
    j: int
    # NG86
    ng_S: float = 0.0
    ng_N: float = 0.0
    ng_dS: float = 0.0
    ng_dN: float = 0.0
    ng_t: float = 0.0
    # YN00
    S: float = 0.0
    N: float = 0.0
    t: float = 0.0
    kappa: float = 0.0
    omega: float = 0.0
    dN: float = 0.0
    dS: float = 0.0
    SEdN: float | None = None
    SEdS: float | None = None
    # LWL85 family
    lwl: dict = field(default_factory=dict)


def _codon_states(data: seqio.PackedData) -> np.ndarray:
    """[ns, npatt] 61-state codes (clean data required)."""
    st = data.tip_partials.argmax(-1)
    if not (data.tip_partials.sum(-1) == 1).all():
        raise ValueError("yn00 requires cleandata=1 (no ambiguities)")
    return st.astype(np.int64)


def _ng86_pair(z1, z2, fpatt, ls, T, PT):
    nd_s = PT["ng_sd"][z1, z2] @ fpatt
    nd_n = PT["ng_nd"][z1, z2] @ fpatt
    # reference: SynSite summed over both codons then * 3/18
    S = ((T["ng_syn"][z1] + T["ng_syn"][z2]) * 3.0 / 18.0) @ fpatt
    N = (3.0 * (1 - (T["ng_nstop"][z1] + T["ng_nstop"][z2]) / 18.0)) @ fpatt - S
    pS = nd_s / S if S > 0 else 0.0
    pN = nd_n / N if N > 0 else 0.0

    # rescale sites so S + N = 3 * ls (reference: DistanceMatNG86 stop-codon
    # rescale, src/treesub.c:2425)
    tot = (fpatt).sum()
    y = tot * 3.0 / (S + N)
    S, N = S * y, N * y
    pS = nd_s / S if S > 0 else 0.0
    pN = nd_n / N if N > 0 else 0.0

    def jc(p):
        if p >= 0.75:
            return -1.0
        return -0.75 * np.log(1 - 4.0 / 3 * p)

    dS, dN = jc(pS), jc(pN)
    t = (dS * 3 * S + dN * 3 * N) / (S + N) if dS >= 0 and dN >= 0 else -1
    return S, N, dS, dN, t


def _count_sites(z, pi61, kappa, fpatt, ls, T):
    """Reference CountSites (src/yn00.c:548) vectorized over patterns."""
    nbr_t = T["nbr_t"][z]              # [H, 3, 4]
    nbr_syn = T["nbr_syn"][z]
    nbr_ts = T["nbr_ts"][z]
    ok = nbr_t >= 0
    r = np.where(ok, pi61[np.clip(nbr_t, 0, None)], 0.0)
    r = r * np.where(nbr_ts, kappa, 1.0)
    rs = np.where(nbr_syn, r, 0.0)
    rn = np.where(ok & ~nbr_syn, r, 0.0)
    S = (rs.sum((1, 2)) * fpatt).sum()
    N = (rn.sum((1, 2)) * fpatt).sum()
    # base freqs at syn/nonsyn sites: weight by source base at each position
    pos_nt = T["pos_nt"][z]            # [H, 3]
    fbS = np.zeros(4)
    fbN = np.zeros(4)
    for p in range(3):
        np.add.at(fbS, pos_nt[:, p], rs[:, p, :].sum(-1) * fpatt)
        np.add.at(fbN, pos_nt[:, p], rn[:, p, :].sum(-1) * fpatt)
    scale = 3.0 * ls / (S + N)
    return S * scale, N * scale, fbS / fbS.sum(), fbN / fbN.sum()


def _count_diffs(z1, z2, fpatt, PT, pmat=None):
    """Reference CountDiffs (src/yn00.c:635): pathway-weighted syn/nonsyn
    transition/transversion differences."""
    edges = PT["edges"][z1, z2]        # [H, 6, 3, 2]
    counts = PT["counts"][z1, z2]      # [H, 6, 4]
    pstop = PT["pstop"][z1, z2]        # [H, 6]
    same = z1 == z2
    if pmat is None:
        w = (~pstop).astype(float)
    else:
        e_ok = edges[..., 0] >= 0
        pm = pmat[np.clip(edges[..., 0], 0, None),
                  np.clip(edges[..., 1], 0, None)]
        pm = np.where(e_ok, pm, 1.0)
        w = np.where(pstop, 0.0, pm.prod(-1))
    sw = w.sum(-1, keepdims=True)
    allstop = (sw[..., 0] <= 1e-20)
    w = np.where(allstop[:, None], 0.0, w / np.where(sw > 0, sw, 1.0))
    per_pat = np.einsum("hk,hkc->hc", w, counts)           # [H, 4]
    # all-stop fallback (reference: src/yn00.c:728): nd==2 -> (.5, 1.5);
    # nd==3 -> (.5, 2.5) for (nts, ntv)
    nd_pair = PT["nd"][z1, z2]
    fb = np.zeros_like(per_pat)
    fb[:, 2] = 0.5
    fb[:, 3] = np.where(nd_pair >= 3, 2.5, 1.5)
    per_pat = np.where((allstop & ~same)[:, None], fb, per_pat)
    tot = (per_pat * fpatt[:, None]).sum(0)
    return tot[0], tot[1], tot[2], tot[3]   # sts, stv, nts, ntv


def _get_kappa(states, fpatt, T, icode):
    """Reference GetKappa (src/yn00.c:461): average pairwise HKY kappa from
    nondegenerate + 4-fold sites."""
    ns = states.shape[0]
    kdefault = 10.0 if icode == 1 else 2.0
    ksum = 0.0
    npair = ns * (ns - 1) / 2
    for i in range(ns):
        for j in range(i):
            z1, z2 = states[i], states[j]
            ka = np.zeros(2)
            wk = np.zeros(2)
            for kind in range(2):
                F = np.zeros((4, 4))
                if kind == 0:
                    for p in range(3):
                        mask = T["nondeg"][z1, p] & T["nondeg"][z2, p]
                        b1 = T["pos_nt"][z1, p][mask]
                        b2 = T["pos_nt"][z2, p][mask]
                        np.add.at(F, (b1, b2), 0.5 * fpatt[mask])
                        np.add.at(F, (b2, b1), 0.5 * fpatt[mask])
                else:
                    same_aa = T["aa"][z1] == T["aa"][z2]
                    mask = T["fourfold"][z1] & T["fourfold"][z2] & same_aa
                    b1 = T["pos_nt"][z1, 2][mask]
                    b2 = T["pos_nt"][z2, 2][mask]
                    np.add.at(F, (b1, b2), 0.5 * fpatt[mask])
                    np.add.at(F, (b2, b1), 0.5 * fpatt[mask])
                S = F.sum()
                if S <= 0:
                    continue
                F = F / S
                P = (F[0, 1] + F[2, 3]) * 2
                Q = 1 - np.trace(F) - P
                pi4 = F.sum(1)
                k, t, _, st = distance_F84(S, P, Q, pi4)
                ka[kind] = k
                wk[kind] = S if k > 0 else 0
            if wk.sum() == 0:
                k_pair = kdefault
            else:
                k_pair = (ka * wk).sum() / wk.sum()
            ksum += k_pair / npair
    return ksum


def _pmat_codon(pi61, t, kappa, omega, G):
    """P(t) [n, n] as numpy, on the device of the pair tables G."""
    import torch

    from ..core.pmat import pmat_rev
    from ..models import codon as cm
    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=G.pi_idx.device)

    with torch.no_grad():
        pi, kap, om = f64(pi61), f64(float(kappa)), f64(float(omega))
        s = cm.mutation_part(G, kap, None, False)
        Q = cm.build_Q(G, s, om, pi)
        mr = cm.mean_rate(G, s, om, pi)
        return pmat_rev(Q / mr, pi, f64([float(t)]))[0].cpu().numpy()


def run(seqfile: str, icode: int = 0, weighting: bool = True,
        common_f3x4: bool = True, verbose: bool = False, *,
        device="cuda") -> list[PairResult]:
    """Full yn00 analysis over all sequence pairs."""
    aln = seqio.read_alignment(seqfile, seqio.CODON_SEQ)
    data = seqio.pack(aln, cleandata=True, icode=icode)
    return run_packed(data, icode=icode, weighting=weighting,
                      common_f3x4=common_f3x4, device=device)


def run_packed(data: seqio.PackedData, icode: int = 0, weighting: bool = True,
               common_f3x4: bool = True, *,
               device="cuda") -> list[PairResult]:
    from ..models.codon import pair_tables

    G = pair_tables(icode, device) if weighting else None
    T = _tables(icode)
    PT = _path_tables(icode)
    states = _codon_states(data)
    fpatt = data.fpatt
    ns = states.shape[0]
    ls = data.ls

    # per-species f3x4 tables (reference: Statistics, src/yn00.c:313)
    f3x4s = np.zeros((ns, 3, 4))
    for i in range(ns):
        pn = T["pos_nt"][states[i]]
        for p in range(3):
            np.add.at(f3x4s[i, p], pn[:, p], fpatt)
        f3x4s[i] /= f3x4s[i].sum(1, keepdims=True)

    kappa = _get_kappa(states, fpatt, T, icode)

    results = []
    for i in range(ns):
        for j in range(i):
            z1, z2 = states[i], states[j]
            r = PairResult(i=i, j=j)
            r.ng_S, r.ng_N, r.ng_dS, r.ng_dN, r.ng_t = \
                _ng86_pair(z1, z2, fpatt, ls, T, PT)

            # codon frequencies for this pair
            if common_f3x4:
                f3x4 = f3x4s.mean(0)
            else:
                f3x4 = (f3x4s[i] + f3x4s[j]) / 2
            pi61 = (f3x4[0][T["pos_nt"][:, 0]] * f3x4[1][T["pos_nt"][:, 1]]
                    * f3x4[2][T["pos_nt"][:, 2]])
            pi61 = pi61 / pi61.sum()

            # YN00 iteration (reference: DistanceYN00, src/yn00.c:237)
            S1, N1, fbS1, fbN1 = _count_sites(z1, pi61, kappa, fpatt, ls, T)
            S2, N2, fbS2, fbN2 = _count_sites(z2, pi61, kappa, fpatt, ls, T)
            S, N = (S1 + S2) / 2, (N1 + N2) / 2
            fbS, fbN = (fbS1 + fbS2) / 2, (fbN1 + fbN2) / 2
            t, omega = 0.5, 1.0
            dS = dN = 0.0
            dS0 = dN0 = w0 = 0.0
            SEdS = SEdN = None
            for it in range(10 if weighting else 1):
                pm = (_pmat_codon(pi61, t, kappa, omega, G)
                      if weighting else None)
                Sdts, Sdtv, Ndts, Ndtv = _count_diffs(z1, z2, fpatt, PT, pm)
                kS, dS, SEdS, st1 = distance_F84(S, Sdts / S, Sdtv / S, fbS,
                                                 want_se=True)
                kN, dN, SEdN, st2 = distance_F84(N, Ndts / N, Ndtv / N, fbN,
                                                 want_se=True)
                if dS < 1e-9:
                    omega = 99.0
                else:
                    omega = max(1e-5, dN / dS)
                t = dS * 3 * S / (S + N) + dN * 3 * N / (S + N)
                if (abs(dS - dS0) < 5e-4 and abs(dN - dN0) < 5e-4
                        and abs(omega - w0) < 5e-4):
                    break
                dS0, dN0, w0 = dS, dN, omega
            r.S, r.N, r.t, r.kappa, r.omega = S, N, t, kappa, omega
            r.dN, r.dS, r.SEdN, r.SEdS = dN, dS, SEdN, SEdS

            # LWL85 family (reference: DistanceMatLWL85, src/yn00.c:390)
            fold1 = T["fold"][z1]
            fold2 = T["fold"][z2]
            L = np.zeros(3)
            sdiff = np.zeros(3)
            vdiff = np.zeros(3)
            pn1 = T["pos_nt"][z1]
            pn2 = T["pos_nt"][z2]
            for p in range(3):
                np.add.at(L, fold1[:, p], 0.5 * fpatt)
                np.add.at(L, fold2[:, p], 0.5 * fpatt)
                ddif = pn1[:, p] != pn2[:, p]
                ts = (pn1[:, p] + pn2[:, p] == 1) | (pn1[:, p] + pn2[:, p] == 5)
                sel_ts = ddif & ts
                sel_tv = ddif & ~ts
                np.add.at(sdiff, fold1[sel_ts, p], 0.5 * fpatt[sel_ts])
                np.add.at(sdiff, fold2[sel_ts, p], 0.5 * fpatt[sel_ts])
                np.add.at(vdiff, fold1[sel_tv, p], 0.5 * fpatt[sel_tv])
                np.add.at(vdiff, fold2[sel_tv, p], 0.5 * fpatt[sel_tv])
            with np.errstate(divide="ignore", invalid="ignore"):
                P3 = sdiff / L
                Q3 = vdiff / L
                a = 1 - 2 * P3 - Q3
                b = 1 - 2 * Q3
                A = -np.log(a) / 2 + np.log(b) / 4
                B = -np.log(b) / 2
                Sd = L[1] * A[1] + L[2] * (A[2] + B[2])
                Nd = L[1] * B[1] + L[0] * (A[0] + B[0])
                lwl = {}
                S_ = L[1] / 3 + L[2]
                N_ = L[1] * 2 / 3 + L[0]
                lwl["LWL85"] = dict(dS=Sd / S_, dN=Nd / N_, S=S_, N=N_)
                rho = A[2] / (A[2] + B[2])
                S_ = L[1] * rho + L[2]
                N_ = L[1] * (1 - rho) + L[0]
                lwl["LWL85m"] = dict(dS=Sd / S_, dN=Nd / N_, S=S_, N=N_,
                                     rho=rho)
                lwl["LPB93"] = dict(
                    dS=(L[1] * A[1] + L[2] * A[2]) / (L[1] + L[2]) + B[2],
                    dN=(L[0] * B[0] + L[1] * B[1]) / (L[0] + L[1]) + A[0])
            r.lwl = lwl
            results.append(r)
    return results
