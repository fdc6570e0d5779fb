"""Amino-acid substitution models (codeml seqtype = 2, aaml).

Port of `paml_tpu/models/aa.py`.  Model family (reference enum,
src/codeml.c:222): Poisson, EqualInput, Empirical, Empirical_F (+F, the
observed frequencies), FromCodon, REVaa_0, REVaa.  The empirical
exchangeabilities (Dayhoff, JTT/jones, WAG, LG, mtREV24, mtmam, ...) and the
amino-acid distances of aaDist are read from this package's copy of the
published tables, `data/aa_matrices.npz` (reference reader: GetDaa,
src/codeml.c:3967).  Q mirrors eigenQaa (src/codeml.c:3400): Q_ij = S_ij
pi_j, normalized to mean rate 1.

The parametric matrices (`from_codon_S`, `revaa_S`) and `build_aa_Q` are
tensor functions: autograd reaches kappa and the REVaa rates.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

AA_MODELS = ["Poisson", "EqualInput", "Empirical", "Empirical_F",
             "FromCodon", "REVaa_0", "REVaa"]

_NPZ = os.path.join(os.path.dirname(__file__), "..", "data",
                    "aa_matrices.npz")

# common aliases for the rate files
ALIASES = {"jtt": "jones", "mtrev": "mtREV24", "mtzoa": "MtZoa",
           "cprev": "cpREV10", "cprev10": "cpREV10", "cprev64": "cpREV64"}


@lru_cache(maxsize=None)
def _npz():
    return np.load(os.path.abspath(_NPZ))


def available_matrices() -> list[str]:
    return sorted({k[:-2] for k in _npz().files if k.endswith("_S")})


def load_empirical(name: str):
    """(S [20, 20], pi [20]) for an empirical matrix ('dayhoff', 'jones',
    'wag', 'lg', 'mtmam', ...; a path's base name, '.dat' dropped)."""
    base = os.path.basename(name)
    if base.endswith(".dat"):
        base = base[:-4]
    base = ALIASES.get(base.lower(), base)
    z = _npz()
    key = f"{base}_S"
    if key not in z.files:
        for k in z.files:
            if k.lower() == key.lower():
                key = k
                base = k[:-2]
                break
        else:
            raise ValueError(f"unknown AA matrix {name!r}; available: "
                             f"{available_matrices()}")
    return z[f"{base}_S"], z[f"{base}_pi"]


def load_distance(name: str) -> np.ndarray:
    """Amino-acid distance matrix ('grantham', 'miyata', 'g1974{a,c,p,v}')
    for the aaDist models (reference: src/codeml.c GetOmegaAA / aaDist)."""
    z = _npz()
    key = f"{name}_d".lower()
    for k in z.files:
        if k.lower() == key:
            return z[k]
    raise ValueError(f"unknown distance matrix {name!r}")


def model_S_pi(model: str, rate_file: str | None, observed_pi: np.ndarray):
    """Exchangeability matrix and equilibrium frequencies (numpy) of a
    model with a fixed S."""
    if model == "Poisson":
        S = np.ones((20, 20))
        pi = np.full(20, 0.05)
    elif model == "EqualInput":
        S = np.ones((20, 20))
        pi = np.asarray(observed_pi)
    elif model == "Empirical":
        S, pi = load_empirical(rate_file or "jones")
    elif model == "Empirical_F":
        S, _ = load_empirical(rate_file or "jones")
        pi = np.asarray(observed_pi)
    else:
        raise ValueError(
            f"AA model {model}: parametric models (FromCodon/FromCodon0/"
            f"REVaa/REVaa_0) are built inside make_aa_objective / "
            f"make_fromcodon0_objective, not from a static S matrix")
    np.fill_diagonal(S, 0.0)
    return S, pi / pi.sum()


# ---------------------------------------------------------------------------
# codon-based and ML-estimated amino-acid models
# ---------------------------------------------------------------------------

def aa2codonf(faa: np.ndarray, graph) -> np.ndarray:
    """Codon frequencies from amino-acid frequencies, equal within each
    synonymous family (reference: AA2Codonf, src/codeml.c:3922)."""
    nsyn = np.bincount(graph.aa, minlength=20).astype(float)
    return np.asarray(faa)[graph.aa] / nsyn[graph.aa]


def from_codon_tables(omega, faa: np.ndarray, graph, *, device,
                      dtype=torch.float64) -> dict:
    """`from_codon_S`'s constants on `device`: the codon and amino-acid
    frequencies, the pair tables and masks, omega.  Made once per
    objective: an evaluation then copies nothing from the host (a CUDA
    graph cannot record the copy)."""
    f64 = dict(dtype=dtype, device=device)
    aai = graph.aa[graph.pi_idx]
    aaj = graph.aa[graph.pj_idx]

    def idx(a):
        return torch.as_tensor(a, device=device)
    return dict(
        fb61=torch.as_tensor(aa2codonf(faa, graph), **f64),
        faa=torch.as_tensor(np.maximum(np.asarray(faa, float), 1e-300),
                            **f64),
        omega=torch.as_tensor(omega, **f64), one=torch.ones((), **f64),
        zero=torch.zeros((), **f64), is_ts=idx(graph.is_ts),
        is_syn=idx(graph.is_syn), pi_idx=idx(graph.pi_idx),
        pj_idx=idx(graph.pj_idx), nonsyn=idx(aai != aaj), ai=idx(aai),
        aj=idx(aaj))


def from_codon_S(kappa, omega, faa: np.ndarray, graph, *, device=None,
                 dtype=torch.float64, tables: dict | None = None
                 ) -> torch.Tensor:
    """Aggregated amino-acid exchangeabilities from the codon chain
    (reference: eigenQaa FromCodon arm + Qcodon2aa, src/codeml.c:3419,
    3487): S[a, b] = sum over the single-difference codon pairs (i in a,
    j in b, a != b) of fb61_i fb61_j q_ij / (faa_a faa_b), q_ij the HKY
    kappa x omega exchangeability.  kappa may be a tensor that carries a
    gradient; omega is fixed in the reference's model 6.  `tables`: what
    `from_codon_tables` made for these omega, faa and graph (made here
    when None)."""
    if isinstance(kappa, torch.Tensor):
        device = kappa.device if device is None else device
    T = tables or from_codon_tables(omega, faa, graph, device=device,
                                    dtype=dtype)
    k = torch.as_tensor(kappa, dtype=dtype, device=device).reshape(())
    q = torch.where(T["is_ts"], k, T["one"])
    q = q * torch.where(T["is_syn"], T["one"], T["omega"])
    fb61, ai, aj = T["fb61"], T["ai"], T["aj"]
    contrib = torch.where(T["nonsyn"],
                          fb61[T["pi_idx"]] * fb61[T["pj_idx"]] * q,
                          T["zero"])
    contrib = contrib / (T["faa"][ai] * T["faa"][aj])
    S = T["zero"].new_zeros((20, 20))
    S = S.index_put((ai, aj), contrib, accumulate=True)
    return S.index_put((aj, ai), contrib, accumulate=True)


def aa_pairs_lower() -> tuple[np.ndarray, np.ndarray]:
    """(i, j) index arrays of the 190 lower-triangle amino-acid pairs
    (i > j), in the reference's AA1STEP order (src/codeml.c:4044)."""
    ii, jj = [], []
    for i in range(1, 20):
        for j in range(i):
            ii.append(i)
            jj.append(j)
    return np.array(ii), np.array(jj)


# reference pair fixed at rate 1: ijAAref = 19*20+9 (src/codeml.c:1091)
IJ_AA_REF = (19, 9)


def aa_1step(graph) -> np.ndarray:
    """AA1STEP flags over the 190 lower-triangle pairs: 1 when the two
    amino acids are exchangeable by a single nucleotide change under the
    genetic code (reference: SetAA1STEP, src/codeml.c:4044)."""
    cnt = np.zeros((20, 20), int)
    aai = graph.aa[graph.pi_idx]
    aaj = graph.aa[graph.pj_idx]
    for a, b in zip(aai, aaj):
        if a != b:
            cnt[a, b] += 1
            cnt[b, a] += 1
    ii, jj = aa_pairs_lower()
    return (cnt[ii, jj] > 0).astype(int)


def revaa_tables(graph, device) -> dict:
    """`revaa_S`'s index tables on `device` (REVaa for graph None,
    REVaa_0 for a codon graph), made once per objective."""
    ii, jj = aa_pairs_lower()
    ri, rj = IJ_AA_REF
    isref = (ii == ri) & (jj == rj)
    fill = ~isref if graph is None else (aa_1step(graph) > 0) & ~isref

    def idx(a):
        return torch.as_tensor(a, device=device)
    return dict(fill=idx(np.nonzero(fill)[0]), isref=idx(np.nonzero(isref)[0]),
                ii=idx(ii), jj=idx(jj))


def revaa_S(rates: torch.Tensor, graph=None,
            tables: dict | None = None) -> torch.Tensor:
    """REVaa / REVaa_0 exchangeability matrix from the free rates (a 1-D
    tensor).  REVaa (graph None): the rates fill all lower-triangle pairs
    but the reference pair (19, 9), which is 1 (src/codeml.c:3431-3436).
    REVaa_0 (graph given): they fill the AA1STEP pairs alone (less the
    reference pair); the other pairs are 0 (src/codeml.c:3424-3429).
    `tables`: what `revaa_tables` made for this graph on the rates'
    device (made here when None)."""
    T = tables or revaa_tables(graph, rates.device)
    vals = rates.new_zeros((190,)).index_put((T["fill"],), rates)
    vals = vals.index_put((T["isref"],), rates.new_ones(()))
    i_t, j_t = T["ii"], T["jj"]
    S = rates.new_zeros((20, 20)).index_put((i_t, j_t), vals)
    return S.index_put((j_t, i_t), vals)


def n_revaa_rates(model: str, graph=None) -> int:
    if model == "REVaa":
        return 189
    return int(aa_1step(graph).sum()) - 1


def build_aa_Q(S: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Q normalized to mean rate 1 from exchangeabilities and
    frequencies."""
    Q = S * pi[None, :]
    Q = Q - torch.diag(Q.sum(1))
    return Q / -(pi * torch.diagonal(Q)).sum()
