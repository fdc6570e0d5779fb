"""paml_tpu_torch yn00 against paml_tpu on the CPU: every field of
`PairResult` (NG86, YN00 with and without the pathway weighting, the
LWL85 / LWL85m / LPB93 family) to 1e-9 relative, with codon frequencies
pooled over all sequences (`commonf3x4`) and per pair, on
`tests/data/clock56.codon` (6 taxa x 300 codons) and on a synthetic
alignment made from a seed with numpy (8 taxa x 200 codons at graded
divergence, from identical to saturated); the static code tables, the
F84 distance with its fallbacks and the weighting's P(t)."""
import os

import numpy as np
import pytest
import torch

from paml_tpu.apps import yn00 as jax_yn00
from paml_tpu.constants import codon_string, sense_codons
from paml_tpu.io import seqio as jax_seqio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import yn00

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-9
FIELDS = ("ng_S", "ng_N", "ng_dS", "ng_dN", "ng_t", "S", "N", "t", "kappa",
          "omega", "dN", "dS", "SEdN", "SEdS")


def graded_codons(rng, ns, ncod, rates=None):
    """Rows of sense codons: the first random, each other row the first
    with a growing share of its codons redrawn."""
    sense = sense_codons(0)
    base = rng.choice(sense, ncod)
    rates = rates if rates is not None else np.linspace(0.0, 0.9, ns)
    rows = []
    for r in rates:
        c = base.copy()
        hit = rng.random(ncod) < r
        c[hit] = rng.choice(sense, int(hit.sum()))
        rows.append("".join(codon_string(int(v)) for v in c))
    return rows


def packed(kind):
    if kind == "clock56":
        aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                       jax_seqio.CODON_SEQ)
    else:
        rows = graded_codons(np.random.default_rng(7), 8, 200)
        aln = jax_seqio.Alignment([f"s{i}" for i in range(8)], rows,
                                  jax_seqio.CODON_SEQ)
    return jax_seqio.pack(aln, cleandata=True)


def close(a, b):
    """Equal to RTOL, or the same None, inf or nan."""
    if a is None or b is None:
        return a is None and b is None
    if not (np.isfinite(a) and np.isfinite(b)):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return abs(a - b) <= RTOL * max(abs(b), 1e-12)


@pytest.mark.parametrize("kind", ["clock56", "graded"])
@pytest.mark.parametrize("weighting,common", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_pair_results_match_jax(kind, weighting, common):
    data = packed(kind)
    rj = jax_yn00.run_packed(data, weighting=weighting, common_f3x4=common)
    rt = yn00.run_packed(interop.packed_from(data), weighting=weighting,
                         common_f3x4=common, device="cpu")
    assert [(r.i, r.j) for r in rt] == [(r.i, r.j) for r in rj]
    for a, b in zip(rt, rj):
        for f in FIELDS:
            assert close(getattr(a, f), getattr(b, f)), (a.i, a.j, f)
        assert a.lwl.keys() == b.lwl.keys()
        for fam in b.lwl:
            assert a.lwl[fam].keys() == b.lwl[fam].keys()
            for k, v in b.lwl[fam].items():
                assert close(a.lwl[fam][k], v), (a.i, a.j, fam, k)


def test_tables_match_jax():
    for name in ("nbr_t", "nbr_syn", "nbr_ts", "ng_syn", "ng_nstop", "fold",
                 "nondeg", "fourfold"):
        np.testing.assert_array_equal(yn00._tables(0)[name],
                                      jax_yn00._tables(0)[name])
    for name in ("edges", "counts", "pstop", "nd", "ng_sd", "ng_nd"):
        np.testing.assert_array_equal(yn00._path_tables(0)[name],
                                      jax_yn00._path_tables(0)[name])


@pytest.mark.parametrize("n,P,Q,pi", [
    (300, 0.1, 0.05, (0.2, 0.3, 0.25, 0.25)),     # F84
    (300, 0.2, 0.0, (0.2, 0.3, 0.25, 0.25)),      # no transversions: JC69
    (300, 0.3, 0.3, (0.1, 0.4, 0.25, 0.25)),      # K80 fallback
    (300, 0.6, 0.5, (0.25, 0.25, 0.25, 0.25))])   # saturated
def test_distance_F84(n, P, Q, pi):
    a = yn00.distance_F84(n, P, Q, np.array(pi), want_se=True)
    b = jax_yn00.distance_F84(n, P, Q, np.array(pi), want_se=True)
    assert a[3] == b[3]
    for u, v in zip(a[:3], b[:3]):
        assert close(u, v)


def test_pmat_matches_jax():
    """The weighting's P(t): the only computation that leaves the host."""
    from paml_tpu_torch.models.codon import pair_tables

    pi = np.random.default_rng(3).dirichlet(np.ones(61))
    Pt = yn00._pmat_codon(pi, 0.37, 2.5, 0.3, pair_tables(0, "cpu"))
    Pj = jax_yn00._pmat_codon(pi, 0.37, 2.5, 0.3, 0)
    np.testing.assert_allclose(Pt, Pj, rtol=1e-10, atol=1e-14)
