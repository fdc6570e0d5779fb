"""paml_tpu_torch amino-acid models and data against paml_tpu: the port's
copy of the matrix library array for array, every function of
`models/aa.py` for every matrix and distance (values; the gradients of the
parametric matrices in kappa and the REVaa rates), and the amino-acid
encoder, the translation of codons and `pack` for seqtype 2 and 3 field by
field."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paml_tpu.io import seqio as jax_seqio
from paml_tpu.models import aa as jax_aa
from paml_tpu.models import codon as jax_codon
from paml_tpu_torch.io import seqio
from paml_tpu_torch.models import aa, codon

DATA = os.path.join(os.path.dirname(__file__), "data")
MATRICES = aa.available_matrices()
DISTANCES = ["grantham", "miyata", "g1974a", "g1974c", "g1974p", "g1974v"]


def test_matrix_library_is_a_copy():
    zt, zj = aa._npz(), jax_aa._npz()
    assert zt.files == zj.files and len(zt.files) == 30
    for k in zt.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert MATRICES == jax_aa.available_matrices()
    assert os.path.dirname(os.path.abspath(aa._NPZ)).endswith(
        os.path.join("paml_tpu_torch", "data"))


@pytest.mark.parametrize("name", MATRICES)
def test_empirical_matrix_matches_jax(name):
    S, pi = aa.load_empirical(name)
    Sj, pij = jax_aa.load_empirical(name)
    np.testing.assert_array_equal(S, Sj)
    np.testing.assert_array_equal(pi, pij)
    # a path and '.dat', as aaRatefile gives them
    S2, _ = aa.load_empirical(f"/some/dir/{name}.dat")
    np.testing.assert_array_equal(S2, Sj)
    obs = np.random.default_rng(3).dirichlet(np.ones(20))
    for model in ("Empirical", "Empirical_F"):
        St, pt = aa.model_S_pi(model, name, obs)
        Sjj, pjj = jax_aa.model_S_pi(model, name, obs)
        np.testing.assert_array_equal(St, Sjj)
        np.testing.assert_allclose(pt, pjj, rtol=1e-15)
        Q = aa.build_aa_Q(torch.as_tensor(St), torch.as_tensor(pt))
        Qj = jax_aa.build_aa_Q(Sjj, pjj)
        np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=1e-12,
                                   atol=1e-15)


def test_aliases_and_unknown_names():
    for alias, name in (("jtt", "jones"), ("mtrev", "mtREV24"),
                        ("LG", "lg"), ("cprev", "cpREV10")):
        np.testing.assert_array_equal(aa.load_empirical(alias)[0],
                                      jax_aa.load_empirical(name)[0])
    with pytest.raises(ValueError, match="unknown AA matrix"):
        aa.load_empirical("nosuch")
    with pytest.raises(ValueError, match="unknown distance"):
        aa.load_distance("nosuch")
    with pytest.raises(ValueError, match="parametric"):
        aa.model_S_pi("REVaa", None, np.full(20, 0.05))


@pytest.mark.parametrize("name", DISTANCES)
def test_distance_matches_jax(name):
    np.testing.assert_array_equal(aa.load_distance(name),
                                  jax_aa.load_distance(name))


@pytest.mark.parametrize("model", ["Poisson", "EqualInput"])
def test_flat_models_match_jax(model):
    obs = np.random.default_rng(4).dirichlet(np.ones(20))
    St, pt = aa.model_S_pi(model, None, obs)
    Sj, pj = jax_aa.model_S_pi(model, None, obs)
    np.testing.assert_array_equal(St, Sj)
    np.testing.assert_allclose(pt, pj, rtol=1e-15)


@pytest.mark.parametrize("icode", [0, 1])
def test_pair_tables_match_jax(icode):
    g, gj = codon.codon_graph(icode), jax_codon.codon_graph(icode)
    for a, b in zip(aa.aa_pairs_lower(), jax_aa.aa_pairs_lower()):
        np.testing.assert_array_equal(a, b)
    assert aa.IJ_AA_REF == jax_aa.IJ_AA_REF
    np.testing.assert_array_equal(aa.aa_1step(g), jax_aa.aa_1step(gj))
    for model in ("REVaa", "REVaa_0"):
        assert aa.n_revaa_rates(model, g) == jax_aa.n_revaa_rates(model, gj)
    faa = np.random.default_rng(icode).dirichlet(np.ones(20))
    np.testing.assert_allclose(aa.aa2codonf(faa, g),
                               jax_aa.aa2codonf(faa, gj), rtol=1e-15)


def _value_grad_t(fn, x):
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    W = torch.as_tensor(np.random.default_rng(7).uniform(0.5, 1.5, (20, 20)))
    v = (fn(xt) * W).sum()
    (g,) = torch.autograd.grad(v, xt)
    return v.item(), g.numpy()


def _value_grad_j(fn, x):
    W = jnp.asarray(np.random.default_rng(7).uniform(0.5, 1.5, (20, 20)))
    v, g = jax.value_and_grad(lambda z: jnp.sum(fn(z) * W))(jnp.asarray(x))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("icode", [0, 1])
def test_from_codon_S_matches_jax(icode):
    g, gj = codon.codon_graph(icode), jax_codon.codon_graph(icode)
    faa = np.random.default_rng(5 + icode).dirichlet(np.ones(20))
    kappa = np.array(2.7)
    S = aa.from_codon_S(torch.as_tensor(kappa), 0.3, faa, g)
    Sj = jax_aa.from_codon_S(kappa, 0.3, faa, gj)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-13)
    v, gr = _value_grad_t(lambda k: aa.from_codon_S(k, 0.3, faa, g), kappa)
    vj, grj = _value_grad_j(lambda k: jax_aa.from_codon_S(k, 0.3, faa, gj),
                            kappa)
    assert abs(v - vj) <= 1e-12 * abs(vj)
    np.testing.assert_allclose(gr, grj, rtol=1e-12)


@pytest.mark.parametrize("model", ["REVaa", "REVaa_0"])
def test_revaa_S_matches_jax(model):
    g, gj = codon.codon_graph(0), jax_codon.codon_graph(0)
    graph, graph_j = (g, gj) if model == "REVaa_0" else (None, None)
    rates = np.random.default_rng(6).uniform(0.1, 3.0,
                                             aa.n_revaa_rates(model, g))
    S = aa.revaa_S(torch.as_tensor(rates), graph)
    Sj = jax_aa.revaa_S(rates, graph_j)
    np.testing.assert_array_equal(S.numpy(), np.asarray(Sj))
    v, gr = _value_grad_t(lambda r: aa.revaa_S(r, graph), rates)
    vj, grj = _value_grad_j(lambda r: jax_aa.revaa_S(r, graph_j), rates)
    assert abs(v - vj) <= 1e-12 * abs(vj)
    np.testing.assert_allclose(gr, grj, rtol=1e-12)
    # and the Q of the REVaa model, with its gradient in the rates
    pi = np.random.default_rng(8).dirichlet(np.ones(20))
    v, gr = _value_grad_t(
        lambda r: aa.build_aa_Q(aa.revaa_S(r, graph), torch.as_tensor(pi)),
        rates)
    vj, grj = _value_grad_j(
        lambda r: jax_aa.build_aa_Q(jax_aa.revaa_S(r, graph_j), pi), rates)
    assert abs(v - vj) <= 1e-12 * abs(vj)
    np.testing.assert_allclose(gr, grj, rtol=1e-10,
                               atol=1e-12 * np.abs(grj).max())


AA_ROWS = ["ARNDCQEGHILKMFPSTWYV", "ARNDCQ-GHILKMFPXTWYV",
           "BRNDCZEGHJLKMFPSTWY?", "ARNDCQEGHILKMFPSTWYV",
           "ARNDCQEGHIL.MFPSTWYV"]


def _assert_same_packed(dt, dj):
    for f in dataclasses.fields(seqio.PackedData):
        va, vb = getattr(dt, f.name), getattr(dj, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=f.name)
        else:
            assert va == vb, f.name


def test_encode_aa_matches_jax():
    rows = [r.replace(".", "A") for r in AA_ROWS]
    np.testing.assert_array_equal(seqio.encode_aa(rows),
                                  jax_seqio.encode_aa(rows))


@pytest.mark.parametrize("icode", [0, 1])
def test_translate_codon_rows_matches_jax(icode):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    rows = list(aln.rows)
    rows[0] = "NNN" + rows[0][3:]
    rows[1] = rows[1][:6] + "---" + rows[1][9:]
    rows[2] = rows[2][:12] + "CAY" + rows[2][15:]
    assert seqio.translate_codon_rows(rows, icode) == \
        jax_seqio.translate_codon_rows(rows, icode)


@pytest.mark.parametrize("cleandata", [False, True])
def test_pack_aa_matches_jax(cleandata, tmp_path):
    path = tmp_path / "aa.phy"
    path.write_text("5 20\n" + "".join(f"s{i}  {r}\n"
                                       for i, r in enumerate(AA_ROWS)))
    aj = jax_seqio.read_alignment(str(path), jax_seqio.AA_SEQ)
    at = seqio.read_alignment(str(path), seqio.AA_SEQ)
    assert at.rows == aj.rows and at.names == aj.names
    _assert_same_packed(seqio.pack(at, cleandata=cleandata),
                        jax_seqio.pack(aj, cleandata=cleandata))


@pytest.mark.parametrize("icode", [0, 1])
def test_pack_codon2aa_matches_jax(icode):
    path = os.path.join(DATA, "clock56.codon")
    aj = jax_seqio.read_alignment(path, jax_seqio.CODON2AA_SEQ)
    at = seqio.read_alignment(path, seqio.CODON2AA_SEQ)
    rows = list(aj.rows)
    rows[3] = rows[3][:30] + "---" + rows[3][33:]
    dj = jax_seqio.pack(jax_seqio.Alignment(aj.names, rows, 3), icode=icode)
    dt = seqio.pack(seqio.Alignment(at.names, rows, 3), icode=icode)
    assert dt.nstates == 20
    _assert_same_packed(dt, dj)


def test_stacked_aa_alignments_match_jax(tmp_path):
    path = tmp_path / "two.phy"
    block = "3 20\n" + "".join(f"s{i}  {r}\n" for i, r in
                                enumerate(AA_ROWS[:3]))
    path.write_text(block + "\n" + block.replace("ARND", "GRND"))
    at = seqio.read_alignments(str(path), seqio.AA_SEQ, 2)
    aj = jax_seqio.read_alignments(str(path), jax_seqio.AA_SEQ, 2)
    assert [a.rows for a in at] == [a.rows for a in aj]
    for a, b in zip(at, aj):
        _assert_same_packed(seqio.pack(a), jax_seqio.pack(b))
