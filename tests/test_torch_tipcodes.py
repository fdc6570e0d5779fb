"""paml_tpu_torch coded tips (`core/tipcodes.py`) against paml_tpu: the
codes and ambiguity table of alignments with gaps, Ns and other ambiguity
codes, packed by the JAX package's `seqio.pack(cleandata=False)`, expand
back to its tip partials bit for bit (A = 0 gives plain state codes, A >
64 a table of several tiles); the plain pruning versions on coded tips
against `_class_site_lnf_lvl` and `jax.grad` (float64 1e-10, float32 2e-6
on values and 3e-5 on gradients, the Pallas kernel's own tolerances),
both the level path and the kernels' residual form (B1/B2's plain
versions, on the binary tree the kernels walk); the codeml objective on a
gapped alignment against `make_codon_objective` at x0 (1e-10 relative);
the coding cache of the kernel wrappers; B1/B2's shared memory and
bounds."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core import pruning as jax_pruning
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.core import cuda_pruning, pruning, tipcodes
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io import treeio

from test_pallas_pruning import _random_problem

DATA = os.path.join(os.path.dirname(__file__), "data")
IUPAC = "RYSWKMBDHVN"


def _gapped_rows(rows, rng, gap=0.05, run=10, n_rate=0.002, iupac=0.0):
    """Codon rows with gap runs (geometric lengths of mean `run` codons,
    about `gap` of each row), one N in a share `n_rate` of the codons, and
    one random IUPAC code in a share `iupac`."""
    out = []
    for r in rows:
        cod = [r[i:i + 3] for i in range(0, len(r), 3)]
        L = len(cod)
        for _ in range(rng.poisson(gap * L / run)):
            s0, ln = int(rng.integers(L)), int(rng.geometric(1.0 / run))
            cod[s0:s0 + ln] = ["---"] * len(cod[s0:s0 + ln])
        for rate, chars in ((n_rate, "N"), (iupac, IUPAC)):
            for i in np.flatnonzero(rng.random(L) < rate):
                if cod[i] != "---":
                    p = int(rng.integers(3))
                    ch = chars[int(rng.integers(len(chars)))]
                    cod[i] = cod[i][:p] + ch + cod[i][p + 1:]
        out.append("".join(cod))
    return out


def _clock56_rows():
    return jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                    jax_seqio.CODON_SEQ)


ROUND_TRIP = {"gaps_and_Ns": dict(gap=0.05, n_rate=0.02),
              "many_ambiguities": dict(gap=0.05, n_rate=0.02, iupac=0.2),
              "clean": None}


@pytest.mark.parametrize("case", list(ROUND_TRIP))
def test_encoding_round_trip_matches_jax_pack(case):
    aln = _clock56_rows()
    kw = ROUND_TRIP[case]
    rows = aln.rows if kw is None else _gapped_rows(
        aln.rows, np.random.default_rng(7), **kw)
    data = jax_seqio.pack(jax_seqio.Alignment(aln.names, rows, aln.seqtype),
                          cleandata=False)
    part = np.asarray(data.tip_partials)
    tc = tipcodes.encode(part)
    n = part.shape[-1]
    assert tc.codes.dtype == torch.int32 and tc.codes.shape == part.shape[:2]
    np.testing.assert_array_equal(tc.dense().numpy(), part)
    codes = tc.codes.numpy()
    one_hot = ((part != 0).sum(-1) == 1) & (part.max(-1) == 1)
    assert ((codes < n) == one_hot).all()
    assert (codes < n + tc.n_amb).all() and (codes >= 0).all()
    # the table holds each ambiguous vector once
    assert len({row.tobytes() for row in tc.amb.numpy()}) == tc.n_amb
    if case == "clean":
        assert tc.n_amb == 0 and (codes == part.argmax(-1)).all()
    elif case == "many_ambiguities":
        assert tc.n_amb > 64            # more than one 64-column block
    else:
        assert 1 <= tc.n_amb <= 64
        # a gap is all ones
        assert any(bool((row == 1).all()) for row in tc.amb.numpy())


CASES = [dict(ns=9, C=1, ladder=True),
         dict(ns=8, C=2, root_trifurcation=False),
         dict(ns=11, C=4)]                       # trifurcating root
TOL = {np.float64: dict(val=1e-10, grad=1e-10),
       np.float32: dict(val=2e-6, grad=3e-5)}


def _coded_problem(case, dtype, seed):
    """A problem with multi-hot tips on every taxon: gaps (all ones), sets
    of 2-6 states drawn from a pool of 80 (more than one table tile)."""
    P, tips, topo, pi = _random_problem(H=193, state_tips=False, seed=seed,
                                        **case)
    rng = np.random.default_rng(seed + 100)
    part = np.array(tips, dtype=np.float64)
    ns, H, n = part.shape
    pool = np.zeros((80, n))
    for row in pool:
        row[rng.choice(n, size=int(rng.integers(2, 7)), replace=False)] = 1
    cells = rng.random((ns, H))
    part[cells < 0.05] = 1.0
    pick = cells > 0.93
    part[pick] = pool[rng.integers(0, 80, size=int(pick.sum()))]
    return (jnp.asarray(P, dtype), jnp.asarray(part, dtype), topo,
            jnp.asarray(pi, dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", CASES, ids=["ladder", "balanced",
                                             "trifurcating"])
def test_plain_on_coded_tips_matches_jax(case, dtype):
    P, tips, topo, pi = _coded_problem(case, dtype, seed=case["ns"])
    C, H = P.shape[1], tips.shape[1]
    gbar = np.random.default_rng(3).uniform(0.5, 2.0, size=(C, H)).astype(
        dtype)

    def obj(P_, pi_):
        lnf = jax_pruning._class_site_lnf_lvl(P_, tips, topo, pi_)
        return jnp.sum(jnp.asarray(gbar) * lnf), lnf
    (_, ref), (gP, gpi) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(P, pi)
    ref, gP, gpi = (np.asarray(a) for a in (ref, gP, gpi))

    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    tc = tipcodes.encode(tipst)
    assert tc.n_amb > 32 and torch.equal(tc.dense(), tipst)
    ttopo = interop.topology_from(topo)
    tol = TOL[dtype]
    # the level path through the public entry (CPU -> plain version)
    Pg = Pt.clone().requires_grad_(True)
    pig = pit.clone().requires_grad_(True)
    lnf = pruning.class_site_lnf(Pg, tc, ttopo, pig)
    np.testing.assert_allclose(lnf.detach().numpy(), ref, rtol=tol["val"],
                               atol=tol["val"])
    (lnf * torch.tensor(gbar)).sum().backward()
    # B1/B2's plain versions: residual S on the binary tree they walk
    tb = cuda_pruning.big_tree(ttopo)
    Pb = cuda_pruning.with_identity(Pt, tb)
    lnf_b, S = pruning.class_site_lnf_big_plain(Pb, tc, tb, pit)
    assert S.shape == (cuda_pruning.big_plan(tb).n_srows, C, P.shape[-1], H)
    dP_b, dpi_b = pruning.class_site_lnf_big_bwd_plain(
        Pb, tc, tb, pit, torch.tensor(gbar), S)
    np.testing.assert_allclose(lnf_b.numpy(), ref, rtol=tol["val"],
                               atol=tol["val"])
    for dP, dpi in ((Pg.grad, pig.grad), (dP_b[:ttopo.nnode], dpi_b)):
        np.testing.assert_allclose(dP.numpy(), gP, rtol=tol["grad"],
                                   atol=tol["grad"])
        np.testing.assert_allclose(dpi.numpy(), gpi, rtol=tol["grad"],
                                   atol=tol["grad"])


GAPPED_SPECS = {"M0": (dict(NSsites=0), 1),
                "M2a": (dict(NSsites=2), 1),
                "branch_site_A_chunked": (dict(model=2, NSsites=2), 3)}


@pytest.mark.parametrize("name", list(GAPPED_SPECS))
def test_gapped_objective_matches_jax(name):
    kw, n_chunks = GAPPED_SPECS[name]
    aln = _clock56_rows()
    rows = _gapped_rows(aln.rows, np.random.default_rng(2), gap=0.05,
                        n_rate=0.01)
    data_j = jax_seqio.pack(jax_seqio.Alignment(aln.names, rows,
                                                aln.seqtype),
                            cleandata=False)
    trees = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                  data_j.names)
    topo_j = jax_from_treenode(trees[0], data_j.names)
    if kw.get("model"):
        topo_j.labels[[9, 0, 1]] = 1
    assert data_j.npatt % n_chunks == 0
    neg_j, _, _, x0, _, _ = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float64,
        n_chunks=n_chunks)
    neg, _, _, x0_t, _, _ = codeml.make_codon_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        codeml.CodemlSpec(**kw), device="cpu", n_chunks=n_chunks)
    assert isinstance(neg.tips, tipcodes.TipCodes) and neg.tips.n_amb >= 2
    np.testing.assert_array_equal(x0_t, x0)
    vj, gj = jax.jit(jax.value_and_grad(neg_j))(jnp.asarray(x0))
    xt = interop.params_from(x0, device="cpu").requires_grad_(True)
    v = neg(xt)
    (g,) = torch.autograd.grad(v, xt)
    gj = np.asarray(gj)
    assert abs(v.item() - float(vj)) <= 1e-10 * abs(float(vj))
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-10,
                               atol=1e-10 * np.abs(gj).max())


def test_kernel_tips_code_dense_partials_once():
    rng = np.random.default_rng(4)
    part = torch.zeros((5, 40, 61), dtype=torch.float64)
    part[torch.arange(5)[:, None], torch.arange(40)[None, :],
         torch.as_tensor(rng.integers(0, 61, size=(5, 40)))] = 1.0
    codes = cuda_pruning.kernel_tips(part)
    # every cell resolved: plain state codes, the large-tree pair's tips
    assert codes.dtype == torch.int32 and codes.shape == (5, 40)
    assert cuda_pruning.use_big_kernels(not isinstance(
        codes, tipcodes.TipCodes))
    part[2, 7] = 1.0                        # a gap, in place
    tc = cuda_pruning.kernel_tips(part)
    assert isinstance(tc, tipcodes.TipCodes) and tc.n_amb == 1
    assert cuda_pruning.kernel_tips(part) is tc          # cached
    assert not cuda_pruning.use_big_kernels(False)
    cuda_pruning.check_tips(tc, 61)
    assert torch.equal(tc.dense(), part)
    # chunks keep the whole table; dense chunks are the partials' chunks
    chunks, fp = pruning.split_patterns(tc, torch.ones(40), 4)
    assert len(chunks) == len(fp) == 4
    for k, ch in enumerate(chunks):
        assert ch.amb is tc.amb and ch.codes.is_contiguous()
        assert torch.equal(ch.dense(), part[:, 10 * k:10 * (k + 1)])


@pytest.mark.parametrize("esize", [4, 8])
def test_fused_shared_memory_fits_a_block(esize):
    # B1 and B2 launch with the forward's and the adjoint's carve of the
    # binary walk; the tip table kernel holds P_v [N][LDN] and a tile of
    # amb^T [N][LDH]
    fwd = cuda_pruning.big_fwd_smem(esize, 64)
    bwd = cuda_pruning.big_bwd_smem(esize, cuda_pruning.BIG_KMAX, 64)
    table = (64 * cuda_pruning.ldn(64) + 64 * cuda_pruning.BIG_LDH) * esize
    for smem in (fwd, bwd, table):
        assert 0 < smem <= cuda_pruning.SMEM_MAX == 232448
    # B2 holds per child P_k (or a tip's dP_k), c_k, s_k and G_k
    assert bwd >= 2 * (64 * 64 + 3 * 64 * 32) * esize


def _balanced_topo(ns):
    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    return from_treenode(treeio.parse_newick(bal(0, ns) + ";"), names)


def test_kernel_work_coded_tips_at_1024_taxa():
    # 1024 taxa x 10240 patterns x 4 classes, f64, n 61, 49 ambiguity
    # vectors: a resolved cell needs no product; each tip's table 2 n^2 A
    # per class, in the forward and again in the adjoint's dP fold
    big = _balanced_topo(1024)
    prod = 2 * 61 * 61 * 10240 * 4
    table = 2 * 61 * 61 * 49 * 4 * 1024
    f1, b1 = cuda_pruning.kernel_work("pruning_fwd", big, 4, 10240, 61, 8,
                                      n_amb=49)
    f2, b2 = cuda_pruning.kernel_work("pruning_bwd", big, 4, 10240, 61, 8,
                                      n_amb=49)
    assert f1 == 1022 * prod + table and f2 == 3066 * prod + table
    assert round(table / 1e9, 2) == 1.49    # half a per cent of the forward
    # the same as the large-tree pair's, plus the table's bytes; B1 does
    # not count the residual S (its TPU counterpart writes lnf alone), B3
    # and both adjoints do
    f3, b3 = cuda_pruning.kernel_work("big_fwd", big, 4, 10240, 61, 8)
    f4, b4 = cuda_pruning.kernel_work("big_bwd", big, 4, 10240, 61, 8)
    assert f1 - f3 == f2 - f4 == table
    S = 511 * 4 * 61 * 10240 * 8
    assert b2 - b4 == 49 * 61 * 8 and b3 - b1 == S - 49 * 61 * 8
    # codes, 4 bytes a cell, not [ns, H, n] partials (5.1 GB in f64)
    assert b1 < 10240 * 1024 * 61 * 8
    # the products set the bound
    assert round(cuda_pruning.bound_ms(f1, b1), 2) == 4.67
    assert f1 / cuda_pruning.PEAK_FLOPS > b1 / cuda_pruning.PEAK_BYTES


def test_kernel_work_fwd_bound_at_bench_shape():
    # B1 at the bench shape (32 taxa, ladder, 4096 patterns, 3 classes,
    # f64) with one ambiguity vector: without S its bound is set by the
    # operations (S, 0.18 GB, would have made it the bytes')
    _, _, bench, _ = _random_problem(ns=32, H=8, ladder=True)
    bench = interop.topology_from(bench)
    f1, b1 = cuda_pruning.kernel_work("pruning_fwd", bench, 3, 4096, 61, 8,
                                      n_amb=1)
    f3, b3 = cuda_pruning.kernel_work("big_fwd", bench, 3, 4096, 61, 8)
    S = cuda_pruning.big_plan(bench).n_srows * 3 * 61 * 4096 * 8
    assert round(S / 1e9, 2) == 0.18 and b3 - b1 == S - 61 * 8
    assert f1 / cuda_pruning.PEAK_FLOPS > b1 / cuda_pruning.PEAK_BYTES
    assert round(cuda_pruning.bound_ms(f1, b1), 3) == 0.041
    assert b3 / cuda_pruning.PEAK_BYTES > f3 / cuda_pruning.PEAK_FLOPS


@pytest.mark.parametrize("ns, C, A, esize, fits", [
    (32, 3, 151, 8, True),          # phase 3's wide tips: 7.9 MB
    (1024, 4, 49, 8, True),         # the gapped 1024-taxon alignment
    (1024, 4, 300, 8, True),        # the issue's A = 300: 671 MB
    (32, 3, 32 * 4096, 8, True),    # soft partials, bench shape: 6.4 GB
    (128, 3, 128 * 1024, 8, False),  # soft partials, 128 taxa: 25.8 GB
    (1024, 4, 1024 * 10240, 4, False),
])
def test_tip_table_must_fit_the_card(ns, C, A, esize, fits):
    # B1/B2's table TA [ns, C, 64, LA] may take at most 1/8 of an 80 GB
    # card; a larger one raises before anything is allocated
    mem = 80 * 2 ** 30
    need = cuda_pruning.tip_table_bytes(ns, C, A, esize, 64)
    assert need == ns * C * 64 * (-(-A // 32) * 32) * esize
    if fits:
        cuda_pruning.check_tip_table(ns, C, A, esize, mem, 64)
    else:
        with pytest.raises(ValueError, match="tip table"):
            cuda_pruning.check_tip_table(ns, C, A, esize, mem, 64)
