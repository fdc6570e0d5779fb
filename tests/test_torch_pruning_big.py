"""paml_tpu_torch large-tree pruning (B3/B4) against paml_tpu: the
schedules against `pallas_pruning_big._sched_arrays`; the plain B3 (lnf and
the residual S) against the Pallas kernel in interpret mode in float32 to
2e-6; the plain B4 against the Pallas kernel's gradient in float32 to 3e-5
and against `jax.grad` of the level path in float64 to 1e-10; the binary
resolution B3/B4 walk, against `jax.grad` of the level path on the tree as
given; the rule that picks B3/B4 over B1/B2; `lnL_chunked` against the JAX
package's; and the state-code check of the public kernel wrappers."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.core import pallas_pruning_big
from paml_tpu.core import pruning as jax_pruning
from paml_tpu.core import topology as jax_topology
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.core import cuda_pruning, pruning
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io import treeio

from test_pallas_pruning import _random_problem

TREES = {"ladder": dict(ns=9, ladder=True),
         "balanced": dict(ns=8, root_trifurcation=False),
         "trifurcating": dict(ns=11),
         "balanced64": dict(ns=64, root_trifurcation=False)}


@pytest.mark.parametrize("tree", list(TREES))
def test_big_plan_matches_sched_arrays(tree):
    _, _, topo, _ = _random_problem(H=8, **TREES[tree])
    fs, bs, kmax, n_srows, all_full = pallas_pruning_big._sched_arrays(topo)
    bp = cuda_pruning.big_plan(interop.topology_from(topo))
    np.testing.assert_array_equal(bp.fs, fs)
    np.testing.assert_array_equal(bp.bs, bs)
    assert (bp.kmax, bp.n_srows, bp.all_full) == (kmax, n_srows, all_full)
    assert bp.fs.dtype == np.int32 and bp.bs.dtype == np.int32
    # the residual rows name their nodes in row order
    assert [int(fs[i, 0]) for i in range(len(fs)) if fs[i, 2] >= 0] == \
        bp.srow_nodes


def _big_problem(tree, dtype, seed, H=193, C=3):
    P, tips, topo, pi = _random_problem(H=H, C=C, seed=seed,
                                        state_tips=True, **TREES[tree])
    P, pi = jnp.asarray(P, dtype), jnp.asarray(pi, dtype)
    gbar = np.random.default_rng(seed + 1).uniform(
        0.5, 2.0, size=(C, H)).astype(dtype)
    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    return (P, tips, topo, pi, gbar), (Pt, tipst, interop.topology_from(topo),
                                       pit, torch.tensor(gbar))


@pytest.mark.parametrize("tree", ["ladder", "trifurcating"])
def test_plain_big_forward_matches_pallas_interpret(tree):
    (P, tips, topo, pi, _), (Pt, tipst, ttopo, pit, _) = _big_problem(
        tree, np.float32, seed=3)
    ref, S_ref = pallas_pruning_big._fwd_big_call(P, tips, pi, topo, 128,
                                                  True, interpret=True)
    lnf, S = pruning.class_site_lnf_big_plain(Pt, tipst, ttopo, pit)
    n, H = P.shape[-1], tips.shape[1]
    assert lnf.dtype == torch.float32 and S.shape == (
        cuda_pruning.big_plan(ttopo).n_srows, P.shape[1], n, H)
    np.testing.assert_allclose(lnf.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_ref)[:, :, :n, :H],
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("tree", ["ladder", "trifurcating"])
def test_plain_big_adjoint_matches_pallas_interpret(tree):
    (P, tips, topo, pi, gbar), (Pt, tipst, ttopo, pit, gb) = _big_problem(
        tree, np.float32, seed=4)

    def obj(P_, pi_):
        return jnp.sum(jnp.asarray(gbar) * pallas_pruning_big.
                       class_site_lnf_big(P_, tips, topo, pi_, 128, True))
    gP, gpi = jax.grad(obj, argnums=(0, 1))(P, pi)
    _, S = pruning.class_site_lnf_big_plain(Pt, tipst, ttopo, pit)
    dP, dpi = pruning.class_site_lnf_big_bwd_plain(Pt, tipst, ttopo, pit, gb,
                                                   S)
    np.testing.assert_allclose(dP.numpy(), np.asarray(gP), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(dpi.numpy(), np.asarray(gpi), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("tree", ["ladder", "balanced", "trifurcating"])
def test_plain_big_adjoint_matches_jax_grad_f64(tree):
    (P, tips, topo, pi, gbar), (Pt, tipst, ttopo, pit, gb) = _big_problem(
        tree, np.float64, seed=5, C=2)

    def obj(P_, pi_):
        lnf = jax_pruning._class_site_lnf_lvl(P_, tips, topo, pi_)
        return jnp.sum(jnp.asarray(gbar) * lnf), lnf
    (_, ref), (gP, gpi) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(P, pi)
    lnf, S = pruning.class_site_lnf_big_plain(Pt, tipst, ttopo, pit)
    dP, dpi = pruning.class_site_lnf_big_bwd_plain(Pt, tipst, ttopo, pit, gb,
                                                   S)
    np.testing.assert_allclose(lnf.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(dP.numpy(), np.asarray(gP), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(dpi.numpy(), np.asarray(gpi), rtol=1e-10,
                               atol=1e-10)


def _balanced_topo(ns):
    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    return from_treenode(treeio.parse_newick(bal(0, ns) + ";"), names)


def test_dispatch_picks_big_kernels_for_large_trees():
    # one 1024-pattern chunk of the 1024-taxon branch-site shape: the
    # adjoints of both pairs take 32 blocks per class for its 32 tiles
    big = _balanced_topo(1024)
    ntiles = cuda_pruning.big_tiles(1024)
    assert cuda_pruning.big_bwd_grid(
        big.nnode, 4, ntiles, 8, 132, 80 << 30,
        cuda_pruning.big_plan(big).work_per_block(64), 64) == ntiles == 32
    assert cuda_pruning.use_big_kernels(True)
    # multi-hot tips stay on B1/B2 (B3/B4 take state codes only)
    assert not cuda_pruning.use_big_kernels(False)
    # the bench shape (B3+B4 beat B1+B2 there too since their redesign)
    # and a node of 4 children: B3/B4 walk the tree as given or its binary
    # resolution
    _, _, bench, _ = _random_problem(ns=32, H=8, ladder=True)
    bench = interop.topology_from(bench)
    assert cuda_pruning.big_tree(bench) is bench
    names = [f"t{i}" for i in range(6)]
    wide = from_treenode(treeio.parse_newick("(t0,t1,t2,(t3,t4,t5));"),
                         names)
    assert cuda_pruning.big_plan(wide).kmax == 4
    assert cuda_pruning.big_plan(cuda_pruning.big_tree(wide)).kmax == \
        cuda_pruning.BIG_KMAX == 2


WIDE = {"root3": "((t0,t1),t2,(t3,t4));",
        "root4": "((t0,t1),(t2,t3),(t4,t5),(t6,t7));",
        "star9": "(t0,t1,t2,t3,t4,t5,t6,t7,t8);",
        "nested5": "((t0,t1),t2,(t3,t4,t5,t6,t7));",
        "inner3": "((t0,t1,t2),(t3,t4));",
        "two_wide": "((t0,t1,t2,t3),(t4,t5,t6),t7);"}


@pytest.mark.parametrize("tree", list(WIDE))
def test_resolved_tree_keeps_lnf_and_gradient(tree):
    # B3/B4's plain versions on the binary resolution (identity P on the
    # added nodes) against jax.grad of the JAX level path on the tree as
    # given
    nwk = WIDE[tree]
    ns = nwk.count("t")
    names = [f"t{i}" for i in range(ns)]
    topo = from_treenode(treeio.parse_newick(nwk), names)
    tb = cuda_pruning.big_tree(topo)
    assert tb.nnode > topo.nnode and cuda_pruning.big_plan(tb).kmax == 2
    # a binary tree keeps one internal node per tip but one
    assert tb.nnode == 2 * ns - 1
    assert tb.root == topo.root and list(tb.postorder)[-1] == tb.root
    rng = np.random.default_rng(11)
    n, C, H = 61, 2, 37
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.7 * np.eye(n) + 0.3 * P / P.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(n), size=C)
    tips = rng.integers(0, n, size=(ns, H)).astype(np.int32)
    gbar = rng.uniform(0.5, 2.0, size=(C, H))
    jtopo = jax_topology.from_treenode(jax_treeio.parse_newick(nwk), names)

    def obj(P_, pi_):
        lnf = jax_pruning._class_site_lnf_lvl(P_, jnp.asarray(tips), jtopo,
                                              pi_)
        return jnp.sum(jnp.asarray(gbar) * lnf), lnf
    (_, ref), (gP, gpi) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(jnp.asarray(P), jnp.asarray(pi))
    Pb = cuda_pruning.with_identity(torch.tensor(P), tb)
    assert Pb.shape[0] == tb.nnode
    assert torch.equal(Pb[topo.nnode:, 1], torch.eye(n).expand(
        tb.nnode - topo.nnode, n, n))
    tt, pit = torch.tensor(tips), torch.tensor(pi)
    lnf, S = pruning.class_site_lnf_big_plain(Pb, tt, tb, pit)
    dP, dpi = pruning.class_site_lnf_big_bwd_plain(Pb, tt, tb, pit,
                                                   torch.tensor(gbar), S)
    np.testing.assert_allclose(lnf.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(dP[:topo.nnode].numpy(), np.asarray(gP),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dpi.numpy(), np.asarray(gpi), rtol=1e-10,
                               atol=1e-10)


def test_resolving_a_star_tree_stays_shallow():
    # 1024 tips under one root: log-depth resolution, so B4's adjoint
    # slots (about one per level) stay few
    names = [f"t{i}" for i in range(1024)]
    star = from_treenode(treeio.parse_newick(
        "(" + ",".join(names) + ");"), names)
    tb = cuda_pruning.big_tree(star)
    assert tb.nnode == 2047 and cuda_pruning.big_tree(star) is tb
    assert cuda_pruning.big_plan(tb).nslots <= 11
    # a binary tree is its own resolution
    bal = _balanced_topo(64)
    assert cuda_pruning.big_tree(bal) is bal


def test_big_adjoint_grid_fills_the_card():
    # H100: 132 SMs, 80 GB; f64 slabs of the 1024-taxon tree are 268 MB
    # per g, so G x C reaches the SM count, capped by the tile count
    big = _balanced_topo(1024)
    wpb = cuda_pruning.big_plan(big).work_per_block(64)
    assert wpb == (11 + 1) * cuda_pruning.BIG_TMAX * 64 * 32
    ntiles = cuda_pruning.big_tiles(10240)
    assert cuda_pruning.big_bwd_grid(big.nnode, 4, ntiles, 8, 132, 80 << 30,
                                     wpb, 64) == 33
    assert cuda_pruning.big_bwd_grid(big.nnode, 4, 16, 8, 132, 80 << 30,
                                     wpb, 64) == 16
    # a small card caps G by memory
    assert cuda_pruning.big_bwd_grid(big.nnode, 4, ntiles, 8, 132, 8 << 30,
                                     wpb, 64) == 3
    # each block walks its tiles in visits of at most BIG_TMAX
    assert cuda_pruning.visit_tiles(ntiles, 33) == 10
    assert cuda_pruning.visit_tiles(ntiles, 3) == cuda_pruning.BIG_TMAX


@pytest.mark.parametrize("esize", [4, 8])
def test_big_grids_fill_the_card_at_a_chunk(esize):
    # one 1024-pattern chunk of the 1024-taxon tree, C = 4: at least 128
    # blocks for both kernels on the H100's 132 SMs
    big = _balanced_topo(1024)
    ntiles = cuda_pruning.big_tiles(1024)
    assert ntiles * 4 >= 128
    wpb = cuda_pruning.big_plan(big).work_per_block(64)
    G = cuda_pruning.big_bwd_grid(big.nnode, 4, ntiles, esize, 132, 80 << 30,
                                  wpb, 64)
    assert G * 4 >= 128
    assert cuda_pruning.visit_tiles(ntiles, G) == 1


@pytest.mark.parametrize("kmax", [2, 3])
@pytest.mark.parametrize("esize", [4, 8])
def test_big_shared_memory_fits_a_block(esize, kmax):
    # a root of kmax children: the wrapper passes the shared memory of the
    # tree B3/B4 walk, its binary resolution
    names = [f"t{i}" for i in range(2 * kmax)]
    kids = ",".join(f"({names[2 * i]},{names[2 * i + 1]})"
                    for i in range(kmax))
    topo = from_treenode(treeio.parse_newick(f"({kids});"), names)
    walked = cuda_pruning.big_plan(cuda_pruning.big_tree(topo)).kmax
    assert walked == cuda_pruning.BIG_KMAX == 2
    fwd = cuda_pruning.big_fwd_smem(esize, 64)
    bwd = cuda_pruning.big_bwd_smem(esize, walked, 64)
    assert 0 < fwd <= cuda_pruning.SMEM_MAX == 232448
    assert 0 < bwd <= cuda_pruning.SMEM_MAX
    # B4 holds, per child, P_k (or a tip's dP_k), c_k, s_k and G_k
    assert bwd >= walked * (64 * 64 + 3 * 64 * 32) * esize


def test_kernel_work_at_1024_taxa():
    # the 1024-taxon balanced tree x 10240 patterns x 4 classes, f64, n 61:
    # B4 needs 3066 products of 2 * 61^2 per pattern and class, B3 1022
    big = _balanced_topo(1024)
    prod = 2 * 61 * 61 * 10240 * 4
    f4, b4 = cuda_pruning.kernel_work("big_bwd", big, 4, 10240, 61, 8)
    f3, b3 = cuda_pruning.kernel_work("big_fwd", big, 4, 10240, 61, 8)
    assert f4 == 3066 * prod and round(f4 / 1e9) == 935
    assert f3 == 1022 * prod and round(f3 / 1e9) == 312
    S = 511 * 4 * 61 * 10240 * 8
    assert round(S / 1e8) == 102            # the residual, 10.2 GB
    assert S < b3 < S + 0.4e9 and S < b4 < S + 0.8e9   # + P, dP, tips
    assert round(cuda_pruning.bound_ms(f4, b4), 2) == 13.95
    assert round(cuda_pruning.bound_ms(f3, b3), 2) == 4.65
    # B1/B2 at the bench shape (32 taxa, ladder, 4096 patterns, 3 classes)
    _, _, bench, _ = _random_problem(ns=32, H=8, ladder=True)
    bench = interop.topology_from(bench)
    f1, _ = cuda_pruning.kernel_work("pruning_fwd", bench, 3, 4096, 61, 8)
    f2, _ = cuda_pruning.kernel_work("pruning_bwd", bench, 3, 4096, 61, 8)
    assert f1 == 30 * 2 * 61 * 61 * 4096 * 3 and f2 == 3 * f1


@pytest.mark.parametrize("tree", list(TREES))
def test_forward_table_keeps_last_children(tree):
    # B3's table: a row keeps its contribution in shared memory exactly
    # when the next row is its parent, and that row reads it there
    _, _, topo, _ = _random_problem(H=8, **TREES[tree])
    topo = interop.topology_from(topo)
    bp = cuda_pruning.big_plan(topo)
    p = cuda_pruning.plan(topo)
    fsi, kmax = bp.fsi, bp.kmax
    assert fsi.dtype == np.int32 and fsi.shape[1] == 5 + 2 * kmax
    assert list(fsi[:, 0]) == [v for v in p.order if v >= topo.ns]
    for i, row in enumerate(fsi):
        kids = p.kids_of[int(row[0])]
        assert list(row[3 + kmax:3 + kmax + len(kids)]) == list(kids)
        nxt = fsi[i + 1] if i + 1 < len(fsi) else None
        keep = nxt is not None and p.kids_of[int(nxt[0])][-1] == row[0]
        assert row[-2] == int(keep)
        if row[-1] >= 0:
            assert kids[row[-1]] == fsi[i - 1, 0] and fsi[i - 1, -2] == 1


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_lnL_chunked_matches_jax(n_chunks):
    P, tips, topo, pi = _random_problem(ns=11, H=195, C=3, seed=7)
    P, pi = jnp.asarray(P, jnp.float64), jnp.asarray(pi, jnp.float64)
    rng = np.random.default_rng(8)
    w = rng.dirichlet(np.ones(3))
    fpatt = rng.integers(1, 5, size=195).astype(np.float64)

    def f(P_, pi_, w_):
        return jax_pruning.lnL_chunked(P_, tips, topo, pi_, w_,
                                       jnp.asarray(fpatt), n_chunks)
    v_ref, g_ref = jax.value_and_grad(f, argnums=(0, 1, 2))(P, pi,
                                                           jnp.asarray(w))
    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    ins = [t.clone().requires_grad_(True)
           for t in (Pt, pit, torch.tensor(w))]
    tc, fc = pruning.split_patterns(tipst, torch.tensor(fpatt), n_chunks)
    assert len(tc) == n_chunks and all(t.is_contiguous() for t in tc)
    v = pruning.lnL_chunked(ins[0], tc, interop.topology_from(topo), ins[1],
                            ins[2], fc)
    grads = torch.autograd.grad(v, ins)
    assert abs(v.item() - float(v_ref)) <= 1e-10 * abs(float(v_ref))
    for got, ref in zip(grads, g_ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())
    with pytest.raises(ValueError, match="equal chunks"):
        pruning.split_patterns(tipst, torch.tensor(fpatt), 2)


def test_public_wrappers_check_state_codes():
    P, tips, topo, pi = _random_problem(ns=9, H=20, C=2, seed=9)
    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    ttopo = interop.topology_from(topo)
    bad = tipst.clone()
    bad[3, 7] = Pt.shape[-1]
    gbar = torch.ones(2, 20)
    for fn, extra in ((cuda_pruning.pruning_fwd, ()),
                      (cuda_pruning.pruning_bwd, (gbar, None)),
                      (cuda_pruning.pruning_big_fwd, ()),
                      (cuda_pruning.pruning_big_bwd, (gbar, None))):
        with pytest.raises(ValueError, match="state codes"):
            fn(Pt, bad, ttopo, pit, *extra)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(Pt, tipst, ttopo, pit, *extra)
    assert not any(cuda_pruning.LAUNCHES.values())
