"""paml_tpu_torch large-tree pruning (B3/B4) against paml_tpu: the
schedules against `pallas_pruning_big._sched_arrays`; the plain B3 (lnf and
the residual S) against the Pallas kernel in interpret mode in float32 to
2e-6; the plain B4 against the Pallas kernel's gradient in float32 to 3e-5
and against `jax.grad` of the level path in float64 to 1e-10; the rule
that picks B3/B4 over B1/B2; `lnL_chunked` against the JAX package's; and
the state-code check of the public kernel wrappers."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.core import pallas_pruning_big
from paml_tpu.core import pruning as jax_pruning
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
    # one 1024-pattern chunk of the 1024-taxon branch-site shape: B2's
    # workspace budget gives 2 blocks per class for 16 tiles
    big = _balanced_topo(1024)
    assert cuda_pruning.bwd_grid(big.nnode, big.ns, 4, 16, 8) == 2
    assert cuda_pruning.use_big_kernels(big, 4, 1024, True, 8)
    assert cuda_pruning.use_big_kernels(big, 4, 10240, True, 4)
    # multi-hot tips stay on B1/B2 (B3/B4 take state codes only)
    assert not cuda_pruning.use_big_kernels(big, 4, 1024, False, 8)
    # the bench shape: B2 gives every tile its own block
    _, _, bench, _ = _random_problem(ns=32, H=8, ladder=True)
    assert not cuda_pruning.use_big_kernels(interop.topology_from(bench), 3,
                                            4096, True, 8)


def test_big_adjoint_grid_fills_the_card():
    # H100: 132 SMs, 80 GB; f64 slabs of the 1024-taxon tree are 268 MB
    # per g, so G x C reaches the SM count, capped by the tile count
    big = _balanced_topo(1024)
    wpb = (11 + 1 + 4) * 64 * 64
    assert cuda_pruning.big_bwd_grid(big.nnode, 4, 160, 8, 132, 80 << 30,
                                     wpb) == 33
    assert cuda_pruning.big_bwd_grid(big.nnode, 4, 16, 8, 132, 80 << 30,
                                     wpb) == 16
    # a small card caps G by memory
    assert cuda_pruning.big_bwd_grid(big.nnode, 4, 160, 8, 132, 8 << 30,
                                     wpb) == 3


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
                      (cuda_pruning.pruning_bwd, (gbar,)),
                      (cuda_pruning.pruning_big_fwd, ()),
                      (cuda_pruning.pruning_big_bwd, (gbar, None))):
        with pytest.raises(ValueError, match="state codes"):
            fn(Pt, bad, ttopo, pit, *extra)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(Pt, tipst, ttopo, pit, *extra)
    assert not any(cuda_pruning.LAUNCHES.values())
