"""paml_tpu_torch pruning against paml_tpu: the plain version and its
analytic adjoint against `_class_site_lnf_lvl` and `jax.grad` (float64
to 1e-10, float32 to 2e-6 on values and 3e-5 on gradients, the Pallas
kernel's own tolerances), once against the Pallas kernel in interpret
mode; the kernels' schedule (order and slots) against
`pallas_pruning._plan`; the CPU behaviour of the dispatch (no kernel
launch, no plain call counted on CUDA, kernel wrappers refuse CPU
tensors); and B2's grid."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.core import pallas_pruning
from paml_tpu.core import pruning as jax_pruning
from paml_tpu_torch import interop
from paml_tpu_torch.core import cuda_pruning, pruning

from test_pallas_pruning import _random_problem

TOL = {np.float64: dict(val=1e-10, grad=1e-10),
       np.float32: dict(val=2e-6, grad=3e-5)}

CASES = [dict(ns=9, C=1, ladder=True),
         dict(ns=8, C=2, root_trifurcation=False),
         dict(ns=11, C=4)]                       # trifurcating root


def _problem(case, state_tips, dtype, seed):
    P, tips, topo, pi = _random_problem(H=193, state_tips=state_tips,
                                        seed=seed, **case)
    P = jnp.asarray(P, dtype)
    pi = jnp.asarray(pi, dtype)
    if not state_tips:
        tips = jnp.asarray(tips, dtype)
    return P, tips, topo, pi


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("state_tips", [True, False])
@pytest.mark.parametrize("case", CASES, ids=["ladder", "balanced",
                                             "trifurcating"])
def test_plain_lnf_and_adjoint_match_jax(case, state_tips, dtype):
    P, tips, topo, pi = _problem(case, state_tips, dtype, seed=case["ns"])
    C, H = P.shape[1], tips.shape[1]
    gbar = np.random.default_rng(3).uniform(0.5, 2.0, size=(C, H)).astype(
        dtype)

    def obj(P_, pi_):
        lnf = jax_pruning._class_site_lnf_lvl(P_, tips, topo, pi_)
        return jnp.sum(jnp.asarray(gbar) * lnf), lnf
    (_, ref), (gP, gpi) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(P, pi)

    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    ttopo = interop.topology_from(topo)
    tol = TOL[dtype]
    # forward through the public entry (CPU -> plain version)
    Pg = Pt.clone().requires_grad_(True)
    pig = pit.clone().requires_grad_(True)
    lnf = pruning.class_site_lnf(Pg, tipst, ttopo, pig)
    assert lnf.dtype == Pt.dtype and lnf.shape == (C, H)
    np.testing.assert_allclose(lnf.detach().numpy(), np.asarray(ref),
                               rtol=tol["val"], atol=tol["val"])
    # backward through autograd, and the adjoint as a plain function
    (lnf * torch.tensor(gbar)).sum().backward()
    dP, dpi = pruning.class_site_lnf_bwd_plain(Pt, tipst, ttopo, pit,
                                               torch.tensor(gbar))
    for got in ((Pg.grad, pig.grad), (dP, dpi)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(gP),
                                   rtol=tol["grad"], atol=tol["grad"])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(gpi),
                                   rtol=tol["grad"], atol=tol["grad"])


def test_plain_lnf_matches_pallas_interpret():
    P, tips, topo, pi = _random_problem(ns=11, H=193, C=4, seed=5)
    ref = pallas_pruning.class_site_lnf_pallas(P, tips, topo, pi, 128, True)
    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    got = pruning.class_site_lnf(Pt, tipst, interop.topology_from(topo), pit)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("case", CASES + [dict(ns=40, C=1, ladder=True)],
                         ids=["ladder", "balanced", "trifurcating",
                              "deep_ladder"])
def test_schedule_table_matches_pallas_plan(case):
    # the postorder, children and slot liveness the kernels' tables
    # (`BigPlan`) are built from
    _, _, topo, _ = _random_problem(H=8, **case)
    ref = pallas_pruning._plan(topo)
    plan = cuda_pruning.plan(interop.topology_from(topo))
    assert plan.order == ref.order
    assert plan.slot == ref.slot
    assert plan.nslots == ref.nslots
    assert plan.root == ref.root
    assert {v: k for v, k in plan.kids_of.items() if k} == \
        {v: k for v, k in ref.kids_of.items() if k}


def test_cpu_dispatch_counts_nothing():
    P, tips, topo, pi = _problem(CASES[2], True, np.float64, seed=1)
    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    ttopo = interop.topology_from(topo)
    cuda_pruning.reset_launch_counts()
    before = pruning.PLAIN_CALLS["cuda"]
    Pg = Pt.requires_grad_(True)
    w = torch.ones(Pt.shape[1], dtype=torch.float64) / Pt.shape[1]
    fpatt = torch.ones(tipst.shape[1], dtype=torch.float64)
    val = pruning.lnL(Pg, tipst, ttopo, pit, w, fpatt)
    val.backward()
    post = pruning.site_class_posterior(Pt.detach(), tipst, ttopo, pit, w)
    np.testing.assert_allclose(post.sum(0).numpy(), 1.0, rtol=1e-12)
    assert torch.isfinite(Pg.grad).all()
    assert not any(cuda_pruning.LAUNCHES.values())
    assert pruning.PLAIN_CALLS["cuda"] == before


def test_kernel_wrappers_refuse_cpu_tensors():
    P, tips, topo, pi = _problem(CASES[0], True, np.float64, seed=2)
    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    ttopo = interop.topology_from(topo)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pruning.pruning_fwd(Pt, tipst, ttopo, pit)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pruning.pruning_bwd(Pt, tipst, ttopo, pit,
                                 torch.ones(1, tipst.shape[1]), None)
    # dense partials are coded before the device check
    hot = torch.nn.functional.one_hot(tipst.long(), Pt.shape[-1]).double()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pruning.pruning_fwd(Pt, hot, ttopo, pit)
    assert not any(cuda_pruning.LAUNCHES.values())


def test_state_codes_are_range_checked():
    cuda_pruning.check_state_codes(torch.tensor([[0, 60], [3, 4]],
                                                dtype=torch.int32), 61)
    for bad in (61, -1):
        with pytest.raises(ValueError, match="state codes"):
            cuda_pruning.check_state_codes(
                torch.tensor([[0, bad]], dtype=torch.int32), 61)
    # coded tips: codes n .. n + A - 1 name the ambiguity table's rows
    cuda_pruning.check_state_codes(torch.tensor([[0, 63]],
                                                dtype=torch.int32), 61, 3)
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        cuda_pruning.check_state_codes(
            torch.tensor([[64, 0]], dtype=torch.int32), 61, 3)


@pytest.mark.parametrize("shape", ["bench", "bench_m0", "chunk1024",
                                   "unchunked1024"])
def test_adjoint_grid_fills_the_card(shape):
    # B2 sizes its grid as B4 does: G x C reaches the H100's 132 SMs where
    # there are as many (tile, class) pairs, one tile or more per block,
    # and the card's size (not a workspace budget) caps it
    ns, H, C = {"bench": (32, 4096, 3), "bench_m0": (32, 4096, 1),
                "chunk1024": (1024, 1024, 4),
                "unchunked1024": (1024, 10240, 4)}[shape]
    topo = _balanced(ns) if ns == 1024 else interop.topology_from(
        _random_problem(ns=32, H=8, ladder=True)[2])
    bp = cuda_pruning.big_plan(topo)
    ntiles = cuda_pruning.big_tiles(H)
    for esize in (4, 8):
        G = cuda_pruning.big_bwd_grid(topo.nnode, C, ntiles, esize, 132,
                                      80 << 30, bp.work_per_block(64), 64)
        assert G * C >= min(132, ntiles * C) and G <= ntiles
        tv = cuda_pruning.visit_tiles(ntiles, G)
        assert tv * G >= ntiles and tv <= cuda_pruning.BIG_TMAX
    # slabs and workspace stay within an eighth of the card
    per_g = (topo.nnode * C * 64 * 64 + C * 64 + C * bp.work_per_block(64)) \
        * 8
    assert G * per_g <= (80 << 30) // cuda_pruning.BIG_WORK_SHARE


def _balanced(ns):
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio
    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    return from_treenode(treeio.parse_newick(bal(0, ns) + ";"), names)
