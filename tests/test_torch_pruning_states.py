"""The padded state count of the CUDA pruning walk, on the CPU: the
instance each state count takes (N = 32 for 16 to 32 states, N = 64 for
33 to 64), the wrapper's padded inputs and the sizes it launches with at
each N, the entry points and the profiler census by instance, padding
changing no value of the plain versions (1e-14 relative, float64), and
the port's plain route at 20 states against the JAX package's Pallas
kernel in interpret mode (N = 24 there), value and gradient within that
kernel's own float32 tolerances (2e-6, 3e-5)."""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.core import pallas_pruning
from paml_tpu_torch import _build, interop
from paml_tpu_torch.core import cuda_pruning as cp
from paml_tpu_torch.core import graphs, pruning
from paml_tpu_torch.core.tipcodes import TipCodes

from test_pallas_pruning import _random_problem

torch.set_num_threads(1)


@pytest.mark.parametrize("n, npad", [(16, 32), (20, 32), (32, 32),
                                     (33, 64), (61, 64), (64, 64)])
def test_padded_state_count(n, npad):
    assert cp.padded_states(n) == npad


@pytest.mark.parametrize("n", [0, 65])
def test_padded_state_count_refuses(n):
    with pytest.raises(ValueError, match="states"):
        cp.padded_states(n)


def test_forced_instance_must_take_the_states():
    assert cp._npad(20, None) == 32 and cp._npad(20, 64) == 64
    for n, npad in ((20, 16), (20, 48), (40, 32)):
        with pytest.raises(ValueError, match="instance"):
            cp._npad(n, npad)


def _coded_problem(n=20, ns=11, H=193, C=4, seed=5, dtype=torch.float64):
    """P, TipCodes (state codes below n, a gap and two sets above), topo
    and pi at n states on the trifurcating tree of `_random_problem`."""
    rng = np.random.default_rng(seed)
    _, _, topo, _ = _random_problem(ns=ns, H=8, C=C, n=n, seed=seed)
    topo = interop.topology_from(topo)
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.7 * np.eye(n) + 0.3 * P / P.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(n), size=C)
    codes = rng.integers(0, n, size=(ns, H)).astype(np.int32)
    amb = np.zeros((3, n))
    amb[0] = 1.0
    amb[1, [2, 3]] = amb[2, [5, 9]] = 1.0
    cells = rng.random((ns, H)) < 0.1
    codes[cells] = n + rng.integers(0, 3, size=int(cells.sum()))
    tips = TipCodes(torch.tensor(codes), torch.tensor(amb, dtype=dtype))
    return (torch.tensor(P, dtype=dtype), tips, topo,
            torch.tensor(pi, dtype=dtype))


def test_inputs_pad_to_32_at_20_states():
    P, tips, topo, pi = _coded_problem()
    x = cp._Inputs(P, tips, topo, pi)
    run = cp.big_tree(topo)
    assert x.N == 32 and x.n == 20 and x.fused and x.A == 3
    assert tuple(x.P.shape) == (run.nnode, 4, 32, 32)
    assert tuple(x.pi.shape) == (4, 32) and tuple(x.amb.shape) == (3, 32)
    assert torch.equal(x.P[:topo.nnode, :, :20, :20], P)
    assert torch.equal(x.pi[:, :20], pi)
    assert torch.equal(x.amb[:, :20], tips.amb)
    for t in (x.P[..., 20:, :], x.P[..., :, 20:], x.pi[:, 20:],
              x.amb[:, 20:]):
        assert t.numel() and not t.any()
    # the nodes big_tree added take an identity P on the real states
    eye = torch.eye(20, dtype=P.dtype).expand(run.nnode - topo.nnode, 4,
                                              20, 20)
    assert torch.equal(x.P[topo.nnode:, :, :20, :20], eye)
    # forced to N = 64 (the wrappers' `npad`), and 61 states at 64
    assert tuple(cp._Inputs(P, tips, topo, pi, 64).P.shape[2:]) == (64, 64)
    P61 = torch.rand(topo.nnode, 1, 61, 61, dtype=torch.float64)
    x61 = cp._Inputs(P61, torch.zeros(topo.ns, 5, dtype=torch.int32), topo,
                     torch.rand(1, 61, dtype=torch.float64))
    assert x61.N == 64 and x61.amb is None


def test_launches_refuse_cpu_inputs():
    P, tips, topo, pi = _coded_problem()
    cp.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cp.pruning_fwd(P, tips, topo, pi, npad=64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cp.pruning_big_bwd(P, tips.codes.clamp(max=19), topo, pi,
                           torch.ones(4, 193, dtype=P.dtype), None)
    assert not any(cp.LAUNCHES.values())
    assert set(cp.INSTANCE_LAUNCHES) == {
        f"{k}_n{m}" for k in cp.KERNELS for m in (32, 64)}
    assert not any(cp.INSTANCE_LAUNCHES.values())


@pytest.mark.parametrize("esize", [4, 8])
def test_shared_memory_and_tables_at_each_instance(esize):
    # hand counts from the carve of pruning_tree.cuh: LDN = N + 4, LDH =
    # 36, the column-reduction scratch 2 x 8 x 32
    fwd = {32: (32 * 36 + 2 * 32 * 36 + 512) * esize,
           64: (64 * 68 + 2 * 64 * 36 + 512) * esize}
    bwd = {32: (2 * 32 * 36 + 7 * 32 * 36 + 512 + 32) * esize,
           64: (2 * 64 * 68 + 7 * 64 * 36 + 512 + 64) * esize}
    for m in (32, 64):
        assert cp.big_fwd_smem(esize, m) == fwd[m]
        assert cp.big_bwd_smem(esize, 2, m) == bwd[m]
        assert cp.tip_table_bytes(11, 4, 33, esize, m) == \
            11 * 4 * m * 64 * esize
    # the parent's N = 64 values, float64: 75,776 and 203,264 bytes
    if esize == 8:
        assert (fwd[64], bwd[64]) == (75776, 203264)
        assert (fwd[32], bwd[32]) == (31744, 87296)
    # an adjoint block at N = 32 takes about 2.3 x less shared memory
    assert bwd[64] / bwd[32] > 2.3


def test_workspace_and_grid_at_each_instance():
    _, _, topo, _ = _random_problem(ns=32, H=8, ladder=True)
    topo = interop.topology_from(topo)
    bp = cp.big_plan(topo)
    for m in (32, 64):
        assert bp.work_per_block(m) == (bp.nslots + 1) * 16 * m * 32
    # aaml's shape, 4 classes x 1559 tiles: G x C fills the 132 SMs at
    # either instance, so both sum their dP slabs in the same order
    g = {m: cp.big_bwd_grid(topo.nnode, 4, 1559, 8, 132, 80 << 30,
                            bp.work_per_block(m), m) for m in (32, 64)}
    assert g == {32: 33, 64: 33}
    # a card of 64 MiB caps G by the slabs, a quarter of N = 64's at 32
    per_g = {m: (topo.nnode * 4 * m * m + 4 * m + 4 * bp.work_per_block(m))
             * 8 for m in (32, 64)}
    mem = 64 << 20
    for m in (32, 64):
        assert cp.big_bwd_grid(topo.nnode, 4, 1559, 8, 132, mem,
                               bp.work_per_block(m), m) == \
            max(1, mem // 8 // per_g[m])
    assert per_g[64] > 3 * per_g[32]


def test_entry_points_of_each_instance():
    # the wrapper's symbol names, and each one instantiated in csrc
    src = {p.stem: p.read_text() for p in _build.CSRC.glob("*.cu")}
    assert cp._suffix(torch.float64, 32) == "f64_n32"
    assert cp._suffix(torch.float32, 64) == "f32_n64"
    assert set(_build._WALK_SUFFIXES) == {"f32_n32", "f32_n64", "f64_n32",
                                          "f64_n64"}
    for stem, macro in (("pruning", "PAML_PRUNING_ENTRIES"),
                        ("pruning_big", "PAML_BIG_ENTRIES")):
        made = set(re.findall(rf"^{macro}\((float|double), (f32|f64), "
                              r"(\d+)\)", src[stem], re.M))
        assert made == {(t, s, m) for t, s in (("float", "f32"),
                                               ("double", "f64"))
                        for m in ("32", "64")}


def test_census_counts_each_instance():
    names = ["void (anonymous namespace)::big_fwd_kernel<double, false, 32>"
             "(int const*, int, int)",
             "void (anonymous namespace)::big_bwd_kernel<double, false, 32>"
             "(int const*)",
             "void (anonymous namespace)::big_fwd_kernel<float, true, 64>"
             "(int const*)",
             "void (anonymous namespace)::reduce_kernel<double, 32>(double)",
             "void (anonymous namespace)::jacobi_eigh_kernel<64, false>()"]
    c = graphs.kernel_census(names)
    assert (c["big_fwd"], c["big_fwd_n32"], c["big_fwd_n64"]) == (1, 1, 0)
    assert (c["big_bwd"], c["big_bwd_n32"]) == (1, 1)
    assert (c["pruning_fwd"], c["pruning_fwd_n64"]) == (1, 1)
    assert c["pruning_bwd"] == 0 and c["eigh"] == 1 and c["all"] == 5


@pytest.mark.parametrize("coded", [False, True])
def test_padding_changes_no_value(coded):
    # the kernels' padded inputs (`_Inputs`: N = 32 at 20 states, identity
    # P on big_tree's nodes) through the plain versions, against the
    # unpadded plain versions on the same tree: lnf, S, dP and dpi
    P, tips, topo, pi = _coded_problem(seed=7)
    if not coded:
        tips = tips.codes.clamp(max=19).contiguous()
    x = cp._Inputs(P, tips, topo, pi)
    # the kernels read a code n + a as the table's row a (n passed apart);
    # the plain versions take the table's width for n
    xt = TipCodes(torch.where(x.states >= 20, x.states + 12, x.states),
                  x.amb) if coded else x.states
    run = x.topo
    Pr = cp.with_identity(P, run)
    gbar = torch.tensor(np.random.default_rng(2).uniform(
        0.5, 2.0, size=(4, 193)))
    lnf_p, S_p = pruning.class_site_lnf_big_plain(x.P, xt, run, x.pi)
    lnf_r, S_r = pruning.class_site_lnf_big_plain(Pr, tips, run, pi)
    dP_p, dpi_p = pruning.class_site_lnf_bwd_plain(x.P, xt, run, x.pi, gbar)
    dP_r, dpi_r = pruning.class_site_lnf_bwd_plain(Pr, tips, run, pi, gbar)
    for got, ref in ((lnf_p, lnf_r), (S_p[:, :, :20], S_r),
                     (dP_p[..., :20, :20], dP_r), (dpi_p[:, :20], dpi_r)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-14,
                                   atol=1e-14 * float(ref.abs().max()))
    # and padding's rows stay empty
    assert not S_p[:, :, 20:].any() and not dpi_p[:, 20:].any()


def test_plain_route_matches_pallas_at_20_states():
    # the TPU kernel pads 20 states to N = 24 (`_pad_inputs`); the port's
    # plain route works at the real n, its kernels at N = 32
    P, tips, topo, pi = _random_problem(ns=6, H=64, C=2, n=20, seed=11)
    w = jnp.asarray(np.random.default_rng(4).uniform(0.5, 2.0, size=64),
                    jnp.float32)

    def obj(P_, pi_):
        lnf = pallas_pruning.class_site_lnf_pallas(P_, tips, topo, pi_, 128,
                                                   True)
        return jnp.sum(w * jnp.sum(lnf, axis=0)), lnf
    (_, ref), (gP, gpi) = jax.value_and_grad(obj, argnums=(0, 1),
                                             has_aux=True)(P, pi)
    Pt, tipst, pit = interop.kernel_inputs_from(P, tips, pi, device="cpu")
    Pg, pig = Pt.requires_grad_(True), pit.requires_grad_(True)
    lnf = pruning.class_site_lnf(Pg, tipst, interop.topology_from(topo), pig)
    np.testing.assert_allclose(lnf.detach().numpy(), np.asarray(ref),
                               rtol=2e-6, atol=2e-6)
    (lnf * torch.tensor(np.asarray(w))).sum().backward()
    np.testing.assert_allclose(Pg.grad.numpy(), np.asarray(gP), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(pig.grad.numpy(), np.asarray(gpi), rtol=3e-5,
                               atol=3e-5)
