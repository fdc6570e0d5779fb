"""The host side of the Hessian's tangent kernels H1 / H2
(`csrc/pruning_tangent.cuh`) on the CPU: their grids (whole waves, every
direction inside a block wherever tiles x classes fill the card), the
shared memory of each instance against the blocks per SM the design
counts on, H2's workspace, the plain version of the tangents' tip tables
(TA = P amb^T, TAd = Pdot amb^T) against an einsum, and the wrappers'
refusal of CPU tensors (the plain versions take those)."""
import numpy as np
import pytest
import torch

from paml_tpu_torch.core import cuda_pruning as cp
from paml_tpu_torch.core.tipcodes import TipCodes
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io import treeio

SMS = 132                   # an H100's streaming multiprocessors
MEM = 80 << 30


def _tree(ns, balanced=False):
    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    nw = names[0]
    for nm in names[1:]:
        nw = f"({nw},{nm})"
    return from_treenode(treeio.parse_newick(
        (bal(0, ns) if balanced else nw) + ";"), names)


@pytest.mark.parametrize("npad", [32, 64])
@pytest.mark.parametrize("D", [4, 16])
def test_grid_is_one_whole_wave(D, npad):
    # the bench shape: 128 tiles x 3 classes fill the card's block slots
    # with every direction inside a block, in one wave with no lone
    # remainder; the grid does not depend on D
    slots = SMS * cp.tan_blocks_per_sm(npad)
    G, Z = cp.tan_grid(128, 3, D, SMS, npad)
    assert Z == 1 and G * 3 == slots
    assert cp.tan_waves(G, 3, Z, SMS, npad) == 1.0
    assert cp.tan_grid(128, 3, 1, SMS, npad) == (G, Z)
    tb = cp.big_tree(_tree(32))
    nslots = cp.full_plan(tb).nslots
    Gb, Zb, TV = cp.tan_bwd_grid(tb.nnode, 3, D, 128, 8, SMS, MEM, nslots,
                                 npad)
    assert (Gb, Zb) == (G, Z)
    # the visit is the block's whole range of tiles
    assert TV == -(-128 // G) <= cp.TAN_TMAX
    # at most one wave for any tile count and class count, and full but
    # for less than one block per class and tile range
    for ntiles in (1, 2, 7, 44, 45, 128, 1559):
        for C in (1, 3, 4, 11, 21):
            G, Z = cp.tan_grid(ntiles, C, D, SMS, npad)
            blocks = G * C * Z
            assert 1 <= Z <= D and 1 <= G <= ntiles
            if C <= slots:
                assert blocks <= slots
                assert blocks > slots - G * C or G == ntiles and Z == D


def test_directions_split_only_to_fill_the_card():
    # two tiles x 3 classes leave most slots empty: the directions split
    # into groups (each block doing the direction-independent part for its
    # own group), at most one direction a block
    assert cp.tan_grid(2, 3, 16, SMS, 64) == (2, 16)
    assert cp.tan_grid(2, 3, 4, SMS, 64) == (2, 4)
    assert cp.tan_grid(20, 3, 16, SMS, 64) == (20, 2)
    # a card too small for the slabs caps G (1024 taxa x 16 directions),
    # and the directions fill the wave instead
    tb = cp.big_tree(_tree(1024, balanced=True))
    nslots = cp.full_plan(tb).nslots
    G, Z, TV = cp.tan_bwd_grid(tb.nnode, 4, 16, 320, 8, SMS, MEM, nslots, 64)
    per_g = (16 * tb.nnode * 4 * 64 * 64 + 16 * 4 * 64
             + 4 * cp.tan_work_per_block(16, 1, nslots, cp.TAN_TMAX, 64)) * 8
    assert G == max(1, MEM // 8 // per_g) < 320
    assert Z == min(16, SMS // (G * 4)) > 1
    assert G * 4 * Z <= SMS and TV == cp.TAN_TMAX


def test_shared_memory_against_blocks_per_sm():
    # hand counts from the carve of pruning_tangent.cuh: [N][N + 4] P_k of
    # both children and one Pd_k, [N][36] tiles (s_k and X_k of both, one
    # sd_k, and H1 a tip's second buffer, H2 one G_k), the
    # column-reduction scratch of 512 values, float64; H1 and H2 carve the
    # same
    want = {32: (3 * 32 * 36 + 6 * 32 * 36 + 512) * 8,
            64: (3 * 64 * 68 + 6 * 64 * 36 + 512) * 8}
    assert want == {32: 87040, 64: 219136}
    for m in (32, 64):
        assert cp.tan_smem(m) == want[m] <= cp.SMEM_MAX
        # the blocks the design counts on fit an SM (1 KB a block kept),
        # and one more would not
        bps = cp.tan_blocks_per_sm(m)
        assert bps * (want[m] + 1024) <= cp.SMEM_SM \
            < (bps + 1) * (want[m] + 1024)
    # at N = 64 one block an SM, at N = 32 two
    assert (cp.tan_blocks_per_sm(64), cp.tan_blocks_per_sm(32)) == (1, 2)


def test_workspace_per_block():
    # A and the block's directions' Ad slots, the node's a, c_0, c_1 and
    # 1 / m_v per tile of a visit
    assert cp.tan_work_per_block(16, 1, 2, 3, 64) == \
        17 * 3 * 3 * 64 * 32 + 3 * (3 * 64 + 1) * 32
    assert cp.tan_work_per_block(16, 5, 2, 3, 32) == \
        5 * 3 * 3 * 32 * 32 + 3 * (3 * 32 + 1) * 32


@pytest.mark.parametrize("npad,A", [(64, 3), (32, 33)])
def test_tip_tables_plain(npad, A):
    rng = np.random.default_rng(4)
    nnode, ns, C, D, n = 9, 5, 3, 4, npad - 3
    P = torch.zeros(nnode, C, npad, npad, dtype=torch.float64)
    P[..., :n, :n] = torch.tensor(rng.dirichlet(np.ones(n),
                                                size=(nnode, C, n)))
    Pd = torch.zeros(D, nnode, C, npad, npad, dtype=torch.float64)
    Pd[..., :n, :n] = torch.tensor(rng.normal(size=(D, nnode, C, n, n)))
    amb = torch.zeros(A, npad, dtype=torch.float64)
    amb[:, :n] = torch.tensor((rng.uniform(size=(A, n)) < 0.4) * 1.0)
    T = cp.tip_tables_plain(P, Pd, amb, ns)
    LA = -(-A // 32) * 32
    assert T.shape == (1 + D, ns, C, npad, LA)
    want = np.einsum("vcji,ai->vcja", P[:ns].numpy(), amb.numpy())
    np.testing.assert_allclose(T[0, ..., :A].numpy(), want, rtol=1e-14)
    for d in range(D):
        want = np.einsum("vcji,ai->vcja", Pd[d, :ns].numpy(), amb.numpy())
        np.testing.assert_allclose(T[1 + d, ..., :A].numpy(), want,
                                   rtol=1e-13,
                                   atol=1e-13 * np.abs(want).max())
    assert not T[..., A:].any() and not T[..., n:, :].any()


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("coded", [False, True])
def test_tangent_wrappers_refuse_cpu_tensors(which, coded):
    topo = _tree(4)
    rng = np.random.default_rng(1)
    n, C, H, D = 20, 2, 40, 2
    P = torch.tensor(rng.dirichlet(np.ones(n), size=(topo.nnode, C, n)))
    pi = torch.tensor(rng.dirichlet(np.ones(n), size=C))
    codes = torch.tensor(rng.integers(0, n, (topo.ns, H)).astype(np.int32))
    tips = TipCodes(codes, torch.ones(1, n, dtype=torch.float64)) \
        if coded else codes
    Pd = torch.zeros(D, topo.nnode, C, n, n, dtype=torch.float64)
    pid = torch.zeros(D, C, n, dtype=torch.float64)
    S = torch.zeros(cp.full_plan(cp.big_tree(topo)).n_srows, C, n, H,
                    dtype=torch.float64)
    g = torch.zeros(C, H, dtype=torch.float64)
    fwd, bwd = (cp.pruning_tan_fwd, cp.pruning_tan_bwd) if coded else \
        (cp.pruning_big_tan_fwd, cp.pruning_big_tan_bwd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if which == "fwd":
            fwd(P, tips, topo, pi, Pd, pid, S)
        else:
            bwd(P, tips, topo, pi, g, Pd, pid, g.expand(D, C, H), S,
                S.expand(D, *S.shape))
    assert not any(cp.LAUNCHES.values())
