"""paml_tpu_torch's bench (`paml_tpu_torch/bench.py`) against `bench.py`
and `__graft_entry__.py` on the CPU: the primary problem's value and
gradient equal the JAX package's in float64 (1e-12 relative, 1e-10 of the
largest gradient component); the 1024-taxon builder, cut to 16 taxa x 64
patterns x 2 chunks, equals `bench._big_branchsite_problem` at the same
sizes in float32 (2e-6 relative on the value, 3e-5 of the largest gradient
component: the Pallas tests' own float32 tolerances); the model-FLOP count
is bench.py's expression, and B3/B4's own products are (2 ns - 2) / (ns -
2) times fewer on the ladder; the device fit's clock56 objective equals
the JAX package's in float32, and its card-against-CPU gap is 0 between
two CPU copies; the fused body's step 0 is an eager step; the kernels'
padded P is the construction it replaced, bit for bit; and the bench
refuses to run without a card."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import bench as jax_bench
from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import bench
from paml_tpu_torch.core import cuda_pruning

torch.set_num_threads(1)


def jax_value_grad(neg, x):
    v, g = jax.jit(jax.value_and_grad(neg))(x)
    return float(v), np.asarray(g, np.float64)


def torch_value_grad(neg, x):
    v, g = bench.value_and_grad(neg)(x)
    return float(v), g.double().numpy()


def test_primary_problem_matches_jax():
    neg, x = bench.primary_problem("cpu", torch.float64, ns=8, npatt=96)
    neg_j, x0_j, _, _ = jax_entry._synthetic_codon_problem(
        ns=8, npatt=96, NSsites=3, seed=1, dtype=jnp.float64)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x0_j, np.float64))
    assert x.dtype == torch.float64
    vj, gj = jax_value_grad(neg_j, jnp.asarray(x0_j, jnp.float64))
    v, g = torch_value_grad(neg, x)
    assert abs(v - vj) <= 1e-12 * abs(vj)
    assert np.abs(g - gj).max() <= 1e-10 * np.abs(gj).max()


def test_big_problem_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_bench, "BIG_TAXA", 16)
    monkeypatch.setattr(jax_bench, "BIG_NPATT", 64)
    monkeypatch.setattr(jax_bench, "BIG_CHUNKS", 2)
    neg_j, x0_j, states_j, fpatt_j = jax_bench._big_branchsite_problem()
    neg, x0, states, fpatt = bench.big_branchsite_problem(
        "cpu", ns=16, npatt=64, n_chunks=2)
    np.testing.assert_array_equal(states, states_j)
    np.testing.assert_array_equal(fpatt, fpatt_j)
    np.testing.assert_array_equal(x0, x0_j)
    assert x0.dtype == np.float32
    vj, gj = jax_value_grad(neg_j, jnp.asarray(x0_j))
    v, g = torch_value_grad(neg, torch.as_tensor(x0))
    assert abs(v - vj) <= 2e-6 * abs(vj)
    assert np.abs(g - gj).max() <= 3e-5 * np.abs(gj).max()


@pytest.mark.parametrize("ns,npatt,K", [(32, 4096, 3), (1024, 10240, 4),
                                        (5, 7, 1)])
def test_model_flops_is_bench_py_expression(ns, npatt, K):
    # bench.py :327-332, written out
    n_states = 61
    nnode = 2 * ns - 1
    fwd_flops = (nnode - 1) * K * npatt * 2 * n_states * n_states
    assert bench.model_flops(ns, npatt, K) == 4 * fwd_flops


@pytest.mark.parametrize("ns", [8, 32])
def test_kernel_flops_are_the_internal_products(ns):
    neg, _ = bench.primary_problem("cpu", ns=ns, npatt=16)
    kflops = bench.kernel_flops(neg.topo, 3, 4096)
    # per class and pattern: 2 n^2 at each of the ns - 2 non-root internal
    # nodes, once in B3 and three times in B4
    assert kflops == 4 * (ns - 2) * 3 * 4096 * 2 * 61 * 61
    assert bench.model_flops(ns, 4096, 3) / kflops == pytest.approx(
        (2 * ns - 2) / (ns - 2), rel=1e-15)


def test_clock56_objective_matches_jax():
    neg, x0, bounds, ns, npatt = bench.clock56_objective("cpu")
    aln = jax_seqio.read_alignment(os.path.join(bench.DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    data_j = jax_seqio.pack(aln, cleandata=True, icode=0)
    topo_j = jax_from_treenode(jax_treeio.read_trees(
        os.path.join(bench.DATA, "clock56.trees"), data_j.names)[0],
        data_j.names)
    neg_j, _, _, x0_j, bounds_j, _ = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(cleandata=True), jnp.float32)
    np.testing.assert_array_equal(x0, x0_j)
    assert list(bounds) == list(bounds_j)
    assert (ns, npatt) == (data_j.ns, data_j.npatt)
    vj, gj = jax_value_grad(neg_j, jnp.asarray(x0_j, jnp.float32))
    v, g = torch_value_grad(neg, torch.as_tensor(x0, dtype=torch.float32))
    assert abs(v - vj) <= 2e-6 * abs(vj)
    assert np.abs(g - gj).max() <= 3e-5 * np.abs(gj).max()
    gap = bench.value_grad_gap(neg, neg, x0, device="cpu")
    assert gap == {"value_rel": 0.0, "grad_abs": 0.0,
                   "grad_max": np.abs(g).max()}


def test_fused_body_step0_is_an_eager_step():
    neg, x = bench.primary_problem("cpu", ns=6, npatt=32)
    step = bench.value_and_grad(neg)
    body, out = bench.fused_body(step, x, n_iter=3)
    body()
    v, g = step(x + 1e-6 * 0)
    assert torch.equal(out["v0"], v) and torch.equal(out["g0"], g)
    vs = [float(step(x + 1e-6 * i)[0]) for i in range(3)]
    assert float(out["total"]) == pytest.approx(sum(vs), rel=1e-6)
    assert x.dtype == torch.float32 and out["g0"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("extra,n", [(0, 61), (3, 61), (2, 20), (1, 64)])
def test_padded_P_equals_the_index_construction(dtype, extra, n):
    rng = np.random.default_rng(n + extra)
    P = torch.as_tensor(rng.random((7, 3, n, n)), dtype=dtype)
    nnode, N = 7 + extra, cuda_pruning.padded_states(n)
    old = P.new_zeros((nnode, 3, N, N))
    old[:7, :, :n, :n] = P
    old[7:, :, range(n), range(n)] = 1.0
    new = cuda_pruning.padded_P(P, nnode, N)
    assert new.dtype == dtype and torch.equal(new, old)


def test_padded_P_keeps_a_kernel_ready_P():
    P = torch.rand(5, 2, 64, 64, dtype=torch.float64)
    assert cuda_pruning.padded_P(P, 5, 64) is P


def test_bench_refuses_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err and "never the CPU" in out.err
    assert not (tmp_path / bench.DETAIL_FILE).exists()
