"""The on-device L-BFGS of paml_tpu_torch (`maximize_device`,
`maximize_device_bounded`) against paml_tpu's `maximize_jax` and
`maximize_jax_bounded` on the CPU: the M0 fit of tests/data/clock56.codon
in float64 within 1e-6 lnL of the JAX package's on-device fit and of the
port's scipy `maximize`, in float32 within 2e-4 of the JAX package's
float32 on-device fit and of the port's float64 fit, each in fewer than
200 iterations; an unbounded smooth function against `maximize_jax`; one
evaluation per line-search trial; and the stop flag read at most once
every CHECK_EVERY trials (plus the read that sees it)."""
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core import optim as jax_optim
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.core import optim

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def m0():
    """(JAX data, JAX topology, port data, port topology, the port's scipy
    fit) of clock56.codon under M0."""
    data_j = jax_seqio.pack(jax_seqio.read_alignment(
        os.path.join(DATA, "clock56.codon"), jax_seqio.CODON_SEQ))
    topo_j = jax_from_treenode(jax_treeio.read_trees(
        os.path.join(DATA, "clock56.trees"), data_j.names)[0], data_j.names)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    ref = codeml.fit_packed(data, topo, codeml.CodemlSpec(), device="cpu")
    return data_j, topo_j, data, topo, ref


def counted(neg):
    calls = [0]

    def fn(x):
        calls[0] += 1
        return neg(x)
    return fn, calls


def assert_counts(calls, it):
    """One evaluation at the start and one per line-search trial, at most
    CHECK_EVERY - 1 frozen ones after the stop; at least one trial per
    iteration; the stop flag read once every CHECK_EVERY trials and once
    more when it is seen."""
    trials, reads = optim.CHECKS["trials"], optim.CHECKS["reads"]
    assert it <= trials and trials + 1 <= calls <= trials + optim.CHECK_EVERY
    assert 1 <= reads <= math.ceil(trials / optim.CHECK_EVERY) + 1


def reset_checks():
    optim.CHECKS.update(reads=0, trials=0)


def test_device_bounded_fit_float64_matches_jax_and_scipy(m0):
    data_j, topo_j, data, topo, ref = m0
    neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
        data, topo, codeml.CodemlSpec(), device="cpu")
    fn, calls = counted(neg)
    reset_checks()
    x, lnl, it = optim.maximize_device_bounded(
        fn, x0, bounds, device="cpu", dtype=torch.float64)
    neg_j, _, _, x0_j, bounds_j, _ = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(), jnp.float64)
    _, lnl_j, it_j = jax_optim.maximize_jax_bounded(
        neg_j, x0_j, bounds_j, dtype=jnp.float64)
    assert abs(lnl - lnl_j) <= 1e-6 and abs(lnl - ref.lnL) <= 1e-6
    assert it < 200 and x.dtype == np.float64 and x.shape == x0.shape
    lo, hi = np.array(bounds).T
    assert np.all((x > lo) & (x < hi))
    assert_counts(calls[0], it)
    with torch.no_grad():
        assert abs(-float(neg(torch.as_tensor(x))) - lnl) <= 1e-9


def test_device_bounded_fit_float32(m0):
    """JAX: -1560.3374023 in 15 iterations."""
    data_j, topo_j, data, topo, ref = m0
    neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
        data, topo, codeml.CodemlSpec(), device="cpu", dtype=torch.float32)
    fn, calls = counted(neg)
    reset_checks()
    x, lnl, it = optim.maximize_device_bounded(
        fn, x0, bounds, device="cpu", dtype=torch.float32)
    neg_j, _, _, x0_j, bounds_j, _ = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(), jnp.float32)
    _, lnl_j, _ = jax_optim.maximize_jax_bounded(
        neg_j, x0_j, bounds_j, dtype=jnp.float32)
    assert abs(lnl - lnl_j) <= 2e-4 and abs(lnl - ref.lnL) <= 2e-4
    assert it < 200 and x.dtype == np.float32
    assert_counts(calls[0], it)


def test_device_unbounded_matches_jax():
    A = np.array([[3.0, 0.5, 0.1], [0.5, 2.0, 0.3], [0.1, 0.3, 1.0]])
    b = np.array([1.0, -2.0, 0.5])
    x0 = np.array([2.0, -1.0, 3.0])

    def f_j(x):
        return (0.5 * x @ (A @ x) - b @ x + 0.1 * jnp.sum(x ** 4)
                + jnp.log1p(jnp.exp(x[0] - x[1])))

    At, bt = torch.tensor(A), torch.tensor(b)

    def f_t(x):
        return (0.5 * x @ (At @ x) - bt @ x + 0.1 * torch.sum(x ** 4)
                + torch.log1p(torch.exp(x[0] - x[1])))

    x_j, lnl_j, _ = jax_optim.maximize_jax(f_j, jnp.asarray(x0))
    fn, calls = counted(f_t)
    reset_checks()
    x, lnl, it = optim.maximize_device(fn, torch.tensor(x0))
    np.testing.assert_allclose(x, np.asarray(x_j), rtol=0, atol=1e-8)
    assert abs(lnl - float(lnl_j)) <= 1e-12
    assert 0 < it < 100
    assert_counts(calls[0], it)
    # a start that already meets the tolerance: one read, no iteration
    reset_checks()
    x2, lnl2, it2 = optim.maximize_device(f_t, torch.as_tensor(x),
                                          tol=1e-3)
    assert it2 == 0 and optim.CHECKS == {"reads": 1, "trials": 0}
    np.testing.assert_array_equal(x2, x)


@pytest.mark.parametrize("x0", [[-1.2, 1.0], [-1.2, 1.0, -0.5, 2.0],
                                [3.0, -2.0, 0.5]])
def test_device_rosenbrock_matches_jax(x0):
    """Rosenbrock's valley makes the line search bracket and zoom: the
    minimum (1, ..., 1) as `maximize_jax` finds it, in as many iterations
    to within 2 (optax's zoom line search, with the same constants)."""
    def f_j(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    def f_t(x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1 - x[:-1]) ** 2)

    x_j, _, it_j = jax_optim.maximize_jax(f_j, jnp.asarray(x0, jnp.float64))
    fn, calls = counted(f_t)
    reset_checks()
    x, lnl, it = optim.maximize_device(fn, torch.tensor(x0,
                                                        dtype=torch.float64))
    np.testing.assert_allclose(x, np.asarray(x_j), rtol=0, atol=1e-8)
    assert -1e-20 <= lnl <= 0.0 and abs(it - it_j) <= 2
    assert optim.CHECKS["trials"] > it
    assert_counts(calls[0], it)
