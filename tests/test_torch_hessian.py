"""`paml_tpu_torch.apps.codeml.hessian` (double backward through the
objective's `twice` route) against `jax.hessian` of the JAX objective at
the same x, on `tests/data/clock56.codon`: M2a, M8 (second
derivatives of the beta quantiles inside the objective) and a clock with
the tree's `@0.45` fossil; other pattern chunks and row blocks give the same
matrix; `standard_errors` is its pseudo-inverse's diagonal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from test_torch_codeml import _clock56, _random_x

torch.set_num_threads(1)


@pytest.mark.parametrize("name,kw", [("M2a", dict(NSsites=2)),
                                     ("M8", dict(NSsites=8, ncatG=4)),
                                     ("clock1", dict(clock=1))])
def test_hessian_matches_jax(name, kw):
    # at a random in-bounds x: the Hessian itself (SEs need an optimum:
    # tests/test_torch_cli_more.py holds them at a fitted one; the second
    # derivatives of the quantile code: tests/test_torch_dgamma.py)
    data_j, topo_j = _clock56(False)
    neg_j = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float64)[0]
    neg, _, _, _, b, _ = codeml.make_codon_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        codeml.CodemlSpec(**kw), device="cpu")
    nb = 0 if kw.get("clock") else len(topo_j.branch_nodes())
    x = _random_x(b, nb, np.random.default_rng(5))
    Hj = np.asarray(jax.hessian(neg_j)(jnp.asarray(x)))
    before = codeml.SECONDS["hessian"]
    H = codeml.hessian(neg, x, device="cpu")
    assert codeml.SECONDS["hessian"] > before
    np.testing.assert_allclose(H, Hj, rtol=1e-6, atol=1e-8 * np.abs(Hj).max())
    # pattern chunks and row blocks of other sizes give the same matrix
    old = codeml.HESSIAN_BYTES["cpu"], codeml.HESSIAN_ROWS
    codeml.HESSIAN_BYTES["cpu"], codeml.HESSIAN_ROWS = 1 << 22, 5
    try:
        H2 = codeml.hessian(neg, x, device="cpu")
    finally:
        codeml.HESSIAN_BYTES["cpu"], codeml.HESSIAN_ROWS = old
    np.testing.assert_allclose(H2, H, rtol=1e-9, atol=1e-10 * np.abs(H).max())
    # standard_errors is the pinv of that matrix
    np.testing.assert_array_equal(
        codeml.standard_errors(neg, x, device="cpu"),
        np.sqrt(np.clip(np.diag(np.linalg.pinv((H + H.T) / 2)), 0.0, None)))
