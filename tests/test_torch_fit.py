"""The paml_tpu_torch slice end to end on CPU: `fit_packed` M0 and M2a on
tests/data/clock56.codon reach paml_tpu's fitted lnL to 1e-5, and the
port's lnL at paml_tpu's optimum matches to 1e-8 relative; `fit` reads
the same files itself."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml

DATA = os.path.join(os.path.dirname(__file__), "data")
SEQ = os.path.join(DATA, "clock56.codon")
TREE = os.path.join(DATA, "clock56.trees")


@pytest.fixture(autouse=True)
def one_thread():
    # small problems: torch's intra-op threads cost more than they give,
    # and the suite runs several workers side by side
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("NSsites", [0, 2])
def test_fit_matches_jax(NSsites):
    data_j = jax_seqio.pack(jax_seqio.read_alignment(SEQ,
                                                     jax_seqio.CODON_SEQ))
    topo_j = jax_from_treenode(jax_treeio.read_trees(TREE, data_j.names)[0],
                               data_j.names)
    spec_j = jax_codeml.CodemlSpec(NSsites=NSsites)
    ref = jax_codeml.fit_packed(data_j, topo_j, spec_j, dtype=jnp.float64)

    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    spec = codeml.CodemlSpec(NSsites=NSsites)
    res = codeml.fit_packed(data, topo, spec, device="cpu")
    assert np.isfinite(res.lnL) and res.x.shape == ref.x.shape
    assert abs(res.lnL - ref.lnL) <= 1e-5
    neg = codeml.make_codon_objective(data, topo, spec, device="cpu")[0]
    with torch.no_grad():
        at_ref = -neg(interop.params_from(ref.x, device="cpu")).item()
    assert abs(at_ref - ref.lnL) <= 1e-8 * abs(ref.lnL)
    assert res.class_omegas.shape == np.asarray(ref.class_omegas).shape
    np.testing.assert_allclose(res.class_freqs.sum(), 1.0, rtol=1e-12)


def test_fit_reads_files():
    res = codeml.fit(SEQ, TREE, codeml.CodemlSpec(NSsites=0), device="cpu")
    data = interop.packed_from(jax_seqio.pack(jax_seqio.read_alignment(
        SEQ, jax_seqio.CODON_SEQ)))
    topo = interop.topology_from(jax_from_treenode(
        jax_treeio.read_trees(TREE, data.names)[0], data.names))
    neg = codeml.make_codon_objective(data, topo, codeml.CodemlSpec(),
                                      device="cpu")[0]
    with torch.no_grad():
        val = -neg(interop.params_from(res.x, device="cpu")).item()
    assert abs(val - res.lnL) <= 1e-9 * abs(res.lnL)
