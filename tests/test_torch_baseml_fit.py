"""paml_tpu_torch baseml fits and standard errors against paml_tpu on
`tests/data/clock56.nuc`: the HKY85 + G5 and the nhomo = 1 fits (lnL to
1e-6, the MLEs), the Hessian of the route that is differentiable twice
against `jax.hessian` of the JAX objective and the SEs from it, on the
tree with its root removed (a rooted tree leaves the two root branches'
sum alone identifiable).  `jax.hessian` cannot differentiate the
incomplete gamma's derivative in its shape (`igamma_grad_a`), so with
gamma rates (discrete, and the rate HMM) the Hessian is held against
central differences of the fit's gradient instead.  Also Mgene = 1 (a
separate fit per gene, `fit_separate`) against the JAX package's."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import baseml as jax_baseml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import baseml, codeml

from test_torch_baseml import DATA, clock56

UNROOTED = "(((A, B), C), (D, E), F);"


def unrooted():
    data_j, _ = clock56()
    tree = jax_treeio.parse_newick(UNROOTED)
    return data_j, jax_from_treenode(tree, data_j.names)


@pytest.mark.parametrize("kw", [
    dict(model="HKY85", ncatG=5, fix_alpha=False),
    dict(model="HKY85", nhomo=1)], ids=["HKY85_G5", "nhomo1"])
def test_fit_matches_jax(kw):
    data_j, topo_j = clock56()
    res_j = jax_baseml.fit_packed(data_j, topo_j, jax_baseml.BasemlSpec(**kw),
                                  dtype=jnp.float64)
    res = baseml.fit_packed(interop.packed_from(data_j),
                            interop.topology_from(topo_j),
                            baseml.BasemlSpec(**kw), device="cpu")
    assert abs(res.lnL - res_j.lnL) <= 1e-6 * abs(res_j.lnL)
    assert res.np == res_j.np
    np.testing.assert_array_equal(res.branch_nodes, res_j.branch_nodes)
    np.testing.assert_allclose(res.rate_params, res_j.rate_params, rtol=1e-4)
    np.testing.assert_allclose(res.pi, res_j.pi, rtol=1e-4, atol=1e-6)
    if kw.get("ncatG"):
        np.testing.assert_allclose(res.alpha, res_j.alpha, rtol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(model="HKY85"), dict(model="REV"), dict(model="UNREST"),
    dict(model="TN93", Mgene=4)], ids=["HKY85", "REV", "UNREST",
                                       "Mgene4_TN93"])
def test_hessian_and_ses_match_jax(kw):
    data_j, topo_j = unrooted()
    if kw.get("Mgene"):
        genes, _ = clock56("genes")
        data_j = genes
    spec = baseml.BasemlSpec(getSE=True, **kw)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    res = baseml.fit_packed(data, topo, spec, device="cpu")
    neg_j = jax_baseml.make_objective(data_j, topo_j,
                                      jax_baseml.BasemlSpec(**kw),
                                      jnp.float64)[0]
    H_j = np.asarray(jax.jit(jax.hessian(neg_j))(jnp.asarray(res.x)))
    neg = baseml.make_objective(data, topo, spec, device="cpu")[0]
    H = codeml.hessian(neg, res.x, device="cpu")
    np.testing.assert_allclose(H, H_j, rtol=0,
                               atol=1e-8 * np.abs(H_j).max())
    ses_j = np.sqrt(np.maximum(np.diag(np.linalg.inv(H_j)), 0.0))
    assert np.all(ses_j > 0)
    np.testing.assert_allclose(res.SEs, ses_j, rtol=1e-6)


def central_hessian(neg, x, h=1e-5):
    def grad(v):
        xt = torch.tensor(v, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(neg(xt), xt)
        return g.numpy()
    n = len(x)
    H = np.zeros((n, n))
    for i in range(n):
        e = np.zeros(n)
        e[i] = h * max(1.0, abs(x[i]))
        H[i] = (grad(x + e) - grad(x - e)) / (2 * e[i])
    return (H + H.T) / 2


@pytest.mark.parametrize("kw", [
    dict(model="HKY85", ncatG=4, fix_alpha=False),
    dict(model="K80", ncatG=3, fix_alpha=False, fix_rho=False)],
    ids=["HKY85_G4", "AdG_K80"])
def test_gamma_hessian_by_differences(kw):
    data_j, topo_j = unrooted()
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    neg, _, x0, _ = baseml.make_objective(data, topo,
                                          baseml.BasemlSpec(**kw),
                                          device="cpu")
    # the rate HMM ties the sites together: no pattern chunks
    assert neg.pattern_chunks == kw.get("fix_rho", True)
    H = codeml.hessian(neg, x0, device="cpu")
    H_fd = central_hessian(neg, x0)
    np.testing.assert_allclose(H, H_fd, rtol=0,
                               atol=1e-5 * np.abs(H_fd).max())


def test_fit_separate_matches_jax(tmp_path):
    """Mgene = 1: one analysis per gene of an option-G alignment."""
    data_j, _ = clock56()
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.nuc"),
                                   jax_seqio.BASE_SEQ)
    ls = len(aln.rows[0])
    seq, tree = tmp_path / "seq.phy", tmp_path / "tree.nwk"
    seq.write_text(f"{len(aln.names)} {ls} G\nG 2 {ls // 2} {ls - ls // 2}\n"
                   + "".join(f"{nm}  {row}\n"
                             for nm, row in zip(aln.names, aln.rows)))
    tree.write_text(UNROOTED + "\n")
    kw = dict(model="K80", Mgene=1)
    res_j = jax_baseml.fit_separate(str(seq), str(tree),
                                    jax_baseml.BasemlSpec(**kw))
    res = baseml.fit_separate(str(seq), str(tree), baseml.BasemlSpec(**kw),
                              device="cpu")
    assert len(res) == len(res_j) == 2
    for a, b in zip(res, res_j):
        assert abs(a.lnL - b.lnL) <= 1e-6 * abs(b.lnL)
        np.testing.assert_allclose(a.rate_params, b.rate_params, rtol=1e-4)
