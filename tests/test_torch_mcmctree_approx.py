"""paml_tpu_torch's in.BV generation and the approximate-likelihood chain
(usedata = 2) against paml_tpu's: `generate_BV`'s MLEs (1e-6), its
gradient and Hessian at the JAX package's MLE (1e-8 relative), and the
chains at clock 1, 2 and 3 draw for draw (1e-9)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_torch_mcmctree as td
from paml_tpu.apps import baseml as jax_baseml
from paml_tpu.apps import mcmctree as J
from paml_tpu.core import topology as jax_topology
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import baseml, codeml
from paml_tpu_torch.apps import mcmctree as T
from paml_tpu_torch.io import seqio, treeio

torch.set_num_threads(1)


def test_generate_BV_matches(tmp_path):
    """The port's in.BV fit against the JAX package's fit of the same
    locus on the same derooted tree (what its `generate_BV` writes), and
    the gradient and Hessian over the branch lengths at the JAX MLE with
    kappa fixed there, against `jax.grad` and `jax.hessian`."""
    (tmp_path / "seq.txt").write_text(td.seq_text(lengths=(160,)))
    at = seqio.read_alignments(str(tmp_path / "seq.txt"), 0, 1)
    (dt, ut, blt, gt, Ht), = T.generate_BV(
        at, treeio.parse_newick(td.NWK), td.NAMES, model="HKY85", ncatG=1,
        alpha0=0.0, outfile=str(tmp_path / "t.BV"), device="cpu")
    dj = jax_seqio.pack(jax_seqio.read_alignments(
        str(tmp_path / "seq.txt"), 0, 1)[0], cleandata=False)
    uj = jax_topology.deroot(jax_topology.from_treenode(
        jax_treeio.parse_newick(td.NWK), dj.names))
    np.testing.assert_array_equal(ut.branch_nodes(), uj.branch_nodes())
    spec_j = jax_baseml.BasemlSpec(model="HKY85", ncatG=1, fix_alpha=False,
                                   alpha=0.0)
    res = jax_baseml.fit_packed(dj, uj, spec_j)
    np.testing.assert_allclose(blt, res.blens, rtol=1e-6, atol=1e-6)
    assert np.abs(gt).max() < 1e-2
    nb = len(uj.branch_nodes())
    fixed = dataclasses.replace(spec_j, fix_kappa=True,
                                kappa=float(res.rate_params[0]),
                                fix_alpha=True, alpha=0.0)
    negj = jax_baseml.make_objective(dj, uj, fixed)[0]
    x = np.asarray(res.x[:nb])
    g_ref = -np.asarray(jax.jit(jax.grad(negj))(x))
    H_ref = -np.asarray(jax.jit(jax.hessian(negj))(x))
    negt = baseml.make_objective(interop.packed_from(dj), ut,
                                 interop.baseml_spec_from(fixed),
                                 device="cpu")[0]
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(negt(xt), xt)
    scale = np.abs(H_ref).max()
    np.testing.assert_allclose(-g.numpy(), g_ref, rtol=1e-8,
                               atol=1e-8 * scale * 1e-6)
    H = -codeml.hessian(negt, x, device="cpu")
    np.testing.assert_allclose(H, H_ref, rtol=1e-8, atol=1e-8 * scale)


def approx_pair(seed, nwk=td.NWK, names=td.NAMES):
    """Approximate loci on the species tree derooted: random MLEs, gradient
    and a negative definite Hessian, transformed (JAX, port)."""
    rng = np.random.default_rng(seed)
    topo = jax_topology.deroot(jax_topology.from_treenode(
        jax_treeio.parse_newick(nwk), names))
    nb = len(topo.branch_nodes())
    A = rng.normal(size=(nb, nb))
    H = -(A @ A.T + nb * np.eye(nb)) * 200
    lj = J.ApproxLocus(names=list(names), topo=topo,
                       bl=rng.uniform(0.01, 0.3, nb),
                       gradient=rng.normal(size=nb), hessian=H)
    lt = interop.approx_locus_from(lj)
    lj.transform_gh()
    lt.transform_gh()
    return lj, lt


@pytest.mark.parametrize("clock", [1, 2, 3])
def test_approx_chain_matches_jax(clock):
    pairs = [approx_pair(s) for s in (1, 2, 3)]
    sj = J.build_species_tree(jax_treeio.parse_newick(td.NWK), td.NAMES)
    st = T.build_species_tree(treeio.parse_newick(td.NWK), td.NAMES)
    spec = dict(clock=clock, usedata=2, seed=13, burnin=8, sampfreq=2,
                nsample=15)
    mj = J.MCMCTree(sj, [p[0] for p in pairs], J.McmcSpec(**spec))
    mt = T.MCMCTree(st, [p[1] for p in pairs], T.McmcSpec(**spec),
                    device="cpu")
    assert mt.branch_orders == mj.branch_orders
    np.testing.assert_allclose(mt.lnL_all(), mj.lnL_all(), rtol=1e-10)
    b = T.gene_branch_lengths(st, mt.ages, mt.rates, 2, 1)
    for order in mt.branch_orders:
        np.testing.assert_array_equal(
            T.rooted_to_unrooted_blens(st, b, order),
            J.rooted_to_unrooted_blens(sj, b, order))
    a, b = mj.run(), mt.run()
    keys = list(a[0])
    assert list(b[0]) == keys
    np.testing.assert_allclose([[s[k] for k in keys] for s in b],
                               [[s[k] for k in keys] for s in a],
                               rtol=1e-9, atol=0)
