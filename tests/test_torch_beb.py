"""paml_tpu_torch.apps.beb against paml_tpu.apps.beb on the same fitted
results: NEB posteriors, BEB for M2a and M8 (class posteriors, posterior
mean and sd of omega, P(omega > 1)) and BEB for branch-site model A, to
1e-8; the per-omega likelihoods of 20-21 classes; the ternary grid; the
list of positive sites; BEB on the fit's own objective (its coded tips and
frequencies used again) gives the same numbers; the bound of BEB's forward
counts no residual.  The alignment is simulated under site classes (omega
0.1 / 1 / 3), so the posteriors are not flat."""
import numpy as np
import pytest
import torch

import chip_smoke
from paml_tpu.apps import beb as jax_beb
from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import beb, codeml
from paml_tpu_torch.core import cuda_pruning

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    names, rows, nwk, _ = chip_smoke.simulate_site_classes(
        torch, rng, 6, 120, "cpu", shape="trifurcating")
    rows[1] = rows[1][:30] + "---" + rows[1][33:]         # coded tips
    data_j = jax_seqio.pack(jax_seqio.Alignment(names, rows, 1))
    tree = jax_treeio.parse_newick(nwk)
    jax_treeio._resolve_names(tree, names)
    topo_j = jax_from_treenode(tree, names)
    return data_j, topo_j


def _fitted(problem, labelled=False, **kw):
    """One result for both packages: the port's fit, carried to the JAX
    package as its CodemlResult (the same x and parameters)."""
    data_j, topo_j = problem
    if labelled:
        topo_j.labels[:] = 0
        topo_j.labels[[0, 1]] = 1
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    spec = codeml.CodemlSpec(**kw)
    res = codeml.fit_packed(data, topo, spec, device="cpu")
    res_j = jax_codeml.CodemlResult(
        lnL=res.lnL, np=res.np, blens=res.blens,
        branch_nodes=res.branch_nodes, kappa=res.kappa, params=res.params,
        pi=res.pi, topo=topo_j, x=res.x, spec=jax_codeml.CodemlSpec(**kw))
    return data_j, topo_j, data, topo, spec, res, res_j


def _same(sp, sj, tol=1e-8):
    assert sp.method == sj.method
    for name in ("class_post", "class_omegas", "mean_w", "p_positive"):
        np.testing.assert_allclose(getattr(sp, name), getattr(sj, name),
                                   atol=tol, err_msg=name)
    if sj.se_w is not None:
        np.testing.assert_allclose(sp.se_w, sj.se_w, atol=tol)


@pytest.mark.parametrize("ns", [2, 8])
def test_neb_and_beb_match_jax(problem, ns):
    data_j, topo_j, data, topo, spec, res, res_j = _fitted(
        problem, NSsites=ns, ncatG=4)
    _same(beb.neb(data, topo, spec, res, device="cpu"),
          jax_beb.neb(data_j, topo_j, res_j.spec, res_j))
    sp = beb.beb(data, topo, spec, res, device="cpu")
    sj = jax_beb.beb(data_j, topo_j, res_j.spec, res_j)
    _same(sp, sj)
    assert sp.class_post.shape == (3 if ns == 2 else 2, data.npatt)
    np.testing.assert_allclose(
        np.array(beb.positive_sites(data, sp, 0.5)),
        np.array(jax_beb.positive_sites(data_j, sj, 0.5)), atol=1e-8)
    assert (sp.p_positive > 0.5).any() and beb.SECONDS["beb"] > 0
    # on the objective the caller already holds: the same tensors, bit for
    # bit the same posteriors
    objective = codeml.make_codon_objective(data, topo, spec, device="cpu")
    fz = beb._Frozen(data, topo, spec, res.x, "cpu", objective[0])
    assert fz.tips is objective[0].tips and fz.fpatt is objective[0].fpatt
    sp2 = beb.beb(data, topo, spec, res, device="cpu", neg=objective[0])
    np.testing.assert_array_equal(sp2.class_post, sp.class_post)
    res2 = codeml.fit_packed(data, topo, spec, device="cpu",
                             objective=objective)
    assert res2.lnL == res.lnL
    # the objective's own NEB (the CLI's rst table) is the same posterior
    neg = codeml.make_codon_objective(data, topo, spec, device="cpu")[0]
    with torch.no_grad():
        post = neg.class_posterior(torch.as_tensor(res.x)).numpy()
    np.testing.assert_allclose(
        post, beb.neb(data, topo, spec, res, device="cpu").class_post,
        atol=1e-10)


def test_per_omega_loglik_matches_jax(problem):
    data_j, topo_j, data, topo, spec, res, res_j = _fitted(problem,
                                                           NSsites=0)
    omegas = np.concatenate([(np.arange(10) + 0.5) / 10, [1.0],
                             1.0 + np.arange(10) + 0.5])
    lnf_j, pi_j = jax_beb._per_omega_loglik(data_j, topo_j, res_j.spec,
                                            res.x, omegas, 0.8)
    lnf, pi = beb._per_omega_loglik(data, topo, spec, res.x, omegas, 0.8,
                                    device="cpu")
    assert lnf.shape == (21, data.npatt)
    # a pattern of several nonsynonymous changes under omega 0.05 rests on
    # entries of P near 1e-10, which float64 eigenvectors give to 1e-15
    # absolute: its lnf agrees to 1e-6; what BEB mixes, the likelihoods
    # relative to the pattern's best omega, agrees to 1e-10
    np.testing.assert_allclose(lnf.numpy(), lnf_j, rtol=1e-6)
    np.testing.assert_allclose(
        np.exp(lnf.numpy() - lnf.numpy().max(0)),
        np.exp(lnf_j - lnf_j.max(0)), atol=1e-10)
    np.testing.assert_allclose(pi, pi_j, rtol=1e-14)


def test_beb_branchsite_A_matches_jax(problem):
    data_j, topo_j, data, topo, spec, res, res_j = _fitted(
        problem, labelled=True, model=2, NSsites=2)
    out = beb.beb_branchsite_A(data, topo, spec, res, device="cpu")
    out_j = jax_beb.beb_branchsite_A(data_j, topo_j, res_j.spec, res_j)
    assert sorted(out) == sorted(out_j)
    for key in out_j:
        np.testing.assert_allclose(out[key], out_j[key], atol=1e-8,
                                   rtol=1e-10, err_msg=key)
    np.testing.assert_allclose(out["postSite"].sum(0), 1.0, atol=1e-10)


def test_ternary_grid_and_errors(problem):
    for n1d in (3, 10):
        for a, b in zip(beb._ternary_grid(n1d), jax_beb._ternary_grid(n1d)):
            np.testing.assert_array_equal(a, b)
    data_j, topo_j = problem
    with pytest.raises(ValueError, match="M2a"):
        beb.beb(interop.packed_from(data_j), interop.topology_from(topo_j),
                codeml.CodemlSpec(NSsites=7), None, device="cpu")


@pytest.mark.parametrize("C, by, ms", [(20, "operations", 0.2607),
                                       (121, "operations", 1.5770)])
def test_beb_forward_bound_counts_no_residual(C, by, ms):
    # B3 at the program's clean alignment (32 taxa, ladder without a root
    # branch, 4046 patterns, f64) with 20 classes (M8) and 121 sets
    # (branch-site A), launched without S: the bound is the products'
    # (29 nodes x 2 x 61^2 x patterns x classes over 67e12 a second); S,
    # 1.2 GB at 20 classes, would have made it the bytes'
    names = [f"t{i}" for i in range(32)]
    tree = jax_treeio.parse_newick(
        chip_smoke.newick(names, "ladder3", np.full(32, 0.1)))
    jax_treeio._resolve_names(tree, names)
    topo = interop.topology_from(jax_from_treenode(tree, names))
    assert chip_smoke.bound("big_fwd", topo, C, 4046, 61, 8,
                            want_S=False) == (pytest.approx(ms, abs=5e-5), by)
    with_S = chip_smoke.bound("big_fwd", topo, C, 4046, 61, 8)
    assert with_S[1] == "bytes" and with_S[0] > 1.3 * ms
    f, b = cuda_pruning.kernel_work("big_fwd", topo, C, 4046, 61, 8,
                                    want_S=False)
    f1, b1 = cuda_pruning.kernel_work("pruning_fwd", topo, C, 4046, 61, 8)
    assert (f, b) == (f1, b1)
