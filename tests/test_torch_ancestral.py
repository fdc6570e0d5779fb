"""paml_tpu_torch ancestral reconstruction against paml_tpu: per-node
posteriors (`inside_outside`), the marginal reconstruction (best states
equal, probabilities to 1e-10), the joint reconstruction of Pupko et al.
(states equal, joint log-probabilities to 1e-10 relative) and the site
rates, at 4 and 61 states, on a 9-taxon tree with a trifurcating root and
on a 7-taxon ladder, with ambiguous tip cells (gaps and partial
ambiguities) and C = 3 classes (one for the joint reconstruction), given
as partials and as state codes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paml_tpu.apps import ancestral as jax_ancestral
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import ancestral

torch.set_num_threads(1)

TREES = {"trifurcating": "(((t0,t1),(t2,t3)),((t4,t5),t6),(t7,t8));",
         "ladder": "((((((t0,t1),t2),t3),t4),t5),t6);"}


def problem(n, C, shape, seed, ambiguous=True):
    rng = np.random.default_rng(seed)
    nwk = TREES[shape]
    ns = nwk.count("t")
    names = [f"t{i}" for i in range(ns)]
    topo = jax_from_treenode(jax_treeio.parse_newick(nwk), names)
    H = 60
    Q = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.6 * np.eye(n) + 0.4 * Q / Q.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.full(n, 2.0), size=C)
    states = rng.integers(0, n, size=(ns, H))
    tips = np.zeros((ns, H, n))
    tips[np.arange(ns)[:, None], np.arange(H)[None, :], states] = 1.0
    if ambiguous:
        gap = rng.random((ns, H)) < 0.08
        tips[gap] = 1.0
        part = (rng.random((ns, H)) < 0.05) & ~gap
        tips[part] = np.maximum(tips[part], rng.random((part.sum(), n)) < 0.3)
    w = rng.dirichlet(np.full(C, 3.0))
    fpatt = rng.integers(1, 4, size=H).astype(float)
    return P, tips, topo, pi, w, fpatt


CASES = [(4, "trifurcating"), (4, "ladder"), (61, "trifurcating")]


@pytest.mark.parametrize("n,shape", CASES)
def test_marginal_matches_jax(n, shape):
    P, tips, topo_j, pi, w, fpatt = problem(n, 3, shape, seed=n)
    topo = interop.topology_from(topo_j)
    post_j = np.asarray(jax_ancestral.inside_outside(
        jnp.asarray(P), jnp.asarray(tips), topo_j, jnp.asarray(pi)))
    T = [torch.as_tensor(v) for v in (P, tips, pi, w, fpatt)]
    post = ancestral.inside_outside(T[0], T[1], topo, T[2]).numpy()
    np.testing.assert_allclose(post, post_j, rtol=0, atol=1e-10)
    best_j, prob_j, mpost_j = jax_ancestral.marginal_reconstruction(
        jnp.asarray(P), jnp.asarray(tips), topo_j, jnp.asarray(pi),
        jnp.asarray(w), jnp.asarray(fpatt))
    best, prob, mpost = ancestral.marginal_reconstruction(
        T[0], T[1], topo, T[2], T[3], T[4])
    np.testing.assert_array_equal(best, best_j)
    np.testing.assert_allclose(prob, prob_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(mpost, mpost_j, rtol=0, atol=1e-10)
    rates = np.linspace(0.2, 2.0, 3)
    np.testing.assert_allclose(
        ancestral.site_rates(T[0], T[1], topo, T[2], T[3], rates),
        jax_ancestral.site_rates(jnp.asarray(P), jnp.asarray(tips), topo_j,
                                 jnp.asarray(pi), jnp.asarray(w),
                                 jnp.asarray(rates)), rtol=1e-10)


@pytest.mark.parametrize("n,shape", CASES)
def test_joint_matches_jax(n, shape):
    P, tips, topo_j, pi, _, _ = problem(n, 1, shape, seed=n + 1)
    topo = interop.topology_from(topo_j)
    st_j, lnP_j = jax_ancestral.joint_reconstruction(
        jnp.asarray(P), jnp.asarray(tips), topo_j, jnp.asarray(pi))
    st, lnP = ancestral.joint_reconstruction(
        torch.as_tensor(P), torch.as_tensor(tips), topo, torch.as_tensor(pi))
    np.testing.assert_array_equal(st, st_j)
    np.testing.assert_allclose(lnP, lnP_j, rtol=1e-10)


def test_state_codes_as_partials():
    """Clean tips given as int32 state codes reconstruct as the same
    tips given as one-hot partials."""
    P, tips, topo_j, pi, w, fpatt = problem(4, 3, "trifurcating", seed=7,
                                            ambiguous=False)
    topo = interop.topology_from(topo_j)
    codes = torch.as_tensor(tips.argmax(-1).astype(np.int32))
    T = [torch.as_tensor(v) for v in (P, tips, pi, w, fpatt)]
    a = ancestral.marginal_reconstruction(T[0], T[1], topo, T[2], T[3], T[4])
    b = ancestral.marginal_reconstruction(T[0], codes, topo, T[2], T[3],
                                          T[4])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-14)
    ja = ancestral.joint_reconstruction(T[0][:, :1], T[1], topo, T[2][:1])
    jb = ancestral.joint_reconstruction(T[0][:, :1], codes, topo, T[2][:1])
    np.testing.assert_array_equal(ja[0], jb[0])
    np.testing.assert_allclose(ja[1], jb[1], rtol=1e-14)
