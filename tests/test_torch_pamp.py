"""paml_tpu_torch pamp against paml_tpu on the CPU, on
`tests/data/clock56.nuc` with its tree: the Fitch change counts, the three
estimators of the gamma shape (method of moments, Sullivan et al. 1995,
Yang & Kumar 1996), the REV distance and the pattern matrix of the JC69
joint reconstruction (run on the device the port is given; here the
CPU); `pattern_ls`'s distances and least-squares branch lengths."""
import os

import numpy as np
import pytest
import torch

from paml_tpu.apps import pamp as jax_pamp
from paml_tpu.apps import parsimony as jax_parsimony
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import pamp, parsimony

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def clock56():
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.nuc"),
                                   jax_seqio.BASE_SEQ)
    data = jax_seqio.pack(aln, cleandata=True)
    tree = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                 data.names)[0]
    topo = jax_from_treenode(tree, data.names)
    return data, topo, interop.packed_from(data), interop.topology_from(topo)


def test_change_counts_match_jax(clock56):
    data, topo, data_t, topo_t = clock56
    np.testing.assert_array_equal(parsimony._tip_bitmasks(data_t),
                                  jax_parsimony._tip_bitmasks(data))
    ct = parsimony.site_change_counts(topo_t, data_t)
    cj = jax_parsimony.site_change_counts(topo, data)
    np.testing.assert_array_equal(ct, cj)
    assert ct.max() > 0


@pytest.mark.parametrize("ncatG", [4, 8])
def test_alpha_estimates_match_jax(clock56, ncatG):
    data, topo, data_t, topo_t = clock56
    changes = jax_parsimony.site_change_counts(topo, data)
    rt = pamp.alpha_estimates(changes, data.fpatt, topo.nbranch, 4, ncatG)
    rj = jax_pamp.alpha_estimates(changes, data.fpatt, topo.nbranch, 4, ncatG)
    np.testing.assert_array_equal(rt.n_changes_hist, rj.n_changes_hist)
    for f in ("mean", "var", "alpha_mm", "alpha_sullivan", "alpha_yk96"):
        assert abs(getattr(rt, f) - getattr(rj, f)) <= 1e-12 * abs(
            getattr(rj, f)), f


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_distance_rev_matches_jax(clock56, alpha):
    data = clock56[0]
    st = data.tip_partials.argmax(-1)
    F = np.zeros((4, 4))
    np.add.at(F, (st[0], st[3]), data.fpatt / 2)
    np.add.at(F, (st[3], st[0]), data.fpatt / 2)
    t1, Q1, pi1, c1 = pamp.distance_rev(F, alpha, data.ls)
    t2, Q2, pi2, c2 = jax_pamp.distance_rev(F, alpha, data.ls)
    assert c1 == c2 and t1 > 0
    assert abs(t1 - t2) <= 1e-12 * t2
    np.testing.assert_allclose(Q1, Q2, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(pi1, pi2, rtol=1e-12)


def test_pattern_matrix_matches_jax(clock56):
    data, topo, data_t, topo_t = clock56
    Ft = pamp.pattern_matrix(topo_t, data_t, device="cpu")
    Fj = jax_pamp.pattern_matrix(topo, data)
    np.testing.assert_array_equal(Ft, Fj)
    assert Ft.sum() == data.fpatt.sum() * topo.nbranch


def test_run_matches_jax():
    seq = os.path.join(DATA, "clock56.nuc")
    tree = os.path.join(DATA, "clock56.trees")
    rt = pamp.run(seq, tree, ncatG=8, device="cpu")
    rj = jax_pamp.run(seq, tree, ncatG=8)
    np.testing.assert_array_equal(rt.pattern_matrix, rj.pattern_matrix)
    for f in ("alpha_mm", "alpha_sullivan", "alpha_yk96"):
        assert abs(getattr(rt, f) - getattr(rj, f)) <= 1e-12 * abs(
            getattr(rj, f))


def test_pattern_ls_raises(clock56):
    """`pattern_ls`, which raised naming ROADMAP A14 until tree search was
    ported: the REV distances, the average Q, pi and the least-squares
    branch lengths against the JAX package's (1e-9), without and with
    gamma."""
    data, topo, data_t, topo_t = clock56
    for alpha in (0.0, 0.5):
        rt = pamp.pattern_ls(topo_t, data_t, alpha)
        rj = jax_pamp.pattern_ls(topo, data, alpha)
        for k in ("D", "Q", "pi", "blens"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-9, atol=1e-12)
        assert abs(rt["ss"] - rj["ss"]) <= 1e-9 * max(rj["ss"], 1e-12)
        assert (rt["blens"][topo.branch_nodes()] >= 0).all()
        assert rt["blens"].sum() > 0
