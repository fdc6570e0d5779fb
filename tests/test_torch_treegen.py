"""paml_tpu_torch tree generation (`apps/treegen.py`) against paml_tpu on
the CPU: random labelled histories and birth-death trees from the same
numpy seeds give the same Newick bytes, the species-addition enumeration
lists the same trees in the same order, and the partition distances
between trees (evolver 8) are the same matrices."""
import numpy as np
import pytest

from paml_tpu.apps import treegen as jax_treegen
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch.apps import treegen
from paml_tpu_torch.io import treeio


def nwk(tree, lengths=False):
    return treeio.write_newick(tree, branch_lengths=lengths)


def jnwk(tree, lengths=False):
    return jax_treeio.write_newick(tree, branch_lengths=lengths)


@pytest.mark.parametrize("ns", [3, 12, 60])
def test_default_names_match_jax(ns):
    assert treegen.default_names(ns) == jax_treegen.default_names(ns)


@pytest.mark.parametrize("ns,rooted", [(5, False), (9, True), (17, False)])
def test_random_labeled_history_matches_jax(ns, rooted):
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        t, ht = treegen.random_labeled_history(ns, rooted, rt)
        j, hj = jax_treegen.random_labeled_history(ns, rooted, rj)
        assert nwk(t) == jnwk(j)
        assert [h.index for h in ht] == [h.index for h in hj]


@pytest.mark.parametrize("sample", [0.0, 0.4])
@pytest.mark.parametrize("birth,death", [(2.0, 1.0), (1.0, 1.0)])
def test_bd_ages_match_jax(birth, death, sample):
    a = treegen.bd_ages(9, birth, death, sample, 1.3,
                        np.random.default_rng(11))
    b = jax_treegen.bd_ages(9, birth, death, sample, 1.3,
                            np.random.default_rng(11))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rooted", [False, True])
def test_random_tree_bd_matches_jax(rooted):
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(10):
        t = treegen.random_tree_bd(8, rooted, birth=2.0, death=1.0,
                                   sample=0.5, mut=1.0, rng=rt)
        j = jax_treegen.random_tree_bd(8, rooted, birth=2.0, death=1.0,
                                       sample=0.5, mut=1.0, rng=rj)
        assert nwk(t, True) == jnwk(j, True)
        lens = [v.blen for v in t.walk_post() if v is not t]
        assert all(b is not None and b >= 0 for b in lens)


@pytest.mark.parametrize("ns,rooted", [(4, False), (5, True), (6, False),
                                       (7, False)])
def test_list_trees_match_jax(ns, rooted):
    got = [nwk(t) for t in treegen.list_trees(ns, rooted)]
    want = [jnwk(t) for t in jax_treegen.list_trees(ns, rooted)]
    assert got == want
    assert len(got) == treegen.num_trees(ns, rooted) == \
        jax_treegen.num_trees(ns, rooted)
    assert len(set(got)) == len(got)


def test_tree_from_index_matches_jax():
    for itree in (0, 17, 104):
        assert nwk(treegen.tree_from_index(itree, 6)) == \
            jnwk(jax_treegen.tree_from_index(itree, 6))
    assert nwk(treegen.make_tree_ib(5, [2, 4, 0], rooted=True)) == \
        jnwk(jax_treegen.make_tree_ib(5, [2, 4, 0], rooted=True))


def test_tree_distances_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    trees = [treegen.random_labeled_history(7, False, rng)[0]
             for _ in range(6)]
    path = tmp_path / "trees.txt"
    path.write_text("\n".join(nwk(t) for t in trees) + "\n")
    sh, rf = treegen.tree_distances_file(str(path))
    shj, rfj = jax_treegen.tree_distances_file(str(path))
    np.testing.assert_array_equal(sh, shj)
    np.testing.assert_array_equal(rf, rfj)
    assert (np.diag(rf) == 0).all() and rf.max() > 0
    sh2, rf2 = treegen.tree_distances(trees)
    np.testing.assert_array_equal(rf2, rf)
