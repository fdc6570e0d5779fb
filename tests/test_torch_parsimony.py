"""paml_tpu_torch parsimony (`apps/parsimony.py`) and bootstrap partitions
(`apps/bootstrap.py`) against paml_tpu on the CPU, on
`tests/data/clock56.{nuc,codon,trees}` and on trees drawn from a seed: the
Fitch scores and change counts, the informative sites, the enumerated
most-parsimonious reconstructions, the pattern-count bootstrap, tree
partitions, partition distances and clade support.  Also the JAX
package's uint32 state masks, which the port keeps: for 61 codon states
the states from 32 on get mask 0, so codon scores are not Fitch's
(ROADMAP C)."""
import os

import numpy as np
import pytest

from paml_tpu.apps import bootstrap as jax_bootstrap
from paml_tpu.apps import parsimony as jax_parsimony
from paml_tpu.apps import treegen as jax_treegen
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import bootstrap, parsimony

DATA = os.path.join(os.path.dirname(__file__), "data")


def load(kind):
    seqtype = jax_seqio.BASE_SEQ if kind == "nuc" else jax_seqio.CODON_SEQ
    aln = jax_seqio.read_alignment(os.path.join(DATA, f"clock56.{kind}"),
                                   seqtype)
    data = jax_seqio.pack(aln, cleandata=True)
    tree = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                 data.names)[0]
    topo = jax_from_treenode(tree, data.names)
    return data, topo, interop.packed_from(data), interop.topology_from(topo)


@pytest.fixture(scope="module", params=["nuc", "codon"])
def clock56(request):
    return load(request.param)


def test_mp_score_matches_jax(clock56):
    data, topo, data_t, topo_t = clock56
    st = parsimony.mp_score(topo_t, data_t)
    assert st == jax_parsimony.mp_score(topo, data) and st > 0
    np.testing.assert_array_equal(parsimony.site_change_counts(topo_t, data_t),
                                  jax_parsimony.site_change_counts(topo, data))


def test_informative_sites_match_jax(clock56):
    data, _, data_t, _ = clock56
    got = parsimony.informative_sites(data_t)
    np.testing.assert_array_equal(got, jax_parsimony.informative_sites(data))
    assert got.any() and not got.all()


def test_pathway_mp_matches_jax():
    data, topo, data_t, topo_t = load("nuc")
    keep = np.arange(0, data.npatt, 7)
    sub = jax_seqio.PackedData(
        names=data.names, seqtype=data.seqtype, nstates=data.nstates,
        tip_partials=data.tip_partials[:, keep], fpatt=data.fpatt[keep])
    got = parsimony.pathway_mp(topo_t, interop.packed_from(sub), max_paths=8)
    want = jax_parsimony.pathway_mp(topo, sub, max_paths=8)
    assert got == want
    assert max(p["n_paths"] for p in got) > 1


def test_codon_masks_keep_jax_uint32_bits():
    """The JAX package's `1 << arange(61)` in uint32: states 32-60 get mask
    0 (a fault of paml_tpu that the port keeps so that tree
    searches start from the same trees; ROADMAP C)."""
    data, topo, data_t, topo_t = load("codon")
    masks = parsimony._tip_bitmasks(data_t)
    np.testing.assert_array_equal(masks, jax_parsimony._tip_bitmasks(data))
    st = data_t.tip_partials.argmax(-1)
    high = st >= 32
    assert high.any()
    # a resolved tip in a state from 32 on is compatible with no state
    assert (masks[high] == 0).all()
    want = np.left_shift(np.uint64(1), st.astype(np.uint64))
    assert (masks[~high].astype(np.uint64) == want[~high]).all()


def test_bootstrap_alignment_matches_jax():
    data, _, data_t, _ = load("nuc")
    got = bootstrap.bootstrap_alignment(data_t, seed=4, n_rep=3)
    want = jax_bootstrap.bootstrap_alignment(data, seed=4, n_rep=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.sum() == data.fpatt.sum()


def test_partitions_and_clade_support_match_jax():
    rng = np.random.default_rng(2)
    names = jax_treegen.default_names(8)
    trees_j = [jax_treegen.random_labeled_history(8, False, rng)[0]
               for _ in range(12)]
    topos_j = [jax_from_treenode(t, names) for t in trees_j]
    topos_t = [interop.topology_from(t) for t in topos_j]
    for a, b in zip(topos_t, topos_j):
        assert bootstrap.tree_partitions(a) == \
            jax_bootstrap.tree_partitions(b)
    for i in range(1, 12):
        assert bootstrap.partition_distance(topos_t[0], topos_t[i]) == \
            jax_bootstrap.partition_distance(topos_j[0], topos_j[i])
    assert bootstrap.partition_distance(topos_t[0], topos_t[0]) == 0
    got = bootstrap.clade_support(topos_t[0], topos_t)
    want = jax_bootstrap.clade_support(topos_j[0], topos_j)
    assert got == want and all(v >= 1 / 12 for v in got.values())
