"""paml_tpu_torch tree search (`apps/treesearch.py`) against paml_tpu on the
CPU, on `tests/data/clock56.{nuc,codon}`: the candidates and the trees of
the parsimony searches (stepwise addition, NNI, star decomposition) as the
same Newick bytes with the same scores, the least-squares branch lengths
(1e-9), and codeml at runmode 4 (NNI from the parsimony stepwise tree,
every candidate a full fit) against the JAX program on 5 taxa.  Also the
kernels' binary resolution of a wide node (`cuda_pruning.big_tree`):
the plain version on the resolved star tree gives the star's own value
and gradient, the adjoint's clip left off the added nodes (ROADMAP C)."""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from paml_tpu import __main__ as jax_cli
from paml_tpu.apps import parsimony as jax_parsimony
from paml_tpu.apps import treesearch as jax_treesearch
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import __main__ as cli
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml, treesearch
from paml_tpu_torch.core import cuda_pruning, pruning
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io import seqio, treeio
from test_torch_cli import write_problem

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def load(kind):
    seqtype = jax_seqio.BASE_SEQ if kind == "nuc" else jax_seqio.CODON_SEQ
    aln = jax_seqio.read_alignment(os.path.join(DATA, f"clock56.{kind}"),
                                   seqtype)
    data = jax_seqio.pack(aln, cleandata=True)
    tree = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                 data.names)[0]
    return data, tree, interop.packed_from(data)


def nwk(tree):
    return treeio.write_newick(tree, branch_lengths=False)


def jnwk(tree):
    return jax_treeio.write_newick(tree, branch_lengths=False)


@pytest.mark.parametrize("kind", ["nuc", "codon"])
def test_parsimony_searches_match_jax(kind):
    data, _, data_t = load(kind)
    t, s = treesearch.stepwise_addition_mp(data_t)
    j, sj = jax_treesearch.stepwise_addition_mp(data)
    assert nwk(t) == jnwk(j) and s == sj
    assert [nwk(c) for c in treesearch.nni_neighbors(t)] == \
        [jnwk(c) for c in jax_treesearch.nni_neighbors(j)]
    t2, s2 = treesearch.nni_search_mp(data_t, t)
    j2, sj2 = jax_treesearch.nni_search_mp(data, j)
    assert nwk(t2) == jnwk(j2) and s2 == sj2 <= s
    t3, s3 = treesearch.star_decomposition(data_t, None, mp=True)
    j3, sj3 = jax_treesearch.star_decomposition(data, None, mp=True)
    assert nwk(t3) == jnwk(j3) and s3 == sj3


def test_ml_searches_order_of_candidates_matches_jax():
    """Stepwise addition, star decomposition and NNI under an ML scorer:
    the same candidates in the same order (scored here by the negative
    parsimony score, so that both packages see the same numbers)."""
    data, _, data_t = load("nuc")
    seen_t, seen_j = [], []

    def fit_t(topo, sub):
        seen_t.append(nwk(treeio.parse_newick(_topo_newick(topo))))
        from paml_tpu_torch.apps import parsimony
        return -parsimony.mp_score(topo, sub)

    def fit_j(topo, sub):
        seen_j.append(nwk(treeio.parse_newick(_topo_newick(topo))))
        return -jax_parsimony.mp_score(topo, sub)

    t, s = treesearch.stepwise_addition_ml(data_t, fit_t)
    j, sj = jax_treesearch.stepwise_addition_ml(data, fit_j)
    assert nwk(t) == jnwk(j) and s == sj
    t, s = treesearch.star_decomposition(data_t, fit_t)
    j, sj = jax_treesearch.star_decomposition(data, fit_j)
    assert nwk(t) == jnwk(j) and s == sj
    t, s = treesearch.nni_search_ml(data_t, t, lambda tp: fit_t(tp, data_t))
    j, sj = jax_treesearch.nni_search_ml(data, j, lambda tp: fit_j(tp, data))
    assert nwk(t) == jnwk(j) and s == sj
    assert seen_t == seen_j and len(seen_t) > 20


def _topo_newick(topo) -> str:
    def build(v):
        kids = [c for c in topo.children[v] if c >= 0]
        if not kids:
            return topo.node_names[v]
        return "(" + ",".join(build(int(c)) for c in kids) + ")"
    return build(topo.root) + ";"


def test_subset_data_keeps_full_frequencies():
    data, _, data_t = load("nuc")
    keep = data.names[:4]
    sub_t = treesearch._subset_data(data_t, keep)
    sub_j = jax_treesearch._subset_data(data, keep)
    assert sub_t.names == sub_j.names == keep
    np.testing.assert_array_equal(sub_t.tip_partials, sub_j.tip_partials)
    np.testing.assert_array_equal(sub_t.fpatt, data.fpatt)
    np.testing.assert_array_equal(sub_t.base_freqs, data.base_freqs)


def test_ls_branch_lengths_match_jax():
    data, tree, data_t = load("nuc")
    topo_j = jax_from_treenode(tree, data.names)
    topo_t = interop.topology_from(topo_j)
    rng = np.random.default_rng(1)
    D = rng.uniform(0.05, 0.5, size=(data.ns, data.ns))
    D = D + D.T
    np.fill_diagonal(D, 0.0)
    bt, st = treesearch.ls_branch_lengths(topo_t, D)
    bj, sj = jax_treesearch.ls_branch_lengths(topo_j, D)
    np.testing.assert_allclose(bt, bj, rtol=1e-9, atol=1e-12)
    assert abs(st - sj) <= 1e-9 * max(sj, 1e-12)
    assert bt[topo_t.root] == 0.0 and (bt >= 0).all()


def test_codeml_runmode4_matches_jax_cli(tmp_path, monkeypatch):
    """codeml runmode 4 (NNI from the parsimony stepwise-addition tree; the
    codon parsimony keeps the JAX package's uint32 masks, so both start
    from the same tree) on 5 taxa x 150 codons: mlc's best lnL and tree
    against the JAX program's."""
    rng = np.random.default_rng(20240601)
    names, rows, nwk_, _ = chip_smoke.simulate_site_classes(
        torch, rng, 6, 150, "cpu", shape="trifurcating")
    names, rows = names[:5], rows[:5]
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    ctl_j = write_problem(dj, names, rows, [nwk_], runmode=4)
    ctl_t = write_problem(dt, names, rows, [nwk_], runmode=4)
    monkeypatch.chdir(dj)
    jax_cli.run_codeml(ctl_j)
    monkeypatch.chdir(dt)
    out = cli.main(["codeml", ctl_t, "--device", "cpu"])
    mj, mt = (open(os.path.join(d, "mlc")).read().splitlines()
              for d in (dj, dt))
    assert mt[0] == "CODEML (paml_tpu_torch) tree search runmode 4"
    assert mt[1:] == mj[1:]
    assert abs(out["lnL"] - float(mj[1].split()[-1])) <= 5e-7
    # every candidate is a full fit of the 5 taxa
    assert out["fits"] and all(f["data"].ns == 5 for f in out["fits"])


def test_runmode1_fits_the_given_tree(tmp_path, monkeypatch):
    """runmode = 1 fits the given tree as runmode = 0 does, as in the JAX
    program (ROADMAP C: the reference searches from the given tree)."""
    rng = np.random.default_rng(3)
    names, rows, nwk_, _ = chip_smoke.simulate_site_classes(
        torch, rng, 4, 60, "cpu", shape="trifurcating")
    outs = {}
    for runmode in (0, 1):
        d = str(tmp_path / f"r{runmode}")
        ctl = write_problem(d, names, rows, [nwk_], runmode=runmode)
        monkeypatch.chdir(d)
        outs[runmode] = cli.main(["codeml", ctl, "--device", "cpu"])
    assert outs[1]["runs"][0]["res"].lnL == outs[0]["runs"][0]["res"].lnL


@pytest.mark.parametrize("gapped", [False, True])
def test_resolved_star_keeps_the_star_gradient(gapped):
    """A 12-taxon star tree: the plain version on `big_tree`'s binary
    resolution (the tree the kernels walk) gives the star's value and
    gradient.  Each added node rescales its partial, so its adjoint G
    grows by 1 / m per level; clipping it at 1e12, as the clip of the
    tree's own nodes does, changed the gradient of the root's children
    (ROADMAP C).  The data: 12 taxa simulated under M0 on a ladder, the
    star at the model's start."""
    rng = np.random.default_rng(5)
    names, rows, _ = chip_smoke.simulate_m0_rows(torch, rng, 12, 200,
                                                 device="cpu")
    if gapped:
        rows = chip_smoke.gapped_rows(rng, rows)
    data = seqio.pack(seqio.Alignment(names, rows, seqio.CODON_SEQ),
                      cleandata=False)
    star = from_treenode(treeio.parse_newick("(" + ",".join(names) + ");"),
                         names)
    neg = codeml.make_codon_objective(
        data, star, codeml.CodemlSpec(NSsites=0, codonf="F3x4",
                                      cleandata=False), device="cpu")
    x0 = torch.as_tensor(neg[3])
    P, piC, w = neg[0].model_at(x0)
    bt = cuda_pruning.big_tree(star)
    assert bt.nnode > star.nnode and bt.n_own == star.nnode
    grads = []
    for tree, Pt in ((star, P), (bt, cuda_pruning.with_identity(P, bt))):
        Pg = Pt.detach().requires_grad_(True)
        v = pruning.lnL(Pg, neg[0].tips, tree, piC, w, neg[0].fpatt)
        g = torch.autograd.grad(v, Pg)[0][:star.nnode]
        grads.append((float(v.detach()), g))
    (v1, g1), (v2, g2) = grads
    assert abs(v1 - v2) <= 1e-12 * abs(v1)
    assert float((g1 - g2).abs().max()) <= 1e-10 * float(g1.abs().max())
