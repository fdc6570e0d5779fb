"""paml_tpu_torch codon Mgene against paml_tpu, on clock56's codons split
into two genes of 150 codons (option G): `make_codon_mgene_objective` for
Mgene = 0, 2, 3 and 4, with omega free and fixed (with Mgene >= 3 the
reference fixes the last partition's omega alone), x0 and bounds equal,
value and gradient at x0 and at a random in-bounds point (1e-10
relative; gradients to 1e-8 of the largest component); `gene_slice`
field by field; `fit_mgene_separate` (Mgene = 1) and the dispatch of
`fit_packed` against the JAX package's fits."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.io import seqio

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def two_genes(ambiguous=False):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    rows = list(aln.rows)
    if ambiguous:
        rows[0] = "NNN" + rows[0][3:]
        rows[2] = rows[2][:450] + "---" + rows[2][453:]
    data = jax_seqio.pack(jax_seqio.Alignment(
        aln.names, rows, 1, ngene=2,
        site_gene=np.repeat([0, 1], [150, 150])))
    trees = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                  data.names)
    return data, jax_from_treenode(trees[0], data.names)


def random_x(bounds, nb, rng):
    return np.array([rng.uniform(0.01, 0.5) if i < nb else
                     rng.uniform(max(lo, 0.05), min(hi, 3.0))
                     for i, (lo, hi) in enumerate(bounds)])


CASES = [(m, fix) for m in (0, 2, 3, 4) for fix in (False, True)]


@pytest.mark.parametrize("mgene,fix_omega", CASES)
def test_mgene_objective_matches_jax(mgene, fix_omega):
    data_j, topo_j = two_genes(ambiguous=mgene == 4)
    kw = dict(Mgene=mgene, fix_omega=fix_omega, omega=0.7)
    neg_j, _, x0_j, b_j, pis_j = jax_codeml.make_codon_mgene_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), mgene, jnp.float64)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    neg, unpack, x0, b, pis = codeml.make_codon_mgene_objective(
        data, topo, codeml.CodemlSpec(**kw), mgene, device="cpu")
    np.testing.assert_array_equal(x0, x0_j)
    assert b == b_j
    for p, pj in zip(pis, pis_j):
        np.testing.assert_allclose(p, np.asarray(pj), rtol=1e-14)
    vg_j = jax.jit(jax.value_and_grad(neg_j))
    nb = len(topo.branch_nodes())
    for x in (x0, random_x(b, nb, np.random.default_rng(17))):
        vj, gj = vg_j(jnp.asarray(x))
        xt = interop.params_from(x, device="cpu").requires_grad_(True)
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        assert abs(v.item() - float(vj)) <= 1e-10 * abs(float(vj))
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=1e-8 * np.abs(gj).max())
    t, rgene, kaps, oms = unpack(torch.as_tensor(x0))
    assert len(kaps) == len(oms) == (2 if mgene >= 3 else 1)
    assert float(rgene[0]) == 1.0


def test_mgene_1_is_not_an_objective():
    data_j, topo_j = two_genes()
    with pytest.raises(ValueError, match="1 = separate"):
        codeml.make_codon_mgene_objective(
            interop.packed_from(data_j), interop.topology_from(topo_j),
            codeml.CodemlSpec(Mgene=1), 1, device="cpu")


@pytest.mark.parametrize("g", [0, 1])
def test_gene_slice_matches_jax(g):
    data_j, _ = two_genes(ambiguous=True)
    got = codeml.gene_slice(interop.packed_from(data_j), g)
    want = jax_codeml.gene_slice(data_j, g)
    for f in dataclasses.fields(seqio.PackedData):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.ngene == 1 and got.npatt == got.posG[1]


def test_fit_mgene_separate_matches_jax():
    data_j, topo_j = two_genes()
    spec_kw = dict(Mgene=1)
    ref = jax_codeml.fit_mgene_separate(data_j, topo_j,
                                        jax_codeml.CodemlSpec(**spec_kw),
                                        jnp.float64)
    got = codeml.fit_mgene_separate(interop.packed_from(data_j),
                                    interop.topology_from(topo_j),
                                    codeml.CodemlSpec(**spec_kw),
                                    device="cpu")
    assert len(got) == len(ref) == 2
    for r, rj in zip(got, ref):
        assert r.np == rj.np and abs(r.lnL - rj.lnL) <= 1e-5


def test_fit_packed_dispatches_mgene_like_jax():
    data_j, topo_j = two_genes()
    kw = dict(Mgene=2)
    ref = jax_codeml.fit_packed(data_j, topo_j, jax_codeml.CodemlSpec(**kw),
                                dtype=jnp.float64)
    res = codeml.fit_packed(interop.packed_from(data_j),
                            interop.topology_from(topo_j),
                            codeml.CodemlSpec(**kw), device="cpu")
    assert res.np == ref.np and abs(res.lnL - ref.lnL) <= 1e-5
    np.testing.assert_allclose(res.params["rgene"],
                               np.asarray(ref.params["rgene"]), rtol=1e-3)
    assert res.kappa.shape == (1,) and res.params["omegas"].shape == (1,)
