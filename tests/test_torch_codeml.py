"""paml_tpu_torch codeml objective against paml_tpu: value and gradient at
x0 and at a random in-bounds x, for M0/M1a/M2a/M3 and the codon-frequency
and option variants of the slice, to 1e-9 relative; clean (state-code)
and ambiguous (multi-hot) tips; unported settings raise."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml

DATA = os.path.join(os.path.dirname(__file__), "data")


def _clock56(ambiguous, icode=0):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    if ambiguous:
        rows = list(aln.rows)
        rows[0] = "NNN" + rows[0][3:]
        rows[2] = rows[2][:30] + "---" + rows[2][33:]
        rows[4] = rows[4][:60] + rows[4][60:62] + "Y" + rows[4][63:]
        aln = jax_seqio.Alignment(aln.names, rows, aln.seqtype)
    if icode == 1:
        # AGA/AGG are stops in the vertebrate mitochondrial code
        stop = {"AGA": "CGA", "AGG": "CGG"}
        rows = ["".join(stop.get(r[i:i + 3], r[i:i + 3])
                        for i in range(0, len(r), 3)) for r in aln.rows]
        aln = jax_seqio.Alignment(aln.names, rows, aln.seqtype)
    data = jax_seqio.pack(aln, icode=icode)
    trees = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                  data.names)
    topo = jax_from_treenode(trees[0], data.names)
    # the tree file has no branch lengths; fix_blength = 2 needs some
    topo.blen0[:] = np.random.default_rng(11).uniform(0.05, 0.3,
                                                      topo.nnode)
    return data, topo


def _random_x(bounds, nb, rng):
    x = []
    for i, (lo, hi) in enumerate(bounds):
        if i < nb:
            x.append(rng.uniform(0.01, 0.5))
        else:
            x.append(rng.uniform(max(lo, -2.0), min(hi, 3.0)))
    return np.array(x)


SPECS = {
    "M0": dict(NSsites=0),
    "M1a": dict(NSsites=1),
    "M2a": dict(NSsites=2),
    "M3": dict(NSsites=3),
    "M3_K4": dict(NSsites=3, ncatG=4),
    "M2a_fixw": dict(NSsites=2, fix_omega=True, omega=1.5),
    "M0_Fequal": dict(NSsites=0, codonf="Fequal"),
    "M0_F1x4": dict(NSsites=0, codonf="F1x4"),
    "M0_F61_icode1": dict(NSsites=0, codonf="Fcodon", icode=1),
    "M0_F3x4MG_hkyREV": dict(NSsites=0, codonf="F3x4MG", hkyREV=True),
    "M0_fixkappa_fixblength": dict(NSsites=0, fix_kappa=True, kappa=3.0,
                                   fix_blength=2),
}


CASES = [(name, False) for name in SPECS] + [("M0", True), ("M2a", True)]


@pytest.mark.parametrize("name,ambiguous", CASES)
def test_objective_matches_jax(name, ambiguous):
    kw = SPECS[name]
    data_j, topo_j = _clock56(ambiguous, kw.get("icode", 0))
    spec_j = jax_codeml.CodemlSpec(**kw)
    spec_t = codeml.CodemlSpec(**kw)
    assert [f.name for f in dataclasses.fields(spec_t)] == \
        [f.name for f in dataclasses.fields(spec_j)]
    neg_j, _, _, x0_j, b_j, pi_j = jax_codeml.make_codon_objective(
        data_j, topo_j, spec_j, jnp.float64)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    neg, unpack, classes_for, x0, b, pi = codeml.make_codon_objective(
        data, topo, spec_t, device="cpu")
    assert (neg.tips.dim() == 3) == ambiguous
    np.testing.assert_array_equal(x0, x0_j)
    assert b == b_j
    np.testing.assert_allclose(pi, pi_j, rtol=1e-14)
    vg_j = jax.jit(jax.value_and_grad(neg_j))
    nb = len(topo.branch_nodes()) if kw.get("fix_blength") != 2 else 0
    for x in (x0, _random_x(b, nb, np.random.default_rng(5))):
        vj, gj = vg_j(jnp.asarray(x))
        xt = interop.params_from(x, device="cpu").requires_grad_(True)
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        assert abs(v.item() - float(vj)) <= 1e-9 * abs(float(vj))
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-9,
                                   atol=1e-9 * np.abs(gj).max())


@pytest.mark.parametrize("kw,item", [
    (dict(model=2), "A4"), (dict(NSsites=8), "A2"),
    (dict(codonf="FMutSel"), "A5"), (dict(clock=1), "A6"),
    (dict(getSE=True), "A3"), (dict(seqtype=2), "A9")])
def test_unported_specs_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        codeml.check_slice(codeml.CodemlSpec(**kw))


def test_entry_points_need_a_device():
    data_j, topo_j = _clock56(False)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    with pytest.raises(TypeError):
        codeml.make_codon_objective(data, topo, codeml.CodemlSpec())
    with pytest.raises(TypeError):
        codeml.fit_packed(data, topo, codeml.CodemlSpec())
