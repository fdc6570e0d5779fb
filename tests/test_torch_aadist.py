"""paml_tpu_torch aaDist models against paml_tpu: `parse_omega_aa` on
OmegaAA.dat texts written here (the stream semantics, the general model,
a misnumbered class, a repeated pair, pairs not one step apart), and
`make_aadist_objective` for aaDist = +-1..6 (chemical distances), 7
(AAClasses, also crossed with branch types under model = 2), 11 and 12
(FIT1 / FIT2): x0 and bounds equal, value and gradient at x0 and at a
random in-bounds point (1e-10 relative; gradients to 1e-8 of the largest
component), on clock56's codons.

The linear models' (aaDist < 0) omega b (1 - a d) is floored at 1e-8 b
where a d >= 1; with most pairs on the floor P(t) spans rates eight
orders apart, and the port's eigh, the JAX package's and
`torch.linalg.matrix_exp` then disagree among themselves beyond 1e-10 in
lnL.  The random point keeps a in (0.01, 0.9), where every pair's omega
is a rate (d is normalized to at most 1) and the three agree to
rounding."""
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
from paml_tpu.models import codon as jax_codon
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.models import codon

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
CLADE = [9, 0, 1]      # the clade (t0, t1) of clock56.trees and its stem

OMEGA_TEXTS = {
    "two_classes": "2\n1: AG AS AT VI IL LM FY DE KR\n0: all others\n",
    "three_classes": "3\n1: AG AS\n2: DE KR QE\n0: others",
    # nothing after the ncls - 1 class lines is read
    "stream_stops": ("2\n1: AG AS\n0: all others\n2: DE NS\n"
                     "// End of File\nQQ junk 7: RK\n"),
    "general_negative": "-1\n",
    "general_large": "65\n1: AG\n",
    "not_one_step_ignored": "2\n1: AW RK CH AA DE\n",
    "misnumbered_class": "3\n2: AG\n1: DE\n",
    "repeated_pair": "2\n1: AG DE GA\n",
    "missing_colon": "2\n1 AG\n",
    "dangling_aa": "2\n1: AG D\n",
    "unknown_aa": "2\n1: AG OU\n",
    "no_integer": "two classes\n",
}


@pytest.mark.parametrize("name", list(OMEGA_TEXTS))
def test_parse_omega_aa_matches_jax(name):
    text = OMEGA_TEXTS[name]
    try:
        want = jax_codeml.parse_omega_aa(text, jax_codon.codon_graph(0))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            codeml.parse_omega_aa(text, codon.codon_graph(0))
        assert str(got.value) == str(e)
        return
    n, cls = codeml.parse_omega_aa(text, codon.codon_graph(0))
    assert n == want[0]
    np.testing.assert_array_equal(cls, want[1])


def clock56(labelled=False):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    data = jax_seqio.pack(aln)
    trees = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                  data.names)
    topo = jax_from_treenode(trees[0], data.names)
    if labelled:
        topo.labels[CLADE] = 1
    return data, topo


def random_x(bounds, nb, rng, linear=False):
    x = np.array([rng.uniform(0.01, 0.5) if i < nb else
                  rng.uniform(max(lo, 1e-3), min(hi, 3.0))
                  for i, (lo, hi) in enumerate(bounds)])
    if linear:
        x[-2] = rng.uniform(0.01, 0.9)        # a of b (1 - a d)
    return x


CASES = ([dict(aaDist=a) for a in (1, 2, 3, 4, 5, 6, -1, -2, -3, -4, -5,
                                   -6, 11, 12)]
         + [dict(aaDist=7), dict(aaDist=7, model=2),
            dict(aaDist=1, codonf="F1x4MG", hkyREV=True)])


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "_".join(
    f"{k}{v}" for k, v in kw.items()))
def test_aadist_objective_matches_jax(kw, tmp_path):
    kw = dict(kw)
    if kw["aaDist"] == 7:
        path = tmp_path / "OmegaAA.dat"
        path.write_text(OMEGA_TEXTS["three_classes"])
        kw["omegaAA"] = str(path)
    data_j, topo_j = clock56(labelled=kw.get("model") == 2)
    neg_j, _, x0_j, b_j, pi_j = jax_codeml.make_aadist_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float64)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    neg, unpack, x0, b, pi = codeml.make_aadist_objective(
        data, topo, codeml.CodemlSpec(**kw), device="cpu")
    np.testing.assert_array_equal(x0, x0_j)
    assert b == b_j
    np.testing.assert_allclose(pi, pi_j, rtol=1e-14)
    vg_j = jax.jit(jax.value_and_grad(neg_j))
    nb = len(topo.branch_nodes())
    for x in (x0, random_x(b, nb, np.random.default_rng(13),
                           kw["aaDist"] < 0)):
        vj, gj = vg_j(jnp.asarray(x))
        xt = interop.params_from(x, device="cpu").requires_grad_(True)
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        assert abs(v.item() - float(vj)) <= 1e-10 * abs(float(vj))
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=1e-8 * np.abs(gj).max())
    P, piC, w = neg.model_at(torch.as_tensor(x0))
    assert P.shape == (topo.nnode, 1, 61, 61) and piC.shape == (1, 61)
    if kw["aaDist"] in (11, 12):
        # the fitness models tilt the codon frequencies
        assert not np.allclose(piC[0].numpy(), pi)
