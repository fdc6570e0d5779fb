"""paml_tpu_torch amino-acid likelihood (codeml seqtype 2 / 3) against
paml_tpu: `make_aa_objective` for the seven aa_models, with and without
discrete-gamma rates, and `make_fromcodon0_objective`, x0 and bounds
equal, value and gradient at x0 and at a random in-bounds point (1e-10
relative; gradients to 1e-8 of the largest component); on clock56's
codons translated (6 taxa x 300 amino acids) and on an alignment simulated
with the port's own P(t), with gaps and X.  One small fit (LG + F + G4)
against the JAX package's `fit_aa_packed`."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.core.tipcodes import TipCodes

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
GAMMA = dict(fix_alpha=False, alpha=0.5, ncatG=4)


def clock56_aa():
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON2AA_SEQ)
    data = jax_seqio.pack(aln)
    trees = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                  data.names)
    return data, jax_from_treenode(trees[0], data.names)


def gapped_aa():
    """6 taxa x 240 amino acids simulated under LG + G4 with gap runs and
    X (chip_smoke's simulator and gaps), seqtype 2."""
    rng = np.random.default_rng(2024)
    names, rows, nwk = chip_smoke.simulate_aa(torch, rng, 6, 240, "cpu")
    rows = chip_smoke.gapped_nuc_rows(rng, rows, amb=b"X")
    rows[0] = "X" * 12 + rows[0][12:]
    rows[1] = rows[1][:20] + "-" * 15 + rows[1][35:]
    data = jax_seqio.pack(jax_seqio.Alignment(names, rows, 2))
    tree = jax_treeio.parse_newick(nwk)
    jax_treeio._resolve_names(tree, names)
    return data, jax_from_treenode(tree, names)


PROBLEMS = {"clock56": clock56_aa, "gapped": gapped_aa}


def random_x(bounds, nb, rng):
    return np.array([rng.uniform(0.01, 0.5) if i < nb else
                     rng.uniform(max(lo, 1e-3), min(hi, 3.0))
                     for i, (lo, hi) in enumerate(bounds)])


def assert_objectives_match(make_j, make_t, data_j, topo_j, kw):
    neg_j, _, x0_j, b_j, pi_j = make_j(data_j, topo_j,
                                       jax_codeml.CodemlSpec(**kw),
                                       jnp.float64)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    neg, _, x0, b, pi = make_t(data, topo, codeml.CodemlSpec(**kw),
                               device="cpu")
    np.testing.assert_array_equal(x0, x0_j)
    assert b == b_j
    np.testing.assert_allclose(pi, pi_j, rtol=1e-14)
    vg_j = jax.jit(jax.value_and_grad(neg_j))
    nb = len(topo.branch_nodes())
    for x in (x0, random_x(b, nb, np.random.default_rng(9))):
        vj, gj = vg_j(jnp.asarray(x))
        xt = interop.params_from(x, device="cpu").requires_grad_(True)
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        assert abs(v.item() - float(vj)) <= 1e-10 * abs(float(vj))
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=1e-8 * np.abs(gj).max())
    return neg


CASES = ([(m, g, "clock56") for m in ("Poisson", "EqualInput", "Empirical",
                                      "Empirical_F", "FromCodon", "REVaa_0",
                                      "REVaa") for g in (False, True)]
         + [("Empirical_F", True, "gapped"), ("REVaa_0", False, "gapped")])


@pytest.mark.parametrize("model,gamma,problem", CASES)
def test_aa_objective_matches_jax(model, gamma, problem):
    data_j, topo_j = PROBLEMS[problem]()
    kw = dict(seqtype=2, aa_model=model, **(GAMMA if gamma else {}))
    if model == "Empirical":
        kw["aa_rate_file"] = "wag"
    if model == "REVaa" and not gamma:
        kw.update(fix_alpha=True, alpha=0.3, ncatG=3)   # alpha taken as 0.5
    neg = assert_objectives_match(jax_codeml.make_aa_objective,
                                  codeml.make_aa_objective, data_j, topo_j,
                                  kw)
    assert isinstance(neg.tips, TipCodes) == (problem == "gapped")
    P, piC, w = neg.model_at(torch.zeros(len(neg.topo.branch_nodes()) + 200,
                                         dtype=torch.float64) + 0.5)
    K = 4 if gamma else (3 if model == "REVaa" else 1)
    assert P.shape[1:] == (K, 20, 20) and piC.shape == (K, 20)


@pytest.mark.parametrize("problem", ["clock56", "gapped"])
def test_fromcodon0_objective_matches_jax(problem):
    data_j, topo_j = PROBLEMS[problem]()
    neg = assert_objectives_match(jax_codeml.make_fromcodon0_objective,
                                  codeml.make_fromcodon0_objective, data_j,
                                  topo_j, dict(seqtype=3,
                                               aa_model="FromCodon0"))
    # an amino acid is the set of its codons: coded tips with a table
    assert isinstance(neg.tips, TipCodes) and neg.tips.amb.shape[1] == 61


def test_fit_aa_packed_matches_jax():
    data_j, topo_j = clock56_aa()
    kw = dict(seqtype=3, aa_model="Empirical_F", aa_rate_file="lg", **GAMMA)
    ref = jax_codeml.fit_aa_packed(data_j, topo_j,
                                   jax_codeml.CodemlSpec(**kw),
                                   dtype=jnp.float64)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    spec = codeml.CodemlSpec(**kw)
    res = codeml.fit_packed(data, topo, spec, device="cpu")
    assert res.x.shape == ref.x.shape and res.np == ref.np
    assert abs(res.lnL - ref.lnL) <= 1e-5
    assert res.kappa.size == 0
    for key in ref.params:
        np.testing.assert_allclose(res.params[key], np.asarray(
            ref.params[key]), rtol=2e-3, atol=1e-6)
    neg = codeml.make_aa_objective(data, topo, spec, device="cpu")[0]
    with torch.no_grad():
        at_ref = -neg(interop.params_from(ref.x, device="cpu")).item()
    assert abs(at_ref - ref.lnL) <= 1e-9 * abs(ref.lnL)
