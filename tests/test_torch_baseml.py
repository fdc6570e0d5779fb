"""paml_tpu_torch baseml objective against paml_tpu: value and gradient at
x0 and at a random in-bounds x, to 1e-10 relative (values) and 1e-8 of the
largest component (gradients), on `tests/data/clock56.nuc` (6 taxa, 90
patterns): the eleven models, REVu / UNRESTu with step matrices, TN93 with
kappa fixed, discrete gamma by the mean and the median method, basemlg's
continuous gamma, Mgene 0 / 2 / 3 / 4 (with Malpha) on the alignment
split in two genes, and tips with gaps and ambiguity codes.  Clocks,
TipDate, nparK and the rate HMM: tests/test_torch_baseml_more.py; nhomo:
tests/test_torch_baseml_nhomo.py; the fits and the SEs:
tests/test_torch_baseml_fit.py."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import baseml as jax_baseml
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import ctl as jax_ctl
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import baseml
from paml_tpu_torch.io import ctl

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
CLADE = [9, 0, 1]      # the clade (A, B) of clock56.trees and its stem
VAL_RTOL, GRAD_RTOL = 1e-10, 1e-8


def clock56(variant=""):
    """(JAX PackedData, JAX Topology) of clock56.nuc: 'gapped' with gaps,
    Ns and ambiguity codes, 'genes' split in two genes (option G),
    'labelled' with #1 on the clade (A, B), 'tipdate' with sampling years
    in the names."""
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.nuc"),
                                   jax_seqio.BASE_SEQ)
    if "gapped" in variant:
        rows = list(aln.rows)
        rows[0] = "NN-" + rows[0][3:]
        rows[2] = rows[2][:30] + "----" + rows[2][34:]
        rows[4] = rows[4][:60] + "RYK" + rows[4][63:]
        rows[5] = rows[5][:100] + "?" + rows[5][101:]
        aln = jax_seqio.Alignment(aln.names, rows, aln.seqtype)
    if "genes" in variant:
        ls = len(aln.rows[0])
        aln = jax_seqio.Alignment(aln.names, aln.rows, aln.seqtype, ngene=2,
                                  site_gene=(np.arange(ls) >= ls // 2)
                                  .astype(np.int64))
    data = jax_seqio.pack(aln)
    trees = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                  data.names)
    topo = jax_from_treenode(trees[0], data.names)
    if "labelled" in variant:
        topo.labels[CLADE] = 1
    if "tipdate" in variant:
        topo.ages0[:] = np.nan              # TipDate dates the tips instead
        data.names = [f"{nm}_{1990 + 4 * i}" for i, nm in
                      enumerate(data.names)]
    return data, topo


def random_x(bounds, nb, rng):
    x = []
    for i, (lo, hi) in enumerate(bounds):
        if i < nb:
            x.append(rng.uniform(0.01, 0.5))
        else:
            x.append(rng.uniform(max(lo, -2.0), min(hi, 3.0)))
    return np.array(x)


def specs_of(kw):
    """The same spec in both packages (a step matrix parsed by each)."""
    kw = dict(kw)
    step = kw.pop("step", None)
    spec_j, spec_t = jax_baseml.BasemlSpec(**kw), baseml.BasemlSpec(**kw)
    if step is not None:
        sym = kw["model"] == "REVu"
        spec_j.step_matrix, spec_j.n_user_rates = \
            jax_ctl.parse_step_matrix(step, sym)
        spec_t.step_matrix, spec_t.n_user_rates = \
            ctl.parse_step_matrix(step, sym)
        np.testing.assert_array_equal(spec_t.step_matrix,
                                      spec_j.step_matrix)
    assert [f.name for f in dataclasses.fields(spec_t)] == \
        [f.name for f in dataclasses.fields(spec_j)]
    return spec_j, spec_t


def check_objective(kw, variant="", nb=None, seed=5):
    """Build both objectives, hold x0 and the bounds equal, then value and
    gradient at x0 and at a random in-bounds point."""
    data_j, topo_j = clock56(variant)
    spec_j, spec_t = specs_of(kw)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    if kw.get("nhomo"):
        neg_j, _, x0_j, b_j = jax_baseml.make_nhomo_objective(
            data_j, topo_j, spec_j, jnp.float64)
        neg, _, x0, b = baseml.make_nhomo_objective(data, topo, spec_t,
                                                    device="cpu")
    else:
        neg_j, _, x0_j, b_j = jax_baseml.make_objective(
            data_j, topo_j, spec_j, jnp.float64)
        neg, _, x0, b = baseml.make_objective(data, topo, spec_t,
                                              device="cpu")
    np.testing.assert_array_equal(x0, x0_j)
    assert b == b_j
    # nhomo's objective builds one P per node in a Python loop: compiling
    # it costs more than running it op by op
    vg_j = jax.value_and_grad(neg_j)
    if not kw.get("nhomo"):
        vg_j = jax.jit(vg_j)
    if nb is None:
        nb = len(topo.branch_nodes())
    for x in (x0, random_x(b, nb, np.random.default_rng(seed))):
        vj, gj = vg_j(jnp.asarray(x))
        xt = interop.params_from(x, device="cpu").requires_grad_(True)
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        assert np.isfinite(float(vj))
        assert abs(v.item() - float(vj)) <= VAL_RTOL * abs(float(vj))
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=GRAD_RTOL * np.abs(gj).max())
    return neg


CASES = {
    "JC69": dict(model="JC69"),
    "K80": dict(model="K80"),
    "F81": dict(model="F81"),
    "F84": dict(model="F84"),
    "HKY85": dict(model="HKY85"),
    "T92": dict(model="T92"),
    "TN93": dict(model="TN93"),
    "REV": dict(model="REV"),
    "UNREST": dict(model="UNREST"),
    "REVu": dict(model="REVu", step="[2 (TC) (AG)]"),
    "UNRESTu": dict(model="UNRESTu", step="[3 (TC CT) (AG) (GA TA)]"),
    "TN93_fixkappa": dict(model="TN93", fix_kappa=True, kappa=3.0),
    "HKY85_G5": dict(model="HKY85", ncatG=5, fix_alpha=False),
    "HKY85_G5_median": dict(model="HKY85", ncatG=5, fix_alpha=False,
                            use_median=True),
    "REV_G4_alpha_fixed": dict(model="REV", ncatG=4, alpha=0.7),
    "K80_continuous_gamma": dict(model="K80", continuous_gamma=True,
                                 fix_alpha=False),
    "Mgene0_HKY85_G4": (dict(model="HKY85", Mgene=0, ncatG=4,
                             fix_alpha=False), "genes"),
    "Mgene2_HKY85": (dict(model="HKY85", Mgene=2), "genes"),
    "Mgene3_TN93": (dict(model="TN93", Mgene=3), "genes"),
    "Mgene4_HKY85_G4_Malpha": (dict(model="HKY85", Mgene=4, ncatG=4,
                                    fix_alpha=False, Malpha=True), "genes"),
    "gapped_HKY85_G4": (dict(model="HKY85", ncatG=4, fix_alpha=False),
                        "gapped"),
    "gapped_UNREST": (dict(model="UNREST"), "gapped"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_objective_matches_jax(name):
    kw, variant = CASES[name] if isinstance(CASES[name], tuple) \
        else (CASES[name], "")
    neg = check_objective(kw, variant)
    if variant == "gapped":
        assert neg.tips.dim() == 3                   # partials, not codes
    elif variant == "":
        assert neg.tips.dtype == torch.int32         # state codes


def test_gene_patterns_split_for_the_hessian():
    """The route that is differentiable twice, summed over pattern slices
    that cut across the genes, gives the fit's value."""
    data_j, topo_j = clock56("genes")
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    spec = baseml.BasemlSpec(model="HKY85", Mgene=4, ncatG=3,
                             fix_alpha=False)
    neg, _, x0, _ = baseml.make_objective(data, topo, spec, device="cpu")
    assert data.ngene == 2 and neg.pattern_chunks
    xt = interop.params_from(x0, device="cpu")
    H = data.npatt
    parts = sum(neg.twice(xt, slice(h, min(h + 37, H))).item()
                for h in range(0, H, 37))
    assert abs(parts - neg(xt).item()) <= 1e-12 * abs(parts)


def test_spec_carries_across():
    """A JAX BasemlSpec read from a control file, step matrix and all,
    carried across by `interop.baseml_spec_from`, equals the port's own
    reading of the same file."""
    opts = {"seqfile": "seq.txt", "treefile": "tree.nwk",
            "model": "10 [3 (TC CT) (AG) (GA TA)]", "ncatG": "4",
            "fix_alpha": "0", "alpha": "0.3", "Mgene": "4", "Malpha": "1",
            "clock": "1", "TipDate": "1 100", "getSE": "1"}
    spec_j = jax_ctl.baseml_spec(opts, "baseml.ctl")[0]
    spec_t = ctl.baseml_spec(opts, "baseml.ctl")[0]
    got = interop.baseml_spec_from(spec_j)
    for f in dataclasses.fields(spec_t):
        a, b = getattr(got, f.name), getattr(spec_t, f.name)
        assert np.array_equal(a, b) if isinstance(b, np.ndarray) \
            else a == b, f.name
    assert spec_t.model == "UNRESTu" and spec_t.n_user_rates == 3
