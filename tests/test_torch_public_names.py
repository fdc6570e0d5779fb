"""Four public names of paml_tpu that paml_tpu_torch carries, against the
JAX package on the CPU: `models/codon.selection_coefficients` under
FMutSel and FMutSel0 at a seeded parameter point on clock56.codon (every
array to 1e-12), `core/pruning.root_partials` on a 32-taxon star and a
64-taxon ladder (float64 to 1e-12, float32 to 2e-6), `core/pmat.symmetrize`
(to 1e-15) and `io/ctl.AA_MODEL_BY_INDEX` (equal)."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paml_tpu.core import pmat as jax_pmat
from paml_tpu.core import pruning as jax_pruning
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import ctl as jax_ctl
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu.models import codon as jax_codon
from paml_tpu_torch import interop
from paml_tpu_torch.core import pmat, pruning
from paml_tpu_torch.io import ctl
from paml_tpu_torch.models import codon

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.parametrize("codonf,hkyrev", [("FMutSel", False),
                                           ("FMutSel", True),
                                           ("FMutSel0", False)])
def test_selection_coefficients_match_jax(codonf, hkyrev):
    data = jax_seqio.pack(jax_seqio.read_alignment(
        os.path.join(DATA, "clock56.codon"), jax_seqio.CODON_SEQ))
    graph_j, graph = jax_codon.codon_graph(0), codon.codon_graph(0)
    fcodon = codon.count_codon_freqs(data.tip_partials, data.fpatt, graph,
                                     data.pos_masks)[0]
    rng = np.random.default_rng(21)
    pf = rng.dirichlet(np.full(4, 5.0))
    fit = (rng.normal(0.0, 0.5, graph.n - 1) if codonf == "FMutSel"
           else None)
    pi = codon.fmutsel_pi(codonf, torch.tensor(pf),
                          None if fit is None else torch.tensor(fit),
                          fcodon, codon.pair_tables(0, "cpu")).numpy()
    kappa = rng.uniform(0.5, 3.0, 5) if hkyrev else rng.uniform(1.0, 4.0)
    omega = rng.uniform(0.1, 1.5)
    args = (pf, pi, kappa, omega, hkyrev, data.ls)
    got = codon.selection_coefficients(graph, *args)
    want = jax_codon.selection_coefficients(graph_j, *args)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-12, atol=0, err_msg=key)


def tree(shape, ns):
    names = [f"t{i}" for i in range(ns)]
    if shape == "star":
        nwk = "(" + ",".join(names) + ");"
    else:
        nwk = names[0]
        for nm in names[1:]:
            nwk = f"({nwk},{nm})"
        nwk += ";"
    topo_j = jax_from_treenode(jax_treeio.parse_newick(nwk), names)
    return topo_j, interop.topology_from(topo_j)


@pytest.mark.parametrize("shape,ns", [("star", 32), ("ladder", 64)])
def test_root_partials_match_jax(shape, ns):
    topo_j, topo = tree(shape, ns)
    rng = np.random.default_rng(ns)
    C, n, H = 2, 20, 40
    P = rng.gamma(1.0, 1.0, (topo.nnode, C, n, n))
    P = 0.8 * np.eye(n) + 0.2 * P / P.sum(-1, keepdims=True)
    tips = np.zeros((ns, H, n))
    tips[np.arange(ns)[:, None], np.arange(H),
         rng.integers(0, n, (ns, H))] = 1.0
    tips[0, :5] = 1.0                       # gaps in the first taxon
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 2e-6)):
        part_j, scale_j = jax_pruning.root_partials(
            jnp.asarray(P, dtype), jnp.asarray(tips, dtype), topo_j)
        part, scale = pruning.root_partials(
            torch.tensor(P, dtype=getattr(torch, np.dtype(dtype).name)),
            torch.tensor(tips), topo)
        assert part.shape == (C, H, n) and scale.shape == (C, H)
        assert part.dtype == scale.dtype == getattr(torch,
                                                    np.dtype(dtype).name)
        np.testing.assert_allclose(part.numpy(), np.asarray(part_j),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(scale.numpy(), np.asarray(scale_j),
                                   rtol=tol, atol=0)


def test_symmetrize_matches_jax():
    rng = np.random.default_rng(3)
    n = 61
    pi = rng.dirichlet(np.ones(n))
    pi[[4, 9]] = 0.0
    pi /= pi.sum()
    S = rng.gamma(1.0, 1.0, (n, n))
    Q = (S + S.T) * pi[None, :]
    np.fill_diagonal(Q, -Q.sum(1))
    got = pmat.symmetrize(torch.tensor(Q), torch.tensor(pi)).numpy()
    want = np.asarray(jax_pmat.symmetrize(jnp.asarray(Q), jnp.asarray(pi)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(got, got.T)


def test_aa_model_by_index_matches_jax():
    assert ctl.AA_MODEL_BY_INDEX == jax_ctl.AA_MODEL_BY_INDEX
