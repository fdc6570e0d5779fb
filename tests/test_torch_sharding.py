"""paml_tpu_torch's pattern mesh (`parallel/sharding.py`,
`pruning.set_pattern_mesh`) against unsharded and against paml_tpu on the
CPU.

- The padding functions equal the JAX package's as arrays.
- The codon objective's value and gradient on a CPU mesh of 2 and 3
  shards (`data_mesh(["cpu"] * k)`) equal the unsharded ones and the JAX
  package's `neg_lnl.with_data` on its 8-device CPU mesh (1e-12
  relative, of the largest gradient component), with clean state codes
  and with `TipCodes` (gaps), at an even and an uneven pattern count (the
  port cuts the axis unevenly and pads nothing).
- Several genes (codon Mgene), `lnL_chunked` (each chunk sharded) and
  the nucleotide objective under the mesh equal their unsharded values.
- The tips are cut once per objective: a second evaluation reuses the
  slices."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core import pruning as jax_pruning
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu.parallel import sharding as jax_sharding
from paml_tpu_torch import interop
from paml_tpu_torch.apps import baseml, codeml
from paml_tpu_torch.core import pruning
from paml_tpu_torch.core.tipcodes import TipCodes
from paml_tpu_torch.parallel import sharding

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def gapped_rows(rows, rng):
    """1 in 10 codons of each row a gap, 1 in 50 with an N."""
    out = []
    for row in rows:
        cods = [row[i:i + 3] for i in range(0, len(row), 3)]
        for h in range(len(cods)):
            u = rng.random()
            if u < 0.1:
                cods[h] = "---"
            elif u < 0.12:
                cods[h] = "N" + cods[h][1:]
        out.append("".join(cods))
    return out


def load(gapped: bool, ncod=None):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    rows = [r[:3 * ncod] for r in aln.rows] if ncod else list(aln.rows)
    if gapped:
        rows = gapped_rows(rows, np.random.default_rng(4))
    data = jax_seqio.pack(jax_seqio.Alignment(aln.names, rows,
                                              jax_seqio.CODON_SEQ),
                          cleandata=not gapped)
    tree = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                 data.names)[0]
    topo = jax_from_treenode(tree, data.names)
    return data, topo, interop.packed_from(data), interop.topology_from(topo)


def value_grad(neg, x):
    xt = torch.as_tensor(x, dtype=torch.float64).requires_grad_(True)
    v = neg(xt)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.numpy()


def on_mesh(k, fn):
    pruning.set_pattern_mesh(sharding.data_mesh(["cpu"] * k))
    try:
        return fn()
    finally:
        pruning.set_pattern_mesh(None)


def close(a, b, what):
    (va, ga), (vb, gb) = a, b
    assert abs(va - vb) <= 1e-12 * abs(vb), what
    assert np.abs(ga - gb).max() <= 1e-12 * np.abs(gb).max(), what


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_pad_patterns_match_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    tp = rng.uniform(0, 1, size=(5, 13, 4))
    fp = rng.integers(1, 9, size=13).astype(float)
    for a, b in zip(sharding.pad_patterns(tp, fp, n_shards),
                    jax_sharding.pad_patterns(tp, fp, n_shards)):
        np.testing.assert_array_equal(a, b)


def test_pad_packed_matches_jax():
    data, _, data_t, _ = load(gapped=True)
    for n in (2, 3, 8):
        got = sharding.pad_packed(data_t, n)
        want = jax_sharding.pad_packed(data, n)
        for f in ("tip_partials", "fpatt", "pos_masks", "pattern_site"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.tip_partials.shape[1] % n == 0
    # maybe_pad_packed: a no-op without a mesh and for several genes
    assert sharding.maybe_pad_packed(data_t) is data_t
    got = on_mesh(3, lambda: sharding.maybe_pad_packed(data_t))
    jax_pruning.set_pattern_mesh(jax_sharding.data_mesh(jax.devices()[:3]))
    try:
        want = jax_sharding.maybe_pad_packed(data)
    finally:
        jax_pruning.set_pattern_mesh(None)
    np.testing.assert_array_equal(got.tip_partials, want.tip_partials)
    np.testing.assert_array_equal(got.fpatt, want.fpatt)


@pytest.mark.parametrize("gapped", [False, True])
@pytest.mark.parametrize("ncod", [None, 107])
def test_codon_objective_sharded_matches_unsharded_and_jax(gapped, ncod):
    """H = 111, 235, 65 and 94 patterns: equal and unequal shards of 2 and
    of 3."""
    data, topo, data_t, topo_t = load(gapped, ncod)
    spec = codeml.CodemlSpec(NSsites=2, cleandata=not gapped)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(data_t, topo_t, spec,
                                                      device="cpu")
    assert isinstance(neg.tips, TipCodes) == gapped
    one = value_grad(neg, x0)
    H = data.npatt
    for k in (2, 3):
        close(on_mesh(k, lambda: value_grad(neg, x0)), one,
              f"{k} shards, H = {H}")
    # the JAX package's sharded objective on its 8-device CPU mesh
    jneg, *_ = jax_codeml.make_codon_objective(
        data, topo, jax_codeml.CodemlSpec(NSsites=2, cleandata=not gapped))
    mesh = jax_sharding.data_mesh(jax.devices()[:8])
    tips_s, fpatt_s = jax_sharding.shard_data(mesh, data.tip_partials,
                                              data.fpatt)
    xs = jax_sharding.replicate(mesh, jnp.asarray(x0))
    with mesh:
        vj, gj = jax.jit(jax.value_and_grad(
            lambda p: jneg.with_data(p, tips_s, fpatt_s)))(xs)
    close(on_mesh(3, lambda: value_grad(neg, x0)),
          (float(vj), np.asarray(gj)), "against the JAX package")


def test_tip_shards_made_once():
    _, _, data_t, topo_t = load(gapped=True)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(
        data_t, topo_t, codeml.CodemlSpec(cleandata=False), device="cpu")
    mesh = sharding.data_mesh(["cpu"] * 3)
    pruning.set_pattern_mesh(mesh)
    try:
        value_grad(neg, x0)
        first = neg.tips.shards[2]
        value_grad(neg, x0)
        assert neg.tips.shards[2] is first and len(first) == 3
        b = mesh.bounds(data_t.npatt)
        assert [p.codes.shape[1] for p in first] == \
            [hi - lo for lo, hi in zip(b, b[1:])]
    finally:
        pruning.set_pattern_mesh(None)


def test_chunked_and_several_genes_sharded():
    data, topo, data_t, topo_t = load(gapped=False, ncod=120)
    spec = codeml.CodemlSpec(cleandata=True)
    # the chunks must be equal: the JAX package's padding
    data_p = sharding.pad_packed(data_t, 4)
    negp, _, _, x0, _, _ = codeml.make_codon_objective(
        data_p, topo_t, spec, device="cpu", n_chunks=4)
    close(on_mesh(2, lambda: value_grad(negp, x0)), value_grad(negp, x0),
          "lnL_chunked")
    # two genes (option G), each a pass of its own, each sharded
    import dataclasses
    H = data_t.npatt
    two = dataclasses.replace(data_t, ngene=2,
                              posG=np.array([0, H // 2, H]),
                              lgene=np.array([H // 2, H - H // 2]))
    mneg, _, mx0, _, _ = codeml.make_codon_mgene_objective(
        two, topo_t, spec, 4, device="cpu")
    close(on_mesh(3, lambda: value_grad(mneg, mx0)), value_grad(mneg, mx0),
          "Mgene 4")
    assert sharding.maybe_pad_packed(two) is two


def test_nucleotide_objective_sharded():
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.nuc"),
                                   jax_seqio.BASE_SEQ)
    data = interop.packed_from(jax_seqio.pack(aln, cleandata=True))
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio
    topo = from_treenode(treeio.read_trees(
        os.path.join(DATA, "clock56.trees"), data.names)[0], data.names)
    spec = baseml.BasemlSpec(model="HKY85", ncatG=4, alpha=0.5,
                             cleandata=True)
    neg, _, x0, _ = baseml.make_objective(data, topo, spec, device="cpu")
    close(on_mesh(3, lambda: value_grad(neg, np.asarray(x0, float))),
          value_grad(neg, np.asarray(x0, float)), "HKY85 + G4")


def test_mesh_helpers():
    mesh = sharding.data_mesh(["cpu", "cpu", "cpu"])
    assert mesh.n_shards == 3 and mesh.bounds(10) == [0, 3, 6, 10]
    tips = np.arange(2 * 10).reshape(2, 10)
    fp = np.arange(10.0)
    ts, fs = sharding.shard_data(mesh, tips, fp)
    assert [t.shape[1] for t in ts] == [3, 3, 4]
    np.testing.assert_array_equal(torch.cat(ts, 1).numpy(), tips)
    np.testing.assert_array_equal(torch.cat(fs).numpy(), fp)
    assert len(sharding.replicate(mesh, torch.ones(2))) == 3
    ranks = sharding.Mesh(mesh.devices[:1], group=object(), rank=1, world=3)
    t1, f1 = sharding.shard_data_multihost(ranks, tips, fp)
    np.testing.assert_array_equal(t1, tips[:, 3:6])
    np.testing.assert_array_equal(f1, fp[3:6])
    assert sharding.engage_auto_mesh() is None      # no cards here
    with pytest.raises(ValueError):
        sharding.data_mesh([])
