"""paml_tpu_torch host layer against paml_tpu: Newick parsing, the array
topology, PHYLIP reading and pattern packing, the interop helpers, and
the import boundary (no JAX, no paml_tpu)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.core.topology import Topology, from_treenode
from paml_tpu_torch.io import seqio, treeio

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEWICKS = [
    ("((a:0.1,b:0.2):0.05,(c:0.3,d:0.1)#1,e:0.7);", list("abcde")),
    ("(((a,b),c),(d,(e,f)));", list("abcdef")),
    ("((a #1, b) $2, (c, d) :0.2, (e, f, g)'@0.4');", list("abcdefg")),
    ("((1:0.1,2:0.1)x:0.2,3:0.3,(4,5):0.1);",
     ["s1", "s2", "s3", "s4", "s5"]),
]


def assert_same_fields(a, b, names):
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=name)
        else:
            assert va == vb, name


@pytest.mark.parametrize("nwk,names", NEWICKS)
def test_newick_topology_matches(nwk, names):
    tj = jax_treeio.parse_newick(nwk)
    tt = treeio.parse_newick(nwk)
    jax_treeio._resolve_names(tj, names)
    treeio._resolve_names(tt, names)
    topo_j = jax_from_treenode(tj, names)
    topo_t = from_treenode(tt, names)
    assert_same_fields(topo_t, topo_j,
                       [f.name for f in dataclasses.fields(Topology)])
    assert_same_fields(interop.topology_from(topo_j), topo_t,
                       [f.name for f in dataclasses.fields(Topology)])


@pytest.mark.parametrize("cleandata", [False, True])
def test_pack_clock56_matches(cleandata):
    path = os.path.join(DATA, "clock56.codon")
    aj = jax_seqio.read_alignment(path, jax_seqio.CODON_SEQ)
    at = seqio.read_alignment(path, seqio.CODON_SEQ)
    assert at.names == aj.names and at.rows == aj.rows
    dj = jax_seqio.pack(aj, cleandata=cleandata)
    dt = seqio.pack(at, cleandata=cleandata)
    fields = [f.name for f in dataclasses.fields(seqio.PackedData)]
    assert fields == [f.name for f in dataclasses.fields(
        jax_seqio.PackedData)]
    assert_same_fields(dt, dj, fields)
    assert_same_fields(interop.packed_from(dj), dt, fields)
    trees_j = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                    dj.names)
    trees_t = treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                dt.names)
    assert_same_fields(from_treenode(trees_t[0], dt.names),
                       jax_from_treenode(trees_j[0], dj.names),
                       [f.name for f in dataclasses.fields(Topology)])


def test_pack_ambiguous_codons_match():
    rng = np.random.default_rng(4)
    rows = ["".join(rng.choice(list("TCAG"), size=60)) for _ in range(4)]
    rows = [r.replace("TAA", "TCA").replace("TAG", "TCG").replace("TGA",
                                                                 "TCA")
            for r in rows]
    rows[0] = "NNN" + rows[0][3:]
    rows[1] = rows[1][:6] + "-R-" + rows[1][9:]
    rows[2] = rows[2][:12] + "CAY" + rows[2][15:]
    names = ["a", "b", "c", "d"]
    dj = jax_seqio.pack(jax_seqio.Alignment(names, rows, 1))
    dt = seqio.pack(seqio.Alignment(names, rows, 1))
    assert_same_fields(dt, dj,
                       [f.name for f in dataclasses.fields(seqio.PackedData)])


def test_unported_inputs_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        seqio.pack(seqio.Alignment(["a", "b"], ["AR", "AK"], seqio.AA_SEQ))


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil\n"
        "import paml_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "paml_tpu_torch.__path__, 'paml_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'paml_tpu' or m.startswith('paml_tpu.')]\n"
        "assert len(mods) >= 12, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
