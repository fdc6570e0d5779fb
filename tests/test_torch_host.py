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


def test_unported_inputs_raise(tmp_path):
    """Continuous morphological characters, once refused until mcmctree
    was ported, read as the JAX package reads them: a block whose header
    carries M (with popvar and ldetRm), after a sequence block."""
    path = tmp_path / "morph.txt"
    path.write_text("3 6\na  ACGTAC\nb  ACGTTC\nc  AGGTAC\n\n"
                    "3 3 M 0.2 -0.5\na 0.1 0.2 0.3\nb 0.2 0.1 0.0\n"
                    "c 1 2 3\n")
    at = seqio.read_alignments(str(path))
    aj = jax_seqio.read_alignments(str(path))
    assert isinstance(at[1], seqio.MorphAlignment) and len(at) == 2
    assert at[0].rows == aj[0].rows
    for f in ("names", "popvar", "ldetRm", "seqtype"):
        assert getattr(at[1], f) == getattr(aj[1], f), f
    np.testing.assert_array_equal(at[1].z, aj[1].z)


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


# --- the program's host layer: control files, readers, side outputs ------

CTLS = {
    "site_models": """
      seqfile = seq.txt * the alignment
     treefile = tree.txt
      outfile = mlc
        noisy = 9
      verbose = 1
      runmode = 0
      seqtype = 1
    CodonFreq = 2
        clock = 0
        model = 0
      NSsites = 0 1 2 7 8
        icode = 0
    fix_kappa = 0
        kappa = 2.5
    fix_omega = 0
        omega = .4
        ncatG = 10
        getSE = 1
 RateAncestor = 0
   Small_Diff = .5e-6
    cleandata = 0
  fix_blength = 1
       method = 0
""",
    "branch_site_null": """
      seqfile = ../data/seq.txt
     treefile = /abs/tree.txt
      seqtype = 1
    CodonFreq = 7
        model = 2
      NSsites = 2
    fix_omega = 1
        omega = 1
       hkyREV = 1
      estFreq = 1
        icode = 4
    cleandata = 1
        ndata = 3 separate_trees
""",
    "tipdate_clock": """
      seqfile = s
     treefile = t
      outfile = out.txt
        clock = 1
      TipDate = 1 100
    CodonFreq = 6
    fix_kappa = 1
        kappa = 3
        ndata = 2 maintree 1
      runmode = -2
""",
}


@pytest.mark.parametrize("name", list(CTLS))
def test_codeml_spec_matches(name, tmp_path):
    from paml_tpu.io import ctl as jax_ctl
    from paml_tpu_torch.io import ctl
    path = tmp_path / "codeml.ctl"
    path.write_text(CTLS[name])
    opts = ctl.read_ctl(str(path))
    assert opts == jax_ctl.read_ctl(str(path))
    got = ctl.codeml_spec(opts, str(path))
    ref = jax_ctl.codeml_spec(jax_ctl.read_ctl(str(path)), str(path))
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(ref[0])
    assert got[1:] == ref[1:]
    assert ctl.resolve_path(str(path), "x/y") == jax_ctl.resolve_path(
        str(path), "x/y")


@pytest.mark.parametrize("line,what", [
    ("nonsense = 1", "not recognised"), ("NShmm = 1", "NShmm"),
    ("fix_rho = 0", "auto-discrete-gamma"), ("bootstrap = 100", "bootstrap")])
def test_codeml_spec_rejects(line, what, tmp_path):
    from paml_tpu_torch.io import ctl
    path = tmp_path / "codeml.ctl"
    path.write_text("seqfile = s\ntreefile = t\n" + line + "\n")
    with pytest.raises(ctl.CtlError, match=what):
        ctl.codeml_spec(ctl.read_ctl(str(path)), str(path))


ROWS = ["ATGCCCAAATTT---GGN", "ATGCCAAAGTTTCCCGGA", "ATGCCTAAATTCCCAGGC"]


@pytest.mark.parametrize("fmt", ["fasta", "nexus", "phylip"])
def test_alignment_readers_match(fmt, tmp_path):
    names = ["one", "two", "three"]
    if fmt == "fasta":
        text = "".join(f">{n} extra words\n{r[:9]}\n{r[9:]}\n"
                       for n, r in zip(names, ROWS))
    elif fmt == "nexus":
        text = ("#NEXUS\nbegin data;\n dimensions ntax=3 nchar=18;\n"
                " format datatype=dna gap=-;\n matrix\n"
                + "".join(f"  {n}  {r[:9]} [c] {r[9:]}\n"
                          for n, r in zip(names, ROWS)) + " ;\nend;\n")
    else:
        text = "3 18\n" + "".join(f"{n}  {r}\n" for n, r in zip(names, ROWS))
    path = tmp_path / "seq"
    path.write_text(text)
    aj = jax_seqio.read_alignment(str(path), jax_seqio.CODON_SEQ)
    at = seqio.read_alignment(str(path), seqio.CODON_SEQ)
    assert at.names == aj.names == names and at.rows == aj.rows == ROWS
    fields = [f.name for f in dataclasses.fields(seqio.PackedData)]
    assert_same_fields(seqio.pack(at), jax_seqio.pack(aj), fields)


def test_stacked_alignments_and_bad_files(tmp_path):
    path = tmp_path / "seq"
    path.write_text("".join(
        f"3 {n}\n" + "".join(f"t{i}  {r[:n]}\n" for i, r in enumerate(ROWS))
        + "\n" for n in (18, 12, 9)))
    for ndata in (None, 2):
        aj = jax_seqio.read_alignments(str(path), 1, ndata)
        at = seqio.read_alignments(str(path), 1, ndata)
        assert len(at) == len(aj) == (ndata or 3)
        for a, b in zip(at, aj):
            assert a.names == b.names and a.rows == b.rows
    path.write_text("not an alignment\n")
    with pytest.raises(ValueError, match="unrecognized"):
        seqio.read_alignment(str(path), 1)
    with pytest.raises(ValueError, match="no alignment headers"):
        seqio.read_alignments(str(path), 1)
    path.write_text(">a\nATG\n>b\nATGC\n")
    with pytest.raises(ValueError, match="not aligned"):
        seqio.read_alignment(str(path), 1)
    # a morphology block (refused until mcmctree was ported) reads as
    # the JAX package's reader reads it
    path.write_text("2 3 M\na 0.1 0.2 0.3\nb 0.3 0.2 0.1\n")
    mt, = seqio.read_alignments(str(path), 1)
    mj, = jax_seqio.read_alignments(str(path), 1)
    assert isinstance(mt, seqio.MorphAlignment) and mt.names == mj.names
    np.testing.assert_array_equal(mt.z, mj.z)


def test_tree_helpers_match(tmp_path):
    nwk = "((a:0.1,b:0.2) #1 :0.05,(c:0.3,d:0.1) '@0.4',e:0.7);"
    tj, tt = jax_treeio.parse_newick(nwk), treeio.parse_newick(nwk)
    for kw in (dict(), dict(branch_lengths=False), dict(labels=True,
                                                        ages=True, digits=3),
               dict(names=False)):
        names = list("abcde")
        jax_treeio._resolve_names(tj, names)
        treeio._resolve_names(tt, names)
        assert treeio.write_newick(tt, **kw) == jax_treeio.write_newick(
            tj, **kw)
    keep = ["a", "c", "d"]
    assert treeio.write_newick(treeio.prune_to(tt, keep)) == \
        jax_treeio.write_newick(jax_treeio.prune_to(tj, keep))
    with pytest.raises(ValueError, match="fewer than 2"):
        treeio.prune_to(tt, ["a"])
    path = tmp_path / "trees"
    path.write_text(" 5 2\n(a,b,(c,(d,e)));\n((a,b),c,\n (d,e));\n// end\n(x);")
    assert treeio.read_tree_strings(str(path)) == \
        jax_treeio.read_tree_strings(str(path))
    assert len(treeio.read_tree_strings(str(path))) == 2
    # TipDate: sampling dates at the end of the names
    for names, unit in ((["P03h1995", "x_2001.5", "y2010"], None),
                        (["a_2001-03-20", "b_2010-12-01"], 365.25)):
        got = treeio.parse_tip_dates(names, unit)
        ref = jax_treeio.parse_tip_dates(names, unit)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]
    with pytest.raises(ValueError, match="sampling date"):
        treeio.parse_tip_dates(["a1999", "b"])
    with pytest.raises(ValueError, match="same age"):
        treeio.parse_tip_dates(["a1999", "b1999"])


def test_side_outputs_match(tmp_path):
    from paml_tpu.io import outputs as jax_outputs
    from paml_tpu_torch.io import outputs
    rng = np.random.default_rng(8)
    fpatt = rng.integers(1, 5, size=7).astype(float)
    lnf = [-rng.uniform(2, 9, size=7) for _ in range(2)]
    post = rng.dirichlet(np.ones(3), size=7).T
    site_pattern = rng.integers(0, 7, size=12)
    for mod, d in ((outputs, tmp_path / "t"), (jax_outputs, tmp_path / "j")):
        d.mkdir()
        mod.write_lnf(str(d / "lnf"), 12, fpatt, lnf,
                      pattern_text=[f"p{h}" for h in range(7)])
        mod.write_lnf(str(d / "lnf1"), 12, fpatt, lnf[:1])
        with open(d / "rst", "w") as f:
            mod.write_rst_neb(f, site_pattern, post, [0.1, 1.0, 2.5], fpatt)
        mod.write_rst1(str(d / "rst1"), [-1234.5678912, 0.25, 3])
        mod.write_rst1(str(d / "rst1"), [1, -2.0], append=True)
    for name in ("lnf", "lnf1", "rst", "rst1"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text(), name
    ls, fp, got = outputs.read_lnf(str(tmp_path / "t" / "lnf1"))
    assert ls == 12
    np.testing.assert_array_equal(fp, fpatt)
    np.testing.assert_allclose(got[0], lnf[0], atol=1e-10)
    _, _, got2 = outputs.read_lnf(str(tmp_path / "t" / "lnf"))
    np.testing.assert_allclose(got2, np.stack(lnf), atol=1e-10)


def test_tree_comparison_matches():
    from paml_tpu.apps import bootstrap as jax_bootstrap
    from paml_tpu_torch.apps import bootstrap
    rng = np.random.default_rng(12)
    fpatt = rng.integers(1, 6, size=40).astype(float)
    site_lnf = -rng.uniform(2, 8, size=(3, 40))
    s, b = bootstrap.rell(site_lnf, fpatt, n_boot=500, seed=3)
    sj, bj = jax_bootstrap.rell(site_lnf, fpatt, n_boot=500, seed=3)
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_array_equal(b, bj)
    got = bootstrap.tree_comparison(site_lnf, fpatt, n_boot=500)
    ref = jax_bootstrap.tree_comparison(site_lnf, fpatt, n_boot=500)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("nwk,clock,dated", [
    ("(((a,b),c),(d,e));", 1, False),
    ("(((a,b) #1,c),(d #2,e));", 2, False),
    ("(((a,b),c) '@0.45',(d,e));", 1, False),
    ("(((a,b) #1,c),(d,e)) '@1.2';", 3, False),
    ("(((a,b),c),(d,e));", 1, True)])
def test_clock_times_match(nwk, clock, dated):
    import jax.numpy as jnp
    import torch
    from paml_tpu.core import clockparam as jax_clockparam
    from paml_tpu_torch.core import clockparam
    names = list("abcde")
    tj, tt = jax_treeio.parse_newick(nwk), treeio.parse_newick(nwk)
    jax_treeio._resolve_names(tj, names)
    treeio._resolve_names(tt, names)
    tip_ages = np.array([0.0, 0.1, 0.05, 0.3, 0.0]) if dated else None
    fj, nj, x0j, bj, ij = jax_clockparam.make_clock_times(
        jax_from_treenode(tj, names), clock, tip_ages)
    ft, nt, x0t, bt, it = clockparam.make_clock_times(
        from_treenode(tt, names), clock, tip_ages)
    assert (nt, x0t, bt) == (nj, x0j, bj)
    for key in ("absrate", "n_rate_cls", "fossil", "free_int",
                "root_fossil"):
        assert it[key] == ij[key], key
    np.testing.assert_array_equal(it["agelow"], ij["agelow"])
    rng = np.random.default_rng(clock)
    x = np.array([rng.uniform(max(lo, 0.3), min(hi, 0.9)) for lo, hi in bt])
    if dated:
        x[0] = 0.8                       # the root above the oldest tip
    xt = torch.tensor(x, requires_grad=True)
    t = ft(xt)
    np.testing.assert_allclose(t.detach().numpy(),
                               np.asarray(fj(jnp.asarray(x))), rtol=1e-14)
    w = np.arange(1.0, len(t) + 1)
    import jax
    gj = jax.grad(lambda v: (fj(v) * w).sum())(jnp.asarray(x))
    (g,) = torch.autograd.grad((t * torch.tensor(w)).sum(), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-12,
                               atol=1e-14)


def test_rub_trace(tmp_path):
    import torch
    from paml_tpu_torch.core import optim
    path = tmp_path / "rub"
    optim.set_rub(str(path))
    try:
        res = optim.maximize(lambda x: ((x - 1.5) ** 2).sum(),
                             np.zeros(2), [(-5.0, 5.0)] * 2, device="cpu")
    finally:
        optim.set_rub(None)
    lines = path.read_text().splitlines()
    assert len(lines) == res.n_eval and len(lines[0].split()) == 3
    np.testing.assert_allclose(res.x, 1.5, atol=1e-6)
    optim.maximize(lambda x: (x ** 2).sum(), np.ones(1), None, device="cpu")
    assert len(path.read_text().splitlines()) == res.n_eval


def test_sources_name_no_jax():
    # the port, its smoke run and its tools import neither JAX nor the JAX
    # package, in any function either
    import glob
    import re
    files = (glob.glob(os.path.join(REPO, "paml_tpu_torch", "**", "*.py"),
                       recursive=True)
             + glob.glob(os.path.join(REPO, "tools", "torch_*.py"))
             + [os.path.join(REPO, "chip_smoke.py")])
    assert len(files) >= 25
    bad = re.compile(r"^\s*(import|from)\s+(jax|paml_tpu)(\.|\s|$)", re.M)
    for path in files:
        assert not bad.search(open(path).read()), path
