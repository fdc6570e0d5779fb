"""paml_tpu_torch evolver against paml_tpu on the CPU.

- Each .dat form (nucleotides REV + G4, amino acids WAG + G4, codons M0,
  per-branch omegas, NSsites, branch-site) is parsed and its model built
  by both packages: P, the root frequencies, the class weights and the
  branch lengths agree to 1e-12.  The JAX side is read from the
  arguments its sampler is handed (`simulate_states` monkeypatched, its
  `jax.jit` skipped so that they stay concrete); nothing in `paml_tpu`
  changes.
- The sampler (`core/simulate`) by distribution: chi-square bounds on the
  root states, the site classes and the parent -> child transitions of
  every branch at 4000 sites; the same seed repeats bit for bit, and the
  replicates do not depend on the chunking.
- Simulate -> refit with the port's own fits, as tests/test_evolver.py
  does, with the JAX package's reader on the port's mc.paml.
- Mode 11 (label clades) writes the JAX program's evolver.out; modes 1-4,
  8 and 9 raise naming ROADMAP A14.

Every test runs in its own directory (an autouse fixture's
`monkeypatch.chdir(tmp_path)`): the codon simulator writes siterates.txt
and ancestral.txt where it runs."""
import types

import numpy as np
import pytest
import torch
from scipy.stats import chi2

import jax
import jax.numpy as jnp

from paml_tpu.apps import evolver as jax_evolver
from paml_tpu.io import seqio as jax_seqio
from paml_tpu_torch.apps import baseml, codeml, evolver
from paml_tpu_torch.core import simulate
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io.treeio import parse_newick
from paml_tpu_torch.models import nuc

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def in_tmp_path(tmp_path, monkeypatch):
    """Every test in a directory of its own."""
    monkeypatch.chdir(tmp_path)


TREE = "((a: 0.1, b: 0.2): 0.12, c: 0.3, d: 0.4);"
LABELLED = ("((a #0.1: 0.1, b #0.2: 0.2) #0.5: 0.12, c #0.3: 0.3, "
            "d #2.5: 0.4);")


def freq_lines(k, seed, per_line=4):
    f = np.random.default_rng(seed).dirichlet(np.full(k, 5.0))
    return "\n".join(" ".join(f"{v:.8f}" for v in f[i:i + per_line])
                     for i in range(0, k, per_line))


def codon_dat(body, tree=TREE, tail="", ncod=500, nrepl=1):
    return (f"0\n13147\n4 {ncod} {nrepl}\n-1\n{tree}\n{body}\n4.0\n"
            f"{freq_lines(64, 5)}\n0\n{tail}")


def label_tree(w):
    return (f"((a #{w[0]}, b #{w[1]}) #{w[2]}, c #{w[3]}, d #{w[4]});")


DATS = {
    "nuc": (f"0\n123\n4 1000 1\n-1\n{TREE}\n7\n1.5 0.4 0.6 0.3 0.8\n"
            f"0.5 4\n0.2 0.3 0.35 0.15\n"),
    "aa": (f"0\n77\n4 1000 1\n-1\n{TREE}\n0.5 4\n2 wag.dat\n"
           f"{freq_lines(20, 6, 10)}\n"),
    "codon_M0": codon_dat("0.3"),
    "codon_branch": codon_dat("", tree=LABELLED),
    "codon_sites": codon_dat("3\n0.6 0.3 0.1\n0.1 1 3"),
    "codon_branchsite": codon_dat(
        "4\n0.4 0.3 0.2 0.1",
        tail="\n".join(label_tree(w) for w in (
            [0.1] * 5, [1.0] * 5, [0.1, 3.0, 0.1, 0.1, 0.1],
            [1.0, 3.0, 1.0, 1.0, 1.0])) + "\n"),
}
JAX_SIM = {"nuc": "simulate_nuc", "aa": "simulate_aa"}


def jax_model(monkeypatch, dat):
    """The arguments the JAX evolver hands its sampler."""
    rec = {}

    def fake(key, topo, P, pi, ls, w=None):
        rec.update(topo=topo, P=np.asarray(P), pi=np.asarray(pi),
                   w=None if w is None else np.asarray(w))
        return (jnp.zeros((topo.nnode, ls), jnp.int32),
                jnp.zeros((ls,), jnp.int32))

    monkeypatch.setattr(jax_evolver, "simulate_states", fake)
    monkeypatch.setattr(jax_evolver, "jax", types.SimpleNamespace(
        jit=lambda f: f, vmap=jax.vmap, random=jax.random))
    return rec


@pytest.mark.parametrize("form", list(DATS))
def test_model_matches_jax(form, tmp_path, monkeypatch):
    (tmp_path / "mc.dat").write_text(DATS[form])
    kind = form.split("_")[0]
    rec = jax_model(monkeypatch, str(tmp_path / "mc.dat"))
    getattr(jax_evolver, JAX_SIM.get(kind, "simulate_codon"))(
        "mc.dat", "jax.paml")
    m = evolver.PREPARE[{"nuc": "5", "codon": "6", "aa": "7"}[kind]](
        "mc.dat", device="cpu")
    assert m.kind == kind and m.P.shape == rec["P"].shape
    np.testing.assert_allclose(m.P.numpy(), rec["P"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.pi.numpy(), rec["pi"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.class_probs.numpy(), rec["w"], rtol=0,
                               atol=1e-12)
    _, _, blens = jax_evolver._prepare_tree(TREE if form != "codon_branch"
                                            else LABELLED, 4, -1)
    np.testing.assert_allclose(m.blens, blens, rtol=0, atol=1e-12)
    for f in ("parent", "children", "root", "ns"):
        np.testing.assert_array_equal(getattr(m.topo, f),
                                      getattr(rec["topo"], f))
    if form == "codon_sites":
        assert m.P.shape[1] == 3


def chi2_ok(obs, exp, ddof=1):
    """Pearson's statistic below its 0.999 quantile (cells with an
    expectation under 5 pooled away)."""
    keep = exp >= 5
    stat = float((((obs - exp) ** 2) / np.where(keep, exp, 1))[keep].sum())
    return stat < chi2.ppf(0.999, max(int(keep.sum()) - ddof, 1)), stat


def sampler_problem():
    tree = parse_newick("((a: 0.2, b: 0.5): 0.3, c: 0.8, (d: 0.1, e: 1.2): "
                        "0.4);")
    topo = from_treenode(tree, list("abcde"))
    def f64(v):
        return torch.tensor(v, dtype=torch.float64)

    pi = f64([0.1, 0.2, 0.3, 0.4])
    ts = torch.as_tensor(topo.blen0)[:, None] * f64([0.3, 2.0])
    P, _ = nuc.pmats_for_model("HKY85", f64([4.0]), pi, ts)
    return topo, P, pi, f64([0.7, 0.3])


def test_sampler_distribution():
    topo, P, pi, w = sampler_problem()
    ls = 4000
    states, cls = simulate.simulate_states(topo, P, pi, ls, 1, w, seed=9,
                                           device="cpu")
    states, cls = states[0].numpy().astype(int), cls[0].numpy().astype(int)
    ok, stat = chi2_ok(np.bincount(cls, minlength=2), w.numpy() * ls)
    assert ok, stat
    ok, stat = chi2_ok(np.bincount(states[topo.root], minlength=4),
                       pi.numpy() * ls)
    assert ok, stat
    for node in range(topo.nnode):
        if node == topo.root:
            continue
        par = topo.parent[node]
        for c in range(2):
            sel = cls == c
            obs = np.zeros((4, 4))
            np.add.at(obs, (states[par][sel], states[node][sel]), 1)
            exp = obs.sum(1, keepdims=True) * P[node, c].numpy()
            ok, stat = chi2_ok(obs.ravel(), exp.ravel(), ddof=4)
            assert ok, (node, c, stat)


def test_sampler_repeats_and_chunks():
    topo, P, pi, w = sampler_problem()
    a = simulate.simulate_states(topo, P, pi, 300, 5, w, seed=3,
                                 device="cpu")
    b = simulate.simulate_states(topo, P, pi, 300, 5, w, seed=3,
                                 device="cpu")
    parts = list(simulate.simulate_chunks(topo, P, pi, 300, 5, w, seed=3,
                                          device="cpu", chunk=2))
    assert [p[0] for p in parts] == [0, 2, 4]
    c = torch.cat([p[1] for p in parts])
    assert a[0].dtype == torch.int16 and a[0].shape == (5, topo.nnode, 300)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0], c)
    other = simulate.simulate_states(topo, P, pi, 300, 5, w, seed=4,
                                     device="cpu")
    assert not torch.equal(a[0], other[0])


REFIT_TREE = "((a: 0.1, b: 0.2): 0.12, c: 0.3, d: 0.4);"


def test_nuc_simulate_refit(tmp_path):
    (tmp_path / "mc.dat").write_text(
        f"0\n123\n4 20000 1\n-1\n{REFIT_TREE}\n4\n5.0\n0 0\n"
        f"0.2 0.3 0.35 0.15\n")
    evolver.simulate_nuc("mc.dat", "mc.paml", seed=7, device="cpu")
    aln = jax_seqio.read_alignment("mc.paml", jax_seqio.BASE_SEQ)
    assert aln.ns == 4 and aln.ls == 20000
    (tmp_path / "t.trees").write_text(REFIT_TREE + "\n")
    res = baseml.fit("mc.paml", "t.trees", baseml.BasemlSpec(model="HKY85"),
                     device="cpu")
    kappa = float(np.ravel(res.rate_params)[0])
    assert abs(kappa - 5.0) < 0.5, kappa
    assert abs(res.blens.sum() - 1.12) < 0.08, res.blens.sum()


def test_codon_simulate_refit(tmp_path):
    freqs = "\n".join(" ".join(["0.015625"] * 4) for _ in range(16))
    (tmp_path / "mc.dat").write_text(
        f"0\n13147\n4 3000 1\n-1\n{REFIT_TREE}\n0.3\n4.0\n{freqs}\n0\n")
    evolver.simulate_codon("mc.dat", "mc.paml", seed=11, device="cpu")
    aln = jax_seqio.read_alignment("mc.paml", jax_seqio.CODON_SEQ)
    assert aln.ns == 4 and aln.ls == 9000
    for name in ("ancestral.txt", "siterates.txt"):
        assert (tmp_path / name).exists()
    (tmp_path / "t.trees").write_text(REFIT_TREE + "\n")
    res = codeml.fit("mc.paml", "t.trees",
                     codeml.CodemlSpec(codonf="Fequal", cleandata=True),
                     device="cpu")
    kappa = float(res.kappa[0])
    omega = float(res.params["W"][0, 0])
    assert abs(kappa - 4.0) < 0.6, kappa
    assert abs(omega - 0.3) < 0.06, omega


def test_aa_simulate_refit(tmp_path):
    pi_line = " ".join(["0.05"] * 20)
    (tmp_path / "mc.dat").write_text(
        f"0\n13147\n4 5000 1\n-1\n{REFIT_TREE}\n0 0\n0\n{pi_line}\n")
    evolver.simulate_aa("mc.dat", "mc.paml", seed=3, device="cpu")
    aln = jax_seqio.read_alignment("mc.paml", jax_seqio.AA_SEQ)
    assert aln.ns == 4 and aln.ls == 5000
    (tmp_path / "t.trees").write_text(REFIT_TREE + "\n")
    res = codeml.fit("mc.paml", "t.trees",
                     codeml.CodemlSpec(seqtype=2, aa_model="Poisson"),
                     device="cpu")
    assert abs(res.blens.sum() - 1.12) < 0.08, res.blens.sum()


def test_codon_files(tmp_path):
    """Site classes and ancestors as the JAX program writes them, NEXUS
    with outfmt 2, read back by the JAX package's reader."""
    (tmp_path / "mc.dat").write_text(
        "2" + DATS["codon_sites"].replace("4 500 1", "4 200 3")[1:])
    res = evolver.main(["6", "mc.dat"], device="cpu")
    assert res["path"] == "mc.nex" and res["nrepl"] == 3
    aln = jax_seqio.read_alignment("mc.nex", jax_seqio.CODON_SEQ)
    assert aln.ns == 4 and aln.ls == 600
    sid = (tmp_path / "siterates.txt").read_text().split("\nreplicate ")
    assert len(sid) == 4
    classes = np.array(sid[1].split("\n", 1)[1].split(), dtype=int)
    assert len(classes) == 200 and set(classes) <= {1, 2, 3}
    anc = (tmp_path / "ancestral.txt").read_text()
    assert anc.count("\nreplicate ") == 3 and anc.count("node5 ") == 3


def test_label_clades_matches_jax(tmp_path):
    (tmp_path / "t.tree").write_text(
        "((HumanX1,HumanX2),(ChimpY1,ChimpY2),Gorilla);\n")
    jax_evolver.label_clades_cli("t.tree", ["HumanX", "ChimpY", "Gorilla"])
    want = (tmp_path / "evolver.out").read_text()
    (tmp_path / "evolver.out").unlink()
    evolver.main(["11", "t.tree", "HumanX", "ChimpY", "Gorilla"],
                 device="cpu")
    got = (tmp_path / "evolver.out").read_text()
    assert got == want and "#3" in got


@pytest.mark.parametrize("mode", ["1", "2", "3", "4", "8", "9"])
def test_tree_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        evolver.main([mode, "5"], device="cpu")
