"""paml_tpu_torch's mcmctree against paml_tpu's on the same inputs: the
calibration grammar and densities, the species tree, the time, rate and
locus-rate priors (1e-12 relative), `deroot`, the morphology reader, the
approximate, exact and morphological likelihoods (1e-10), in.BV reading
and writing, FigTree output and the posterior summaries.  Its inputs (a
6-species tree with calibrations, nucleotide loci from a seeded numpy
generator, control files) serve the other mcmctree tests too."""
import math

import numpy as np
import pytest
import torch

from paml_tpu.apps import mcmctree as J
from paml_tpu.core import topology as jax_topology
from paml_tpu.io import outputs as jax_outputs
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import mcmctree as T
from paml_tpu_torch.core import topology
from paml_tpu_torch.io import outputs, seqio, treeio

torch.set_num_threads(1)

NAMES = ["s1", "s2", "s3", "s4", "s5", "s6"]
# the root in B(0.9, 1.1), a soft interval and a lower bound inside
NWK = ("((((s1, s2) '>0.1', s3) 'B(0.2, 0.4)', (s4, s5)), s6) "
       "'B(0.9, 1.1)';")
# dated tips: the names carry their sampling years
TIPDATE_NAMES = ["a_2000", "b_1990", "c_2010", "d_1980", "e_2005",
                 "f_1995"]
TIPDATE_NWK = ("((((a_2000, b_1990), c_2010), (d_1980, e_2005)), f_1995) "
               "'B(0.9, 1.5)';")


def locus_rows(rng, names, ls, p_same=0.8):
    """Nucleotide rows related through a common ancestor: each site keeps
    the ancestor's base with probability p_same."""
    anc = rng.choice(list("TCAG"), ls)
    rows = []
    for _ in names:
        keep = rng.random(ls) < p_same
        rows.append("".join(np.where(keep, anc, rng.choice(list("TCAG"),
                                                           ls))))
    return rows


def phylip_block(names, rows):
    return f"{len(names)} {len(rows[0])}\n" + "".join(
        f"{n}  {r}\n" for n, r in zip(names, rows)) + "\n"


def seq_text(seed=1, names=NAMES, lengths=(300, 200), gaps=False):
    """Stacked PHYLIP blocks, one per locus; with `gaps` a few '-' and N."""
    rng = np.random.default_rng(seed)
    blocks = []
    for ls in lengths:
        rows = locus_rows(rng, names, ls)
        if gaps:
            rows = ["".join("-" if rng.random() < 0.03 else
                            "N" if rng.random() < 0.01 else c for c in r)
                    for r in rows]
        blocks.append(phylip_block(names, rows))
    return "".join(blocks)


def morph_text(seed=2, names=NAMES, ls=4, popvar=0.01, ldetRm=0.0):
    """A continuous-character locus ('ns ls M popvar ldetRm')."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(len(names), ls))
    return (f"{len(names)} {ls} M {popvar} {ldetRm}\n"
            + "".join(f"{n}  " + " ".join(f"{v:.6f}" for v in row) + "\n"
                      for n, row in zip(names, z)) + "\n")


MCMC_CTL = """         seed = {seed}
      seqfile = seq.txt
     treefile = tree.nwk
     mcmcfile = mcmc.txt
      outfile = out.txt
        ndata = {ndata}
      usedata = {usedata}
        clock = {clock}
        model = 4
        alpha = 0.5
        ncatG = 4
    cleandata = 0
      BDparas = 1 1 0.1
  kappa_gamma = 6 2
  alpha_gamma = 1 1
  rgene_gamma = 2 4 1
 sigma2_gamma = 1 10 1
        print = 1
       burnin = {burnin}
     sampfreq = {sampfreq}
      nsample = {nsample}
"""


def mcmc_ctl(ndata=2, usedata=1, clock=2, burnin=4, sampfreq=2, nsample=6,
             seed=7, **extra):
    return MCMC_CTL.format(seed=seed, ndata=ndata, usedata=usedata,
                           clock=clock, burnin=burnin, sampfreq=sampfreq,
                           nsample=nsample) + "".join(
        f"{k} = {v}\n" for k, v in extra.items())


CALS = [
    ("L", [0.1, 0.1, 1.0, 0.025]), ("U", [1.0, 0.025]),
    ("B", [0.06, 0.08, 0.025, 0.025]), ("G", [2.0, 20.0]),
    ("SN", [0.5, 0.1, 2.0]), ("ST", [0.5, 0.1, 2.0, 5.0]),
    ("S2N", [0.3, 1.0, 0.2, 2.0, 3.0, 0.5, -1.0])]


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("kind,p", CALS)
def test_calibration_densities_match(kind, p):
    for t in (0.01, 0.05, 0.07, 0.09, 0.3, 0.5, 1.0, 1.7, 4.0):
        assert T._ln_calibration_density(t, kind, p) == pytest.approx(
            J._ln_calibration_density(t, kind, p), rel=1e-12, abs=1e-300)
    rng_j, rng_t = (np.random.default_rng(3) for _ in range(2))
    a = J._sample_calibration_density(kind, p, 500, rng_j)
    b = T._sample_calibration_density(kind, p, 500, rng_t)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ann", [
    ">0.06", "<0.08", ">0.06<0.08", "B(0.1, 0.2)", "L{0.5, 0.2, 1, 0.01}",
    "U(1.2)", "G(2, 20)", "SN{0.5,0.1,2}", "ST(0.5, 0.1, 2, 5)",
    "S2N(0.3 1 0.2 2 3 0.5 -1)", "#1", "Q(1,2)", "@0.45", None])
def test_parse_calibration_matches(ann):
    assert treeio.parse_calibration(ann) == \
        jax_treeio.parse_calibration(ann)


def test_bds_kernel_matches():
    for lam, mu, rho in ((1.0, 1.0, 0.1), (2.0, 1.0, 0.3), (1.5, 0.2, 1.0)):
        p0 = J._p0t(math.exp((mu - lam) * 1.0), lam, mu, rho) \
            if abs(lam - mu) > 1e-20 else rho / (1 + rho * mu)
        vt1 = 0.7
        for t in (0.1, 0.5, 0.9):
            assert T._bds_cdf(t, 1.0, vt1, lam, mu, rho) == \
                J._bds_cdf(t, 1.0, vt1, lam, mu, rho)
            assert T._bds_pdf_ln(t, 1.0, vt1, lam, mu, rho) == \
                J._bds_pdf_ln(t, 1.0, vt1, lam, mu, rho)
        assert np.isfinite(p0)


def species_trees(nwk=NWK, names=NAMES, **kw):
    tj = J.build_species_tree(jax_treeio.parse_newick(nwk), names, **kw)
    tt = T.build_species_tree(treeio.parse_newick(nwk), names, **kw)
    return tj, tt


def check_species_tree(tj, tt):
    assert tt.calibrations == tj.calibrations
    assert tt.root_age_prior == tj.root_age_prior
    assert tt.mirror_of == tj.mirror_of and tt.bds == tj.bds
    for f in ("parent", "children", "postorder"):
        np.testing.assert_array_equal(getattr(tt.topo, f),
                                      np.asarray(getattr(tj.topo, f)))


def ages_for(st, rng):
    """Node ages in order (tips 0), the root near 1."""
    topo = st.topo
    ages = np.zeros(topo.nnode)
    for n in topo.postorder:
        kids = [c for c in topo.children[n] if c >= 0]
        ages[n] = max(ages[c] for c in kids) + rng.uniform(0.05, 0.3)
    return ages / ages[st.root] * rng.uniform(0.95, 1.05)


@pytest.mark.parametrize("kw", [
    dict(), dict(root_age="<1.2"), dict(multiplicative=True),
    dict(bds=(2.0, 1.0, 0.3), root_age="G(10, 10)")])
def test_prior_times_match(kw):
    tj, tt = species_trees(**kw)
    check_species_tree(tj, tt)
    rng = np.random.default_rng(5)
    for _ in range(5):
        ages = ages_for(tt, rng)
        v = T.ln_prior_times(tt, ages)
        assert np.isfinite(v)
        assert v == pytest.approx(J.ln_prior_times(tj, ages), rel=1e-12)


def test_prior_times_root_lower_bound_and_cross_bracing():
    nwk = "(((s1, s2) '>0.2', s3) 'L(0.8)', ((s4, s5), s6));"
    tj, tt = species_trees(nwk, root_age="<1.5")
    ages = ages_for(tt, np.random.default_rng(1))
    assert T.ln_prior_times(tt, ages) == pytest.approx(
        J.ln_prior_times(tj, ages), rel=1e-12)
    nwk = ("(((A1,A2) #2, A3) [#1], ((B1,B2) #2, B3) [#1 B{0.5,0.7}]) "
           "'B(0.9, 1.1)';")
    names = ["A1", "A2", "A3", "B1", "B2", "B3"]
    tj, tt = species_trees(nwk, names, duplication=True)
    check_species_tree(tj, tt)
    assert tt.mirror_of
    ages = ages_for(tt, np.random.default_rng(2))
    for mj, mi in tt.mirror_of.items():
        ages[mj] = ages[mi]
    assert T.ln_prior_times(tt, ages) == pytest.approx(
        J.ln_prior_times(tj, ages), rel=1e-12)


def test_prior_times_tipdate_and_fossil_errors():
    tj, tt = species_trees(TIPDATE_NWK, TIPDATE_NAMES)
    tips_j = jax_treeio.parse_tip_dates(TIPDATE_NAMES, None)[0]
    tips_t = T.parse_tip_dates(TIPDATE_NAMES, None)[0]
    np.testing.assert_array_equal(tips_t, tips_j)
    for st, psi in ((tj, 0.0), (tt, 0.0)):
        st.tip_ages = tips_j.copy()
    ages = ages_for(tt, np.random.default_rng(3)) + 0.3
    ages[:tt.ns] = tips_j
    for psi in (0.0, 0.5):
        tj.psi = tt.psi = psi
        assert T.ln_prior_times(tt, ages) == pytest.approx(
            J.ln_prior_times(tj, ages), rel=1e-12)
    # fossil errors: the mixture over used-fossil sets with its Monte
    # Carlo constants (the same generator and draws in both)
    tj, tt = species_trees()
    tj.pfossilerror = tt.pfossilerror = (2.0, 20.0, 1)
    ages = ages_for(tt, np.random.default_rng(4))
    for pE in (0.05, 0.3):
        assert T.ln_prior_times(tt, ages, pE) == pytest.approx(
            J.ln_prior_times(tj, ages, pE), rel=1e-12)


@pytest.mark.parametrize("clock", [1, 2, 3])
def test_prior_rates_match(clock):
    tj, tt = species_trees()
    rng = np.random.default_rng(clock)
    ages = ages_for(tt, rng)
    g = 3
    rates = rng.uniform(0.05, 0.5, (tt.topo.nnode, g))
    mu, s2 = rng.uniform(0.1, 0.4, g), rng.uniform(0.05, 0.3, g)
    a = T.ln_prior_rates_per_locus(tt, rates, mu, s2, ages, clock)
    b = J.ln_prior_rates_per_locus(tj, rates, mu, s2, ages, clock)
    np.testing.assert_allclose(a, b, rtol=1e-12)
    assert T.ln_prior_rates(tt, rates, mu, s2, ages, clock) == \
        pytest.approx(J.ln_prior_rates(tj, rates, mu, s2, ages, clock),
                      rel=1e-12)
    assert T.ln_prior_gamma_dirichlet(mu, (2, 20, 1)) == pytest.approx(
        J.ln_prior_gamma_dirichlet(mu, (2, 20, 1)), rel=1e-12)


def test_deroot_matches():
    for nwk in (NWK, "((a:0.1,b:0.2):0.3,(c:0.1,(d:0.2,e:0.1):0.4):0.2);",
                "(a:0.1,(b:0.2,c:0.3):0.1);"):
        tree_j, tree_t = jax_treeio.parse_newick(nwk), treeio.parse_newick(nwk)
        names = [n.name for n in tree_t.walk_pre() if not n.children]
        tj = jax_topology.from_treenode(tree_j, names)
        tt = topology.from_treenode(tree_t, names)
        assert topology.is_rooted(tt) == jax_topology.is_rooted(tj)
        uj, ut = jax_topology.deroot(tj), topology.deroot(tt)
        assert not topology.is_rooted(ut)
        ref = interop.topology_from(uj)
        for f in ("ns", "nnode", "root", "node_names"):
            assert getattr(ut, f) == getattr(ref, f), f
        for f in ("parent", "children", "postorder", "blen0", "labels",
                  "ages0"):
            np.testing.assert_array_equal(getattr(ut, f), getattr(ref, f))
        np.testing.assert_array_equal(ut.branch_nodes(), uj.branch_nodes())


def test_morphology_and_F73_match(tmp_path):
    path = tmp_path / "m.txt"
    path.write_text(seq_text(lengths=(50,)) + morph_text())
    aj = jax_seqio.read_alignments(str(path))
    at = seqio.read_alignments(str(path))
    assert isinstance(at[1], seqio.MorphAlignment)
    assert at[1].names == aj[1].names
    assert (at[1].popvar, at[1].ldetRm) == (aj[1].popvar, aj[1].ldetRm)
    np.testing.assert_array_equal(at[1].z, aj[1].z)
    tj, tt = species_trees()
    rng = np.random.default_rng(6)
    ages = ages_for(tt, rng)
    for popvar, ldetRm in ((0.0, 0.0), (0.05, -0.3)):
        b = J.gene_branch_lengths(tj, ages, np.array([0.3]), 1, 0)
        assert T.gene_branch_lengths(tt, ages, np.array([0.3]), 1, 0) == b
        v = T.lnL_morph_F73(tt.topo, b, at[1].z, popvar, ldetRm,
                            device="cpu")
        assert v == pytest.approx(J.lnL_morph_F73(
            tj.topo, b, aj[1].z, popvar, ldetRm), rel=1e-10)


def approx_loci(seed=0, transform="arcsin"):
    """A JAX ApproxLocus and its port on a random unrooted 6-taxon tree."""
    rng = np.random.default_rng(seed)
    nwk = "((s1:0.1,s2:0.2):0.05,(s3:0.3,s4:0.1):0.2,(s5:0.1,s6:0.2):0.1);"
    topo = jax_topology.from_treenode(jax_treeio.parse_newick(nwk), NAMES)
    nb = len(topo.branch_nodes())
    A = rng.normal(size=(nb, nb))
    H = -(A @ A.T + nb * np.eye(nb)) * 50
    bl = rng.uniform(1e-6, 0.3, nb)
    bl[0] = 2e-6                          # one branch at the log floor
    g = rng.normal(size=nb)
    lj = J.ApproxLocus(names=NAMES, topo=topo, bl=bl.copy(), gradient=g,
                       hessian=H, transform=transform)
    lt = interop.approx_locus_from(lj)
    return lj, lt


@pytest.mark.parametrize("transform", ["none", "sqrt", "log", "arcsin"])
def test_approx_lnL_matches(transform):
    lj, lt = approx_loci(transform=transform)
    lj.transform_gh()
    lt.transform_gh()
    for f in ("bl", "gradient", "hessian"):
        np.testing.assert_allclose(getattr(lt, f), getattr(lj, f),
                                   rtol=1e-12, atol=1e-12)
    rng = np.random.default_rng(1)
    for _ in range(4):
        b = rng.uniform(1e-4, 0.4, len(lj.bl))
        assert T.approx_lnL(lt, b, device="cpu") == pytest.approx(
            J.approx_lnL(lj, b), rel=1e-10)


def test_approx_batch_pads_loci():
    """Loci of different branch counts and transforms as one padded
    product: each row equals its locus alone."""
    loci = [approx_loci(0, "arcsin")[1], approx_loci(1, "log")[1]]
    small = approx_loci(2, "sqrt")[1]
    keep = [0, 1, 2]
    small.bl, small.gradient = small.bl[keep], small.gradient[keep]
    small.hessian = small.hessian[np.ix_(keep, keep)]
    loci.append(small)
    for l in loci:
        l.transform_gh()
    ab = T.ApproxBatch(loci, device="cpu")
    rng = np.random.default_rng(3)
    bu = rng.uniform(1e-3, 0.3, (3, ab.nbmax))
    got = ab.lnL(torch.as_tensor(bu)).numpy()
    want = [T.approx_lnL(l, bu[i, :len(l.bl)], device="cpu")
            for i, l in enumerate(loci)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_exact_lnL_matches(tmp_path, alpha):
    """usedata = 1: every locus's exact likelihood, batched and looped,
    against the JAX chain's per-locus and vmapped likelihoods."""
    text = seq_text(lengths=(120, 80, 60), gaps=True)
    tj, tt = species_trees()
    path = tmp_path / "seq.txt"
    path.write_text(text)
    loci_j = [jax_seqio.pack(a, cleandata=False)
              for a in jax_seqio.read_alignments(str(path), 0, 3)]
    loci_t = [interop.packed_from(d) for d in loci_j]
    kw = dict(clock=2, usedata=1, alpha=alpha, ncatG=4, seed=3)
    mj = J.MCMCTree(tj, loci_j, J.McmcSpec(**kw))
    mt = T.MCMCTree(tt, loci_t, T.McmcSpec(**kw), device="cpu")
    np.testing.assert_array_equal(mt.ages, mj.ages)
    np.testing.assert_array_equal(mt.rates, mj.rates)
    rng = np.random.default_rng(8)
    for _ in range(2):
        mj.kappa = mt.kappa = rng.uniform(1, 8, 3)
        mj.alpha_g = mt.alpha_g = rng.uniform(0.2, 2, 3)
        want = mj.lnL_all()
        np.testing.assert_allclose(mt.lnL_all(), want, rtol=1e-10)
        b = mt._branch_lengths_all()
        for route in ("batched", "loop"):
            np.testing.assert_allclose(
                mt._exact.lnl(b, mt.kappa, mt.alpha_g, route=route), want,
                rtol=1e-10)
        for i in range(3):
            assert mt.lnL_locus(i) == pytest.approx(mj.lnL_locus(i),
                                                    rel=1e-10)


def test_BV_file_round_trip(tmp_path):
    """The port writes in.BV in the reference's branch order, which both
    readers take back to the MLEs, gradient and Hessian of `generate_BV`;
    the layout the JAX package writes fails its own reader's check."""
    (tmp_path / "seq.txt").write_text(seq_text(lengths=(150, 120)))
    alns = seqio.read_alignments(str(tmp_path / "seq.txt"), 0, 2)
    tree = treeio.parse_newick(NWK)
    per = T.generate_BV(alns, tree, NAMES, ncatG=1, alpha0=0.0,
                        outfile=str(tmp_path / "out.BV"), device="cpu")
    for reader in (T.read_BV, J.read_BV):
        loci = reader(str(tmp_path / "out.BV"), 2, transform="none")
        for (data, utopo, bl, g, H), l in zip(per, loci):
            np.testing.assert_array_equal(l.topo.branch_nodes(),
                                          utopo.branch_nodes())
            np.testing.assert_allclose(l.bl, bl, atol=6e-7)
            np.testing.assert_allclose(l.gradient, g, atol=6e-7)
            np.testing.assert_allclose(l.hessian, H, atol=6e-5)
    # the JAX package's generate_BV writes the vectors in branch_nodes
    # order (paml_tpu/apps/mcmctree.py:931-938), which its reader refuses
    data, utopo, bl, g, H = per[0]
    nwk = T._tree_with_blens(utopo, dict(zip(utopo.branch_nodes().tolist(),
                                             bl.tolist())))
    (tmp_path / "jax.BV").write_text(
        f"\n{data.ns}\n\n{nwk}\n\n" + " ".join(f"{v:.6f}" for v in bl)
        + "\n\n" + " ".join(f"{v:.6f}" for v in g) + "\n\nHessian\n\n"
        + "".join(" ".join(f"{v:.4f}" for v in row) + "\n" for row in H))
    with pytest.raises(ValueError, match="does not match"):
        J.read_BV(str(tmp_path / "jax.BV"), 1)


def test_figtree_and_summaries_match(tmp_path):
    tj, tt = species_trees()
    rng = np.random.default_rng(9)
    ages = ages_for(tt, rng)
    lo, hi = ages * 0.9, ages * 1.1
    names = [NAMES[i] if i < tt.ns else "" for i in range(tt.topo.nnode)]
    a = outputs.figtree_newick(tt.topo.parent, tt.topo.children,
                               tt.topo.root, names, ages, lo, hi)
    b = jax_outputs.figtree_newick(tj.topo.parent, tj.topo.children,
                                   tj.topo.root, names, ages, lo, hi)
    assert a == b
    outputs.write_figtree(str(tmp_path / "t.tre"), a, timeunit=2.5)
    jax_outputs.write_figtree(str(tmp_path / "j.tre"), b, timeunit=2.5)
    assert (tmp_path / "t.tre").read_text() == \
        (tmp_path / "j.tre").read_text()
    x = np.cumsum(rng.normal(size=400))
    assert T.hpd_interval(x) == J.hpd_interval(x)
    assert T.ess(x) == J.ess(x)
    samples = [dict(lnL=float(v), t=float(w)) for v, w in
               zip(x, rng.normal(size=400))]
    assert T.summarize(samples) == J.summarize(samples)
