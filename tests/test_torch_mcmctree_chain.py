"""paml_tpu_torch's mcmctree chain against paml_tpu's, draw for draw: the
same seed, the same start and the same order of numpy draws, so the
samples agree to 1e-9 relative (a flipped accept decision would show as a
jump).  usedata 0 (the prior) and 1 (exact likelihood, also with a
morphological locus) at clock 1, 2 and 3, TipDate, fossil errors, and a
resumed chain against an uninterrupted one."""
import numpy as np
import pytest
import torch

import test_torch_mcmctree as td
from paml_tpu.apps import mcmctree as J
from paml_tpu.apps import mcmcutils as jax_mcmcutils
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import mcmctree as T
from paml_tpu_torch.apps import mcmcutils
from paml_tpu_torch.io import treeio

torch.set_num_threads(1)


def table(samples):
    keys = list(samples[0])
    return keys, np.array([[s[k] for k in keys] for s in samples])


def assert_same_samples(sj, st):
    kj, a = table(sj)
    kt, b = table(st)
    assert kt == kj and a.shape == b.shape and len(a) > 0
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=0)


def loci_for(tmp_path, usedata, morph=False, names=td.NAMES):
    """(JAX loci, port loci): packed sequence loci (and a morphological
    one), or None per locus for usedata 0."""
    if usedata == 0:
        return [None, None], [None, None]
    path = tmp_path / "seq.txt"
    path.write_text(td.seq_text(names=names, lengths=(120, 90))
                    + (td.morph_text(names=names) if morph else ""))
    lj, lt = [], []
    for a in jax_seqio.read_alignments(str(path), 0, 3 if morph else 2):
        if isinstance(a, jax_seqio.MorphAlignment):
            lj.append(J.MorphLocus(names=a.names, z=a.z, popvar=a.popvar,
                                   ldetRm=a.ldetRm))
            lt.append(T.MorphLocus(names=list(a.names), z=np.array(a.z),
                                   popvar=a.popvar, ldetRm=a.ldetRm))
        else:
            d = jax_seqio.pack(a, cleandata=False)
            lj.append(d)
            lt.append(interop.packed_from(d))
    return lj, lt


def chains(tmp_path, usedata, clock, nwk=td.NWK, names=td.NAMES,
           morph=False, tweak=None, **kw):
    sj = J.build_species_tree(jax_treeio.parse_newick(nwk), names)
    st = T.build_species_tree(treeio.parse_newick(nwk), names)
    if tweak:
        tweak(sj)
        tweak(st)
    lj, lt = loci_for(tmp_path, usedata, morph, names)
    # a burn-in under 4 iterations adapts no step length: on loci this
    # short an adapted step sends alpha to e^99, where the JAX package's
    # gamma quantiles stall
    spec = dict(clock=clock, usedata=usedata, alpha=0.5, ncatG=4, seed=11,
                burnin=3, sampfreq=2, nsample=10, **kw)
    mj = J.MCMCTree(sj, lj, J.McmcSpec(**spec))
    mt = T.MCMCTree(st, lt, T.McmcSpec(**spec), device="cpu")
    return mj, mt


@pytest.mark.parametrize("usedata", [0, 1])
@pytest.mark.parametrize("clock", [1, 2, 3])
def test_chain_matches_jax(tmp_path, usedata, clock):
    mj, mt = chains(tmp_path, usedata, clock)
    assert_same_samples(mj.run(), mt.run())
    for k in mj.acceptance:
        np.testing.assert_array_equal(mt.acceptance[k], mj.acceptance[k])


def test_chain_with_a_morphological_locus(tmp_path):
    mj, mt = chains(tmp_path, 1, 2, morph=True)
    assert isinstance(mt.loci[2], T.MorphLocus)
    assert_same_samples(mj.run(), mt.run())


def test_chain_tipdate(tmp_path):
    tips = jax_treeio.parse_tip_dates(td.TIPDATE_NAMES, None)[0]

    def tweak(st):
        st.tip_ages = tips.copy()
        st.psi = 0.2
    mj, mt = chains(tmp_path, 1, 1, td.TIPDATE_NWK, td.TIPDATE_NAMES,
                    tweak=tweak, transform="sqrt")
    assert_same_samples(mj.run(), mt.run())


def test_chain_fossil_errors(tmp_path):
    def tweak(st):
        st.pfossilerror = (2.0, 20.0, 1)
    mj, mt = chains(tmp_path, 0, 2, tweak=tweak)
    sj, s_t = mj.run(), mt.run()
    assert "Pfossilerr" in s_t[0]
    assert_same_samples(sj, s_t)


def test_resumed_chain_continues(tmp_path):
    """A chain saved after its burn-in and n1 samples, then resumed for n2
    more (burn-in 0), gives the samples an uninterrupted chain of n1 + n2
    samples gives after its first n1; and the JAX package resumes its own
    checkpoint of the same state to the same samples."""
    def make(nsample, burnin, pkg, spec_cls, dev):
        sj = pkg.build_species_tree((jax_treeio if pkg is J else treeio)
                                    .parse_newick(td.NWK), td.NAMES)
        spec = spec_cls(clock=2, usedata=0, seed=5, burnin=burnin,
                        sampfreq=2, nsample=nsample)
        return (pkg.MCMCTree(sj, [None, None], spec) if dev is None else
                pkg.MCMCTree(sj, [None, None], spec, device=dev))
    full = make(10, 8, T, T.McmcSpec, "cpu").run()
    first = make(4, 8, T, T.McmcSpec, "cpu")
    s1 = first.run()
    mcmcutils.save_state(first, str(tmp_path / "c.ckpt"), it=len(s1))
    second = make(6, 0, T, T.McmcSpec, "cpu")
    assert mcmcutils.load_state(second, str(tmp_path / "c.ckpt")) == 4
    s2 = second.run()
    assert_same_samples(full[:4], s1)
    assert_same_samples(full[4:], s2)
    jax_second = make(6, 0, J, J.McmcSpec, None)
    jax_mcmcutils.load_state(jax_second, str(tmp_path / "c.ckpt"))
    assert_same_samples(jax_second.run(), s2)
