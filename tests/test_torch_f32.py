"""paml_tpu_torch's float32 path against paml_tpu's on the CPU: P(t) by
uniformization (`pmat_rev_multi`, `pmat_rev`) at 61 states with
zero-frequency codons, t = 0 and branches that need squarings, P to 2e-6
and a vector-Jacobian product to 3e-5 of its largest component; the
float32 objectives (codon M2a on the entry's synthetic problem and M0 on
clock56.codon, baseml HKY85 + G5 and REV on clock56.nuc, LG + F + G4 on
clock56 translated), values to 5e-6 relative and gradients to 3e-5 of
the largest component (the JAX package's own float32 tolerances,
tests/test_f32_parity.py and tests/test_pallas_pruning.py); the float32
`fit_packed` under M0 against the JAX package's float32 fit (lnL to 2e-4,
estimates to 2e-3) and the port's float64 fit; baseml's
float32 fit with getSE (REV, HKY85 on clock56.nuc unrooted): the Hessian
against `jax.hessian` of the JAX package's float32 objective and the SEs
from it, to 3e-5; and `entry(dtype=torch.float32)` against
`__graft_entry__.entry()`."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jax_entry
from paml_tpu.apps import baseml as jax_baseml
from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core import pmat as jax_pmat
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import entry, interop
from paml_tpu_torch.apps import baseml, codeml
from paml_tpu_torch.core import pmat

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
P_TOL, VAL_RTOL, GRAD_RTOL = 2e-6, 5e-6, 3e-5


def codon_Qs(rng, n=61, G=3, n_zero=2):
    """G reversible rate matrices sharing pi, n_zero states of pi 0."""
    pi = rng.dirichlet(np.ones(n))
    pi[rng.choice(n, n_zero, replace=False)] = 0.0
    pi /= pi.sum()
    Qs = []
    for _ in range(G):
        S = rng.gamma(1.0, 1.0, (n, n))
        S = (S + S.T) / 2
        np.fill_diagonal(S, 0.0)
        Q = S * pi[None, :]
        np.fill_diagonal(Q, -Q.sum(1))
        Qs.append(Q / -(pi * np.diag(Q)).sum())
    return np.stack(Qs), pi


def test_pmat_float32_matches_jax():
    rng = np.random.default_rng(0)
    Qs, pi = codon_Qs(rng)
    ts = rng.uniform(0.0, 0.5, (7, 3))
    ts[0] = 0.0
    ts[1] = [3.0, 10.0, 60.0]          # q t past 5: one to six squarings
    f32 = [np.asarray(a, np.float32) for a in (Qs, pi, ts)]
    Pj = np.asarray(jax_pmat.pmat_rev_multi(*map(jnp.asarray, f32)))
    Q_t, pi_t, t_t = (torch.tensor(a, requires_grad=True) for a in f32)
    P = pmat.pmat_rev_multi(Q_t, pi_t, t_t)
    assert P.dtype == torch.float32 and P.shape == Pj.shape
    np.testing.assert_allclose(P.detach().numpy(), Pj, rtol=0, atol=P_TOL)
    # dropped states: identity rows; t = 0: the identity
    zero = np.flatnonzero(pi == 0)
    np.testing.assert_array_equal(P[:, :, zero, zero].detach().numpy(), 1.0)
    np.testing.assert_array_equal(P[0].detach().numpy(),
                                  np.broadcast_to(np.eye(61), (3, 61, 61)))
    # a VJP with a seeded cotangent, in Q and t (pi enters by its mask)
    ct = rng.normal(size=Pj.shape).astype(np.float32)
    gj = jax.grad(lambda Q, t: jnp.sum(jax_pmat.pmat_rev_multi(
        Q, jnp.asarray(f32[1]), t) * ct), argnums=(0, 1))(
            jnp.asarray(f32[0]), jnp.asarray(f32[2]))
    g = torch.autograd.grad((P * torch.tensor(ct)).sum(), (Q_t, t_t))
    for got, want in zip(g, gj):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())
    # one Q (baseml's REV and pairwise P(t)), 4 and 61 states
    for n in (4, 61):
        Q1, pi1 = codon_Qs(rng, n=n, G=1, n_zero=0)
        t1 = np.array([0.0, 0.05, 0.7, 40.0], np.float32)
        args = (np.asarray(Q1[0], np.float32), np.asarray(pi1, np.float32))
        Pj1 = np.asarray(jax_pmat.pmat_rev(*map(jnp.asarray, args),
                                           jnp.asarray(t1)))
        P1 = pmat.pmat_rev(*map(torch.tensor, args), torch.tensor(t1))
        assert P1.dtype == torch.float32
        np.testing.assert_allclose(P1.numpy(), Pj1, rtol=0, atol=P_TOL)


def test_pmat_float32_products_ignore_tf32():
    """The products run with TF32 off whatever the caller set, and the flag
    is the caller's again afterwards."""
    Qs, pi = codon_Qs(np.random.default_rng(1), G=1)
    args = [torch.tensor(a, dtype=torch.float32)
            for a in (Qs, pi[None], np.array([[0.3], [30.0]]))]
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    try:
        m.allow_tf32 = True
        P_on = pmat.pmat_rev_multi(*args)
        assert m.allow_tf32
    finally:
        m.allow_tf32 = old
    torch.testing.assert_close(P_on, pmat.pmat_rev_multi(*args), rtol=0,
                               atol=0)


def assert_float32_match(neg_j, neg, xs):
    vg_j = jax.jit(jax.value_and_grad(neg_j))
    for x in xs:
        vj, gj = vg_j(jnp.asarray(x))
        xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        assert v.dtype == torch.float32
        assert abs(float(v) - float(vj)) <= VAL_RTOL * abs(float(vj))
        gj = np.asarray(gj, np.float64)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=GRAD_RTOL * np.abs(gj).max())


def clock56(kind):
    seqtype = {"codon": jax_seqio.CODON_SEQ, "nuc": jax_seqio.BASE_SEQ,
               "aa": jax_seqio.CODON2AA_SEQ}[kind]
    aln = jax_seqio.read_alignment(
        os.path.join(DATA, "clock56.nuc" if kind == "nuc"
                     else "clock56.codon"), seqtype)
    data = jax_seqio.pack(aln)
    trees = jax_treeio.read_trees(os.path.join(DATA, "clock56.trees"),
                                  data.names)
    return data, jax_from_treenode(trees[0], data.names)


def random_x(bounds, nb, rng):
    return np.array([rng.uniform(0.01, 0.5) if i < nb else
                     rng.uniform(max(lo, 1e-2), min(hi, 3.0))
                     for i, (lo, hi) in enumerate(bounds)])


def test_codon_objective_float32_matches_jax():
    """M2a on the entry's synthetic problem (random codons, dense tips) and
    M0 on clock56.codon (state codes)."""
    neg_j, x0_j, _, _ = jax_entry._synthetic_codon_problem(dtype=jnp.float32)
    neg, x0, _, _ = entry._synthetic_codon_problem(device="cpu",
                                                   dtype=torch.float32)
    np.testing.assert_allclose(x0, x0_j, rtol=1e-6)
    assert_float32_match(neg_j, neg, [x0])
    data_j, topo_j = clock56("codon")
    spec_j, spec = jax_codeml.CodemlSpec(), codeml.CodemlSpec()
    neg_j, _, _, x0, bounds, _ = jax_codeml.make_codon_objective(
        data_j, topo_j, spec_j, jnp.float32)
    neg = codeml.make_codon_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j), spec,
        device="cpu", dtype=torch.float32)[0]
    assert neg.fpatt.dtype == torch.float32
    nb = len(topo_j.branch_nodes())
    assert_float32_match(neg_j, neg,
                         [x0, random_x(bounds, nb, np.random.default_rng(3))])


@pytest.mark.parametrize("kw", [dict(model="HKY85", ncatG=5, fix_alpha=False),
                                dict(model="REV")], ids=["HKY85_G5", "REV"])
def test_baseml_objective_float32_matches_jax(kw):
    data_j, topo_j = clock56("nuc")
    neg_j, _, x0, bounds = jax_baseml.make_objective(
        data_j, topo_j, jax_baseml.BasemlSpec(**kw), jnp.float32)
    neg = baseml.make_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        baseml.BasemlSpec(**kw), device="cpu", dtype=torch.float32)[0]
    nb = len(topo_j.branch_nodes())
    assert_float32_match(neg_j, neg,
                         [x0, random_x(bounds, nb, np.random.default_rng(4))])


def test_aa_objective_float32_matches_jax():
    data_j, topo_j = clock56("aa")
    kw = dict(seqtype=2, aa_model="Empirical_F", aa_rate_file="lg",
              fix_alpha=False, alpha=0.5, ncatG=4)
    neg_j, _, x0, bounds, _ = jax_codeml.make_aa_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float32)
    neg = codeml.make_aa_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        codeml.CodemlSpec(**kw), device="cpu", dtype=torch.float32)[0]
    nb = len(topo_j.branch_nodes())
    assert_float32_match(neg_j, neg,
                         [x0, random_x(bounds, nb, np.random.default_rng(5))])


def test_fit_packed_float32_m0():
    """The port's float32 fit against the JAX package's on the same
    inputs (JAX: -1560.3374023 in float32, -1560.3374773 in float64): lnL
    to 2e-4, kappa, omega and the branch lengths to 2e-3 relative; then
    the port's float64 fit as a second check, lnL to 2e-4 and the
    estimates within the JAX package's float32 envelope of a fit
    (tests/test_f32_parity.py: kappa on a flat ridge, 3 %)."""
    data_j, topo_j = clock56("codon")
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    spec = codeml.CodemlSpec()
    r32 = codeml.fit_packed(data, topo, spec, device="cpu",
                            dtype=torch.float32)
    rj = jax_codeml.fit_packed(data_j, topo_j, jax_codeml.CodemlSpec(),
                               dtype=jnp.float32)
    assert abs(r32.lnL - rj.lnL) <= 2e-4
    for field in ("kappa", "class_omegas", "blens"):
        np.testing.assert_allclose(getattr(r32, field),
                                   np.asarray(getattr(rj, field)), rtol=2e-3)
    for field in (r32.x, r32.blens, r32.kappa, r32.class_omegas):
        assert field.dtype == np.float64
    r64 = codeml.fit_packed(data, topo, spec, device="cpu")
    assert abs(r32.lnL - r64.lnL) <= 2e-4
    np.testing.assert_allclose(r32.kappa, r64.kappa, rtol=0.03)
    np.testing.assert_allclose(r32.class_omegas, r64.class_omegas, rtol=0.03)


@pytest.mark.parametrize("model", ["REV", "HKY85"])
def test_baseml_float32_ses_match_jax(model):
    """The port's Hessian runs P(t) in float64 (`pmat_rev_multi_twice`),
    the JAX package differentiates its float32 P(t) twice; both SEs stand
    within 1.4e-3 of float64's here."""
    data_j, _ = clock56("nuc")
    topo_j = jax_from_treenode(
        jax_treeio.parse_newick("(((A, B), C), (D, E), F);"), data_j.names)
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    res = baseml.fit_packed(data, topo,
                            baseml.BasemlSpec(model=model, getSE=True),
                            device="cpu", dtype=torch.float32)
    neg_j = jax_baseml.make_objective(data_j, topo_j,
                                      jax_baseml.BasemlSpec(model=model),
                                      jnp.float32)[0]
    H_j = np.asarray(jax.jit(jax.hessian(neg_j))(jnp.asarray(res.x)),
                     np.float64)
    neg = baseml.make_objective(data, topo, baseml.BasemlSpec(model=model),
                                device="cpu", dtype=torch.float32)[0]
    H = codeml.hessian(neg, res.x, device="cpu")
    np.testing.assert_allclose(H, H_j, rtol=0,
                               atol=GRAD_RTOL * np.abs(H_j).max())
    ses_j = np.sqrt(np.maximum(np.diag(np.linalg.inv(H_j)), 0.0))
    assert np.all(ses_j > 0) and res.SEs.dtype == np.float64
    np.testing.assert_allclose(res.SEs, ses_j, rtol=GRAD_RTOL)


def test_entry_float32_matches_jax():
    fn_j, (x_j,) = jax_entry.entry()
    vj, gj = fn_j(x_j)
    fn, (x,) = entry.entry(device="cpu", dtype=torch.float32)
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-7)
    v, g = fn(x)
    assert v.dtype == g.dtype == torch.float32
    assert abs(float(v) - float(vj)) <= VAL_RTOL * abs(float(vj))
    gj = np.asarray(gj)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                               atol=GRAD_RTOL * np.abs(gj).max())
