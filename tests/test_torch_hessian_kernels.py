"""The Hessian's route through the pruning kernels on the CPU: the plain
versions of the tangent kernels H1 / H2 (`pruning.class_site_lnf_tan_plain`,
`class_site_lnf_bwd_tan_plain`) against `jax.jvp` of the JAX package's
level pass and of its VJP (7 taxa x 40 patterns x 3 classes x 61 states,
state codes and coded tips with gaps), and `codeml.hessian` through
`cuda_pruning.ClassSiteLnfKernelTwice` (its launches sent to those plain
versions, as on CPU tensors) against `jax.hessian` and against the plain
route (`class_site_lnf_twice`) on tests/data/clock56.codon: M2a and M8,
clean and gapped (on the gapped data also rows in blocks of 2 and 16,
pattern chunks of 64 and of all).  Branch lengths stay fixed (fix_blength =
2) in the Hessian cases, which leaves 5 parameters: every row costs a
batched second derivative of P(t) through `matrix_exp`, most of the
route's CPU time.  A trifurcating root: the nodes `cuda_pruning.big_tree`
adds take Pdot = 0 and get no dPd."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.core import pruning as jax_pruning
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.core import cuda_pruning, pruning
from paml_tpu_torch.core.tipcodes import TipCodes
from test_torch_codeml import _clock56, _random_x

torch.set_num_threads(1)

N_STATES, N_CLASSES, N_PATT, N_DIRS = 61, 3, 40, 2
NEWICK = "((a,b),(c,(d,e)),(f,g));"


def _problem(gapped: bool, seed: int = 3):
    """P, pi, tips (port and JAX forms), directions, gbar and gdot from a
    numpy seed on a 7-taxon tree with a trifurcating root."""
    rng = np.random.default_rng(seed)
    names = list("abcdefg")
    topo_j = jax_from_treenode(jax_treeio.parse_newick(NEWICK), names)
    topo = interop.topology_from(topo_j)
    n, C, H, D = N_STATES, N_CLASSES, N_PATT, N_DIRS
    P = rng.dirichlet(np.ones(n), size=(topo.nnode, C, n))
    pi = rng.dirichlet(np.ones(n), size=C)
    codes = rng.integers(0, n, (topo.ns, H)).astype(np.int32)
    if gapped:
        amb = (rng.uniform(size=(3, n)) < 0.3).astype(float)
        amb[0] = 1.0                                  # a gap
        codes[1, ::5], codes[3, 1::7], codes[5, 2::9] = n, n + 1, n + 2
        tips = TipCodes(torch.tensor(codes), torch.tensor(amb))
        dense = np.concatenate([np.eye(n), amb])[codes]
        tips_j = jnp.asarray(dense)
    else:
        tips = torch.tensor(codes)
        tips_j = jnp.asarray(codes)
    dirs = (rng.normal(0.0, 0.1, (D, topo.nnode, C, n, n)),
            rng.normal(0.0, 0.01, (D, C, n)))
    gbar = rng.normal(size=(C, H))
    gdot = rng.normal(size=(D, C, H))
    return topo, topo_j, P, pi, tips, tips_j, dirs, gbar, gdot


def _close(got, want, rel):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("gapped", [False, True], ids=["clean", "gapped"])
def test_tangent_plain_versions_match_jax(gapped):
    topo, topo_j, P, pi, tips, tips_j, (Pd, pid), gbar, gd = \
        _problem(gapped)
    t = torch.tensor
    lnfd, Sd = pruning.class_site_lnf_tan_plain(t(P), tips, topo, t(pi),
                                                t(Pd), t(pid))
    dPd, dpid = pruning.class_site_lnf_bwd_tan_plain(
        t(P), tips, topo, t(pi), t(gbar), t(Pd), t(pid), t(gd))
    assert Sd.shape == (N_DIRS, cuda_pruning.full_plan(
        cuda_pruning.big_tree(topo)).n_srows, N_CLASSES, N_STATES, N_PATT)

    def lnf(P_, pi_):
        # the level pass's forward rule: jax.jvp does not enter custom_vjp
        return jax_pruning._lnf_lvl_fwd(P_, tips_j, topo_j, pi_)[0]

    def adjoint(P_, pi_, g_):
        return jax.vjp(lambda a, b: jax_pruning.class_site_lnf(
            a, tips_j, topo_j, b), P_, pi_)[1](g_)

    lnf_jvp = jax.jit(lambda *a: jax.jvp(lnf, a[:2], a[2:])[1])
    adjoint_jvp = jax.jit(lambda *a: jax.jvp(adjoint, a[:3], a[3:])[1])
    for d in range(N_DIRS):
        lnfd_j = lnf_jvp(P, pi, Pd[d], pid[d])
        dPd_j, dpid_j = adjoint_jvp(P, pi, gbar, Pd[d], pid[d], gd[d])
        _close(lnfd[d], lnfd_j, 1e-10)
        _close(dPd[d], dPd_j, 1e-10)
        _close(dpid[d], dpid_j, 1e-10)


def test_added_nodes_take_no_direction():
    # big_tree resolves the trifurcating root under one added node: its
    # identity P is a constant, so a direction on the caller's nodes alone
    # gives the same tangents as one with a value there (which the
    # wrappers never pass: they pad Pdot with zeros), and dPd covers the
    # caller's nodes alone
    topo, _, P, pi, tips, _, (Pd, pid), gbar, gd = _problem(False)
    run = cuda_pruning.big_tree(topo)
    assert run.nnode == topo.nnode + 1 and run.n_own == topo.nnode
    t = torch.tensor
    x = cuda_pruning._Inputs(t(P), tips, topo, t(pi))
    Pp, pp = cuda_pruning._tan_dirs(x, t(Pd), t(pid))
    assert Pp.shape == (N_DIRS, run.nnode, N_CLASSES, 64, 64)
    assert not Pp[:, topo.nnode:].any() and not Pp[..., N_STATES:, :].any()
    assert torch.equal(Pp[:, :topo.nnode, :, :N_STATES, :N_STATES], t(Pd))
    dPd, dpid = pruning.class_site_lnf_bwd_tan_plain(
        t(P), tips, topo, t(pi), t(gbar), t(Pd), t(pid), t(gd))
    assert dPd.shape == (N_DIRS, topo.nnode, N_CLASSES, N_STATES, N_STATES)
    # on the binary tree with the identity node, the caller's rows agree
    P_run = cuda_pruning.with_identity(t(P), run)
    Pd_run = torch.cat([t(Pd), torch.zeros(N_DIRS, 1, N_CLASSES, N_STATES,
                                           N_STATES, dtype=torch.float64)],
                       1)
    dPd_run, dpid_run = pruning.class_site_lnf_bwd_tan_plain(
        P_run, tips, run, t(pi), t(gbar), Pd_run, t(pid), t(gd))
    _close(dPd_run[:, :topo.nnode], dPd, 1e-12)
    _close(dpid_run, dpid, 1e-12)
    lnfd, _ = pruning.class_site_lnf_tan_plain(t(P), tips, topo, t(pi),
                                               t(Pd), t(pid))
    lnfd_run, _ = pruning.class_site_lnf_tan_plain(P_run, tips, run, t(pi),
                                                   Pd_run, t(pid))
    _close(lnfd_run, lnfd, 1e-12)


@pytest.mark.parametrize("gapped", [False, True], ids=["clean", "gapped"])
@pytest.mark.parametrize("name,kw", [("M2a", dict(NSsites=2)),
                                     ("M8", dict(NSsites=8, ncatG=4))])
def test_hessian_through_the_kernel_route(name, kw, gapped, monkeypatch):
    kw = dict(kw, fix_blength=2)
    data_j, topo_j = _clock56(gapped)
    neg_j = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float64)[0]
    neg, _, _, _, b, _ = codeml.make_codon_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        codeml.CodemlSpec(**kw), device="cpu")
    x = _random_x(b, 0, np.random.default_rng(5))
    Ht = codeml.hessian(neg, x, device="cpu")          # the plain route
    calls = []
    real = cuda_pruning.ClassSiteLnfKernelTwice

    def route(*a):
        calls.append(a[0].shape)
        return real(*a)
    monkeypatch.setattr(pruning, "uses_twice_kernels", lambda P: True)
    monkeypatch.setattr(cuda_pruning, "ClassSiteLnfKernelTwice", route)
    H = codeml.hessian(neg, x, device="cpu")
    assert calls and np.isfinite(H).all()
    Hj = np.asarray(jax.jit(jax.hessian(neg_j))(jnp.asarray(x)))
    np.testing.assert_allclose(H, Hj, rtol=1e-6,
                               atol=1e-8 * np.abs(Hj).max())
    _close(H, Ht, 1e-9)
    if not gapped:
        return
    # rows in blocks of 2 (and 16 above: one block), patterns in chunks of
    # 64 (and all at once above) give the same matrix
    monkeypatch.setattr(codeml, "HESSIAN_ROWS", 2)
    monkeypatch.setitem(codeml.HESSIAN_BYTES, "cpu", 1)
    n_calls = len(calls)
    H2 = codeml.hessian(neg, x, device="cpu")
    assert len(calls) - n_calls > n_calls
    _close(H2, H, 1e-12)
