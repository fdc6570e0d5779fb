"""paml_tpu_torch's graph-safe pieces against paml_tpu on the CPU: what
lets the clocks, FromCodon / REVaa, AdG, nparK 4, UNREST / UNRESTu and
mcmctree's exact likelihood replay from CUDA graphs, with the same inputs
from one numpy seed in both packages.

- The clock's branch lengths from its device tables by pointer jumping
  (`core/clockparam.py`) against `paml_tpu.core.clockparam` for clock 1,
  2 (local clock, rate classes), 3, TipDate, a fossil-calibrated root and
  a 32-taxon ladder (depth 31): values within 1e-13 relative (with tip
  dates, or 1e-13 of the root's age: the subtraction of close ages),
  gradients within 1e-11 of the largest component; no host read.
- `pmat.expm` / `pmat_expm` (the [13/13] Pade approximant, its squarings
  from the norm on the device, masked) against `paml_tpu`'s `pmat_expm`
  and `torch.linalg.matrix_exp`: P within 1e-12, the gradient within
  1e-10 of its largest component; past S_MAX its status word raises.
- `pmat.solve_small` (Gaussian elimination with partial pivoting in fixed
  steps) against `jnp.linalg.solve`, values and gradients; a singular
  system raises.
- The AdG, nparK 4, FromCodon, REVaa_0 + G and UNREST / UNRESTu objectives
  evaluated under `test_torch_graphs.no_host_reads` (the quantile code on
  its card route through the plain versions) against the JAX package's:
  values within 1e-10 relative, gradients within 1e-8 of the largest
  component.
- `mcmctree.ExactLoci.lnl` with its class rates from `discrete_gamma` over
  the loci's alphas against the JAX package's vmapped exact likelihood
  (1e-10), and its evaluation under `no_host_reads`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import baseml as jax_baseml
from paml_tpu.apps import codeml as jax_codeml
from paml_tpu.apps import mcmctree as J
from paml_tpu.core import clockparam as jax_clockparam
from paml_tpu.core import pmat as jax_pmat
from paml_tpu.core.topology import from_treenode as jax_from_treenode
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch import interop
from paml_tpu_torch.apps import baseml, codeml
from paml_tpu_torch.apps import mcmctree as T
from paml_tpu_torch.core import clockparam, cuda_quantile, dgamma
from paml_tpu_torch.core import graphs, optim, pmat
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io import treeio

import test_torch_aaml as ta
import test_torch_baseml as tb
import test_torch_mcmctree as tm
from test_torch_graphs import guarded_value_grad, no_host_reads

torch.set_num_threads(1)


# --- the clock's branch lengths ---------------------------------------------

def _ladder(ns):
    names = [f"t{i}" for i in range(ns)]
    nwk = names[0]
    for nm in names[1:]:
        nwk = f"({nwk},{nm})"
    return nwk + ";", names


CLOCKS = {
    "clock1": ("(((a,b),c),(d,e));", 1, False),
    "clock2": ("(((a,b) #1,c),(d #2,e));", 2, False),
    "clock3": ("(((a,b) #1,c),(d,e)) '@1.2';", 3, False),
    "tipdate": ("(((a,b),c),(d,e));", 1, True),
    "fossil_root": ("(((a,b),c) '@0.45',(d,e)) '@1.5';", 1, False),
    "ladder32": (_ladder(32)[0], 1, False),
    "ladder32_tipdate": (_ladder(32)[0], 1, True),
}


@pytest.mark.parametrize("name", list(CLOCKS))
def test_clock_branch_lengths_match_jax(name):
    nwk, clock, dated = CLOCKS[name]
    names = _ladder(32)[1] if name.startswith("ladder") else list("abcde")
    tj, tt = jax_treeio.parse_newick(nwk), treeio.parse_newick(nwk)
    jax_treeio._resolve_names(tj, names)
    treeio._resolve_names(tt, names)
    rng = np.random.default_rng(len(name))
    tip_ages = rng.uniform(0.0, 0.3, len(names)) if dated else None
    topo_j = jax_from_treenode(tj, names)
    fj, nj, x0j, bj, ij = jax_clockparam.make_clock_times(topo_j, clock,
                                                          tip_ages)
    ft, nt, x0t, bt, _ = clockparam.make_clock_times(
        from_treenode(tt, names), clock, tip_ages, device="cpu")
    assert (nt, x0t, bt) == (nj, x0j, bj)
    for x in (np.asarray(x0t, float),
              np.array([rng.uniform(max(lo, 0.3), min(hi, 0.9))
                        for lo, hi in bt])):
        if dated:
            x[0] = 1.5                  # the root above the oldest tip
        xt = torch.tensor(x, requires_grad=True)
        with no_host_reads():
            t = ft(xt)
        tj_ = np.asarray(fj(jnp.asarray(x)))
        # a branch is the difference of two ages: where tip dates bring
        # them close, both packages' values carry the subtraction's
        # rounding of the ages (5.6e-13 relative each against exact
        # rational arithmetic on the dated ladder), so the relative
        # tolerance stands beside one of 1e-13 of the root's age
        root_age = float(ij["ages_of"](jnp.asarray(x))[topo_j.root])
        np.testing.assert_allclose(t.detach().numpy(), tj_, rtol=1e-13,
                                   atol=1e-13 * root_age if dated else 0)
        w = np.random.default_rng(3).normal(size=len(tj_))
        gj = np.asarray(jax.grad(lambda v: (fj(v) * w).sum())(
            jnp.asarray(x)))
        (g,) = torch.autograd.grad((t * torch.tensor(w)).sum(), xt)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=1e-11 * np.abs(gj).max())


# --- expm and the small solve -------------------------------------------------

def _unrest_Q(rng):
    R = rng.uniform(0.05, 5.0, size=(4, 4))
    np.fill_diagonal(R, 0.0)
    Q = R - np.diag(R.sum(1))
    w, v = np.linalg.eig(Q.T)
    pi = np.real(v[:, np.argmin(np.abs(w))])
    return Q / -(pi / pi.sum() * np.diag(Q)).sum()


TS = np.array([1e-5, 0.01, 0.1, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 50.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expm_matches_jax_and_matrix_exp(seed):
    rng = np.random.default_rng(seed)
    Q = _unrest_Q(rng)
    W = rng.normal(size=(len(TS), 4, 4))

    def port(q, t):
        return (pmat.pmat_expm(q, t) * torch.tensor(W)).sum()
    q, t = torch.tensor(Q, requires_grad=True), torch.tensor(
        TS, requires_grad=True)
    with no_host_reads(), graphs.status_sink():
        P = pmat.pmat_expm(q, t)
    Pj = np.asarray(jax_pmat.pmat_expm(jnp.asarray(Q), jnp.asarray(TS)))
    Pm = torch.linalg.matrix_exp(q.detach()[None] * t.detach()[:, None,
                                                                 None])
    assert np.abs(P.detach().numpy() - Pj).max() <= 1e-12
    assert float((P.detach() - Pm).abs().max()) <= 1e-12
    g = torch.autograd.grad(port(q, t), (q, t))
    gj = jax.grad(lambda a, b: (jax_pmat.pmat_expm(a, b) * W).sum(),
                  (0, 1))(jnp.asarray(Q), jnp.asarray(TS))
    gm = torch.autograd.grad((torch.linalg.matrix_exp(
        q[None] * t[:, None, None]) * torch.tensor(W)).sum(), (q, t))
    for a, b, c in zip(g, gj, gm):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()
        assert float((a - c).abs().max()) <= 1e-10 * float(c.abs().max())


def test_expm_past_s_max_reports_noconv():
    Q = torch.tensor(_unrest_Q(np.random.default_rng(4)))
    t = torch.tensor([0.1, 400.0])
    with pytest.raises(graphs.DeviceStatusError, match="S_MAX"):
        pmat.pmat_expm(Q, t, s_max=3)
    with graphs.status_sink() as sink:
        pmat.pmat_expm(Q, t, s_max=3)
    assert float(graphs.status_of(sink, Q)) == pmat.NOCONV
    # enough squarings: status 0 and the same P as a larger S_MAX
    with graphs.status_sink() as sink:
        P = pmat.pmat_expm(Q, t, s_max=pmat.expm_squarings(400.0 * 10))
    assert float(graphs.status_of(sink, Q)) == 0.0
    assert torch.equal(P, pmat.pmat_expm(Q, t, s_max=40))
    assert pmat.expm_squarings(1.0) == 1
    assert pmat.expm_squarings(5.0 * 2 ** 20) == 20


@pytest.mark.parametrize("n,batch,pivot", [(4, (), False), (4, (5,), True),
                                           (3, (2, 3), True), (1, (2,), False)])
def test_solve_small_matches_jax(n, batch, pivot):
    rng = np.random.default_rng(n + len(batch))
    A = rng.normal(size=batch + (n, n))
    if pivot:
        A[..., 0, 0] = 0.0               # the first pivot must be a swap
    b = rng.normal(size=batch + (n,))
    At, bt = (torch.tensor(v, requires_grad=True) for v in (A, b))
    with no_host_reads(), graphs.status_sink():
        x = pmat.solve_small(At, bt)
    xj = np.asarray(jnp.linalg.solve(jnp.asarray(A),
                                     jnp.asarray(b)[..., None])[..., 0])
    assert np.abs(x.detach().numpy() - xj).max() <= 1e-12 * np.abs(xj).max()
    w = rng.normal(size=x.shape)
    g = torch.autograd.grad((x * torch.tensor(w)).sum(), (At, bt))
    gj = jax.grad(lambda a, c: (jnp.linalg.solve(a, c[..., None])[..., 0]
                                * w).sum(), (0, 1))(jnp.asarray(A),
                                                    jnp.asarray(b))
    for a, r in zip(g, gj):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= 1e-10 * np.abs(r).max()
    # a matrix right-hand side
    B = torch.tensor(rng.normal(size=batch + (n, 2)))
    X = pmat.solve_small(At.detach(), B)
    assert float((At.detach() @ X - B).abs().max()) <= 1e-12


def test_solve_small_singular_raises():
    A = torch.tensor([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 1.0, 1.0]])
    with pytest.raises(graphs.DeviceStatusError, match="singular test"):
        pmat.solve_small(A, torch.ones(3), "singular test")
    with graphs.status_sink() as sink:
        pmat.solve_small(torch.stack([torch.eye(3, dtype=A.dtype), A]),
                         torch.ones(2, 3))
    assert float(graphs.status_of(sink, A)) == pmat.SINGULAR


def test_graphed_value_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GraphedValue(lambda a: a.sum(), [torch.zeros(3)])


# --- objectives evaluated the capturable way, against the JAX package ---------

def _check_guarded(neg, neg_j, x0, bounds, nb, monkeypatch):
    """The port's value + gradient under `no_host_reads` against the JAX
    package's at x0 and at a random in-bounds point."""
    assert neg.capturable is True
    vg_j = jax.jit(jax.value_and_grad(neg_j))
    for x in (np.asarray(x0, float),
              tb.random_x(bounds, nb, np.random.default_rng(17))):
        v, g, read = guarded_value_grad(neg, x, monkeypatch)
        assert read is None, read
        vj, gj = vg_j(jnp.asarray(x))
        gj = np.asarray(gj)
        assert abs(float(v.detach()) - float(vj)) <= 1e-10 * abs(float(vj))
        assert np.abs(g.numpy() - gj).max() <= 1e-8 * np.abs(gj).max()


NUC = {"AdG": dict(model="HKY85", ncatG=4, fix_alpha=False, alpha=0.5,
                   fix_rho=False, rho=0.4),
       "nparK4": dict(model="K80", ncatG=3, nparK=4),
       "UNREST": dict(model="UNREST"),
       "UNRESTu": dict(model="UNRESTu", step="[3 (TC CT) (AG) (GA TA)]")}


@pytest.mark.parametrize("name", list(NUC))
def test_nucleotide_objective_graph_safe_matches_jax(name, monkeypatch):
    data_j, topo_j = tb.clock56()
    spec_j, spec_t = tb.specs_of(NUC[name])
    neg_j, _, x0, b = jax_baseml.make_objective(data_j, topo_j, spec_j,
                                                jnp.float64)
    neg, _, x0_t, _ = baseml.make_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j), spec_t,
        device="cpu")
    np.testing.assert_array_equal(x0_t, x0)
    _check_guarded(neg, neg_j, x0, b, len(topo_j.branch_nodes()),
                   monkeypatch)


AA = {"FromCodon": dict(aa_model="FromCodon"),
      "REVaa_0_G": dict(aa_model="REVaa_0", fix_alpha=False, alpha=0.5,
                        ncatG=4)}


@pytest.mark.parametrize("name", list(AA))
def test_aa_objective_graph_safe_matches_jax(name, monkeypatch):
    data_j, topo_j = ta.clock56_aa()
    kw = dict(seqtype=3, **AA[name])
    neg_j, _, x0, b, _ = jax_codeml.make_aa_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float64)
    neg, _, x0_t, _, _ = codeml.make_aa_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        codeml.CodemlSpec(**kw), device="cpu")
    np.testing.assert_array_equal(x0_t, x0)
    _check_guarded(neg, neg_j, x0, b, len(topo_j.branch_nodes()),
                   monkeypatch)


# --- mcmctree's exact likelihood ------------------------------------------------

@pytest.mark.parametrize("alpha,ncatG", [(0.0, 4), (0.5, 5)])
def test_exact_loci_device_rates_match_jax(tmp_path, alpha, ncatG,
                                           monkeypatch):
    """`ExactLoci.lnl` with every locus's class rates from one batched
    `discrete_gamma` inside the evaluation, against the JAX chain's
    vmapped exact likelihood; the evaluation from device tensors reads
    nothing on the host; on the CPU it runs op by op."""
    path = tmp_path / "seq.txt"
    path.write_text(tm.seq_text(lengths=(90, 70, 50, 40), gaps=True))
    loci_j = [jax_seqio.pack(a, cleandata=False)
              for a in jax_seqio.read_alignments(str(path), 0, 4)]
    loci_t = [interop.packed_from(d) for d in loci_j]
    tj, tt = tm.species_trees()
    kw = dict(clock=2, usedata=1, alpha=alpha, ncatG=ncatG, seed=5)
    mj = J.MCMCTree(tj, loci_j, J.McmcSpec(**kw))
    mt = T.MCMCTree(tt, loci_t, T.McmcSpec(**kw), device="cpu")
    rng = np.random.default_rng(21)
    ex = mt._exact
    for _ in range(2):
        mj.kappa = mt.kappa = rng.uniform(1, 8, 4)
        mj.alpha_g = mt.alpha_g = rng.uniform(0.1, 3, 4)
        want = mj.lnL_all()
        b = mt._branch_lengths_all()
        optim.GRAPHS.update(dict.fromkeys(optim.GRAPHS, 0))
        for route in ("batched", "loop"):
            got = ex.lnl(b, mt.kappa, mt.alpha_g, route=route)
            np.testing.assert_allclose(got, want, rtol=1e-10)
        assert optim.GRAPHS == {"graphed_evals": 0, "eager_evals": 2,
                                "captures": 0}
        got = ex.lnl(b[[2]], mt.kappa[[2]], mt.alpha_g[[2]], rows=[2])
        np.testing.assert_allclose(got, want[[2]], rtol=1e-10)
        args = [torch.tensor(v) for v in (b, mt.kappa, mt.alpha_g)]
        # the quantile code on its card route (the plain versions)
        monkeypatch.setattr(dgamma, "_e2", lambda t: cuda_quantile.PLAIN)
        with no_host_reads(), graphs.status_sink():
            out = ex._lnl(*args, tuple(range(4)), "batched")
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-10)
