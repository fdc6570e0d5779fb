"""paml_tpu_torch's compiled execution on the CPU: what a CUDA graph needs
of the work it records, held where a card is not needed.

- The device L-BFGS (`optim._lbfgs_run`), its state overwritten in place
  by each pass, gives the same bits with the stop flag read after every
  pass as after every CHECK_EVERY (the graphed loop replays CHECK_EVERY
  passes between reads), and as the passes stepped one at a time by hand.
- Every codon objective of tests/test_torch_codeml.py::SPECS (and the
  quantile models M5-M13, the clocks, TipDate and a fossil-calibrated
  root), and amino-acid and nucleotide objectives with and without gamma
  rates (FromCodon, REVaa, UNREST / UNRESTu, AdG, nparK, the clocks and
  nhomo 1-5 among them), evaluate a value + gradient under a guard that
  makes the host reads (`item`, `__bool__`, `__float__`, `__int__`,
  `tolist`, `numpy`, `cpu`, `to` the CPU) and the copies from the host
  (`torch.as_tensor` / `torch.tensor` / `Tensor.new_tensor` of anything
  but a tensor) raise,
  with `core/dgamma.py` on its card route with the plain versions
  (`cuda_quantile.PLAIN`): every one of them is marked `capturable` and
  the guard passes for each.
- `GraphedValueGrad` on a CPU device raises; `maximize` and the device
  L-BFGS on the CPU make no capture and count their evaluations as eager
  (`optim.GRAPHS`); the status words.
- The Jacobi eigensolver's plain version (`cuda_eigh.jacobi_plain`, the
  kernel's sweep order and rounding) against `torch.linalg.eigh` on codon
  S matrices (P(t) within 1e-13 of its largest entry, the VJP within
  1e-11 of its largest component), at 61, 20, 5, 4, 3, 2 and 1 states and
  at 63 and 64 (the kernel's largest), with degenerate spectra and
  zero-frequency states, and on the 60 and 63 sense codons of the
  vertebrate mitochondrial and ciliate codes; its status words; and the
  port's float64 P(t) with that eigensolver against paml_tpu's
  `pmat_rev_multi` within 1e-12, the same inputs from one numpy seed.
"""
import contextlib
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.core import pmat as jax_pmat
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from paml_tpu_torch.bench import clock56_objective
from paml_tpu_torch.apps import baseml
from paml_tpu_torch.core import cuda_eigh, cuda_quantile, dgamma, graphs, optim
from paml_tpu_torch.core import pmat
from paml_tpu_torch.io import seqio
from paml_tpu_torch.models import codon

import test_torch_codeml as tc

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


# --- the device L-BFGS in place ---------------------------------------------

@pytest.fixture(scope="module")
def clock56_f64():
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio
    data = seqio.pack(seqio.read_alignment(
        os.path.join(DATA, "clock56.codon"), seqio.CODON_SEQ))
    topo = from_treenode(treeio.read_trees(
        os.path.join(DATA, "clock56.trees"), data.names)[0], data.names)
    neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
        data, topo, codeml.CodemlSpec(), device="cpu")
    return neg, x0, bounds


def _bounded(neg, x0, bounds, dtype):
    """`maximize_device_bounded`'s chart: (neg of y, y0)."""
    lo = torch.tensor([b[0] for b in bounds], dtype=dtype)
    hi = torch.tensor([b[1] for b in bounds], dtype=dtype)
    x = torch.as_tensor(np.asarray(x0), dtype=dtype)
    x = torch.minimum(torch.maximum(x, lo + 1e-6 * (hi - lo)),
                      hi - 1e-6 * (hi - lo))
    return (lambda y: neg(lo + (hi - lo) * torch.sigmoid(y)),
            torch.logit((x - lo) / (hi - lo)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lbfgs_in_place_same_bits_per_pass(monkeypatch, clock56_f64, dtype):
    if dtype == torch.float32:
        neg, x0, bounds = clock56_objective("cpu")[:3]
    else:
        neg, x0, bounds = clock56_f64
    fn, y0 = _bounded(neg, x0, bounds, dtype)
    ftol = 3e-7 if dtype == torch.float32 else 1e-10
    y, f, it, trials = optim._lbfgs_run(fn, y0, 500, 1e-9, ftol, 5)
    # the stop flag read after every pass
    monkeypatch.setattr(optim, "CHECK_EVERY", 1)
    y1, f1, it1, trials1 = optim._lbfgs_run(fn, y0, 500, 1e-9, ftol, 5)
    assert torch.equal(y, y1) and torch.equal(f, f1)
    assert int(it) == int(it1) and int(trials) == int(trials1)
    assert 0 < int(it) < 200
    # one pass at a time, by hand
    st = optim._lbfgs_state(fn, y0, 1e-9)
    while not bool(st["done"]):
        optim._lbfgs_pass(fn, st, 500, 1e-9, ftol, 5)
    assert torch.equal(y, st["y"]) and torch.equal(f, st["f"])
    assert int(it) == int(st["it"]) and int(trials) == int(st["trials"])


def test_lbfgs_counts_eager_evaluations_on_cpu(clock56_f64):
    neg, x0, bounds = clock56_f64
    neg.capturable = True
    try:
        optim.CHECKS.update(dict.fromkeys(optim.CHECKS, 0))
        optim.GRAPHS.update(dict.fromkeys(optim.GRAPHS, 0))
        x, lnl, it = optim.maximize_device_bounded(
            neg, x0, bounds, device="cpu", dtype=torch.float64)
    finally:
        del neg.capturable
    c = {**optim.CHECKS, **optim.GRAPHS}
    assert c["captures"] == 0 and c["graphed_evals"] == 0
    assert c["eager_evals"] == 1 + optim.CHECK_EVERY * (c["reads"] - 1)
    assert c["trials"] + 1 <= c["eager_evals"]


# --- objectives that capture: no host read ---------------------------------

class HostRead(Exception):
    pass


HOST_READS = ("item", "__bool__", "__float__", "__int__", "tolist", "numpy",
              "cpu")


@contextlib.contextmanager
def no_host_reads():
    """Tensor methods that read a tensor on the host raise HostRead inside
    the block (and `to` the CPU, the clock's way to the host), and so do
    `torch.as_tensor`, `torch.tensor` and `Tensor.new_tensor` of anything
    but a tensor (a copy from the host on the card), an item assignment
    of a Python number
    (`t[k] = 1.0` copies the number from the host on the card), and the
    two linear-algebra calls that read the host on the card
    (`torch.linalg.solve` checks its result there, `matrix_exp` picks its
    degree there)."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    saved["to"] = torch.Tensor.to
    saved["__setitem__"] = torch.Tensor.__setitem__
    saved["new_tensor"] = torch.Tensor.new_tensor
    made = {name: getattr(torch, name) for name in ("as_tensor", "tensor")}
    linalg = {name: getattr(torch.linalg, name)
              for name in ("solve", "matrix_exp")}

    def trip(name):
        def f(self, *args, **kw):
            raise HostRead(name)
        return f

    def to(self, *args, **kw):
        dev = kw.get("device", args[0] if args else None)
        if isinstance(dev, (str, torch.device)) and \
                torch.device(dev).type == "cpu":
            raise HostRead("to the CPU")
        return saved["to"](self, *args, **kw)

    def setitem(self, key, value):
        if not isinstance(value, torch.Tensor):
            raise HostRead(f"an item assignment of {type(value).__name__}")
        return saved["__setitem__"](self, key, value)

    def new_tensor(self, data, *args, **kw):
        if not isinstance(data, torch.Tensor):
            raise HostRead(f"new_tensor of {type(data).__name__}")
        return saved["new_tensor"](self, data, *args, **kw)

    def copy(name):
        def f(data, *args, **kw):
            if not isinstance(data, torch.Tensor):
                raise HostRead(f"torch.{name} of {type(data).__name__}")
            return made[name](data, *args, **kw)
        return f
    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, trip(name))
        torch.Tensor.to = to
        torch.Tensor.__setitem__ = setitem
        torch.Tensor.new_tensor = new_tensor
        for name in made:
            setattr(torch, name, copy(name))
        for name in linalg:
            setattr(torch.linalg, name, trip(f"torch.linalg.{name}"))
        yield
    finally:
        for name, f in saved.items():
            setattr(torch.Tensor, name, f)
        for name, f in made.items():
            setattr(torch, name, f)
        for name, f in linalg.items():
            setattr(torch.linalg, name, f)


def guarded_value_grad(neg, x0, monkeypatch):
    """(value, gradient, None) of neg at x0 under `no_host_reads`, the
    quantile code on its card route with the plain versions and the status
    words collected as a graph's evaluation collects them, after one
    evaluation outside the guard (the capture's warm-up, which makes the
    objective's device tables); or (None, None, the read) if the guard
    tripped."""
    monkeypatch.setattr(dgamma, "_e2", lambda t: cuda_quantile.PLAIN)
    xt = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    with graphs.status_sink():
        torch.autograd.grad(neg(xt), xt)
    try:
        with no_host_reads(), graphs.status_sink():
            v = neg(xt)
            (g,) = torch.autograd.grad(v, xt)
    except HostRead as e:
        return None, None, str(e)
    return v, g, None


QUANTILE_SPECS = {"M5": dict(NSsites=5), "M6": dict(NSsites=6, ncatG=4),
                  "M7": dict(NSsites=7), "M8": dict(NSsites=8),
                  "M9": dict(NSsites=9, ncatG=4),
                  "M10": dict(NSsites=10, ncatG=4),
                  "M11": dict(NSsites=11, ncatG=4),
                  "M12": dict(NSsites=12, ncatG=4),
                  "M13": dict(NSsites=13, ncatG=4)}
GUARD_CASES = ([(n, False) for n in tc.SPECS] + [(n, False) for n in
                                                 QUANTILE_SPECS]
               + [("M0", True), ("M2a", True)] + [(n, False) for n in
                                                  tc.N_CHUNKS])


@pytest.mark.parametrize("name,ambiguous", GUARD_CASES)
def test_capturable_objectives_read_nothing_on_the_host(name, ambiguous,
                                                        monkeypatch):
    base, n_chunks = tc.N_CHUNKS.get(name, (name, 1))
    kw = {**tc.SPECS, **QUANTILE_SPECS}[base]
    data_j, topo_j = tc._clock56(ambiguous, kw.get("icode", 0),
                                 labelled=tc._labelled(kw))
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(
        data, topo, codeml.CodemlSpec(**kw), device="cpu", n_chunks=n_chunks)
    assert neg.capturable is True
    v, g, read = guarded_value_grad(neg, x0, monkeypatch)
    assert (read is None) == neg.capturable, read
    if read is None:
        assert np.isfinite(float(v.detach())) and np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("dated", ["tipdate", "fossil"])
def test_dated_codon_objectives_read_nothing_on_the_host(dated, monkeypatch):
    """The codon clock with TipDate, and with a fossil-calibrated root:
    capturable, and no host read."""
    data, topo = _port_data("clock56.codon", seqio.CODON_SEQ, dated)
    kw = dict(clock=1, tipdate=dated == "tipdate", tipdate_timeunit=10.0)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(
        data, topo, codeml.CodemlSpec(**kw), device="cpu")
    assert neg.capturable is True
    v, g, read = guarded_value_grad(neg, x0, monkeypatch)
    assert read is None, read
    assert np.isfinite(float(v.detach())) and np.isfinite(g.numpy()).all()


def _port_data(name, seqtype, variant=""):
    """clock56's alignment and tree in the port's types: 'genes' split in
    two genes, 'labelled' with #1 on the clade (A, B), 'tipdate' with
    sampling years in the names, 'fossil' with the root at age 1.2."""
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio
    aln = seqio.read_alignment(os.path.join(DATA, name), seqtype)
    if variant == "genes":
        ls = len(aln.rows[0]) // (3 if seqtype == seqio.CODON_SEQ else 1)
        aln = seqio.Alignment(aln.names, aln.rows, aln.seqtype, ngene=2,
                              site_gene=(np.arange(ls) >= ls // 2)
                              .astype(np.int64))
    data = seqio.pack(aln)
    topo = from_treenode(treeio.read_trees(
        os.path.join(DATA, "clock56.trees"), data.names)[0], data.names)
    if variant == "labelled":
        topo.labels[tc.CLADE] = 1
    if variant == "tipdate":
        topo.ages0[:] = np.nan
        data.names = [f"{nm}_{1990 + 4 * i}" for i, nm in
                      enumerate(data.names)]
    if variant == "fossil":
        topo.ages0[:] = np.nan
        topo.ages0[topo.root] = 1.2
    return data, topo


# the census of the amino-acid and nucleotide objectives: each with its
# `capturable` flag; those that stay eager read the host where named
AA_CENSUS = {
    "aa_F_G_free": (dict(aa_model="Empirical_F", fix_alpha=False, alpha=0.5,
                         ncatG=4), True),
    "aa_F_G_fixed": (dict(aa_model="Empirical_F", fix_alpha=True, alpha=0.8,
                          ncatG=4), True),
    "aa_G_free": (dict(aa_model="Empirical", fix_alpha=False, alpha=0.5,
                       ncatG=4), True),
    "aa_Poisson": (dict(aa_model="Poisson"), True),
    # the index tables made on the device once (aamod.revaa_tables,
    # from_codon_tables)
    "aa_REVaa_0_G": (dict(aa_model="REVaa_0", fix_alpha=False, alpha=0.5,
                          ncatG=4), True),
    "aa_FromCodon": (dict(aa_model="FromCodon"), True),
    "aa_FromCodon_fixed_kappa": (dict(aa_model="FromCodon", fix_kappa=True,
                                      kappa=2.5), True),
    "aa_REVaa": (dict(aa_model="REVaa"), True),
}
NUC_CENSUS = {
    "REV_G5": (dict(model="REV", ncatG=5, fix_alpha=False, alpha=0.5),
               "", True),
    "HKY85_G5": (dict(model="HKY85", ncatG=5, fix_alpha=False, alpha=0.5),
                 "", True),
    "HKY85_G5_median": (dict(model="HKY85", ncatG=5, fix_alpha=False,
                             alpha=0.5, use_median=True), "", True),
    "TN93_G4_fixed": (dict(model="TN93", ncatG=4, fix_alpha=True,
                           alpha=0.7), "", True),
    "F84": (dict(model="F84"), "", True),
    "HKY85_G4_Mgene4": (dict(model="HKY85", ncatG=4, fix_alpha=False,
                             alpha=0.5, Mgene=4), "genes", True),
    "basemlg": (dict(model="HKY85", continuous_gamma=True, fix_alpha=False,
                     alpha=0.5), "", True),
    "HKY85_nparK1": (dict(model="HKY85", ncatG=3, nparK=1), "", True),
    "HKY85_nparK3": (dict(model="HKY85", ncatG=3, nparK=3), "", True),
    # the expm and the solves as fixed tensor operations, AdG's quadrature
    # and the clock's tables on the device (each read the host before)
    "UNREST": (dict(model="UNREST"), "", True),
    "UNREST_G4": (dict(model="UNREST", ncatG=4, fix_alpha=False, alpha=0.5),
                  "", True),
    "UNRESTu": (dict(model="UNRESTu", step="[3 (TC CT) (AG) (GA TA)]"), "",
                True),
    "HKY85_AdG": (dict(model="HKY85", ncatG=4, fix_alpha=False, alpha=0.5,
                       fix_rho=False, rho=0.4), "", True),
    "HKY85_AdG_fixed_rho": (dict(model="HKY85", ncatG=4, fix_alpha=False,
                                 alpha=0.5, rho=0.4), "", True),
    "HKY85_nparK4": (dict(model="HKY85", ncatG=3, nparK=4), "", True),
    "HKY85_clock1": (dict(model="HKY85", clock=1), "", True),
    "HKY85_clock2": (dict(model="HKY85", clock=2), "labelled", True),
    "HKY85_clock3": (dict(model="HKY85", clock=3), "labelled", True),
    "HKY85_G4_clock3_Mgene": (dict(model="HKY85", clock=3, ncatG=4, alpha=0.5,
                                   fix_alpha=False, Mgene=4), "genes", True),
    "REV_tipdate": (dict(model="REV", clock=1, tipdate=True,
                         tipdate_timeunit=10.0), "tipdate", True),
    "UNREST_fossil": (dict(model="UNREST", clock=1), "fossil", True),
    "nhomo1_HKY85": (dict(model="HKY85", nhomo=1), "", True),
    "nhomo1_REV": (dict(model="REV", nhomo=1), "", True),
    "nhomo2_K80": (dict(model="K80", nhomo=2), "", True),
    "nhomo3_HKY85": (dict(model="HKY85", nhomo=3), "", True),
    "nhomo4_TN93": (dict(model="TN93", nhomo=4), "", True),
    "nhomo5_HKY85": (dict(model="HKY85", nhomo=5), "labelled", True),
}


@pytest.mark.parametrize("name", list(AA_CENSUS))
def test_aa_objectives_census(name, monkeypatch):
    kw, expect = AA_CENSUS[name]
    data, topo = _port_data("clock56.codon", seqio.CODON2AA_SEQ)
    neg, _, x0, _, _ = codeml.make_aa_objective(
        data, topo, codeml.CodemlSpec(seqtype=3, **kw), device="cpu")
    assert getattr(neg, "capturable", False) is expect
    v, g, read = guarded_value_grad(neg, x0, monkeypatch)
    assert (read is None) == expect, read
    if read is None:
        assert np.isfinite(float(v.detach())) and np.isfinite(g.numpy()).all()


# codeml's other objectives: FromCodon0 (the codon chain on amino-acid
# data), aaDist and codon Mgene
MORE_CENSUS = {
    "FromCodon0": ("fromcodon0", dict(seqtype=3, aa_model="FromCodon0")),
    "FromCodon0_fixed": ("fromcodon0", dict(seqtype=3, aa_model="FromCodon0",
                                            fix_kappa=True, fix_omega=True,
                                            omega=0.4)),
    "aaDist1": ("aadist", dict(aaDist=1)),
    "aaDist-2_fixed_kappa": ("aadist", dict(aaDist=-2, fix_kappa=True)),
    "aaDist12": ("aadist", dict(aaDist=12)),
    "Mgene2_fixed_omega": ("mgene", dict(Mgene=2, fix_omega=True)),
    "Mgene4": ("mgene", dict(Mgene=4)),
}


@pytest.mark.parametrize("name", list(MORE_CENSUS))
def test_more_codon_objectives_census(name, monkeypatch):
    kind, kw = MORE_CENSUS[name]
    kw = dict(kw)
    if kind == "fromcodon0":
        data, topo = _port_data("clock56.codon", seqio.CODON2AA_SEQ)
        neg, _, x0, _, _ = codeml.make_fromcodon0_objective(
            data, topo, codeml.CodemlSpec(**kw), device="cpu")
    elif kind == "aadist":
        data, topo = _port_data("clock56.codon", seqio.CODON_SEQ)
        neg, _, x0, _, _ = codeml.make_aadist_objective(
            data, topo, codeml.CodemlSpec(**kw), device="cpu")
    else:
        data, topo = _port_data("clock56.codon", seqio.CODON_SEQ, "genes")
        mgene = kw.pop("Mgene")
        neg, _, x0, _, _ = codeml.make_codon_mgene_objective(
            data, topo, codeml.CodemlSpec(**kw), mgene, device="cpu")
    assert neg.capturable is True
    v, g, read = guarded_value_grad(neg, x0, monkeypatch)
    assert read is None, read
    assert np.isfinite(float(v.detach())) and np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("name", list(NUC_CENSUS))
def test_nucleotide_objectives_census(name, monkeypatch):
    from paml_tpu_torch.io import ctl
    kw, variant, expect = NUC_CENSUS[name]
    kw = dict(kw)
    step = kw.pop("step", None)
    spec = baseml.BasemlSpec(**kw)
    if step is not None:
        spec.step_matrix, spec.n_user_rates = ctl.parse_step_matrix(
            step, False)
    data, topo = _port_data("clock56.nuc", seqio.BASE_SEQ, variant)
    make = baseml.make_nhomo_objective if spec.nhomo else \
        baseml.make_objective
    neg, _, x0, _ = make(data, topo, spec, device="cpu")
    assert getattr(neg, "capturable", False) is expect
    v, g, read = guarded_value_grad(neg, x0, monkeypatch)
    assert (read is None) == expect, read
    if read is None:
        assert np.isfinite(float(v.detach())) and np.isfinite(g.numpy()).all()


# the pairwise programs' objectives (one per fit kind, reading the
# program's one slot) and clock 5 / 6's step-3 and AHRS objectives, each
# taken from its program as the program hands it to `maximize`


class _Enough(Exception):
    pass


def program_objective(monkeypatch, module, run, n):
    """The n-th objective and start that run() hands `module.maximize`
    (earlier fits return their start; the program stops at the n-th)."""
    got = []

    def maximize(neg, x0, bounds=None, **kw):
        got.append((neg, np.asarray(x0, np.float64)))
        if len(got) == n:
            raise _Enough
        return types.SimpleNamespace(x=np.asarray(x0, np.float64), lnL=0.0)
    monkeypatch.setattr(module, "maximize", maximize)
    with pytest.raises(_Enough):
        run()
    return got[-1]


def _codon_rows(ns, twin=False):
    """clock56.codon's first taxa (with `twin`, its first taxon twice, so
    that the first pair is identical), packed as the port's data."""
    from paml_tpu_torch.io import seqio
    aln = seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                               seqio.CODON_SEQ)
    idx = ([0] if twin else []) + list(range(ns))
    return seqio.pack(seqio.Alignment([f"s{k}" for k in range(len(idx))],
                                      [aln.rows[k] for k in idx],
                                      seqio.CODON_SEQ), cleandata=True)


def _aa_rows(ns):
    from paml_tpu_torch.io import seqio
    aln = seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                               seqio.CODON_SEQ)
    rows = seqio.translate_codon_rows(aln.rows[:ns])
    return seqio.pack(seqio.Alignment(aln.names[:ns], rows, seqio.AA_SEQ),
                      cleandata=True)


def _pairwise_run(name):
    """(the program, the call of its objective) of a census entry."""
    from paml_tpu_torch.apps import pairwise
    return {
        "codeml-2": (lambda: pairwise.pairwise_codon(
            _codon_rows(3), device="cpu"), 1),
        "codeml-2_fix_kappa": (lambda: pairwise.pairwise_codon(
            _codon_rows(3), codonf="F1x4MG", fix_kappa=True, device="cpu"),
            1),
        "aaml-2": (lambda: pairwise.pairwise_aa(_aa_rows(3), device="cpu"),
                   1),
        "codeml-3_ML": (lambda: pairwise.bayes_pairwise_codon(
            _codon_rows(2, twin=True), device="cpu"), 1),
        # the identical first pair takes the MAP fit
        "codeml-3_MAP": (lambda: pairwise.bayes_pairwise_codon(
            _codon_rows(2, twin=True), device="cpu"), 2),
        "window_omega_1": (lambda: pairwise.sliding_window_codon(
            _codon_rows(2), 100, 100, device="cpu"), 1),
        "window": (lambda: pairwise.sliding_window_codon(
            _codon_rows(2), 100, 100, device="cpu"), 2),
    }[name]


@pytest.mark.parametrize("name", ["codeml-2", "codeml-2_fix_kappa",
                                  "aaml-2", "codeml-3_ML", "codeml-3_MAP",
                                  "window_omega_1", "window"])
def test_pairwise_objectives_census(name, monkeypatch):
    from paml_tpu_torch.apps import pairwise
    run, n = _pairwise_run(name)
    neg, x0 = program_objective(monkeypatch, pairwise, run, n)
    assert neg.capturable is True
    v, g, read = guarded_value_grad(neg, x0, monkeypatch)
    assert read is None, read
    assert np.isfinite(float(v.detach())) and np.isfinite(g.numpy()).all()


CLOCK56_CENSUS = {
    "clock5_HKY85_G4": (seqio.BASE_SEQ, 5, 1, dict(
        model="HKY85", ncatG=4, fix_alpha=False, alpha=0.5)),
    "clock5_codon": (seqio.CODON_SEQ, 5, 1, dict(codonf="F3x4")),
    "clock5_codon_fixed": (seqio.CODON_SEQ, 5, 1, dict(
        codonf="F1x4MG", fix_kappa=True, kappa=[2.5, 1.5], fix_omega=True,
        omega=0.3)),
    # clock 6: the two loci's no-clock fits, then the AHRS smoothing
    "clock6_AHRS": (seqio.BASE_SEQ, 6, 3, dict(model="HKY85")),
}


@pytest.mark.parametrize("name", list(CLOCK56_CENSUS))
def test_clock56_objectives_census(name, monkeypatch):
    from paml_tpu_torch.apps import clock56
    seqtype, clock, n, kw = CLOCK56_CENSUS[name]
    nm = "clock56.codon" if seqtype == seqio.CODON_SEQ else "clock56.nuc"
    hd = clock56.read_tree_seqs(os.path.join(DATA, "clock56.trees"),
                                os.path.join(DATA, nm), 2, seqtype=seqtype)
    spec = clock56.Clock56Spec(clock=clock, seqtype=seqtype, **kw)
    fit = clock56.fit_clock5 if clock == 5 else clock56.fit_clock6
    neg, x0 = program_objective(monkeypatch, clock56,
                                lambda: fit(hd, spec, device="cpu"), n)
    assert neg.capturable is True
    v, g, read = guarded_value_grad(neg, x0, monkeypatch)
    assert read is None, read
    assert np.isfinite(float(v.detach())) and np.isfinite(g.numpy()).all()


def test_guard_trips_on_each_host_read():
    t = torch.ones(2)
    for name in HOST_READS:
        with no_host_reads(), pytest.raises(HostRead):
            f = getattr(t[0], name)
            f()
    with no_host_reads(), pytest.raises(HostRead):
        t.to("cpu", torch.float64)
    with no_host_reads(), pytest.raises(HostRead):
        t[1] = 1.0
    with no_host_reads(), pytest.raises(HostRead):
        t.new_tensor([2.0])
    with no_host_reads():
        assert t.to(torch.float64).dtype == torch.float64
        t[1] = t[0]


def test_level_route_index_cache_keeps_flags_and_nodes_apart():
    """The level route's per-tree index tensors: a list of flags and an
    equal list of node numbers ((True, False) == (1, 0)) each keep their
    own dtype, in either order."""
    from paml_tpu_torch.core import pruning
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio

    names = ["a", "b", "c"]
    for first in ("flags", "nodes"):
        topo = from_treenode(treeio.parse_newick("((a,b),c);"), names)
        lists = {"flags": [True, False], "nodes": [1, 0]}
        order = [first] + [k for k in lists if k != first]
        got = {k: pruning._index(topo, lists[k], "cpu") for k in order}
        assert got["flags"].dtype == torch.bool
        assert got["nodes"].dtype == torch.int64
        assert got["nodes"].tolist() == [1, 0]


# --- graphs on the CPU, counters, status words -------------------------------

def test_graphed_value_grad_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GraphedValueGrad(lambda x: (x * x).sum(), torch.zeros(3))


def test_maximize_on_cpu_makes_no_capture():
    def neg(x):
        return ((x - torch.arange(3, dtype=x.dtype)) ** 2).sum()
    neg.capturable = True
    assert optim.graphed(neg, "cuda") and not optim.graphed(neg, "cpu")
    optim.GRAPHS.update(dict.fromkeys(optim.GRAPHS, 0))
    res = optim.maximize(neg, np.full(3, 5.0), device="cpu")
    np.testing.assert_allclose(res.x, [0.0, 1.0, 2.0], atol=1e-6)
    assert optim.GRAPHS["captures"] == 0
    assert optim.GRAPHS["graphed_evals"] == 0
    assert optim.GRAPHS["eager_evals"] == res.n_eval > 0


def test_status_words():
    with pytest.raises(graphs.DeviceStatusError):
        graphs.report_status(torch.tensor([0, 2], dtype=torch.int32), "k")
    graphs.report_status(torch.zeros(3, dtype=torch.int32), "k")
    with graphs.status_sink() as sink:
        graphs.report_status(torch.tensor([0, 1], dtype=torch.int32), "k")
        graphs.report_status(torch.tensor([2], dtype=torch.int32), "k")
    assert len(sink) == 2
    assert float(graphs.status_of(sink, torch.zeros(1))) == 2.0
    assert float(graphs.status_of([], torch.zeros(1))) == 0.0
    graphs.check_status(0.0, "k")
    with pytest.raises(graphs.DeviceStatusError):
        graphs.check_status(1.0, "k")
    out = graphs.value_grad_eager(lambda x: (x ** 3).sum(),
                                  np.array([1.0, 2.0]), "cpu")
    np.testing.assert_array_equal(out, [9.0, 3.0, 12.0])


# --- the Jacobi eigensolver's plain version ----------------------------------

def _codon_Q(pi, kappa, omegas, icode=0):
    T = codon.dense_tables(icode, "cpu")
    s = codon.mutation_dense(T, torch.tensor([kappa], dtype=torch.float64))
    return codon.build_Q_dense(T, s, torch.tensor(omegas,
                                                  dtype=torch.float64),
                               torch.tensor(pi))


def _small_Q(rng, n, G):
    pi = rng.dirichlet(np.full(n, 3.0))
    Qs = []
    for _ in range(G):
        R = rng.uniform(0.2, 2.0, size=(n, n))
        Q = (R + R.T) * pi[None, :]
        np.fill_diagonal(Q, 0.0)
        Qs.append(Q - np.diag(Q.sum(1)))
    return torch.tensor(np.stack(Qs)), pi


def _cases():
    rng = np.random.default_rng(13)
    zero = rng.dirichlet(np.ones(61))
    zero[[0, 7, 30]] = 0.0
    f3 = rng.dirichlet(np.full(4, 5.0), size=3)
    f3x4 = codon.codon_pi("F3x4", None, f3, f3.mean(0),
                          codon.codon_graph(0))
    out = {"codon": (_codon_Q(f3x4, 2.3, [0.05, 1.0, 3.0]), f3x4),
           "degenerate": (_codon_Q(np.full(61, 1 / 61), 1.0, [1.0]),
                          np.full(61, 1 / 61)),
           "zero_pi": (_codon_Q(zero / zero.sum(), 1.8, [0.3, 2.0]),
                       zero / zero.sum())}
    for n in (20, 5, 4):
        out[f"n{n}"] = _small_Q(rng, n, 2)
    # the smallest and odd orders, the kernel's largest (NMAX), and the
    # sense codons of two other genetic codes: 60 (vertebrate mitochondrial)
    # and 63 (ciliate)
    for n in (1, 2, 3, 63, 64):
        out[f"n{n}"] = _small_Q(rng, n, 2)
    for name, icode in (("mito60", 1), ("ciliate63", 5)):
        pi = rng.dirichlet(np.full(codon.codon_graph(icode).n, 5.0))
        out[name] = (_codon_Q(pi, 2.1, [0.2, 1.7], icode), pi)
    return out


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_jacobi_plain_against_eigh(name, monkeypatch):
    Q, pi = CASES[name]
    pit = torch.as_tensor(pi).expand(Q.shape[0], -1)
    S, sqp, _ = pmat._sym_parts(Q, pit)
    lam, U, info = cuda_eigh.jacobi_plain(S)
    assert info[:, 0].eq(0).all() and info[:, 1].le(20).all()
    lr, Ur = torch.linalg.eigh(S)
    scale = float(S.abs().max())
    assert float((lam - lr).abs().max()) <= 1e-13 * 61 * scale
    eye = torch.eye(S.shape[-1], dtype=S.dtype)
    assert float((U.transpose(-1, -2) @ U - eye).abs().max()) <= 1e-13
    ts = torch.as_tensor(np.random.default_rng(2).uniform(
        0.001, 1.5, size=(7, Q.shape[0])))
    P = pmat.spectral_P(lam, U, sqp, ts)[1]
    Pr = pmat.spectral_P(lr, Ur, sqp, ts)[1]
    assert float((P - Pr).abs().max()) <= 1e-13 * float(Pr.abs().max())

    # P(t) and its VJP through the fit's route with either eigensolver
    W = torch.as_tensor(np.random.default_rng(3).normal(
        size=ts.shape + Q.shape[1:]))

    def p_and_vjp():
        a = [Q.clone().requires_grad_(), torch.as_tensor(pi),
             ts.clone().requires_grad_()]
        Pv = pmat.pmat_rev_multi(*a)
        return (Pv.detach(),) + torch.autograd.grad((Pv * W).sum(),
                                                    (a[0], a[2]))
    ref = p_and_vjp()
    monkeypatch.setattr(cuda_eigh, "eigh",
                        lambda S: cuda_eigh.jacobi_plain(S)[:2])
    got = p_and_vjp()
    for g, r, tol in zip(got, ref, (1e-13, 1e-11, 1e-11)):
        assert float((g - r).abs().max()) <= tol * float(r.abs().max())


def test_jacobi_status_words(monkeypatch):
    Q, pi = CASES["codon"]
    S = pmat.symmetrize(Q, torch.as_tensor(pi))
    bad = S.clone()
    bad[1, 3, 3] = float("nan")
    lam, U, info = cuda_eigh.jacobi_plain(bad)
    assert info[:, 0].tolist() == [0, 1, 0]
    assert torch.isnan(lam[1]).all() and torch.isnan(U[1]).all()
    assert torch.isfinite(lam[[0, 2]]).all()
    monkeypatch.setattr(cuda_eigh, "MAX_SWEEPS", 2)
    info = cuda_eigh.jacobi_plain(S)[2]
    assert info[:, 0].tolist() == [2, 2, 2] and info[:, 1].tolist() == [2] * 3


def test_eigh_kernel_refuses_cpu_and_wide_matrices():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_eigh.eigh_kernel(torch.eye(4, dtype=torch.float64)[None])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_eigh.eigh_probe(torch.eye(4, dtype=torch.float64)[None])
    assert cuda_eigh.eigh(torch.eye(3, dtype=torch.float64))[0].tolist() == \
        [1.0, 1.0, 1.0]


@pytest.mark.parametrize("name", ["codon", "degenerate", "zero_pi"])
def test_pmat_with_jacobi_matches_jax(name, monkeypatch):
    Q, pi = CASES[name]
    rng = np.random.default_rng(7)
    ts = rng.uniform(0.001, 1.5, size=(5, Q.shape[0]))
    monkeypatch.setattr(cuda_eigh, "eigh",
                        lambda S: cuda_eigh.jacobi_plain(S)[:2])
    P = pmat.pmat_rev_multi(Q, torch.as_tensor(pi), torch.as_tensor(ts))
    Pj = jax.jit(jax_pmat.pmat_rev_multi)(jnp.asarray(Q.numpy()),
                                          jnp.asarray(pi), jnp.asarray(ts))
    assert np.abs(P.numpy() - np.asarray(Pj)).max() <= \
        1e-12 * np.abs(np.asarray(Pj)).max()
