"""Entry points: one value + gradient of the flagship model, and the
pattern mesh's checks.

Port of `__graft_entry__.py`.  `entry()` returns the codon model's -lnL
and gradient step (the flagship compute path: M2a on a synthetic 8-taxon x
96-pattern problem) with its example argument, on the card unless the
caller asks for the CPU, in float64 unless it asks for float32 (the JAX
entry point's own type).  `dryrun_multichip(n)` runs the JAX package's
four multi-device checks on the port's pattern mesh
(`parallel/sharding.py`): the objective's value and gradient, B1/B2 and
B3/B4 per shard, and a whole codeml program, each sharded against
unsharded, in float64, so the checks hold 1e-12 relative on values and
1e-10 of the largest gradient component.
"""
from __future__ import annotations

import numpy as np
import torch


def _synthetic_codon_problem(ns=8, npatt=96, NSsites=2, seed=0, *,
                             device="cuda", dtype=torch.float64):
    """Small self-contained codon problem (no file dependencies): the JAX
    package's, draw for draw, its objective in `dtype`.  Returns (neg_lnl,
    x0, tips, fpatt)."""
    from .apps.codeml import CodemlSpec, make_codon_objective
    from .core.topology import from_treenode
    from .io import seqio, treeio
    from .models.codon import codon_graph

    rng = np.random.default_rng(seed)
    graph = codon_graph(0)
    names = [f"t{i}" for i in range(ns)]
    # ladder tree
    nwk = names[0]
    for nm in names[1:-1]:
        nwk = f"({nwk}, {nm})"
    nwk = f"({nwk}, {names[-2]}x);".replace(f"{names[-2]}x", names[-1])
    tree = treeio.parse_newick(nwk)
    for node in tree.walk_post():
        node.blen = float(rng.uniform(0.02, 0.3))
    topo = from_treenode(tree, names)

    states = rng.integers(0, graph.n, size=(ns, npatt))
    tips = np.zeros((ns, npatt, graph.n))
    tips[np.arange(ns)[:, None], np.arange(npatt)[None, :], states] = 1.0
    fpatt = rng.integers(1, 6, size=npatt).astype(np.float64)
    data = seqio.PackedData(
        names=names, seqtype=1, nstates=graph.n, tip_partials=tips,
        fpatt=fpatt, ls=int(fpatt.sum()),
        posG=np.array([0, npatt]), base_freqs=np.full(graph.n, 1 / graph.n))
    spec = CodemlSpec(NSsites=NSsites, codonf="Fequal", cleandata=True)
    neg_lnl, _unpack, _classes_for, x0, _bounds, _pi = \
        make_codon_objective(data, topo, spec, device=device, dtype=dtype)
    return neg_lnl, np.asarray(x0), tips, fpatt


def entry(device="cuda", dtype=torch.float64):
    """(fn, example_args): fn(x) -> (-lnL, its gradient) on the flagship
    model, computed in `dtype`, x on `device` in `dtype`."""
    neg_lnl, x0, _, _ = _synthetic_codon_problem(device=device, dtype=dtype)

    def step(x):
        x = x.detach().requires_grad_(True)
        val = neg_lnl(x)
        (grad,) = torch.autograd.grad(val, x)
        return val.detach(), grad

    return step, (torch.as_tensor(x0, dtype=dtype, device=device),)


def _balanced_topo(ns: int):
    from .core.topology import from_treenode
    from .io import treeio

    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"

    return from_treenode(treeio.parse_newick(bal(0, ns) + ";"), names)


def _random_kernel_problem(ns: int, H: int, C: int, n: int = 61, seed=0, *,
                           device="cuda"):
    """State-coded-tip kernel inputs (the encoding of clean codon data) on
    a balanced ns-taxon tree, the JAX package's draws in float64:
    (P, tips, topo, pi)."""
    rng = np.random.default_rng(seed)
    topo = _balanced_topo(ns)
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = P / P.sum(-1, keepdims=True)
    P = 0.7 * np.eye(n)[None, None] + 0.3 * P
    pi = rng.dirichlet(np.ones(n), size=C)
    tips = rng.integers(0, n, size=(ns, H)).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)
    return t(P), t(tips), topo, t(pi)


def _close(got: float, want: float, what: str) -> None:
    if not abs(got - want) <= 1e-12 * max(1.0, abs(want)):
        raise AssertionError(f"{what}: sharded {got!r} != unsharded {want!r}")


def _grad_close(got, want, what: str) -> None:
    gd = float((got - want).abs().max())
    gr = float(want.abs().max())
    if not gd <= 1e-10 * max(1.0, gr):
        raise AssertionError(f"{what}: sharded gradient off by {gd} (of "
                             f"{gr})")


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The pattern mesh's checks on `devices` (default: the first
    n_devices cards; repeats allowed, e.g. ["cuda:0", "cuda:0"] or
    ["cpu"] * n), at the JAX package's shapes (64 taxa, 2048 site
    patterns, 61 states):

    1. the full codon training step (value + gradient + update; M2a) with
       the pattern axis sharded, against unsharded;
    2. B1/B2 (coded tips with a table: the same states with 1 in 20 cells
       a gap) per shard, forward and gradient, against unsharded;
    3. B3/B4 (state codes) per shard, against unsharded;
    4. a codeml program (`run_codeml` on a 6-taxon x 120-codon control
       file, M0) on the mesh, its lnL against unsharded.

    On CPU tensors the shards run the plain version.  Returns the values
    of each step."""
    import os
    import re
    import tempfile

    from .__main__ import run_codeml
    from .constants import codon_string
    from .core import pruning
    from .core.tipcodes import encode
    from .models.codon import codon_graph
    from .parallel.sharding import data_mesh

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    mesh = data_mesh(devices)
    home = mesh.devices[0]
    before = pruning.pattern_mesh()
    out = {}

    def on_mesh(fn):
        pruning.set_pattern_mesh(mesh)
        try:
            return fn()
        finally:
            pruning.set_pattern_mesh(before)

    # -- 1. full training step, 64 taxa x 2048 patterns, M2a mixture -----
    neg_lnl, x0, _, _ = _synthetic_codon_problem(ns=64, npatt=2048,
                                                 device=home)

    def train_step():
        x = torch.as_tensor(x0, device=home).requires_grad_(True)
        val = neg_lnl(x)
        (grad,) = torch.autograd.grad(val, x)
        return float(val.detach()), grad, (x - 1e-3 * grad).detach()

    v1, g1, _ = train_step()
    val, grad, x_new = on_mesh(train_step)
    if not np.isfinite(val):
        raise AssertionError("non-finite loss in multichip dry run")
    _close(val, v1, "step 1 (64 x 2048 objective)")
    _grad_close(grad, g1, "step 1 (64 x 2048 objective)")
    out["step1"] = dict(lnL=-val, x_new=x_new.cpu().numpy())
    print(f"dryrun_multichip({n_devices}): step 1 (64x2048 objective) "
          f"lnL={-val:.4f} sharded==unsharded ok")

    # -- 2./3. the kernels per shard -------------------------------------
    P, ktips, topo, pi = _random_kernel_problem(64, 2048, 2, seed=1,
                                                device=home)
    w = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2.0, 2048),
                        device=home)
    rng = np.random.default_rng(3)
    dense = torch.nn.functional.one_hot(ktips.long(), 61).double()
    dense[torch.as_tensor(rng.random(ktips.shape) < 0.05,
                          device=home)] = 1.0
    gapped = encode(dense).to(home, torch.float64)

    def wsum_grad(tips):
        Pg = P.detach().requires_grad_(True)
        v = (w * pruning.class_site_lnf(Pg, tips, topo, pi).sum(0)).sum()
        (g,) = torch.autograd.grad(v, Pg)
        return float(v.detach()), g

    for step, tips, pair in ((2, gapped, "B1/B2"), (3, ktips, "B3/B4")):
        ref, gref = wsum_grad(tips)
        got, g = on_mesh(lambda tips=tips: wsum_grad(tips))
        _close(got, ref, f"step {step} ({pair} per shard)")
        _grad_close(g, gref, f"step {step} ({pair} per shard)")
        out[f"step{step}"] = got
        print(f"dryrun_multichip({n_devices}): step {step} ({pair} per "
              f"shard, 64x2048) fwd+grad ok")

    # -- 4. a codeml program on the mesh ---------------------------------
    rng = np.random.default_rng(7)
    graph = codon_graph(0)
    ns_cli, ncod = 6, 120
    names = [f"sp{i}" for i in range(ns_cli)]
    anc = rng.integers(0, graph.n, size=ncod)
    rows = []
    for i in range(ns_cli):
        s = anc.copy()
        nmut = rng.integers(5, 20)
        s[rng.integers(0, ncod, nmut)] = rng.integers(0, graph.n, nmut)
        rows.append("".join(codon_string(int(graph.sense[c])) for c in s))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        with open(f"{td}/seq.txt", "w") as f:
            f.write(f" {ns_cli} {3 * ncod}\n")
            for nm, r in zip(names, rows):
                f.write(f"{nm}  {r}\n")
        nwk = "(" + ",".join(f"({names[i]},{names[i + 1]})"
                             for i in (0, 2, 4)) + ");"
        with open(f"{td}/t.trees", "w") as f:
            f.write(f" {ns_cli} 1\n{nwk}\n")
        with open(f"{td}/codeml.ctl", "w") as f:
            f.write("seqfile = seq.txt\ntreefile = t.trees\n"
                    "outfile = mlc\nseqtype = 1\nCodonFreq = 2\n"
                    "model = 0\nNSsites = 0\ncleandata = 1\n")

        def lnl_of_run():
            run_codeml(f"{td}/codeml.ctl", str(home))
            txt = open(f"{td}/mlc").read()
            return float(re.search(r"lnL.*?(-\d+\.\d+)", txt).group(1))

        try:
            os.chdir(td)
            lnl_rep = lnl_of_run()
            lnl_sh = on_mesh(lnl_of_run)
        finally:
            os.chdir(cwd)
    if not abs(lnl_sh - lnl_rep) <= 1e-6 * max(1.0, abs(lnl_rep)):
        raise AssertionError(f"sharded CLI fit lnL {lnl_sh} != unsharded "
                             f"{lnl_rep}")
    out["step4"] = lnl_sh
    print(f"dryrun_multichip({n_devices}): step 4 (CLI ctl fit on the "
          f"mesh) lnL={lnl_sh:.6f} sharded==unsharded ok")
    return out
