"""Benchmark of the port on one CUDA card: site-pattern value + gradient
evaluations per second (61-state codon), as `bench.py` prints them.

    python -m paml_tpu_torch.bench

Counterpart of the repository's `bench.py` (the JAX package's bench, which
stays as it is).  It times the card and never the CPU: without a CUDA
device it exits 2 and prints no result.  The kernels are built from
`csrc/` at their first use.  The last line of standard output is one JSON
object, bench.py's:

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "extra": {"primary_ms_per_eval", "mfu_vs_fp32_peak", "big_ms_per_eval",
             "f32_rel", "detail_file"}}

and the detail goes to BENCH_TORCH_DETAIL.json in the working directory.

Primary workload (bench.py :6-11, :303-326): value + gradient of an M3
codon log-likelihood (NSsites = 3, three site classes, Fequal) in float32
on the synthetic 32-taxon ladder x 4096 patterns of
`entry._synthetic_codon_problem(seed=1)`.  The tips are state codes, so
B3/B4 (`csrc/pruning_big.cu`) carry it.

Timing: `primary_ms_per_eval` runs 30 steps at x + 1e-6 i back to back in
one CUDA graph (bench.py's `lax.scan` under one `jit`, :65-92): the carry
c + v + sum(g) 1e-30, a warm-up on a side stream before the capture, 3
replays timed between synchronizations.  The graph's step 0 must equal an
eager step at the same x bit for bit: the same kernels in the same order.
`primary_ms_per_eval_with_dispatch` is the eager loop (bench.py's
`_time_steps`, :53-62: 12 warm-up steps, 30 timed).  The LAUNCHES counters
count host launches: 30 per kernel at the capture, none during a replay;
the kernels a replay runs are counted under `torch.profiler`.  One step
runs under `torch.cuda.set_sync_debug_mode("error")`: it must not
synchronize with the host, or it could not be captured.

Derived as bench.py derives them: `value` (site patterns per second) and
`vs_baseline` against the C reference's 5.32e5 branch-class-pattern
updates per second (a CPU number: bench.py :28-33, :40);
`mfu_vs_fp32_peak`, bench.py's model FLOPs (4 x (nnode - 1) x K x npatt x
2 x 61^2, :327-332) per second over 67 TFLOP/s, the H100 SXM's FP32 rate
outside the tensor cores (the unit of the float32 kernels' bound), and
beside it the same share of B3/B4's own products (`kernel_work`: none at
a tip, so 62 / 30 times fewer on the 32-taxon ladder);
`phase_split.model_at_fwd_ms`, P(t) construction alone, captured and
replayed the same way; `f32_rel`, the card's float32 lnL against the same
objective on CPU tensors in float32 (the plain version; bench.py
:384-395).  The 1024-taxon branch-site A shape (bench.py :95-135), float32
in 10 pattern chunks, is timed per step (3 + 5), beside the bound of its
B3/B4 launches (`cuda_pruning.kernel_work`, `bound_ms`).  The on-device
fit is `optim.maximize_device_bounded` on M0 F3x4 in float32 on
tests/data/clock56.codon with the first tree of clock56.trees, its
line-search trials replayed from a CUDA graph (captures, replays,
evaluations and stop-flag reads in the detail); the card's
value and gradient at the start and at the fitted x go into the detail
beside those of the same objective on CPU tensors, and the fit's lnL
beside the float64 optimum.

Not ported: bench.py's `--parity`, its abglobin fit and
`bench_examples.py`, which read the reference's example files; its
`convergence_wall_times` and `onchip_parity`, which are the JAX package's
numbers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .core import cuda_pruning
from .core.cuda_pruning import (INSTANCE_LAUNCHES, LAUNCHES, bound_ms,
                                kernel_work)
from .core.graphs import capture, replay_kernels

# the H100 SXM's FP32 rate outside the tensor cores (the float32 kernels'
# bound), 67 TFLOP/s
PEAK_FP32 = cuda_pruning.PEAK_FLOPS

REF_UPDATES_PER_SEC = 5.32e5     # reference codeml, measured (bench.py :28)

NS_TAXA = 32
NPATT = 4096
K_CLASSES = 3                    # NSsites = 3 (M3) with ncatG = 3
N_STATES = 61

BIG_TAXA = 1024
BIG_NPATT = 10240
BIG_CHUNKS = 10

N_FUSED = 30                     # steps per graph (bench.py :65)
REPLAYS = 3
DETAIL_FILE = "BENCH_TORCH_DETAIL.json"
# the float64 optimum of the clock56 M0 F3x4 fit (scipy `maximize` and
# the JAX package's `maximize_jax_bounded`, both in float64)
CLOCK56_M0_F64_LNL = -1560.3374773
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data")


def model_flops(ns: int, npatt: int, K: int, n: int = N_STATES) -> float:
    """bench.py's model FLOPs of one value + gradient (:327-332): the
    products of the forward, 2 n^2 per branch, class and pattern, on a
    rooted binary tree of 2 ns - 1 nodes, x 4 for the analytic-adjoint
    value + gradient."""
    return 4.0 * (2 * ns - 2) * K * npatt * 2 * n * n


def kernel_flops(topo, K: int, npatt: int, n: int = N_STATES) -> float:
    """B3's and B4's own products in one value + gradient (`kernel_work`:
    a tip is a gather, so only the non-root internal nodes multiply)."""
    tree = cuda_pruning.big_tree(topo)
    return sum(kernel_work(k, tree, K, npatt, n, 4)[0]
               for k in ("big_fwd", "big_bwd"))


def primary_problem(device, dtype=torch.float32, ns=NS_TAXA, npatt=NPATT):
    """bench.py's primary problem (:309-310): (neg_lnl, x) with x in dtype
    on device, the JAX package's x0 (float32) as it hands it over."""
    from .entry import _synthetic_codon_problem

    neg, x0, _, _ = _synthetic_codon_problem(ns=ns, npatt=npatt, NSsites=3,
                                             seed=1, device=device,
                                             dtype=dtype)
    return neg, torch.as_tensor(np.asarray(x0, np.float32), dtype=dtype,
                                device=device)


def big_branchsite_problem(device, dtype=torch.float32, ns=BIG_TAXA,
                           npatt=BIG_NPATT, n_chunks=BIG_CHUNKS, seed=7):
    """bench.py's `_big_branchsite_problem` (:95-135), draw for draw:
    branch-site model A on a balanced ns-taxon tree (#1 on the root's left
    subtree), random state codes over npatt patterns, the objective in
    n_chunks pattern chunks.  Returns (neg_lnl, x0 float32, states,
    fpatt)."""
    from .apps.codeml import CodemlSpec, make_codon_objective
    from .core.topology import from_treenode
    from .io import seqio, treeio
    from .models.codon import codon_graph

    rng = np.random.default_rng(seed)
    graph = codon_graph(0)
    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        mid = (lo + hi) // 2
        return f"({bal(lo, mid)},{bal(mid, hi)})"
    nwk = f"({bal(0, ns // 2)} #1,{bal(ns // 2, ns)});"
    tree = treeio.parse_newick(nwk)
    for node in tree.walk_post():
        node.blen = float(rng.uniform(0.02, 0.3))
    topo = from_treenode(tree, names)
    states = rng.integers(0, graph.n, size=(ns, npatt)).astype(np.int32)
    fpatt = rng.integers(1, 6, size=npatt).astype(np.float32)
    data = seqio.PackedData(
        names=names, seqtype=1, nstates=graph.n, tip_partials=states,
        fpatt=fpatt, ls=int(fpatt.sum()), posG=np.array([0, npatt]),
        base_freqs=np.full(graph.n, 1 / graph.n))
    spec = CodemlSpec(NSsites=2, model=2, codonf="Fequal", cleandata=True,
                      omega=1.5)
    neg, _, _, x0, _, _ = make_codon_objective(data, topo, spec,
                                               device=device, dtype=dtype,
                                               n_chunks=n_chunks)
    return neg, np.asarray(x0, np.float32), states, fpatt


def value_and_grad(neg):
    """step(x) -> (-lnL, its gradient), both detached."""
    def step(x):
        x = x.detach().requires_grad_(True)
        v = neg(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g
    return step


def fused_body(step, x, n_iter=N_FUSED):
    """(body, outputs): body() runs n_iter steps at x + 1e-6 i back to
    back, carrying c + v + sum(g) 1e-30 (bench.py :77-81), and writes the
    carry to outputs["total"] and step 0's value and gradient to
    outputs["v0"], outputs["g0"]; x stays the input buffer."""
    out = {"total": x.new_zeros(()), "v0": x.new_zeros(()),
           "g0": torch.zeros_like(x)}

    def body():
        c = x.new_zeros(())
        for i in range(n_iter):
            v, g = step(x + 1e-6 * i)
            if i == 0:
                out["v0"].copy_(v)
                out["g0"].copy_(g)
            c = c + v + g.sum() * 1e-30
        out["total"].copy_(c)
    return body, out


def model_at_body(neg, x, n_iter=N_FUSED):
    """(body, outputs) of bench.py's `ma_scan` (:337-345): n_iter P(t)
    constructions at x + 1e-6 i, every P and the class weights summed
    into the carry, so that none of them is skipped."""
    out = {"total": x.new_zeros(())}

    def body():
        with torch.no_grad():
            c = x.new_zeros(())
            for i in range(n_iter):
                P, _, fr = neg.model_at(x + 1e-6 * i)
                c = c + P.sum() + fr.sum()
            out["total"].copy_(c)
    return body, out


def _counts() -> dict:
    """The wrappers' launch counts, by kernel and by instance
    (`big_fwd_n64`, ...)."""
    return {**LAUNCHES, **INSTANCE_LAUNCHES}


def launches_of(fn, *args, **kw):
    """(fn(*args, **kw), the kernel launches it made, by wrapper and by
    instance)."""
    before = _counts()
    out = fn(*args, **kw)
    return out, {k: v - before[k] for k, v in _counts().items()}


# launches made only to check a result (the graph's step 0 against an
# eager step, the fit's card against the CPU), kept out of the path's
CHECK_LAUNCHES = dict.fromkeys(_counts(), 0)


def checked(fn, *args):
    """fn(*args), its launches counted in CHECK_LAUNCHES."""
    out, launches = launches_of(fn, *args)
    for k, v in launches.items():
        CHECK_LAUNCHES[k] += v
    return out


def time_replays(graph, n_iter=N_FUSED, reps=REPLAYS) -> float:
    """Seconds per step: one replay to warm, then reps replays between
    synchronizations (bench.py :84-89)."""
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        graph.replay()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (reps * n_iter)


def time_steps(step, x, n_iter=30, warmup=12):
    """bench.py's `_time_steps` (:53-62): seconds per eagerly dispatched
    step, and the last step's output."""
    for i in range(warmup):
        out = step(x + 1e-6 * i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_iter):
        out = step(x + 1e-6 * i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_iter, out


def _require_big_pair(launches: dict, what: str, n: int | None = None
                      ) -> None:
    """B3 and B4 launched (n times each, where n is given), B1/B2 never."""
    fwd, bwd = launches["big_fwd"], launches["big_bwd"]
    ok = fwd and bwd if n is None else fwd == bwd == n
    if launches["pruning_fwd"] or launches["pruning_bwd"] or not ok:
        raise AssertionError(f"{what}: B3/B4 must carry it alone, launches "
                             f"{launches}")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _log(msg: str) -> None:
    print(f"paml_tpu_torch.bench: {msg}", file=sys.stderr, flush=True)


def primary(detail: dict) -> dict:
    """The primary workload: the sync-free check, the eager and the graph
    timings, step 0 against an eager step, the phase split, float64's
    eager time and f32_rel.  Fills `detail`; returns the numbers the last
    line needs."""
    neg, x = primary_problem("cuda")
    step = value_and_grad(neg)
    (v, _), first = launches_of(step, x)
    torch.cuda.synchronize()
    _require_big_pair(first, "the primary step")
    if not bool(torch.isfinite(v)):
        raise AssertionError("non-finite benchmark loss")
    # an evaluation that synchronizes with the host cannot be captured
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    (dt_dispatch, _), eager_launches = launches_of(time_steps, step, x)
    _require_big_pair(eager_launches, "the dispatched steps", 42)

    body, out = fused_body(step, x)
    graph, at_capture = capture(body)
    _require_big_pair(at_capture, "the captured steps", N_FUSED)
    dt, during = launches_of(time_replays, graph)
    if any(during.values()):
        raise AssertionError("a replay went through a wrapper")
    if not bool(torch.isfinite(out["total"])):
        raise AssertionError("non-finite fused benchmark total")
    per_replay = replay_kernels(graph)
    v_e, g_e = checked(step, x + 1e-6 * 0)
    same = (torch.equal(out["v0"], v_e), torch.equal(out["g0"], g_e))
    detail["graph"] = {
        "steps": N_FUSED, "replays_timed": REPLAYS,
        # 1 + REPLAYS timed, 1 profiled
        "replays": REPLAYS + 2,
        "launches_at_capture": at_capture,
        # counted by kernel name under the profiler
        "launches_per_replay": per_replay,
        "step0_equal_eager": all(same), "step0_value": float(out["v0"]),
        "eager_value": float(v_e),
        "step0_grad_max_abs_diff": float((out["g0"] - g_e).abs().max())}
    if not all(same):
        raise AssertionError(
            f"the graph's step 0 is not the eager step bit for bit: value "
            f"{float(out['v0'])!r} against {float(v_e)!r}, gradient "
            f"{detail['graph']['step0_grad_max_abs_diff']!r} off")
    del graph, body, out

    mbody, mout = model_at_body(neg, x)
    mgraph, m_launches = capture(mbody)
    if any(m_launches.values()):
        raise AssertionError(f"P(t) launched a pruning kernel: {m_launches}")
    model_dt = time_replays(mgraph)
    del mgraph, mbody, mout

    neg64, x64 = primary_problem("cuda", torch.float64)
    dt64, _ = time_steps(value_and_grad(neg64), x64)
    del neg64

    neg_cpu, x_cpu = primary_problem("cpu", torch.float32)
    v_cpu = float(neg_cpu(x_cpu))
    # both at x (bench.py compares the last timed step's value, at x +
    # 29e-6, with the CPU's at x)
    f32_err = abs(float(v) - v_cpu)
    f32_rel = f32_err / abs(v_cpu)

    flops = model_flops(NS_TAXA, NPATT, K_CLASSES)
    kflops = kernel_flops(neg.topo, K_CLASSES, NPATT)
    detail.update(
        primary_shape=f"{NS_TAXA} taxa (ladder) x {NPATT} patterns x "
                      f"{N_STATES} states x {K_CLASSES} classes, M3, "
                      "float32",
        primary_ms_per_eval=dt * 1e3,
        primary_ms_per_eval_with_dispatch=dt_dispatch * 1e3,
        primary_f64_ms_per_eval_with_dispatch=dt64 * 1e3,
        launches_eager={"steps": 30 + 12, **eager_launches},
        host_syncs_per_eval=0,
        model_flops_per_eval=flops,
        peak_fp32_flops=PEAK_FP32,
        mfu_vs_fp32_peak=flops / dt / PEAK_FP32,
        # B3/B4's own products (no product at a tip): model / kernel
        # FLOPs = 62 / 30 on the ladder
        kernel_flops_per_eval=kflops,
        kernel_flops_share_of_fp32_peak=kflops / dt / PEAK_FP32,
        phase_split={"model_at_fwd_ms": model_dt * 1e3,
                     "fused_step_ms": dt * 1e3,
                     "note": "model_at = Q build + uniformization P(t); "
                             "remainder = B3 + B4, the objective's "
                             "autograd and its small kernels"},
        card_vs_cpu_f32_lnl_absdiff=f32_err,
        card_vs_cpu_f32_lnl_reldiff=f32_rel)
    return dict(dt=dt, f32_rel=f32_rel)


def big(detail: dict) -> float:
    """The 1024-taxon branch-site A shape in float32 and 10 chunks, per
    eagerly dispatched step (3 + 5), beside its B3/B4 launches' bound."""
    neg, x0, _, _ = big_branchsite_problem("cuda")
    x = torch.as_tensor(x0, device="cuda")
    step = value_and_grad(neg)
    (bdt, (bv, _)), launches = launches_of(time_steps, step, x, n_iter=5,
                                           warmup=3)
    _require_big_pair(launches, "the 1024-taxon step")
    if not bool(torch.isfinite(bv)):
        raise AssertionError("non-finite big-shape loss")
    per_eval = {k: v / 8 for k, v in launches.items() if v}
    tree = cuda_pruning.big_tree(neg.topo)
    work = {k: kernel_work(k, tree, 4, BIG_NPATT // BIG_CHUNKS, N_STATES, 4)
            for k in per_eval}
    bounds = {k: bound_ms(*w) for k, w in work.items()}
    bound_eval = sum(per_eval[k] * bounds[k] for k in per_eval)
    by_ops = all(f / PEAK_FP32 >= b / cuda_pruning.PEAK_BYTES
                 for f, b in work.values())
    detail.update(
        big_shape=f"{BIG_TAXA} taxa (balanced) x {BIG_NPATT} patterns "
                  f"branch-site A, float32, {BIG_CHUNKS} chunks",
        big_pattern_evals_per_sec=BIG_NPATT / bdt,
        big_ms_per_eval=bdt * 1e3,
        big_roofline={
            "launches_per_eval": per_eval,
            "bound_ms_per_launch": bounds,
            "bound_by": "operations" if by_ops else "bytes",
            "bound_ms_per_eval": bound_eval,
            "share_of_step": bound_eval / (bdt * 1e3),
            "note": "B3 runs twice per chunk (the checkpoint's forward and "
                    "its recomputation), B4 once; the bound counts the "
                    "kernels alone"})
    return bdt


def clock56_objective(device):
    """The M0 F3x4 objective on tests/data/clock56.codon and the first
    tree of clock56.trees in float32 on device: (neg_lnl, x0, bounds,
    ns, npatt)."""
    from .apps.codeml import CodemlSpec, make_codon_objective
    from .core.topology import from_treenode
    from .io import seqio, treeio

    aln = seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                               seqio.CODON_SEQ)
    data = seqio.pack(aln, cleandata=True, icode=0)
    topo = from_treenode(treeio.read_trees(
        os.path.join(DATA, "clock56.trees"), data.names)[0], data.names)
    neg, _, _, x0, bounds, _ = make_codon_objective(
        data, topo, CodemlSpec(cleandata=True), device=device,
        dtype=torch.float32)
    return neg, x0, bounds, data.ns, data.npatt


def value_grad_gap(neg, neg_cpu, x, device="cuda") -> dict:
    """neg's float32 value and gradient at x, on device, against the same
    objective's on CPU tensors (the plain version): the relative value
    gap, the largest gradient gap and the CPU gradient's largest
    component."""
    xt = torch.as_tensor(np.asarray(x), dtype=torch.float32)
    v, g = checked(value_and_grad(neg), xt.to(device))
    vc, gc = value_and_grad(neg_cpu)(xt)
    return {"value_rel": abs(float(v) - float(vc)) / abs(float(vc)),
            "grad_abs": float((g.cpu() - gc).abs().max()),
            "grad_max": float(gc.abs().max())}


def device_fit(detail: dict) -> None:
    """`maximize_device_bounded` on M0 F3x4 in float32 on clock56.codon
    (bench.py :454-480 fits abglobin, whose files the repository lacks),
    its line-search trials replayed from a CUDA graph (`optim._lbfgs_run`):
    one capture, the start evaluated op by op, every other evaluation
    replayed; at the start and at the fitted x, the card's value and
    gradient against the CPU's.  At the optimum the gradient is float32
    noise (its largest component 5.6e-4 in float64 on the CPU, float32's
    1.1e-4 off it), so its gap is read against the largest component at
    the start."""
    from .core import optim

    neg, x0, bounds, ns, npatt = clock56_objective("cuda")
    before = {**optim.CHECKS, **optim.GRAPHS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (xf, lnl, it), launches = launches_of(
        optim.maximize_device_bounded, neg, x0, bounds, device="cuda",
        dtype=torch.float32)
    wall = time.perf_counter() - t0
    checks = {k: v - before[k]
              for k, v in {**optim.CHECKS, **optim.GRAPHS}.items()}
    _require_big_pair(launches, "the device fit")
    if checks["captures"] != 1 or checks["eager_evals"] != 1 or \
            not checks["graphed_evals"]:
        raise AssertionError(f"the device fit must replay its CUDA graph: "
                             f"{checks}")
    neg_cpu = clock56_objective("cpu")[0]
    detail["onchip_fit_clock56_M0"] = {
        "config": f"tests/data/clock56.codon ({ns} taxa x {npatt} "
                  "patterns), M0 F3x4, float32",
        "wall_s": wall, "lnL": lnl, "iters": it,
        "evaluations": checks["graphed_evals"] + checks["eager_evals"],
        "trials": checks["trials"], "captures": checks["captures"],
        "replays": checks["graphed_evals"] // optim.CHECK_EVERY,
        "stop_reads": checks["reads"], "launches": launches,
        "lnL_gap_vs_f64_optimum": lnl - CLOCK56_M0_F64_LNL,
        "card_vs_cpu_at_start": value_grad_gap(neg, neg_cpu, x0),
        "card_vs_cpu_at_fit": value_grad_gap(neg, neg_cpu, xf)}


def main() -> int:
    if not torch.cuda.is_available():
        print("paml_tpu_torch.bench: no CUDA device; the bench times the "
              "card and never the CPU", file=sys.stderr)
        return 2
    from . import _build

    card = _card()
    _log(card)
    t0 = time.perf_counter()
    _build.lib()
    detail = {"card": card, "kind": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
              "kernel_build_s": time.perf_counter() - t0}
    p = primary(detail)
    _log(f"primary {detail['primary_ms_per_eval']:.3f} ms per eval (graph), "
         f"{detail['primary_ms_per_eval_with_dispatch']:.3f} dispatched")
    torch.cuda.empty_cache()
    bdt = big(detail)
    _log(f"1024 taxa {bdt * 1e3:.1f} ms per eval")
    torch.cuda.empty_cache()
    device_fit(detail)
    dt = p["dt"]
    evals_per_sec = 1.0 / dt
    nbranch = 2 * NS_TAXA - 2      # the ladder of the synthetic problem
    updates_per_sec = evals_per_sec * NPATT * nbranch * K_CLASSES
    detail["bench_s"] = time.perf_counter() - t0
    # the path's host launches (a graph's counted once), checks left out
    detail["launches_total"] = {k: v - CHECK_LAUNCHES[k]
                                for k, v in _counts().items()}
    detail["launches_of_checks"] = dict(CHECK_LAUNCHES)
    _require_big_pair(detail["launches_total"], "the bench")
    with open(DETAIL_FILE, "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({
        "metric": "codon61_sitepattern_lnl+grad_evals_per_sec_per_chip",
        "value": round(evals_per_sec * NPATT, 1),
        "unit": "site-pattern-evals/s",
        "vs_baseline": round(updates_per_sec / REF_UPDATES_PER_SEC, 2),
        "extra": {
            "primary_ms_per_eval": round(dt * 1e3, 4),
            "mfu_vs_fp32_peak": round(detail["mfu_vs_fp32_peak"], 4),
            "big_ms_per_eval": round(bdt * 1e3, 2),
            "f32_rel": p["f32_rel"],
            "detail_file": DETAIL_FILE,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
