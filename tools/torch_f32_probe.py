#!/usr/bin/env python3
"""Where a float32 evaluation's time goes at the bench shape on one CUDA
card, beside float64's.

    python3 tools/torch_f32_probe.py

Builds the kernels, simulates chip_smoke's bench alignment (32 taxa x 4096
codons under M0, clean: B3/B4), then for M0 and M2a in float32 and
float64: ms per value + gradient (median of 10, host clock with a sync),
and one window of 5 evaluations under `torch.profiler`: device operations
per evaluation, device busy time, the device's idle share of the wall,
and the five largest device kernels.  Then P(t) alone at M2a's 3 classes
x 63 branches (chip_smoke's 13a matrices), forward + backward, under the
profiler: autograd nodes and products (`bmm`) per call and host ms.  Last
line: all of it as JSON.  Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_window(torch, fn, reps=5):
    """(device ops per call, device busy ms per call, wall ms per call,
    the five largest device kernels by ms per call, host events) of fn
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    events = prof.events()
    dev = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
    by_name = {}
    for e in dev:
        by_name[e.name[:50]] = (by_name.get(e.name[:50], 0.0)
                                + e.time_range.elapsed_us() / reps / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    host = [e for e in events if e.device_type.name == "CPU"]
    return len(dev) / reps, busy, wall, top, host


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paml_tpu_torch import _build
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import pmat

    _build.build()
    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(cs.SEED)
    clean, topo, _ = cs.simulate_m0(torch, rng, 32, 4096)
    out = {"card": card, "evaluations": {}}
    for name, ns in (("M0", 0), ("M2a", 2)):
        spec = codeml.CodemlSpec(NSsites=ns, codonf="F3x4")
        for dt in (torch.float32, torch.float64):
            neg, _, _, x0, _, _ = codeml.make_codon_objective(
                clean, topo, spec, device="cuda", dtype=dt)
            walls = []
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cs.value_grad(torch, neg, x0)
                walls.append(time.perf_counter() - t0)
            ops, busy, wall, top, _ = profile_window(
                torch, lambda: cs.value_grad(torch, neg, x0))
            r = dict(ms=1e3 * float(np.median(walls[1:])), device_ops=ops,
                     busy_ms=busy, profiled_wall_ms=wall,
                     idle=1.0 - busy / wall, top=top)
            out["evaluations"][f"{name} {str(dt)[6:]}"] = r
            print(f"{name} {str(dt)[6:]} [{card}]: {r['ms']:.2f} ms per "
                  f"value + gradient; profiled {ops:.0f} device ops, busy "
                  f"{busy:.2f} of {wall:.2f} ms (idle {r['idle']:.3f}); "
                  + "; ".join(f"{k} {v:.3f}" for k, v in top), flush=True)
    neg = codeml.make_codon_objective(
        clean, topo, codeml.CodemlSpec(NSsites=2, codonf="F3x4"),
        device="cuda")[0]
    Qs, pi, ts = cs.bench_Qs(torch, neg, topo, torch.float32)
    ct = torch.randn(ts.shape + (61, 61), device="cuda")
    Ql, tl = Qs.requires_grad_(True), ts.requires_grad_(True)

    def fwd_bwd():
        torch.autograd.grad((pmat.pmat_rev_multi(Ql, pi, tl) * ct).sum(),
                            (Ql, tl))
    ops, busy, wall, top, host = profile_window(torch, fwd_bwd)
    nodes = sum(1 for e in host if e.name.startswith(
        "autograd::engine::evaluate_function")) / 5
    bmm = sum(1 for e in host if e.name == "aten::bmm") / 5
    out["pmat_f32_fwd_bwd"] = dict(device_ops=ops, busy_ms=busy,
                                   wall_ms=wall, autograd_nodes=nodes,
                                   bmm=bmm)
    print(f"float32 P(t) forward + backward, {tuple(ts.shape)} [{card}]: "
          f"{wall:.2f} ms, {ops:.0f} device ops, busy {busy:.2f} ms, "
          f"{nodes:.0f} autograd nodes, {bmm:.0f} bmm", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
