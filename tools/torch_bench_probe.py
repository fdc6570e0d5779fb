#!/usr/bin/env python3
"""Where the bench's primary step spends the card's time, dispatched step
by step and replayed from a CUDA graph.

    python3 tools/torch_bench_probe.py

Builds the kernels, then takes `paml_tpu_torch.bench`'s primary problem
(M3, 32 taxa x 4096 patterns, float32, B3/B4) and, under `torch.profiler`,
one window of 5 dispatched value + gradient steps (float32, then float64)
and one of 2 replays of the bench's 30-step graph: per step the device
operations, the device busy time, the wall time and the device's idle
share of it, and the five largest device kernels.  Last line: all of it
as JSON.  Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_bench_probe: no CUDA device", file=sys.stderr)
        return 2
    from torch_f32_probe import profile_window

    from paml_tpu_torch import _build, bench

    _build.lib()
    card = torch.cuda.get_device_name(0)
    out = {"card": card}

    def record(tag, fn, reps, steps):
        ops, busy, wall, top, _ = profile_window(torch, fn, reps=reps)
        r = dict(device_ops=ops / steps, busy_ms=busy / steps,
                 wall_ms=wall / steps, idle=1.0 - busy / wall,
                 top=[(k, v / steps) for k, v in top])
        out[tag] = r
        print(f"{tag} [{card}]: per step {r['device_ops']:.0f} device ops, "
              f"busy {r['busy_ms']:.3f} of {r['wall_ms']:.3f} ms (idle "
              f"{r['idle']:.3f}); " + "; ".join(
                  f"{k} {v:.3f}" for k, v in r["top"]), flush=True)

    for dt in (torch.float32, torch.float64):
        neg, x = bench.primary_problem("cuda", dt)
        step = bench.value_and_grad(neg)
        record(f"dispatched {str(dt)[6:]}", lambda: step(x), 5, 1)
    neg, x = bench.primary_problem("cuda")
    body, _ = bench.fused_body(bench.value_and_grad(neg), x)
    graph, _ = bench.capture(body)
    record("graph float32", graph.replay, 2, bench.N_FUSED)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
