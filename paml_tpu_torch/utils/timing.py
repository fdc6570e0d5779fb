"""Per-phase wall-clock instrumentation (SURVEY.md section 5.1).

The reference keeps global work counters (NFunCall/NEigenQ/NPMatUVRoot,
printed at src/codeml.c:770) and a start/print timer (src/tools.c:1086).
Here: a nestable phase timer plus an optional `torch.profiler` trace.

Port of `paml_tpu/utils/timing.py`: `phase`, `report` and `reset` as
there; the JAX package's `xla_trace` becomes `torch_trace`, a
`torch.profiler` capture of the CPU and, when there is one, the CUDA card.

    with phase("optimize"):
        ...
    report()              # prints per-phase totals and counts

    with torch_trace("trace_dir"):  # a Chrome trace, one file per capture
        step(x)
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TOTALS[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def report(out=None) -> dict:
    """Per-phase totals; prints a table when `out` is a stream."""
    rows = {k: dict(seconds=round(_TOTALS[k], 3), calls=_COUNTS[k])
            for k in sorted(_TOTALS)}
    if out is not None:
        out.write(f"{'phase':<24s} {'seconds':>10s} {'calls':>8s}\n")
        for k, v in rows.items():
            out.write(f"{k:<24s} {v['seconds']:>10.3f} {v['calls']:>8d}\n")
    return rows


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Capture a `torch.profiler` trace around the block and write it to
    `logdir` as a Chrome trace (open in chrome://tracing or Perfetto)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
