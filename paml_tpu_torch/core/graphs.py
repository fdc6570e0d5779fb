"""CUDA graphs of fixed-shape work: the port's counterpart of `jax.jit`.

The JAX package compiles its objectives: `maximize` evaluates through
`jax.jit(jax.value_and_grad(neg_fn))` (paml_tpu/core/optim.py:62), and the
device L-BFGS runs under one `jit` (:213-244, :283-310).  PyTorch runs
eagerly, one launch per operation, and at the bench shape a value +
gradient is ~400-650 launches whose dispatch leaves the card idle most of
the time.  A CUDA graph records the launches of one evaluation once and
replays them as one: the same kernels on the same buffers, so the same
bits as the eager evaluation, at the device's own pace.

What a graph needs of the work it records: fixed shapes, no host read of
the device (a read cannot be recorded, and the capture fails), and inputs
and outputs in buffers that outlive it (`GraphedValueGrad`'s static x and
output).  Failure states that a kernel would otherwise report on the host
(`cuda_eigh`'s no convergence) go to device tensors instead: inside a
`status_sink` they are collected and folded into the work's own output,
for the host to read with the copy it makes anyway; outside one,
`report_status` reads them at once and raises.

Nothing here falls back: a capture that fails raises, and a graph is made
only on a CUDA device.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch


class DeviceStatusError(RuntimeError):
    """A kernel reported a failure in its device status word."""


_SINKS: list[list] = []


@contextlib.contextmanager
def status_sink():
    """Collect the status words that `report_status` is given in the block
    (a list of device tensors) instead of reading each on the host."""
    sink: list = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.pop()


def report_status(status: torch.Tensor, what: str) -> None:
    """A kernel's status words (0: success): into the innermost
    `status_sink`, or, with none open, read now (one host sync) and raised
    on if any is non-zero."""
    if _SINKS:
        _SINKS[-1].append(status)
        return
    code = int(status.max())
    if code:
        raise DeviceStatusError(f"{what}: status {code}")


def status_of(sink: list, like: torch.Tensor) -> torch.Tensor:
    """The largest status word collected in `sink`, as a float64 0-d
    tensor on like's device (0 when there is none)."""
    out = torch.zeros((), dtype=torch.float64, device=like.device)
    for s in sink:
        out = torch.maximum(out, s.max().to(torch.float64))
    return out


def check_status(code: float, what: str) -> None:
    """Raise on a status word read back from the device."""
    if code != 0:
        raise DeviceStatusError(f"{what}: status {int(code)}")


def fetch(tensors, sink: list, what: str) -> list:
    """The tensors (on one device) as float64 CPU tensors of their shapes,
    through one copy to the host that also carries the largest status word
    collected in `sink` (`DeviceStatusError` if it is not 0)."""
    like = tensors[0]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors]
                     + [status_of(sink, like).reshape(1)]).cpu()
    check_status(float(flat[-1]), what)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def kernel_launches() -> dict:
    """The hand-written kernels' launch counts, by wrapper."""
    from . import cuda_eigh, cuda_pruning, cuda_quantile
    return {**cuda_pruning.LAUNCHES, **cuda_eigh.LAUNCHES,
            **cuda_quantile.LAUNCHES}


def capture(body: Callable[[], None],
            warmup: Callable[[], None] | None = None):
    """(a CUDA graph of body(), the kernel launches at its capture, by
    wrapper): warmup() (default body()) runs once on a side stream first,
    so that the allocator's pool, cuBLAS's workspace and the objectives'
    device tables exist before the capture, which is made on the same
    side stream.  (The allocator's cache is emptied first, as
    `torch.cuda.graph` does, but without its `gc.collect()`, which walks
    every object of the process at each capture.)"""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        (warmup or body)()
        # the capture's pool cannot take blocks cached outside it, and
        # nothing can be freed during a capture
        torch.cuda.empty_cache()
        before = kernel_launches()
        graph.capture_begin()
        try:
            body()
        finally:
            graph.capture_end()
        after = kernel_launches()
    torch.cuda.current_stream().wait_stream(s)
    return graph, {k: after[k] - before[k] for k in after}


def replay_kernels(graph) -> dict:
    """The hand-written kernels one replay of graph runs, counted by name
    under `torch.profiler` (no wrapper sees a replay): B1/B2 and B3/B4 by
    their tip coding (the walk's template argument AMB), and each by its
    instance (`<kernel>_n32`, `<kernel>_n64`: the template argument N), the
    eigensolver, and every device operation ("all")."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return kernel_census(
        [e.name for e in prof.events() if e.device_type.name == "CUDA"])


def kernel_census(names: list[str]) -> dict:
    """`replay_kernels`' counts from the device operations' names, as the
    profiler gives them demangled (`big_fwd_kernel<double, true, 32>`)."""
    from .cuda_pruning import INSTANCES

    out = {"all": len(names)}
    for key, walk, amb in (("pruning_fwd", "::big_fwd_kernel<", ", true, "),
                           ("pruning_bwd", "::big_bwd_kernel<", ", true, "),
                           ("big_fwd", "::big_fwd_kernel<", ", false, "),
                           ("big_bwd", "::big_bwd_kernel<", ", false, ")):
        mine = [s for s in names if walk in s and amb in s]
        out[key] = len(mine)
        for m in INSTANCES:
            out[f"{key}_n{m}"] = sum(f"{amb}{m}>" in s for s in mine)
    out["eigh"] = sum("jacobi_eigh_kernel" in s for s in names)
    out["quantile"] = sum(k in s for s in names for k in (
        "inc_kernel<", "inc_inv_kernel<", "mix_kernel"))
    return out


def _value_grad_packed(neg_fn, x: torch.Tensor) -> torch.Tensor:
    """[value, gradient..., status] of neg_fn at x, float64, on x's device;
    status the largest word the evaluation reported."""
    xr = x.detach().requires_grad_(True)
    with status_sink() as sink, torch.enable_grad():
        v = neg_fn(xr)
        (g,) = torch.autograd.grad(v, xr)
    return torch.cat([v.detach().reshape(1).to(torch.float64),
                      g.to(torch.float64), status_of(sink, g).reshape(1)])


def value_grad_eager(neg_fn, x: np.ndarray, device) -> np.ndarray:
    """(value, gradient...) of neg_fn at the float64 vector x, evaluated
    op by op on `device`, as a float64 numpy array: one copy back, which
    carries the evaluation's status word (`DeviceStatusError` if it is not
    0)."""
    xt = torch.tensor(x, dtype=torch.float64, device=device)
    out = _value_grad_packed(neg_fn, xt).cpu().numpy()
    check_status(out[-1], "value + gradient")
    return out[:-1]


class GraphedValueGrad:
    """Value + gradient of neg_fn (a function of a float64 1-D tensor
    returning a scalar) replayed from one CUDA graph.  The graph reads x
    from a static buffer and writes [value, gradient..., status] to
    another; a call copies x in from pinned memory, replays, and copies the
    output back (the one host sync of an evaluation).  Captured once, at
    x_like (a CUDA tensor of x's shape), after one warm-up evaluation
    there, which is not counted anywhere.  On any other device it raises,
    and so does a capture that fails: nothing falls back to eager
    evaluation.  `close()` releases the graph and its memory pool."""

    def __init__(self, neg_fn, x_like: torch.Tensor):
        if x_like.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device, got "
                             f"{x_like.device}")
        self.x = x_like.detach().to(torch.float64).reshape(-1).clone()
        self.out = torch.zeros(self.x.numel() + 2, dtype=torch.float64,
                               device=self.x.device)
        self.x_host = torch.empty(self.x.numel(), dtype=torch.float64,
                                  pin_memory=True)

        def body():
            self.out.copy_(_value_grad_packed(neg_fn, self.x))
        self.graph, _ = capture(body)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """(value, gradient...) at the float64 vector x, as numpy."""
        self.x_host.numpy()[:] = x
        self.x.copy_(self.x_host, non_blocking=True)
        self.graph.replay()
        out = self.out.cpu().numpy()
        check_status(out[-1], "value + gradient (graph)")
        return out[:-1]

    def close(self) -> None:
        self.graph = self.x = self.out = self.x_host = None


class GraphedValue:
    """A value-only function of fixed-shape float64 inputs replayed from
    one CUDA graph (mcmctree's exact likelihood: no autograd).  The inputs
    are views of one static device buffer and the output, with the
    largest status word the evaluation reported, is written to another: a
    call packs its numpy arrays into pinned memory, makes one copy in,
    replays, and makes one copy back (the one host sync of a call).
    Captured once from `like` (CUDA tensors of the inputs' shapes), after
    one warm-up evaluation there.  On any other device it raises, and so
    does a capture that fails.  `close()` releases the graph."""

    def __init__(self, fn, like):
        dev = like[0].device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {dev}")
        self.shapes = [tuple(t.shape) for t in like]
        sizes = [t.numel() for t in like]
        self.flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                               for t in like])
        self.inputs = [v.reshape(shape) for v, shape in
                       zip(torch.split(self.flat, sizes), self.shapes)]
        self.host = torch.empty(self.flat.numel(), dtype=torch.float64,
                                pin_memory=True)
        self.out = None

        def body():
            with status_sink() as sink, torch.no_grad():
                v = fn(*self.inputs).reshape(-1).to(torch.float64)
                out = torch.cat([v, status_of(sink, v).reshape(1)])
            if self.out is None:
                self.out = torch.zeros_like(out)
            self.out.copy_(out)
        self.graph, _ = capture(body)

    def __call__(self, *arrays) -> np.ndarray:
        """The function's value at the inputs `arrays` (numpy, of the
        captured shapes), as a float64 numpy array."""
        k, h = 0, self.host.numpy()
        for a, shape in zip(arrays, self.shapes):
            n = int(np.prod(shape))
            h[k:k + n] = np.asarray(a, np.float64).reshape(-1)
            k += n
        self.flat.copy_(self.host, non_blocking=True)
        self.graph.replay()
        out = self.out.cpu().numpy()
        check_status(out[-1], "value (graph)")
        return out[:-1]

    def close(self) -> None:
        self.graph = self.flat = self.inputs = self.out = self.host = None

