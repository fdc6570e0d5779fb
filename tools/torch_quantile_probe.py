#!/usr/bin/env python3
"""E2, the quantile code (`csrc/quantile.cu`), on one CUDA card: where a
root's cycles go, in this checkout's kernels and another checkout's, and
the two timed in turns.

    python3 tools/torch_quantile_probe.py [OTHER_CHECKOUT]

Compiles this checkout's `paml_tpu_torch/csrc/quantile.cu` twice with the
package's nvcc flags: as it is, and with `-DPAML_QPROBE`, where lane 0 of
each root's warp writes `clock64()` at the kernel's marks (STAMP(k) in the
source) into a device array that `paml_quantile_stamps` copies out.  With
OTHER_CHECKOUT (e.g. the parent, unpacked by `git archive` into a
gitignored directory) its source is built the same two ways if it has the
marks.  The first design's source (Lentz fractions, multisection then
Newton: `git show d753327:paml_tpu_torch/csrc/quantile.cu`), which has
none, gets them inserted at the same places of its algorithm (after the
multisection or the start, mark 1; after the Newton steps, 2; after the
partials, 3; mark 0 at the root's start), so that its split can be taken
again beside this design's; any other source without the marks is timed
only.

At the five shapes of chip_smoke.py's 16a (M8's ten beta medians and M5's
ten gamma medians with first partials, the M9 bracket at ten quantiles,
BEB's 900 incomplete betas, four gamma cuts at order 0 and at order 1):
ms per launch (CUDA events, 50 launches after 150 ms of warm-up) in the
order this, other, other, this, through the same bare ctypes call, and,
for the roots and the bracket, each root's cycles between the marks (the
median over the roots and the largest), with the SM clock sampled by
nvidia-smi meanwhile.  The two checkouts' roots must agree within 1e-12
relative.  Prints the card's name and power limit, then one line per
result, then all of it as JSON.  Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NSTAMP = 8              # marks per root in the device array
MAXROOT = 64

# the marks, for a source that has none: (anchor, text put before it)
_STAMP = ("if ((threadIdx.x & 31) == 0) { const int r_ = (blockIdx.x * "
          f"blockDim.x + threadIdx.x) >> 5; if (r_ < {MAXROOT}) "
          f"paml_stamps[r_ * {NSTAMP} + (@K@)] = clock64(); }}\n")
_DEFS = ("\n__device__ long long paml_stamps[{m} * {n}];\n"
         .format(m=MAXROOT, n=NSTAMP))
_READ = ("\nextern \"C\" int paml_quantile_stamps(long long* out) {{\n"
         "  void* p = nullptr;\n"
         "  cudaError_t e = cudaGetSymbolAddress(&p, paml_stamps);\n"
         "  if (e == cudaSuccess) e = cudaMemcpy(out, p, sizeof(long long) * "
         "{m} * {n}, cudaMemcpyDeviceToHost);\n"
         "  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(long long) * "
         "{m} * {n});\n"
         "  return (int)e;\n}}\n".format(m=MAXROOT, n=NSTAMP))
_OLD_MARKS = [
    # beta_root: after the multisection, after the Newton steps
    ("  double x = clampd(1.0 / (1.0 + exp(-0.5 * (tlo + thi))), X_LO, X_HI);",
     1),
    ("    if (!moved) break;\n  }\n  return x;", None),
    # gamma_root: after the start, after the log-Newton steps and polish
    ("  double y = log(maxd(x0, 1e-300));", 1),
    ("  return exp(y);\n}", 2),
    # inc_inv_kernel: the root's start, after the root, after the partials
    ("  double x = NAN;\n  if (isfinite(p) && isfinite(q) && isfinite(y))",
     0),
    ("  // the partials (every lane alike; lane 0 writes)", 2),
    ("  st = __reduce_max_sync(FULL, st);\n  par = __reduce_add_sync", 3),
    # mix_kernel: the start and the end of the multisection
    ("  const double target = (k + 0.5) / K;", 0),
    ("  st = __reduce_max_sync(FULL, st);\n  ops = __reduce_add_sync", 3),
]


def probe_source(src: str):
    """The source with the marks compiled in: a source that has them
    (`PAML_QPROBE`) as it is, the first design's with them inserted, None
    for any other."""
    if "PAML_QPROBE" in src:
        return src
    if not all(anchor in src for anchor, _ in _OLD_MARKS):
        return None
    src = src.replace("#include <math.h>\n", "#include <math.h>\n" + _DEFS, 1)
    for anchor, k in _OLD_MARKS:
        if k is None:     # beta_root's return: mark 2 before it
            src = src.replace(anchor, anchor.replace(
                "  return x;", _STAMP.replace("@K@", "2") + "  return x;"), 1)
        else:
            src = src.replace(anchor,
                              _STAMP.replace("@K@", str(k)) + anchor, 1)
    return src + _READ


def build(checkout: str, tag: str):
    """(plain library, probe library or None) of a checkout's
    quantile.cu."""
    from paml_tpu_torch import _build

    src = os.path.join(checkout, "paml_tpu_torch", "csrc", "quantile.cu")
    text = open(src).read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = []
    probe = probe_source(text)
    for kind, body, extra in (("plain", text, []),
                              ("probe", probe, ["-DPAML_QPROBE"])):
        if body is None:
            libs.append(None)
            continue
        cu = os.path.join(_build.BUILD_DIR, f"quantile_{tag}_{kind}.cu")
        with open(cu, "w") as f:
            f.write(body)
        out = cu[:-3] + ".so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra,
                            "-I", os.path.dirname(src), "-o", out, cu],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {tag} {kind}:\n{r.stdout}{r.stderr}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  r.stdout + r.stderr)})
        print(f"built {tag} {kind}: registers {regs}", flush=True)
        lib = ctypes.CDLL(out)
        for name, sig in _build._SIGNATURES["quantile"].items():
            fn = getattr(lib, name + "_f64")
            fn.argtypes, fn.restype = sig, ctypes.c_int
        if kind == "probe":
            lib.paml_quantile_stamps.argtypes = [ctypes.c_void_p]
            lib.paml_quantile_stamps.restype = ctypes.c_int
        libs.append(lib)
    return libs


def shapes(torch):
    """{name: (entry, kind, order, args)}: chip_smoke.py's 16a shapes."""
    from paml_tpu_torch.apps import codeml

    f64 = dict(dtype=torch.float64, device="cuda")
    ys = (np.arange(10) + 0.5) / 10
    pg = (np.arange(10) + 0.5) * 0.2
    beb = [v.ravel() for v in np.meshgrid(pg, pg, np.arange(1, 10) / 10,
                                          indexing="ij")]
    cuts = np.array([0.3, 0.9, 1.7, 3.1])

    def t(*vs):
        return tuple(torch.tensor(np.asarray(v, float), **f64) for v in vs)
    m9 = torch.tensor(codeml.nssites_x0_bounds(9, 10, False, 0.4)[0], **f64)
    return {"M8": ("inc_inv", 0, 1, t(np.full(10, 0.3), np.full(10, 1.7),
                                      ys)),
            "M5": ("inc_inv", 1, 1, t(np.full(10, 0.6), np.ones(10), ys)),
            "M9_bracket": ("mix", 9, 0, (m9,)),
            "BEB": ("inc", 0, 0, t(*beb)),
            "gamma_cuts_order0": ("inc", 1, 0, t(np.full(4, 1.6), np.ones(4),
                                                 cuts)),
            "gamma_cuts_order1": ("inc", 1, 1, t(np.full(4, 1.6), np.ones(4),
                                                 cuts))}


def launcher(torch, lib, entry, kind, order, args):
    """A bare call of `lib`'s entry on preallocated outputs; returns (call,
    outputs)."""
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "mix":
        (th,) = args
        K = 10
        x = th.new_empty(K)
        info = torch.empty((K, 2), dtype=torch.int32, device="cuda")

        def call():
            err = lib.paml_mix_quantiles_f64(kind, th.data_ptr(), th.numel(),
                                             K, x.data_ptr(), info.data_ptr(),
                                             stream)
            if err:
                raise RuntimeError(f"mix launch: cudaError_t {err}")
        return call, (x, info)
    a, b, xin = args
    n = a.numel()
    val = torch.empty_like(a)
    d1 = a.new_empty((n, 3))
    d2 = a.new_empty((n, 3, 3))
    info = torch.empty((n, 2), dtype=torch.int32, device="cuda")
    fn = getattr(lib, f"paml_{entry}_f64")

    def call():
        err = fn(kind, order, a.data_ptr(), b.data_ptr(), xin.data_ptr(), n,
                 val.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                 info.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{entry} launch: cudaError_t {err}")
    return call, (val, d1, info)


def ms(torch, fn, reps=50, warmup_s=0.15):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def stamps(torch, lib, call, nroot):
    """Each root's cycles between its marks [nroot, NSTAMP - 1] (0 where a
    mark was not reached) after one launch."""
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (MAXROOT * NSTAMP))()
    if lib.paml_quantile_stamps(ctypes.addressof(buf)):   # read and cleared
        raise RuntimeError("paml_quantile_stamps failed")
    call()
    torch.cuda.synchronize()
    if lib.paml_quantile_stamps(ctypes.addressof(buf)):
        raise RuntimeError("paml_quantile_stamps failed")
    s = np.frombuffer(buf, dtype=np.int64).reshape(MAXROOT, NSTAMP)[:nroot]
    out = np.zeros((nroot, NSTAMP - 1), dtype=np.int64)
    for r in range(nroot):
        marks = [k for k in range(NSTAMP) if s[r, k]]
        for lo, hi in zip(marks, marks[1:]):
            out[r, hi - 1] = s[r, hi] - s[r, lo]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_quantile_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    checkouts = {"this": ROOT}
    if len(sys.argv) > 1:
        checkouts["other"] = sys.argv[1]
    libs = {tag: build(path, tag) for tag, path in checkouts.items()}
    out = {"card": smi, "times": {}, "cycles": {}, "agree": {}}
    clocks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            clocks.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip())
            time.sleep(0.2)

    th = threading.Thread(target=sample)
    th.start()
    try:
        for name, (entry, kind, order, args) in shapes(torch).items():
            calls = {tag: launcher(torch, lib[0], entry, kind, order, args)
                     for tag, lib in libs.items()}
            order_ = ["this", "other", "other", "this"] if "other" in libs \
                else ["this", "this"]
            row = {tag: [] for tag in libs}
            for tag in order_:
                row[tag].append(ms(torch, calls[tag][0]))
            out["times"][name] = row
            for tag in libs:
                calls[tag][0]()
            torch.cuda.synchronize()
            if "other" in libs:
                a, b = calls["this"][1][0], calls["other"][1][0]
                err = float(((a - b).abs() / b.abs().clamp_min(1e-300))
                            .max())
                out["agree"][name] = err
            line = f"{name}: ms per launch {row}"
            if "other" in libs:
                line += f"; this against other {out['agree'][name]:.2e}"
            if entry != "inc":
                nroot = calls["this"][1][0].numel()
                cyc = {}
                for tag, lib in libs.items():
                    if lib[1] is None:
                        continue
                    call = launcher(torch, lib[1], entry, kind, order,
                                    args)[0]
                    c = stamps(torch, lib[1], call, nroot)
                    cyc[tag] = {"median": np.median(c, 0).tolist(),
                                "max": c.max(0).tolist()}
                out["cycles"][name] = cyc
                line += "; cycles between marks 0-1 / 1-2 / 2-3 (median, " \
                    "max over roots) " + "; ".join(
                        f"{tag} {v['median'][:3]} {v['max'][:3]}"
                        for tag, v in cyc.items())
            print(line, flush=True)
    finally:
        stop.set()
        th.join()
    out["sm_clock"] = sorted(set(clocks))
    print(f"SM clock while timing: {out['sm_clock']}", flush=True)
    bad = [k for k, v in out["agree"].items() if v > 1e-12]
    print(json.dumps(out))
    if bad:
        print(f"torch_quantile_probe: the checkouts disagree at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
