#!/usr/bin/env python3
"""Times the Hessian's tangent kernels H1 / H2 of two checkouts of the repo
on one CUDA card, each in its own process, in the order A, B, B, A (so a
drift of the card's clock over the call does not favour either):

    python3 tools/torch_ab_tangent.py DIR_A DIR_B
    python3 tools/torch_ab_tangent.py --probe

Each process imports paml_tpu_torch and chip_smoke from its directory,
builds its kernels there, simulates chip_smoke.py's bench alignment (32
taxa x 4096 codons under M0 on a ladder, and the copy with gaps), takes
M2a's P, pi and the mixture's cotangent gbar at the objective's starting
point, and times H1 and H2 (CUDA events, medians of 5 after one) at 4 and
16 directions made from one seed, on state codes (the B3/B4 walk) and on
the gapped data's coded tips (B1/B2's).  It prints one JSON line per
process, with the sums of lnfd and dPd (the two checkouts compute the
same thing) and, from the process that built its kernels, the registers
and spills that ptxas reports for the tangent kernels; then the card's
name and power limit.

With --probe it builds this checkout's kernels with -DPAML_TPROBE (a
library of its own) and prints, for one launch of H1 and of H2 at 16
directions, clean and gapped, the cycles that thread 0 of a block spent
in each section of the kernel (`TP(s)` marks; the sections are listed
in csrc/pruning_tangent.cuh, PAML_TP_SECTIONS, and the library gives
their labels), averaged over the blocks.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

SEED = 20240601


def bench_inputs(torch, cs, codeml, cp):
    """(route, P, pi, gbar, S, tips, topo, fwd, bwd) of the bench shape's
    clean and gapped M2a at the objective's starting point."""
    rng = np.random.default_rng(SEED)
    clean, topo, gapped = cs.simulate_m0(torch, rng, ns=32, ncod=4096)
    spec = codeml.CodemlSpec(NSsites=2, codonf="F3x4")
    f64 = dict(dtype=torch.float64, device="cuda")
    for route, data in (("clean", clean), ("gapped", gapped)):
        neg, _, _, x0, _, _ = codeml.make_codon_objective(data, topo, spec,
                                                          device="cuda")
        with torch.no_grad():
            P, piC, w = neg.model_at(torch.as_tensor(np.asarray(x0, float),
                                                     **f64))
        P, pi = P.contiguous(), piC.contiguous()
        twice = cp.ClassSiteLnfKernelTwice(P, neg.tips, topo, pi)
        gz = codeml._mixture(twice.lnf, w, neg.fpatt)[2].detach()
        tips = cp.kernel_tips(neg.tips)
        fwd, bwd = (cp.pruning_tan_fwd, cp.pruning_tan_bwd) \
            if isinstance(tips, cp.TipCodes) else \
            (cp.pruning_big_tan_fwd, cp.pruning_big_tan_bwd)
        yield route, P, pi, gz, twice.S, tips, topo, fwd, bwd


def directions(torch, P, gz, D):
    g = np.random.default_rng(SEED + 19 + D)
    nnode, C, n = P.shape[0], P.shape[1], P.shape[-1]
    f64 = dict(dtype=torch.float64, device="cuda")
    return (torch.tensor(g.normal(0.0, 0.1, (D, nnode, C, n, n)), **f64),
            torch.tensor(g.normal(0.0, 0.01, (D, C, n)), **f64),
            torch.tensor(g.normal(0.0, 1.0, (D,) + tuple(gz.shape)), **f64)
            * gz.abs().max())


def one() -> dict:
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paml_tpu_torch import _build
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning as cp

    _build.build()
    lines = _build.build_log.splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "tan_" in line:
            kernel = line.split("'")[1]
            ptxas[kernel] = " | ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "stack frame" in x or "registers" in x)
    out = {"dir": os.getcwd(), "ptxas": ptxas}
    for route, P, pi, gz, S, tips, topo, fwd, bwd in bench_inputs(
            torch, cs, codeml, cp):
        for D in (4, 16):
            Pd, pid, gd = directions(torch, P, gz, D)
            lnfd, Sd = fwd(P, tips, topo, pi, Pd, pid, S)
            dPd, dpid = bwd(P, tips, topo, pi, gz, Pd, pid, gd, S, Sd)
            ms_f = cs.cuda_ms_median(
                lambda: fwd(P, tips, topo, pi, Pd, pid, S))
            ms_b = cs.cuda_ms_median(
                lambda: bwd(P, tips, topo, pi, gz, Pd, pid, gd, S, Sd))
            out[f"{route}_d{D}"] = {
                "H1_ms": ms_f, "H2_ms": ms_b,
                "lnfd_sum": float(lnfd.sum()), "dPd_sum": float(dPd.sum()),
                "dpid_sum": float(dpid.sum())}
            del Pd, pid, gd, lnfd, Sd, dPd, dpid
            torch.cuda.empty_cache()
    return out


def probe() -> int:
    """Cycles by section of H1 / H2 (-DPAML_TPROBE) at 16 directions."""
    import ctypes

    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paml_tpu_torch import _build
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning as cp

    _build.NVCC_FLAGS.append("-DPAML_TPROBE")
    _build.lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for route, P, pi, gz, S, tips, topo, fwd, bwd in bench_inputs(
            torch, cs, codeml, cp):
        src = "pruning.cu" if isinstance(tips, cp.TipCodes) else \
            "pruning_big.cu"
        lib = ctypes.CDLL(str(_build.library_path(_build.CSRC / src)))
        lib.paml_tprobe_names.restype = ctypes.c_char_p
        names = lib.paml_tprobe_names().decode().splitlines()
        read = lib.paml_tprobe_read
        read.argtypes = [ctypes.c_void_p]
        cyc = np.zeros(len(names), dtype=np.uint64)
        Pd, pid, gd = directions(torch, P, gz, 16)
        Sd = fwd(P, tips, topo, pi, Pd, pid, S)[1]
        bwd(P, tips, topo, pi, gz, Pd, pid, gd, S, Sd)
        torch.cuda.synchronize()
        _build.check(read(cyc.ctypes.data), "paml_tprobe_read")
        for name, fn in (("H1", lambda: fwd(P, tips, topo, pi, Pd, pid, S)),
                         ("H2", lambda: bwd(P, tips, topo, pi, gz, Pd, pid,
                                            gd, S, Sd))):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            _build.check(read(cyc.ctypes.data), "paml_tprobe_read")
            total = float(cyc.sum())
            print(f"{route} {name}, 16 directions: {a.elapsed_time(b):.3f} ms"
                  f" (marks on); {total / sms:.0f} cycles a block (the grid"
                  f" is one wave of {sms} blocks)", flush=True)
            for i in np.flatnonzero(cyc):
                print(f"  {names[i]:30s} {cyc[i] / sms:12.0f} "
                      f"{100 * cyc[i] / total:5.1f} %", flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one()), flush=True)
        return 0
    import torch
    if sys.argv[1:] == ["--probe"] and torch.cuda.is_available():
        code = probe()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        return code
    if not torch.cuda.is_available() or len(sys.argv) != 3:
        print("usage: torch_ab_tangent.py DIR_A DIR_B (on a CUDA card)",
              file=sys.stderr)
        return 2
    a, b = (os.path.abspath(d) for d in sys.argv[1:])
    for d in (a, b, b, a):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one"], cwd=d, env={**os.environ,
                                                  "PYTHONPATH": d})
        if r.returncode:
            return r.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
