#!/usr/bin/env python3
"""Times the large-tree pruning pair (B3/B4) of two checkouts of the repo
on one CUDA card, each in its own process, in the order A, B, B, A (so a
drift of the card's clock over the call does not favour either):

    python3 tools/torch_ab_big.py DIR_A DIR_B

Each process imports paml_tpu_torch from its directory, builds its
kernels there, and times B3 and B4 (CUDA events, 5 launches after 1) on
the 1024-taxon balanced tree with 4 classes: one 1024-pattern chunk in
float64, and all 10240 patterns in float64 and float32, on inputs made
from one seed.  It prints one JSON line per process (with the sums of its
lnf and dP, so that the two checkouts can be seen to compute the same
thing; from the process that built the checkout's kernels, the
registers and spills that ptxas reports for B3 and B4; and a hash of each
B3/B4 kernel's machine code, `cuobjdump -sass` of the library without the
function's name, equal where the two checkouts compiled the same
instructions), then the card's name and power limit.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

SEED = 20240603
TAXA, C, n = 1024, 4, 61


def one() -> dict:
    import torch

    from paml_tpu_torch import _build
    from paml_tpu_torch.core import cuda_pruning as cp
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio

    _build.build()
    lines = _build.build_log.splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "big_" in line:
            kernel = line.split("'")[1]
            ptxas[kernel] = " | ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "stack frame" in x or "registers" in x)
    names = [f"t{i}" for i in range(TAXA)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    topo = from_treenode(treeio.parse_newick(bal(0, TAXA) + ";"), names)
    rng = np.random.default_rng(SEED)
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.7 * np.eye(n)[None, None] + 0.3 * P / P.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(n), size=C)
    st = rng.integers(0, n, size=(TAXA, 10240)).astype(np.int32)
    gb = rng.uniform(0.5, 2.0, size=(C, 10240))
    out = {"dir": os.getcwd(), "ptxas": ptxas, "sass": sass_hashes(_build)}
    for H, dtype in ((1024, torch.float64), (10240, torch.float64),
                     (10240, torch.float32)):
        dev = dict(dtype=dtype, device="cuda")
        Pt, pit = torch.tensor(P, **dev), torch.tensor(pi, **dev)
        tips = torch.tensor(st[:, :H].copy(), device="cuda")
        gbar = torch.tensor(gb[:, :H], **dev)
        lnf, S = cp.pruning_big_fwd(Pt, tips, topo, pit)
        dP, _ = cp.pruning_big_bwd(Pt, tips, topo, pit, gbar, S)
        times = []
        for fn in (lambda: cp.pruning_big_fwd(Pt, tips, topo, pit),
                   lambda: cp.pruning_big_bwd(Pt, tips, topo, pit, gbar, S)):
            fn()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 5)
        key = f"{H}_{str(dtype).split('.')[1]}"
        out[key] = {"B3_ms": times[0], "B4_ms": times[1],
                    "lnf_sum": float(lnf.double().sum()),
                    "dP_sum": float(dP.double().sum())}
        del Pt, tips, gbar, lnf, S, dP
        torch.cuda.empty_cache()
    return out


def sass_hashes(_build) -> dict:
    """{big_fwd|big_bwd}_{f32|f64}: sha256 (12 hex digits) and length of
    the kernel's SASS in the large-tree library."""
    lib = _build.library_path(_build.CSRC / "pruning_big.cu")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        for kind in ("big_fwd", "big_bwd"):
            if f"{kind}_kernel" in name:
                dt = "f64" if f"{kind}_kernelId" in name else "f32"
                code = body.split("..........")[0]
                out[f"{kind}_{dt}"] = (
                    hashlib.sha256(code.encode()).hexdigest()[:12],
                    code.count(";"))
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 3:
        print("usage: torch_ab_big.py DIR_A DIR_B (on a CUDA card)",
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
