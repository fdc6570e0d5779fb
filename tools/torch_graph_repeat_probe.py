#!/usr/bin/env python3
"""Whether chip_smoke.py's 15b comparison repeats: a value + gradient
replayed from a CUDA graph against the eager one, bit for bit, many times
over, with the memory the evaluations take filled with poison first.

    python3 tools/torch_graph_repeat_probe.py [ROUNDS]

Builds the kernels and simulates chip_smoke's bench alignment (32 taxa x
4096 codons under M0, clean for B3/B4, with the last taxon's second half
gaps for B1/B2).  Then, ROUNDS times (default 10), for M2a and M3, clean
and gapped, float32 and float64, at 15b's three points x0 (1 + 1e-3 i):
the allocator's cache is filled with one poison in blocks of 1 KiB to
256 MiB (NaN, 1e30, -1e30, random bits, 0 in turn; after
`empty_cache` the driver's free memory too), the eager evaluation is made
again and a new graph is captured and replayed, each against the first
eager values, and the kernels of one replay are counted under
`torch.profiler`.  An evaluation that read memory it had not written, or
that does not repeat, shows as a mismatch.  Last line: the tallies as
JSON (cases x rounds, mismatches of each kind, the kernel censuses seen).
Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POISONS = (float("nan"), 1e30, -1e30, "random bits", 0.0)
BLOCK_MIB = (1 / 1024, 0.01, 0.05, 0.2, 0.5, 1, 2, 4, 8, 16, 32, 64, 128,
             256)


def poison(torch, value) -> None:
    """Six blocks of each size in BLOCK_MIB filled with value, then freed
    into the allocator's cache."""
    keep = []
    for mib in BLOCK_MIB:
        n = max(1, int(mib * 2 ** 20 / 4))
        for _ in range(6):
            t = torch.empty(n, dtype=torch.float32, device="cuda")
            if value == "random bits":
                t.view(torch.int32).random_(-2 ** 31, 2 ** 31 - 1)
            else:
                t.fill_(value)
            keep.append(t)
    torch.cuda.synchronize()
    del keep


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_graph_repeat_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paml_tpu_torch import _build
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import graphs

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    _build.build()
    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(cs.SEED)
    clean, topo, gapped = cs.simulate_m0(torch, rng, 32, 4096)
    cases = []
    for route, data in (("clean", clean), ("gapped", gapped)):
        for dt in (torch.float64, torch.float32):
            for name in ("M2a", "M3"):
                spec = codeml.CodemlSpec(NSsites=2 if name == "M2a" else 3,
                                         codonf="F3x4")
                neg, _, _, x0, _, _ = codeml.make_codon_objective(
                    data, topo, spec, device="cuda", dtype=dt)
                x0 = np.asarray(x0, float)
                xs = [x0 * (1.0 + 1e-3 * i) for i in range(3)]
                first = [graphs.value_grad_eager(neg, x, "cuda") for x in xs]
                cases.append((f"{name} {route} {str(dt)[6:]}", neg, x0, xs,
                              first))
    tally = collections.Counter()
    censuses = collections.defaultdict(collections.Counter)
    t0 = time.perf_counter()
    for r in range(rounds):
        value = POISONS[r % len(POISONS)]
        for key, neg, x0, xs, first in cases:
            poison(torch, value)
            eager = [cs.mismatch(graphs.value_grad_eager(neg, x, "cuda"), f)
                     for x, f in zip(xs, first)]
            poison(torch, value)
            torch.cuda.empty_cache()
            poison(torch, value)
            torch.cuda.empty_cache()
            gv = graphs.GraphedValueGrad(neg, torch.as_tensor(x0).cuda())
            graph = [cs.mismatch(gv(x), f) for x, f in zip(xs, first)]
            kern = graphs.replay_kernels(gv.graph)
            gv.close()
            censuses[key][json.dumps({k: v for k, v in kern.items()
                                      if k != "all"})] += 1
            tally[key, "evaluations"] += 2 * len(xs)
            tally[key, "eager mismatches"] += sum(map(bool, eager))
            tally[key, "graph mismatches"] += sum(map(bool, graph))
            if any(eager) or any(graph):
                print(f"round {r} ({value}) {key}: eager {eager}, graph "
                      f"{graph}", flush=True)
        print(f"round {r} ({value}) done, {time.perf_counter() - t0:.1f} s",
              flush=True)
    out = {"card": card, "rounds": rounds, "cases": {}}
    for key, *_ in cases:
        out["cases"][key] = {
            "evaluations": tally[key, "evaluations"],
            "eager_mismatches": tally[key, "eager mismatches"],
            "graph_mismatches": tally[key, "graph mismatches"],
            "kernel_censuses": dict(censuses[key])}
        print(f"{key}: {json.dumps(out['cases'][key])}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
