#!/usr/bin/env python3
"""Measurements of the large-tree pruning pair (B3/B4) of paml_tpu_torch on
one CUDA card, beside chip_smoke.py (run from the repo root):

    python3 tools/torch_big_probe.py

1. The 1024-taxon tree with a trifurcating root (the root of an unrooted
   codeml tree), one 1024-pattern chunk and all 10240 patterns, 4
   classes: B3 and B4 on its binary resolution (`cuda_pruning.big_tree`,
   one identity node more) against the binary 1024-taxon tree.
2. A 1024-taxon tree whose root has 4 children: B1+B2 against B3+B4 on
   `cuda_pruning.big_tree` of it, one chunk.
3. B4's grid at one chunk of the binary 1024-taxon tree: G blocks per
   class in {4, 8, 16, 32}, each timed, with the split between
   big_bwd_kernel and reduce_kernel from torch.profiler and the bytes of
   the dP slabs.

Every result is held against the level path (the plain version of B1/B2)
with chip_smoke.py's tolerances.  Prints the card's name and power
limit, one line per measurement, and last all of them as one JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

SEED = 20240602
TAXA, CHUNK_H, FULL_H, C = 1024, 1024, 10240, 4


def root_k_topo(ns, k):
    """Balanced subtrees of ns / k taxa under a root of k children."""
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio

    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    parts = ",".join(bal(i * ns // k, (i + 1) * ns // k) for i in range(k))
    return from_treenode(treeio.parse_newick(f"({parts});"), names)


def problem(torch, rng, topo, H, dtype, n=61):
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.7 * np.eye(n)[None, None] + 0.3 * P / P.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(n), size=C)
    st = rng.integers(0, n, size=(topo.ns, H)).astype(np.int32)
    gb = rng.uniform(0.5, 2.0, size=(C, H))
    dev = dict(dtype=dtype, device="cuda")
    return (torch.tensor(P, **dev), torch.tensor(st, device="cuda"),
            torch.tensor(pi, **dev), torch.tensor(gb, **dev))


def level(torch, P, tips, topo, pi, gbar):
    from paml_tpu_torch.core import pruning
    with torch.no_grad():
        lnf = pruning.class_site_lnf_plain(P, tips, topo, pi)
    return (lnf,) + pruning.class_site_lnf_bwd_plain(P, tips, topo, pi, gbar)


def big_pair(P, tips, topo, pi, gbar):
    from paml_tpu_torch.core import cuda_pruning as cp
    lnf, S = cp.pruning_big_fwd(P, tips, topo, pi)
    return (lnf,) + cp.pruning_big_bwd(P, tips, topo, pi, gbar, S), S


def check(got, ref, dn, what):
    tol = cs.TOL[dn]
    return max(cs.max_err(got[0], ref[0], tol["val"], f"lnf {what}"),
               cs.max_err(got[1], ref[1], tol["grad"], f"dP {what}"),
               cs.max_err(got[2], ref[2], tol["grad"], f"dpi {what}"))


def time_pair(torch, P, tips, topo, pi, gbar, reps):
    from paml_tpu_torch.core import cuda_pruning as cp
    _, S = cp.pruning_big_fwd(P, tips, topo, pi)
    t3 = cs.cuda_ms(lambda: cp.pruning_big_fwd(P, tips, topo, pi), **reps)
    t4 = cs.cuda_ms(lambda: cp.pruning_big_bwd(P, tips, topo, pi, gbar, S),
                    **reps)
    del S
    torch.cuda.empty_cache()
    return t3, t4


def roots(torch, rng, out, card):
    """1: a trifurcating root, walked as its binary resolution, against
    the binary tree of as many taxa."""
    from paml_tpu_torch.core import cuda_pruning as cp
    tri, bal = root_k_topo(TAXA, 3), root_k_topo(TAXA, 2)
    assert cp.big_tree(tri).nnode == tri.nnode + 1 and cp.big_tree(bal) is bal
    for H, dtype in ((CHUNK_H, torch.float64), (CHUNK_H, torch.float32),
                     (FULL_H, torch.float64)):
        dn = str(dtype).split(".")[1]
        tag = f"{TAXA} taxa, {H} patterns, C {C}, {dn}"
        t, e = {}, 0.0
        for name, topo in (("trifurcating", tri), ("binary", bal)):
            P, tips, pi, gbar = problem(torch, rng, topo, H, dtype)
            if H == CHUNK_H:
                got, _ = big_pair(P, tips, topo, pi, gbar)
                e = max(e, check(got, level(torch, P, tips, topo, pi, gbar),
                                 dn, f"{name} [{tag}]"))
                del got
            t[name] = time_pair(torch, P, tips, topo, pi, gbar,
                                dict(reps=5, warmup=1))
            del P, tips, pi, gbar
            torch.cuda.empty_cache()
        out.append({"probe": "root", "shape": tag, "max_abs_err": e,
                    "card": card, **{k: {"B3_ms": v[0], "B4_ms": v[1]}
                                     for k, v in t.items()}})
        print(f"root [{tag}, {card}]: " + "; ".join(
            f"{k} B3 {v[0]:.3f} ms B4 {v[1]:.3f} ms" for k, v in t.items())
            + (f"; max|diff| {e:.3e}" if H == CHUNK_H else ""), flush=True)


def polytomy(torch, rng, out, card):
    """2: a root of 4 children, B1+B2 against B3+B4 on its resolution."""
    from paml_tpu_torch.core import cuda_pruning as cp
    topo = root_k_topo(TAXA, 4)
    tb = cp.big_tree(topo)
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[1]
        P, tips, pi, gbar = problem(torch, rng, topo, CHUNK_H, dtype)
        tag = (f"{TAXA} taxa, root of 4 children, {CHUNK_H} patterns, C {C},"
               f" {dn}")
        ref = level(torch, P, tips, topo, pi, gbar)
        big, _ = big_pair(P, tips, topo, pi, gbar)
        lnf, S = cp.pruning_fwd(P, tips, topo, pi)
        fused = (lnf,) + cp.pruning_bwd(P, tips, topo, pi, gbar, S)
        e = max(check(big, ref, dn, f"B3/B4 [{tag}]"),
                check(fused, ref, dn, f"B1/B2 [{tag}]"))
        del big, fused, ref, S
        reps = dict(reps=3, warmup=1)
        t3, t4 = time_pair(torch, P, tips, topo, pi, gbar, reps)
        t12 = cs.cuda_ms(lambda: cp.pruning_bwd(
            P, tips, topo, pi, gbar, cp.pruning_fwd(P, tips, topo, pi)[1]),
            **reps)
        out.append({"probe": "polytomy", "shape": tag, "max_abs_err": e,
                    "card": card, "B3_ms": t3, "B4_ms": t4, "B1_B2_ms": t12,
                    "added_nodes": tb.nnode - topo.nnode})
        print(f"polytomy [{tag}, {card}]: B3 {t3:.3f} + B4 {t4:.3f} = "
              f"{t3 + t4:.3f} ms on its resolution (nodes added: "
              f"{tb.nnode - topo.nnode}); B1+B2 {t12:.3f} ms; max|diff| {e:.3e}",
              flush=True)
        del P, tips, pi, gbar
        torch.cuda.empty_cache()


def device_ms(prof, name):
    total = 0.0
    for ev in prof.key_averages():
        if name in ev.key:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            total += us
    return total / 1e3


def grid(torch, rng, out, card):
    """3: B4's G at one chunk of the binary tree."""
    from paml_tpu_torch.core import cuda_pruning as cp
    topo = root_k_topo(TAXA, 2)
    full = cp.big_bwd_grid
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[1]
        P, tips, pi, gbar = problem(torch, rng, topo, CHUNK_H, dtype)
        ref = level(torch, P, tips, topo, pi, gbar)
        _, S = cp.pruning_big_fwd(P, tips, topo, pi)
        for G in (4, 8, 16, 32):
            tag = (f"{TAXA} taxa, {CHUNK_H} patterns, C {C}, {dn}, G {G}")
            cp.big_bwd_grid = lambda *args, G=G: G
            try:
                lnf = cp.pruning_big_fwd(P, tips, topo, pi, want_S=False)[0]
                e = check((lnf,) + cp.pruning_big_bwd(P, tips, topo, pi,
                                                      gbar, S),
                          ref, dn, tag)
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ms = cs.cuda_ms(lambda: cp.pruning_big_bwd(
                    P, tips, topo, pi, gbar, S), reps=5, warmup=1)
                peak = torch.cuda.max_memory_allocated() - base
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        cp.pruning_big_bwd(P, tips, topo, pi, gbar, S)
                    torch.cuda.synchronize()
            finally:
                cp.big_bwd_grid = full
            walk = device_ms(prof, "big_bwd_kernel") / 3
            red = device_ms(prof, "reduce_kernel") / 3
            npad = cp.padded_states(P.shape[-1])
            slab = G * topo.nnode * C * npad * npad * P.element_size()
            out.append({"probe": "grid", "shape": tag, "card": card,
                        "G": G, "blocks": G * C,
                        "visit_tiles": cp.visit_tiles(
                            cp.big_tiles(CHUNK_H), G),
                        "B4_ms": ms, "walk_ms": walk, "reduce_ms": red,
                        "slab_bytes": slab, "peak_bytes": peak,
                        "max_abs_err": e})
            print(f"grid [{tag}, {card}]: B4 {ms:.3f} ms (profiler: walk "
                  f"{walk:.3f} ms, reduce {red:.3f} ms); slabs "
                  f"{slab / 1e9:.2f} GB written once, read once by the "
                  f"reduction ({2 * slab / cp.PEAK_BYTES * 1e3:.2f} ms at "
                  f"the memory rate); peak above the inputs "
                  f"{peak / 2 ** 30:.2f} GiB; max|diff| {e:.3e}", flush=True)
        del P, tips, pi, gbar, S, ref
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_big_probe: no CUDA device", file=sys.stderr)
        return 2
    from paml_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    rng = np.random.default_rng(SEED)
    out: list = []
    roots(torch, rng, out, card)
    polytomy(torch, rng, out, card)
    grid(torch, rng, out, card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
