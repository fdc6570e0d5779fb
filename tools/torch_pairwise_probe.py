#!/usr/bin/env python3
"""Where the time of codeml's pairwise ML fits (`runmode = -2`) goes on
one CUDA card, and whether the host CPU fits a pair faster.

    python3 tools/torch_pairwise_probe.py [ntaxa]

Simulates `ntaxa` (default 8) taxa x 500 codons with evolver 6 (chip_smoke
phase 9's site classes), then runs `python -m paml_tpu_torch codeml` at
`runmode = -2` three times in the process: on the card, with `--device
cpu` at one thread, and with `--device cpu` at PyTorch's default thread
count.  For each: seconds, seconds per pair, evaluations (the lines of
`rub`) and ms per evaluation.  Then one pair's value + gradient on the
card under `torch.profiler`: kernels per evaluation, device time and the
device's idle share of the wall time.  Last line: all of it as JSON.
Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fit_run(torch, cs, d, device, threads):
    cs.CPU_THREADS = threads          # run_cli's thread count on the CPU
    out, wall, counts = cs.run_cli(torch, d, ["codeml", "codeml.ctl"],
                                   device)
    nev = sum(1 for _ in open(os.path.join(d, "rub")))
    npair = len(out["pairs"])
    return dict(device=device, threads=threads, pairs=npair,
                seconds=out["seconds"], s_per_pair=out["seconds"] / npair,
                evaluations=nev, ms_per_eval=1e3 * out["seconds"] / nev,
                lnL=[p.lnL for p in out["pairs"]])


def profile_eval(torch, data, reps=20):
    """One pair's value + gradient on the card: kernels per evaluation,
    device ms and wall ms per evaluation."""
    from torch.profiler import ProfilerActivity, profile

    from paml_tpu_torch.apps import pairwise
    from paml_tpu_torch.models import codon

    cp = pairwise._CodonPair(data, 1, 0, "F3x4",
                             codon.pair_tables(0, "cuda"),
                             codon.codon_graph(0), "cuda", False)
    x = torch.tensor([0.3, 2.0, 0.4], dtype=torch.float64, device="cuda",
                     requires_grad=True)

    def one():
        v = cp.loglik(x[0], x[1], x[2])
        (g,) = torch.autograd.grad(v, x)
        return float(v.detach()), g.cpu()

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = sum(e.device_time for e in kernels)
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.device_time
    top = sorted(top.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=1e3 * wall, kernels_per_eval=len(kernels) / reps,
                device_ms=dev_us / 1e3 / reps,
                idle_share=1 - dev_us / 1e3 / reps / (1e3 * wall),
                top_kernels_ms=[(n[:60], t / 1e3 / reps) for n, t in top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_pairwise_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paml_tpu_torch.io import seqio

    ntaxa = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    default_threads = torch.get_num_threads()
    rng = np.random.default_rng(cs.SEED)
    work = tempfile.mkdtemp(prefix="pairwise_probe_")
    names = [f"t{i}" for i in range(ntaxa)]
    with open(os.path.join(work, "mc.dat"), "w") as f:
        f.write(cs.codon_dat(cs.random_unrooted_tree(rng, names), ntaxa,
                             cs.PW_CODONS, 1, 97))
    cs.run_cli(torch, work, ["evolver", "6", "mc.dat"])
    aln = seqio.read_alignment(os.path.join(work, "mc.paml"),
                               seqio.CODON_SEQ)
    runs = []
    for device, threads in (("cuda", default_threads), ("cpu", 1),
                            ("cpu", default_threads)):
        d = os.path.join(work, f"{device}_{threads}")
        os.makedirs(d)
        cs.write_phylip(os.path.join(d, "seq.phy"), aln.names, aln.rows)
        with open(os.path.join(d, "codeml.ctl"), "w") as f:
            f.write(cs.PW_CTL.format(runmode=-2))
        r = fit_run(torch, cs, d, device, threads)
        runs.append(r)
        print(f"runmode -2, {ntaxa} taxa x {cs.PW_CODONS} codons on "
              f"{device} ({threads} threads): {r['seconds']:.2f} s, "
              f"{r['s_per_pair']:.4f} s per pair, {r['evaluations']} "
              f"evaluations, {r['ms_per_eval']:.3f} ms each", flush=True)
    torch.set_num_threads(default_threads)
    lnl = np.array([r["lnL"] for r in runs])
    rel = float(np.max(np.abs(lnl - lnl[0]) / np.abs(lnl[0])))
    prof = profile_eval(torch, seqio.pack(aln, cleandata=True))
    print(f"one value + gradient on the card [{card}]: {prof['wall_ms']:.3f}"
          f" ms wall, {prof['kernels_per_eval']:.0f} kernels, "
          f"{prof['device_ms']:.3f} ms of device time (idle share "
          f"{prof['idle_share']:.3f}); lnL of the three runs to {rel:.1e}",
          flush=True)
    for r in runs:
        del r["lnL"]
    print(json.dumps({"card": card, "default_threads": default_threads,
                      "runs": runs, "profile": prof, "lnl_rel": rel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
