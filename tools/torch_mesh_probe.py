#!/usr/bin/env python3
"""Times the pattern mesh over every card of one host:

    python3 tools/torch_mesh_probe.py

1. One process, `sharding.data_mesh()` over all visible cards: one value +
   gradient of M2a at the bench shape (32 taxa x 4096 codons simulated
   under M0; clean codons on B3/B4, the same with chip_smoke's gaps and Ns
   on B1/B2) and of branch-site model A on the 1024-taxon x 10240-codon
   alignment unchunked (B3/B4), each held against unsharded (1e-12
   relative on the value, 1e-10 of the largest gradient component) and
   timed beside it (medians of 5, the host clock around a synchronized
   evaluation), with the launches of one sharded evaluation.
2. A NCCL group of one process per card (`distributed.initialize` on
   tcp://localhost): the same bench objectives in every rank, the
   patterns cut over the ranks, against unsharded in each rank, timed.

With one card both run on it (a mesh of one shard, a group of one).  Prints
the card's name and power limit, a line per measurement, and last a JSON
line of them all.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())
SEED = 20241017


def value_grad(torch, neg, x):
    """-lnL and its gradient at x on the objective's device."""
    xt = torch.tensor(x, dtype=torch.float64, device=neg.fpatt.device,
                      requires_grad=True)
    v = neg(xt)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.cpu().numpy()


def timed(torch, neg, x, reps=5):
    ts = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, g = value_grad(torch, neg, x)
        ts.append(1e3 * (time.perf_counter() - t0))
    return v, g, float(np.median(ts[1:]))


def check(tag, one, got):
    (v1, g1, _), (v2, g2, _) = one, got
    dv = abs(v2 - v1) / abs(v1)
    dg = float(np.abs(g2 - g1).max() / np.abs(g1).max())
    if dv > 1e-12 or dg > 1e-10:
        raise AssertionError(f"{tag}: sharded value off by {dv:.2e}, "
                             f"gradient by {dg:.2e}")
    return dv, dg


def bench_objectives(torch, device):
    """M2a objectives at the bench shape on `device`: clean and gapped."""
    import chip_smoke as cs
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.io import seqio

    # simulated on the host, so that every rank holds the same codons
    rng = np.random.default_rng(SEED)
    names, rows, topo = cs.simulate_m0_rows(torch, rng, 32, 4096,
                                            device="cpu")
    spec = codeml.CodemlSpec(NSsites=2, codonf="F3x4", cleandata=False)
    out = {}
    for tag, rws in (("bench clean", rows),
                     ("bench gapped", cs.gapped_rows(rng, rows))):
        data = seqio.pack(seqio.Alignment(names, rws, seqio.CODON_SEQ),
                          cleandata=False)
        neg, _, _, x0, _, _ = codeml.make_codon_objective(
            data, topo, spec, device=device)
        out[tag] = (neg, x0)
    return out


def one_process(torch) -> list[dict]:
    import dataclasses

    import chip_smoke as cs
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning
    from paml_tpu_torch.parallel import sharding

    mesh = sharding.data_mesh()
    objs = bench_objectives(torch, "cuda:0")
    data, topo, spec, _ = cs.simulate_branch_site(
        torch, np.random.default_rng(SEED + 1), cs.BIG_TAXA, cs.BIG_NPATT,
        "cuda:0")
    free = dataclasses.replace(spec, fix_blength=0)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(data, topo, free,
                                                      device="cuda:0")
    objs["1024 taxa model A"] = (neg, x0)
    rows = []
    for tag, (neg, x0) in objs.items():
        one = timed(torch, neg, x0)
        pruning.set_pattern_mesh(mesh)
        try:
            cuda_pruning.reset_launch_counts()
            value_grad(torch, neg, x0)
            la = {k: v for k, v in cuda_pruning.LAUNCHES.items() if v}
            got = timed(torch, neg, x0)
        finally:
            pruning.set_pattern_mesh(None)
        dv, dg = check(tag, one, got)
        rows.append(dict(what=f"{tag}, {mesh.n_shards} cards in one process",
                         ms=got[2], unsharded_ms=one[2], value_err=dv,
                         grad_err=dg, launches=la))
        print(f"{rows[-1]['what']}: {got[2]:.2f} ms against {one[2]:.2f} "
              f"unsharded; value {dv:.1e}, gradient {dg:.1e} off; launches "
              f"{la}", flush=True)
    return rows


def rank_main(rank: int, world: int, port: int) -> None:
    import torch

    from paml_tpu_torch.core import pruning
    from paml_tpu_torch.parallel import distributed

    os.environ["LOCAL_RANK"] = str(rank)
    distributed.initialize(backend="nccl",
                           init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    dev = str(distributed.local_device())
    for tag, (neg, x0) in bench_objectives(torch, dev).items():
        one = timed(torch, neg, x0)
        pruning.set_pattern_mesh(distributed.global_data_mesh())
        try:
            got = timed(torch, neg, x0)
        finally:
            pruning.set_pattern_mesh(None)
        dv, dg = check(f"rank {rank} {tag}", one, got)
        print("RANK " + json.dumps(dict(
            rank=rank, what=f"{tag}, NCCL group of {world}", ms=got[2],
            unsharded_ms=one[2], value_err=dv, grad_err=dg)), flush=True)
    torch.distributed.destroy_process_group()


def nccl_group(torch) -> list[dict]:
    world = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(world), str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    rows = []
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=600)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        if p.returncode:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith("RANK "):
                rows.append(json.loads(line[5:]))
                print(line, flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    from paml_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.build()
    rows = one_process(torch) + nccl_group(torch)
    print(card.splitlines()[0])
    print(json.dumps(dict(cards=torch.cuda.device_count(), rows=rows)))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
