#!/usr/bin/env python3
"""The float64 eigensolver (`csrc/eigh.cu`) on one CUDA card: this
checkout's kernel against another checkout's, bit for bit and timed in
turns, and one round of this checkout's kernel split into its parts.

    python3 tools/torch_eigh_probe.py [OTHER_CHECKOUT]

Builds this checkout's kernels; with OTHER_CHECKOUT (e.g. the parent,
unpacked by `git archive` into a gitignored directory) also compiles that
checkout's `paml_tpu_torch/csrc/eigh.cu` with the same nvcc flags and
loads its `paml_eigh_f64`.  Inputs from one seed: random reversible rate
matrices (three of each order from 1 to 64 the kernel's instances split
on) and codon matrices under three genetic codes (61, 60 and 63 sense
codons).  For each input: this kernel against `cuda_eigh.jacobi_plain`
(eigenpairs and status words, to the bit) and against the other
checkout's kernel.  Then at 3 x 61, 8 x 61, 4 x 20, 1 x 4, 3 x 60 and 3 x
63: ms per launch (CUDA events, 50 launches after 150 ms of warm-up), in
the order this, other, other, this, both through the same bare ctypes
call, beside this one through `cuda_eigh.eigh_kernel` (the package's
wrapper, whose host time shows at small shapes) and `torch.linalg.eigh`;
the kernel's bound (`cuda_eigh.kernel_work`); and, at 3 x 61, the debug
instance's split of a round (`cuda_eigh.eigh_probe`: the full round, V
skipped, A skipped, the chain skipped, at the sweeps the kernel took)
and each warp's clock cycles of work and of waiting at the barrier
(`cuda_eigh.round_stamps`), with the SM clock sampled by nvidia-smi
meanwhile.  Prints the card's name and power limit, then one line per
result, then all of it as JSON.  Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SEED = 20240614
ORDERS = (1, 2, 3, 4, 5, 6, 7, 19, 20, 21, 33, 59, 60, 61, 62, 63, 64)


def reversible_S(torch, rng, n, G):
    from paml_tpu_torch.core import pmat

    pi = rng.dirichlet(np.full(n, 3.0))
    Qs = []
    for _ in range(G):
        R = rng.uniform(0.2, 2.0, size=(n, n))
        Q = (R + R.T) * pi[None, :]
        np.fill_diagonal(Q, 0.0)
        Qs.append(Q - np.diag(Q.sum(1)))
    f64 = dict(dtype=torch.float64, device="cuda")
    return pmat.symmetrize(torch.tensor(np.stack(Qs), **f64),
                           torch.tensor(pi, **f64).expand(G, -1))


def codon_S(torch, rng, G, icode=0):
    from paml_tpu_torch.core import pmat
    from paml_tpu_torch.models import codon

    f64 = dict(dtype=torch.float64, device="cuda")
    T = codon.dense_tables(icode, "cuda", torch.float64)
    pi = torch.tensor(rng.dirichlet(np.full(codon.codon_graph(icode).n, 5.0)),
                      **f64)
    s = codon.mutation_dense(T, torch.tensor([2.1], **f64))
    W = torch.tensor([0.08, 1.0, 2.7, 0.3, 0.5, 1.7, 0.9, 4.0][:G], **f64)
    return pmat.symmetrize(codon.build_Q_dense(T, s, W, pi),
                           pi.expand(G, -1))


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


def other_kernel(checkout):
    """The other checkout's paml_eigh_f64, compiled into this checkout's
    build directory."""
    from paml_tpu_torch import _build

    src = os.path.join(checkout, "paml_tpu_torch", "csrc", "eigh.cu")
    out = os.path.join(_build.BUILD_DIR, "libpaml_eigh_other.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True)
    f = ctypes.CDLL(out).paml_eigh_f64
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def run_other(torch, f, S):
    G, n = S.shape[0], S.shape[-1]
    lam, U = S.new_empty((G, n)), S.new_empty((G, n, n))
    info = torch.empty((G, 2), dtype=torch.int32, device="cuda")
    err = f(S.data_ptr(), lam.data_ptr(), U.data_ptr(), info.data_ptr(), G, n,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other checkout's eigh: cudaError_t {err}")
    return lam, U, info


def same_bits(torch, a, b):
    return all(torch.equal(x.view(torch.int64) if x.is_floating_point() else x,
                           y.view(torch.int64) if y.is_floating_point() else y)
               for x, y in zip(a, b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_eigh_probe: no CUDA device", file=sys.stderr)
        return 2
    from paml_tpu_torch import _build
    from paml_tpu_torch.core import cuda_eigh
    from paml_tpu_torch.core import cuda_pruning as cp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.lib()
    other = other_kernel(sys.argv[1]) if len(sys.argv) > 1 else None
    rng = np.random.default_rng(SEED)
    out = {"card": smi, "bits": {}, "times": {}}
    cases = [(f"n{n}", reversible_S(torch, rng, n, 3)) for n in ORDERS]
    cases += [("codon61x3", codon_S(torch, rng, 3)),
              ("codon61x8", codon_S(torch, rng, 8)),
              ("mito60x3", codon_S(torch, rng, 3, 1)),
              ("ciliate63x3", codon_S(torch, rng, 3, 5))]
    ok = True
    for tag, S in cases:
        got = cuda_eigh.eigh_kernel(S)
        plain = same_bits(torch, got, cuda_eigh.jacobi_plain(S))
        oth = same_bits(torch, got, run_other(torch, other, S)) if other \
            else None
        ok &= plain and oth is not False
        out["bits"][tag] = dict(sweeps=got[2][:, 1].tolist(), plain=plain,
                                other=oth)
        print(f"{tag} {tuple(S.shape)}: sweeps {got[2][:, 1].tolist()}; "
              f"bit for bit: plain version {plain}, other checkout {oth}",
              flush=True)
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
    shapes = {"3x61": codon_S(torch, rng, 3), "8x61": codon_S(torch, rng, 8),
              "4x20": reversible_S(torch, rng, 20, 4),
              "1x4": reversible_S(torch, rng, 4, 1),
              "3x60": codon_S(torch, rng, 3, 1),
              "3x63": codon_S(torch, rng, 3, 5)}
    for tag, S in shapes.items():
        sw = cuda_eigh.eigh_kernel(S)[2][:, 1].tolist()
        # both libraries through the same bare call; the package's wrapper
        # (checks, device context, reshapes) timed apart
        lib = _build.lib().paml_eigh_f64
        mine = lambda: run_other(torch, lib, S)         # noqa: E731
        row = {"sweeps": sw, "this": [ms(torch, mine)]}
        if other:
            theirs = lambda: run_other(torch, other, S)  # noqa: E731
            row["other"] = [ms(torch, theirs), ms(torch, theirs)]
        row["this"].append(ms(torch, mine))
        row["wrapper"] = ms(torch, lambda: cuda_eigh.eigh_kernel(S))
        row["linalg"] = ms(torch, lambda: torch.linalg.eigh(S))
        row["bound"] = cp.bound_ms(*cuda_eigh.kernel_work(S.shape[-1], sw))
        out["times"][tag] = row
        print(f"{tag}: ms this {row['this']}, other {row.get('other')}, "
              f"this through cuda_eigh.eigh_kernel {row['wrapper']:.4f}, "
              f"torch.linalg.eigh {row['linalg']:.4f}, bound "
              f"{row['bound']:.3g} (sweeps {sw})", flush=True)
    S = shapes["3x61"]
    sw = max(out["times"]["3x61"]["sweeps"])
    rounds = sw * 61
    modes = {"full": 0, "V skipped": cuda_eigh.SKIP_V,
             "A skipped": cuda_eigh.SKIP_A,
             "chain skipped": cuda_eigh.SKIP_CHAIN,
             "chain alone": cuda_eigh.SKIP_V | cuda_eigh.SKIP_A,
             "all skipped": cuda_eigh.SKIP_V | cuda_eigh.SKIP_A
             | cuda_eigh.SKIP_CHAIN}
    out["round_us"] = {k: ms(torch, lambda f=f: cuda_eigh.eigh_probe(S, f, sw))
                       * 1e3 / rounds for k, f in modes.items()}
    out["stamps"] = {k: cuda_eigh.round_stamps(S, sw, f)
                     for k, f in (("full", 0), ("V skipped", 1),
                                  ("A skipped", 2), ("chain skipped", 4))}
    stop.set()
    th.join()
    out["sm_clock"] = sorted(set(clocks))
    print("one round at 3 x 61, us: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["round_us"].items()), flush=True)
    for k, st in out["stamps"].items():
        print(f"clock cycles, {k}: round {st['round']:.0f}; per warp (work / "
              f"wait) " + ", ".join(f"{w} {a:.0f}/{b:.0f}"
                                    for w, (a, b) in st["warps"].items()),
              flush=True)
    print(f"SM clock while timing: {out['sm_clock']}", flush=True)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
