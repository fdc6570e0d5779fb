#!/usr/bin/env python3
"""Phase 9 of chip_smoke.py (the pairwise programs and evolver) alone on
one CUDA card.

    python3 tools/torch_phase9.py [--ml-taxa N]

`--ml-taxa` sets the taxa of 9c's `runmode = -2` run (chip_smoke's
PW_ML_TAXA; 20 gives 190 pairs).  The M2a refit of 9a builds the
kernels at their first use.  Prints phase 9's lines and its summary.
Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_phase9: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--ml-taxa", type=int, default=cs.PW_ML_TAXA)
    cs.PW_ML_TAXA = ap.parse_args().ml_taxa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(cs.SEED)
    t0 = time.perf_counter()
    print(cs.phase_pairwise(torch, rng, {"pruning_fwd": {}}, card))
    print(f"phase 9 wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
