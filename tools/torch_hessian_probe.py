#!/usr/bin/env python3
"""What the Hessian route of `codeml.standard_errors` costs on one CUDA
card at the bench alignment, by how many Hessian rows share one backward
pass.

    python3 tools/torch_hessian_probe.py

Simulates chip_smoke.py's phase-6 alignment (32 taxa x 4096 codons under
site classes), fits M0, M2a and M8 (ncatG 10) through the kernels, and
times `codeml.hessian` at each optimum twice: one row per pass with the
patterns in chunks of 2^28 bytes of partials (a plain double backward per
parameter, as HESSIAN_BYTES counts the graph's copies: 21 x 2^28), and the package's setting (HESSIAN_ROWS rows per batched pass,
HESSIAN_BYTES per chunk).  Prints the seconds of each, the largest
relative difference between the two matrices, and last one JSON line.
Needs the card: it exits 2 without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_hessian_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paml_tpu_torch import _build
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import pruning
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.lib()
    rng = np.random.default_rng(cs.SEED)
    names, rows, nwk, _ = cs.simulate_site_classes(torch, rng, 32, 4096,
                                                   "cuda")
    data = seqio.pack(seqio.Alignment(names, rows, seqio.CODON_SEQ))
    tree = treeio.parse_newick(nwk)
    treeio._resolve_names(tree, names)
    topo = from_treenode(tree, names)
    settings = {"per_row": (1, (1 << 28) * (20 + 1)),
                "batched": (codeml.HESSIAN_ROWS, codeml.HESSIAN_BYTES["cuda"])}
    out = {"card": card, "npatt": int(data.npatt), "models": {}}
    for name, kw in (("M0", dict()), ("M2a", dict(NSsites=2)),
                     ("M8", dict(NSsites=8, ncatG=10))):
        spec = codeml.CodemlSpec(**kw)
        res = codeml.fit_packed(data, topo, spec, device="cuda")
        neg = codeml.make_codon_objective(data, topo, spec, device="cuda")[0]
        codeml.hessian(neg, res.x, device="cuda")        # warm-up
        got = {}
        for tag, (nrows, nbytes) in settings.items():
            codeml.HESSIAN_ROWS, codeml.HESSIAN_BYTES["cuda"] = nrows, nbytes
            pruning.TWICE_CALLS["cuda"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            H = codeml.hessian(neg, res.x, device="cuda")
            got[tag] = (time.perf_counter() - t0, H,
                        pruning.TWICE_CALLS["cuda"])
        rel = float(np.abs(got["per_row"][1] - got["batched"][1]).max()
                    / np.abs(got["batched"][1]).max())
        out["models"][name] = {
            "np": len(res.x), "lnL": res.lnL,
            "per_row_s": got["per_row"][0], "batched_s": got["batched"][0],
            "per_row_chunks": got["per_row"][2],
            "batched_chunks": got["batched"][2], "max_rel_diff": rel}
        print(f"{name} [{card}]: {len(res.x)} parameters, lnL {res.lnL:.4f}; "
              f"Hessian one row per pass {got['per_row'][0]:.2f} s "
              f"({got['per_row'][2]} pattern chunks), "
              f"{settings['batched'][0]} rows per pass "
              f"{got['batched'][0]:.2f} s ({got['batched'][2]} chunks); max "
              f"relative difference {rel:.2e}", flush=True)
        if rel > 1e-8:
            raise AssertionError(f"{name}: the two Hessians disagree")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
