"""Do the Hessians behind the SEs repeat bit for bit on the card?

    python3 tools/torch_hessian_repeat_probe.py [ROUNDS [OUT.npz [PREV.npz]]]

Builds, on the card, a 30-taxon x 3000-site nucleotide alignment (REV + G5
simulated as chip_smoke.py's phase 7 simulates, fitted as HKY85 and HKY85
+ G5: the level route's Hessian, `_hessian_twice`) and chip_smoke.py's
32 x 4096 M0 codon alignment (M2a, clean and gapped: the kernels'
route), and takes each Hessian ROUNDS times (default 3) at a fixed x,
with `codeml.hessian`'s deterministic algorithms, with them but the
autograd engine's multithreaded backward (the passes on the card run on
its device thread: the earlier setting, whose Hessians from the third on
are one ulp from the first two), and without either (`codeml._deterministic`
replaced by a null context).  Prints, per case and mode, the time of a
Hessian (the first, a process's warm-up, included), the largest
difference between rounds and whether they are bit for bit the same,
then the operations that PyTorch's deterministic mode reports
as having no deterministic implementation (its warn-only alerts) in one
more Hessian of each case.  With OUT.npz, the first round of each case
under the deterministic algorithms is saved there; with PREV.npz too,
each is compared with PREV's, another process's, bit for bit.  Needs one
CUDA card."""
import contextlib
import os
import sys
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_hessian_repeat_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paml_tpu_torch import _build
    from paml_tpu_torch.apps import baseml, codeml
    from paml_tpu_torch.io import seqio

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    out = sys.argv[2] if len(sys.argv) > 2 else None
    prev = dict(np.load(sys.argv[3])) if len(sys.argv) > 3 else None
    first = {}
    _build.build()
    rng = np.random.default_rng(cs.SEED)
    names, rows, _, _, topo = cs.simulate_nuc(torch, rng, 30, 3000, "cuda")
    nuc = seqio.pack(seqio.Alignment(names, rows, seqio.BASE_SEQ))
    clean, ctopo, gapped = cs.simulate_m0(torch, rng, ns=32, ncod=4096)
    # the codons first: the process's first Hessians, the multithreaded
    # backward first among the modes
    cases = []
    for tag, data in (("clean", clean), ("gapped", gapped)):
        neg, _, _, x0, _, _ = codeml.make_codon_objective(
            data, ctopo, codeml.CodemlSpec(NSsites=2, codonf="F3x4"),
            device="cuda")
        cases.append((f"codons M2a {tag}", neg, np.asarray(x0, float)))
    for tag, spec in (("HKY85", baseml.BasemlSpec(model="HKY85")),
                      ("HKY85 + G5", baseml.BasemlSpec(
                          model="HKY85", ncatG=5, alpha=0.5))):
        neg, _, x0, _ = baseml.make_objective(nuc, topo, spec, device="cuda")
        cases.append((f"nucleotides {tag}", neg, np.asarray(x0, float)))
    card = torch.cuda.get_device_name(0)
    det = codeml._deterministic

    @contextlib.contextmanager
    def multithreaded():
        with det(), torch.autograd.set_multithreading_enabled(True):
            yield
    for name, neg, x in cases:
        for how, ctx in (("deterministic, multithreaded backward",
                          multithreaded),
                         ("deterministic", det),
                         ("default", contextlib.nullcontext)):
            real, codeml._deterministic = codeml._deterministic, ctx
            try:
                t0 = time.perf_counter()
                Hs = [codeml.hessian(neg, x, device="cuda")
                      for _ in range(rounds)]
                sec = (time.perf_counter() - t0) / rounds
            finally:
                codeml._deterministic = real
            if how == "deterministic":
                first[name] = Hs[0]
            diff = max(float(np.abs(h - Hs[0]).max()) for h in Hs[1:])
            same = all(np.array_equal(h, Hs[0]) for h in Hs[1:])
            print(f"{name} [{card}], {how}: {len(x)} parameters, "
                  f"{sec:.2f} s a Hessian, {rounds} rounds max |diff| "
                  f"{diff:.3e} (largest entry {np.abs(Hs[0]).max():.3e}), "
                  f"bit for bit {same}", flush=True)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                real, codeml._deterministic = (codeml._deterministic,
                                               contextlib.nullcontext)
                codeml.hessian(neg, x, device="cuda")
            finally:
                codeml._deterministic = real
                torch.use_deterministic_algorithms(False)
        alerts = sorted({str(w.message).split(" does not have")[0][:120]
                         for w in seen if "deterministic" in str(w.message)})
        print(f"{name}: deterministic mode's alerts {alerts}", flush=True)
    if out:
        np.savez(out, **first)
    for name, H in (prev or {}).items():
        print(f"{name}: this process's first Hessian against another's, "
              f"max |diff| {float(np.abs(first[name] - H).max()):.3e}, bit "
              f"for bit {bool(np.array_equal(first[name], H))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
