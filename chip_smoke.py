#!/usr/bin/env python3
"""Smoke run of paml_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit; TF32 off.
2. Build: the CUDA kernels from paml_tpu_torch/csrc/ (nvcc, timed).
3. Kernels against their plain PyTorch versions on the card: the pruning
   forward (lnf) and adjoint (dP, dpi) at the bench shape (32 taxa on a
   ladder tree x 4096 patterns x 61 states x 3 classes) and at an 11-taxon
   tree with a trifurcating root (193 patterns, 4 classes), for state-code
   and multi-hot tips, in float32 and float64, with one value + gradient
   timed for each.
4. The slice: a codon alignment simulated under M0 (kappa 2, omega 0.3;
   32 taxa x 4096 codons) is fitted with `codeml.fit_packed` on the card
   under M0 and M2a; the kernels must carry the whole run, and the fitted
   lnL must match the plain version's on the card.

Prints a kernels JSON line and, last, {"ok": true, "device": {...}}.  Any
failed phase raises, so the script exits non-zero; so it does with no
CUDA device, or without the paml_tpu_torch package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20240601
BENCH = dict(ns=32, H=4096, C=3, shape="ladder")
UNEVEN = dict(ns=11, H=193, C=4, shape="trifurcating")
# f32: the Pallas kernel's own test tolerances; f64: relative
TOL = {"float32": dict(val=2e-6, grad=3e-5),
       "float64": dict(val=1e-10, grad=1e-8)}


def newick(names, shape, blens=None):
    def lab(i, nm):
        return nm if blens is None else f"{nm}:{blens[i]:.6f}"
    if shape == "ladder":
        s = lab(0, names[0])
        for i, nm in enumerate(names[1:-1], 1):
            s = f"({s},{lab(i, nm)})"
        return f"({s},{lab(len(names) - 1, names[-1])});"

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    ns = len(names)
    a, b = ns // 3, 2 * ns // 3
    return f"({bal(0, a)},{bal(a, b)},{bal(b, ns)});"


def kernel_problem(rng, ns, H, C, shape, n=61):
    """Random P rows (positive, diagonally dominant), pi and tips, as the
    JAX package's kernel tests build them."""
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio

    names = [f"t{i}" for i in range(ns)]
    topo = from_treenode(treeio.parse_newick(newick(names, shape)), names)
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.7 * np.eye(n)[None, None] + 0.3 * P / P.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(n), size=C)
    states = rng.integers(0, n, size=(ns, H)).astype(np.int32)
    hot = np.zeros((ns, H, n))
    hot[np.arange(ns)[:, None], np.arange(H)[None, :], states] = 1.0
    amb = rng.integers(0, H, size=max(10, H // 20))
    hot[0, amb] = 0.0
    hot[0, amb, :5] = 1.0
    gbar = rng.uniform(0.5, 2.0, size=(C, H))
    return topo, P, pi, states, hot, gbar


def cuda_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
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


def max_err(got, ref, rtol, what):
    """max |got - ref|; raises unless |got - ref| <= rtol (|ref| + max|ref|)
    elementwise (atol scaled to the array, for sums over many patterns)."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} vs {ref.shape} or "
                             "non-finite values")
    err = np.abs(got - ref)
    bound = rtol * (np.abs(ref) + np.abs(ref).max())
    if not (err <= bound).all():
        i = np.unravel_index(np.argmax(err - bound), err.shape)
        raise AssertionError(f"{what}: |diff| {err[i]:.3e} > {bound[i]:.3e} "
                             f"at {i} (kernel {got[i]!r}, plain {ref[i]!r})")
    return float(err.max())


def phase_kernels(torch, rng, report, card):
    from paml_tpu_torch.core import cuda_pruning, pruning

    for cfg in (BENCH, UNEVEN):
        topo, P_np, pi_np, st_np, hot_np, gb_np = kernel_problem(rng, **cfg)
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).split(".")[1]
            tol = TOL[dn]
            P = torch.tensor(P_np, dtype=dtype, device="cuda")
            pi = torch.tensor(pi_np, dtype=dtype, device="cuda")
            gbar = torch.tensor(gb_np, dtype=dtype, device="cuda")
            for enc, tips in (("states", torch.tensor(st_np, device="cuda")),
                              ("multihot", torch.tensor(hot_np, dtype=dtype,
                                                        device="cuda"))):
                tag = f"{cfg['shape']} {cfg['ns']}x{cfg['H']}x{cfg['C']} {dn} {enc}"
                lnf = cuda_pruning.pruning_fwd(P, tips, topo, pi)
                dP, dpi = cuda_pruning.pruning_bwd(P, tips, topo, pi, gbar)
                torch.cuda.synchronize()
                with torch.no_grad():
                    lnf_r = pruning.class_site_lnf_plain(P, tips, topo, pi)
                dP_r, dpi_r = pruning.class_site_lnf_bwd_plain(
                    P, tips, topo, pi, gbar)
                e_f = max_err(lnf, lnf_r, tol["val"], f"lnf {tag}")
                e_b = max(max_err(dP, dP_r, tol["grad"], f"dP {tag}"),
                          max_err(dpi, dpi_r, tol["grad"], f"dpi {tag}"))
                print(f"kernel vs plain [{tag}]: lnf max|diff| {e_f:.3e}, "
                      f"dP/dpi max|diff| {e_b:.3e}", flush=True)
                for name, e in (("pruning_fwd", e_f), ("pruning_bwd", e_b)):
                    key = f"max_abs_err_{dn}"
                    report[name][key] = max(report[name].get(key, 0.0), e)
                if cfg is BENCH and enc == "states":
                    times = {
                        "pruning_fwd": cuda_ms(lambda: cuda_pruning.pruning_fwd(
                            P, tips, topo, pi)),
                        "pruning_bwd": cuda_ms(lambda: cuda_pruning.pruning_bwd(
                            P, tips, topo, pi, gbar)),
                    }
                    plain = {}
                    with torch.no_grad():
                        plain["pruning_fwd"] = cuda_ms(
                            lambda: pruning.class_site_lnf_plain(P, tips, topo,
                                                                 pi))
                    plain["pruning_bwd"] = cuda_ms(
                        lambda: pruning.class_site_lnf_bwd_plain(
                            P, tips, topo, pi, gbar))
                    for name in times:
                        report[name][f"ms_{dn}"] = times[name]
                        report[name][f"plain_ms_{dn}"] = plain[name]
                    print(f"  time [{tag}, {card}]: fwd kernel "
                          f"{times['pruning_fwd']:.3f} "
                          f"ms, plain {plain['pruning_fwd']:.3f} ms; adjoint "
                          f"kernel {times['pruning_bwd']:.3f} ms, plain "
                          f"{plain['pruning_bwd']:.3f} ms; value+grad kernel "
                          f"{times['pruning_fwd'] + times['pruning_bwd']:.3f}"
                          f" ms, plain {plain['pruning_fwd'] + plain['pruning_bwd']:.3f} ms",
                          flush=True)
                if cfg is BENCH and enc == "states" and dtype == torch.float64:
                    # a workspace budget too small for one block per tile:
                    # 5 blocks per class walk the 64 tiles and add into
                    # their slabs
                    full = cuda_pruning.bwd_grid
                    cuda_pruning.bwd_grid = lambda *args: 5
                    try:
                        dP5, dpi5 = cuda_pruning.pruning_bwd(P, tips, topo,
                                                             pi, gbar)
                    finally:
                        cuda_pruning.bwd_grid = full
                    e5 = max(max_err(dP5, dP_r, tol["grad"], f"dP G=5 {tag}"),
                             max_err(dpi5, dpi_r, tol["grad"],
                                     f"dpi G=5 {tag}"))
                    report["pruning_bwd"]["max_abs_err_float64"] = max(
                        report["pruning_bwd"]["max_abs_err_float64"], e5)
                    print(f"  adjoint with 5 blocks per class over "
                          f"{-(-cfg['H'] // cuda_pruning.HT)} tiles "
                          f"[{tag}]: dP/dpi max|diff| {e5:.3e}", flush=True)


def simulate_m0(torch, rng, ns, ncod, kappa=2.0, omega=0.3):
    """Codon alignment simulated under M0 on a ladder tree with the port's
    own float64 P(t) (F3x4 frequencies from random nucleotide tables)."""
    from paml_tpu_torch.constants import codon_string
    from paml_tpu_torch.core.pmat import pmat_rev_multi
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio
    from paml_tpu_torch.models import codon

    names = [f"t{i}" for i in range(ns)]
    blens = rng.uniform(0.02, 0.3, size=ns)
    tree = treeio.parse_newick(newick(names, "ladder", blens))
    for node in tree.walk_post():
        if node.blen is None:
            node.blen = float(rng.uniform(0.02, 0.3))
    topo = from_treenode(tree, names)
    graph = codon.codon_graph(0)
    f3x4 = rng.dirichlet(np.full(4, 8.0), size=3)
    pi_np = codon.codon_pi("F3x4", None, f3x4, f3x4.mean(0), graph)
    T = codon.dense_tables(0, "cuda")
    pi = torch.tensor(pi_np, dtype=torch.float64, device="cuda")
    s = codon.mutation_dense(T, torch.tensor([kappa], dtype=torch.float64,
                                             device="cuda"))
    Q = codon.build_Q_dense(T, s, torch.tensor([omega], dtype=torch.float64,
                                               device="cuda"), pi)
    rs, ra = codon.flux_dense(T, s, pi)
    t = torch.tensor(topo.blen0, dtype=torch.float64, device="cuda")
    t[topo.root] = 0.0
    P = pmat_rev_multi(Q, pi, (t / (rs + ra * omega))[:, None])[:, 0]
    P = P.cpu().numpy()
    cum = np.cumsum(P / P.sum(-1, keepdims=True), axis=-1)
    st = np.zeros((topo.nnode, ncod), dtype=np.int64)
    st[topo.root] = rng.choice(graph.n, size=ncod, p=pi_np)
    stack = [topo.root]
    while stack:
        v = stack.pop()
        for c in topo.children[v]:
            if c < 0:
                continue
            u = rng.random(ncod)
            st[c] = np.minimum((u[:, None] > cum[c][st[v]]).sum(-1),
                               graph.n - 1)
            stack.append(int(c))
    rows = ["".join(codon_string(int(graph.sense[k])) for k in st[i])
            for i in range(ns)]
    data = seqio.pack(seqio.Alignment(names, rows, seqio.CODON_SEQ))
    return data, topo


def plain_lnl(torch, neg, x):
    """lnL at x with the plain pruning version on the card."""
    from paml_tpu_torch.core import pruning
    with torch.no_grad():
        P, piC, freqs = neg.model_at(x)
        lnf = pruning.class_site_lnf_plain(P, neg.tips, neg.topo,
                                           piC.contiguous())
        site = torch.logsumexp(lnf + torch.log(freqs)[:, None], dim=0)
        return float(torch.sum(neg.fpatt * site))


def proj_grad_max(torch, neg, x, bounds):
    xt = torch.tensor(x, dtype=torch.float64, device="cuda",
                      requires_grad=True)
    (g,) = torch.autograd.grad(neg(xt), xt)
    g = g.cpu().numpy()
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    g = np.where((x <= lo + 1e-12) & (g > 0), 0.0, g)
    g = np.where((x >= hi - 1e-12) & (g < 0), 0.0, g)
    return float(np.abs(g).max())


def phase_slice(torch, rng, report, card):
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    t0 = time.perf_counter()
    data, topo = simulate_m0(torch, rng, ns=32, ncod=4096)
    print(f"simulated M0 alignment: {data.ns} taxa x {data.ls} codons, "
          f"{data.npatt} patterns ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    specs = {"M0": codeml.CodemlSpec(NSsites=0, codonf="F3x4"),
             "M2a": codeml.CodemlSpec(NSsites=2, codonf="F3x4")}
    cuda_pruning.reset_launch_counts()
    pruning.PLAIN_CALLS["cuda"] = 0
    fits = {}
    for name, spec in specs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = codeml.fit_packed(data, topo, spec, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fits[name] = (res, wall)
        print(f"fit {name} [{card}]: lnL {res.lnL:.6f}, kappa {res.kappa}, omegas "
              f"{res.class_omegas.ravel()}, freqs {res.class_freqs}, "
              f"{res.fit.n_eval} evals, {wall:.2f} s wall, "
              f"{1e3 * wall / res.fit.n_eval:.2f} ms/eval ({res.fit.message})",
              flush=True)
    launches = dict(cuda_pruning.LAUNCHES)
    plain_cuda = pruning.PLAIN_CALLS["cuda"]
    print(f"main path: kernel launches {launches}, plain-version calls on "
          f"CUDA {plain_cuda}", flush=True)
    for name in ("pruning_fwd", "pruning_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
        report[name]["launches"] = launches[name]
    if plain_cuda:
        raise AssertionError(f"plain pruning ran {plain_cuda} times on CUDA "
                             "inside the main path")
    # correctness of the fits
    for name, spec in specs.items():
        res, _ = fits[name]
        neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
            data, topo, spec, device="cuda")
        x = torch.tensor(res.x, dtype=torch.float64, device="cuda")
        with torch.no_grad():
            lnl_kernel = -float(neg(x))
            lnl_x0 = -float(neg(torch.tensor(x0, dtype=torch.float64,
                                             device="cuda")))
        lnl_plain = plain_lnl(torch, neg, x)
        pg = proj_grad_max(torch, neg, res.x, bounds)
        rel = abs(lnl_kernel - lnl_plain) / abs(lnl_plain)
        print(f"check {name}: lnL kernel {lnl_kernel:.9f}, plain "
              f"{lnl_plain:.9f} (rel {rel:.2e}), at x0 {lnl_x0:.4f}, max "
              f"projected |grad| {pg:.2e}, converged {res.fit.converged}",
              flush=True)
        if not np.isfinite(res.lnL) or res.lnL < lnl_x0:
            raise AssertionError(f"{name}: fit did not improve on its start")
        if not (res.fit.converged or pg < 1e-2):
            raise AssertionError(f"{name}: not converged ({res.fit.message},"
                                 f" projected gradient {pg:.2e})")
        if rel > 1e-9 or abs(lnl_kernel - res.lnL) > 1e-9 * abs(res.lnL):
            raise AssertionError(f"{name}: lnL disagrees with the plain "
                                 "version on the card")
    m0, m2a = fits["M0"][0], fits["M2a"][0]
    if m2a.lnL < m0.lnL - 1e-6 * abs(m0.lnL):
        raise AssertionError("M2a (which nests M0) fitted below M0")
    if abs(float(m0.class_omegas.ravel()[0]) - 0.3) > 0.1 or \
            abs(float(m0.kappa[0]) - 2.0) > 0.5:
        raise AssertionError("M0 estimates far from the simulated kappa 2, "
                             "omega 0.3")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paml_tpu_torch import _build

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    # 2. build
    t0 = time.perf_counter()
    path = _build.build()
    print(f"built {path.name} from paml_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    _build.lib()
    # 3. kernels against the plain version
    rng = np.random.default_rng(SEED)
    report = {name: {"name": name, "route": "cuda",
                     "source": "paml_tpu_torch/csrc/pruning.cu",
                     "replaces": src}
              for name, src in (
                  ("pruning_fwd", "paml_tpu/core/pallas_pruning.py:389"),
                  ("pruning_bwd", "paml_tpu/core/pallas_pruning.py:406"))}
    phase_kernels(torch, rng, report, smi[0])
    # 4. the slice
    phase_slice(torch, rng, report, smi[0])
    kernels = []
    for r in report.values():
        r["max_abs_err"] = r["max_abs_err_float64"]
        r["ms"] = r["ms_float64"]
        r["plain_ms"] = r["plain_ms_float64"]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
