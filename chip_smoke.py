#!/usr/bin/env python3
"""Smoke run of paml_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit; TF32 off.
2. Build: the CUDA kernels from paml_tpu_torch/csrc/ (one nvcc per source,
   side by side, timed).
3. B1/B2 (coded tips with an ambiguity table) against their plain
   PyTorch versions on the card: the pruning forward (lnf, and the
   residual S on the binary tree the kernels walk) and adjoint (dP, dpi)
   at the bench shape (32 taxa on a ladder tree x 4096 patterns x 61
   states x 3 classes) and at an 11-taxon tree with a trifurcating root
   (193 patterns, 4 classes), in float32 and float64, for state codes,
   multi-hot partials (one table row) and partials whose table passes 64
   rows (also with 5 adjoint blocks per class: multi-tile visits); each
   kernel timed with multi-hot tips at the bench shape, beside its bound.
3b. B3/B4 (the large-tree pair) against their plain versions (lnf, the
   residual S, dP, dpi, on the tree the kernels walk) and against the
   level path, in float32 and float64, at the bench shape with 3 classes
   and with 1 (M0's), the uneven shape, a 128-taxon balanced tree x 1024
   patterns x 3 classes and one 1024-pattern chunk of the 1024-taxon
   balanced tree (4 classes); B1/B2 on the same states with gaps (runs of
   mean 10 codons over about 5 % of the cells) and Ns (0.2 % of the
   codons), against their plain versions; B3+B4 on the state codes, B1+B2
   on the gapped tips and on the same state codes, and the plain version
   timed at each (the dispatch rule's evidence), each kernel beside its
   bound.
4. The M0 path: a codon alignment simulated under M0 (kappa 2, omega 0.3;
   32 taxa x 4096 codons) is fitted with `codeml.fit_packed` on the card
   under M0 and M2a, B3/B4 carrying the fits (state-code tips); then the
   same alignment with the last taxon's second half gaps (coded tips with
   a table), B1/B2 carrying the fits.  Each fitted lnL must match the
   plain version's on the card; each fit reports ms per evaluation.
5. The branch-site path: an alignment simulated under branch-site model A
   (kappa 2, p0 0.5, p1 0.3, w0 0.1, w2 4; 1024 taxa on a balanced tree
   with #1 on the root's left child, 10240 codons, Fequal) with the
   port's own P(t).  One value + gradient with every branch length free
   in 10 pattern chunks is held against the chunked plain version on the
   card, and timed beside one unchunked; B3/B4 at the unchunked shape
   timed, with their share of the bound, and held against their plain
   versions chunk by chunk; then `codeml.fit_packed` fits model A with the
   branch lengths fixed, twice: B3/B4 must carry the whole fit, and the
   two fits must give the same lnL bit for bit.  Then the same alignment
   with the gaps and Ns of 3b: value + gradient in 10 chunks against the
   plain version, twice unchunked (the same bits), B1/B2 timed unchunked,
   and the model A fit, carried by B1/B2 alone.  Each fit reports ms per
   evaluation gross and net of its own objective's set-up, timed apart.

Prints a kernels JSON line and, last, {"ok": true, "device": {...}}.  Any
failed phase raises, so the script exits non-zero; so it does with no
CUDA device, or without the paml_tpu_torch package beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

SEED = 20240601
BENCH = dict(ns=32, H=4096, C=3, shape="ladder")
BENCH1 = dict(ns=32, H=4096, C=1, shape="ladder")     # M0's one class
UNEVEN = dict(ns=11, H=193, C=4, shape="trifurcating")
MID = dict(ns=128, H=1024, C=3, shape="balanced")
CHUNK = dict(ns=1024, H=1024, C=4, shape="balanced")
# the JAX package's north-star shape (bench.py:46-48)
BIG_TAXA, BIG_NPATT, BIG_CHUNKS = 1024, 10240, 10
BS_TRUTH = dict(kappa=2.0, p0=0.5, p1=0.3, w0=0.1, w2=4.0)
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
            return lab(lo, names[lo])
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    ns = len(names)
    if shape == "balanced":
        return bal(0, ns) + ";"
    a, b = ns // 3, 2 * ns // 3
    return f"({bal(0, a)},{bal(a, b)},{bal(b, ns)});"


def kernel_problem(rng, ns, H, C, shape, n=61, multihot=True):
    """Random P rows (positive, diagonally dominant), pi and tips, as the
    JAX package's kernel tests build them; with `multihot` also two sets of
    [ns, H, n] partials: `hot` (tip 0 takes the first 5 states at 1 in 20
    patterns, the JAX tests' ambiguity) and `wide` (1 in 10 cells of every
    taxon a gap or one of 150 random sets of 2-6 states: an ambiguity table
    of more than 64 rows)."""
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio

    names = [f"t{i}" for i in range(ns)]
    topo = from_treenode(treeio.parse_newick(newick(names, shape)), names)
    P = rng.gamma(1.0, 1.0, size=(topo.nnode, C, n, n))
    P = 0.7 * np.eye(n)[None, None] + 0.3 * P / P.sum(-1, keepdims=True)
    pi = rng.dirichlet(np.ones(n), size=C)
    states = rng.integers(0, n, size=(ns, H)).astype(np.int32)
    hot = wide = None
    if multihot:
        hot = np.zeros((ns, H, n))
        hot[np.arange(ns)[:, None], np.arange(H)[None, :], states] = 1.0
        wide = hot.copy()
        amb = rng.integers(0, H, size=max(10, H // 20))
        hot[0, amb] = 0.0
        hot[0, amb, :5] = 1.0
        pool = np.zeros((151, n))
        pool[0] = 1.0                                   # a gap
        for row in pool[1:]:
            row[rng.choice(n, size=int(rng.integers(2, 7)),
                           replace=False)] = 1.0
        cell = rng.random((ns, H)) < 0.1
        wide[cell] = pool[rng.integers(0, 151, size=int(cell.sum()))]
    gbar = rng.uniform(0.5, 2.0, size=(C, H))
    return topo, P, pi, states, (hot, wide), gbar


def gapped_codes(rng, states, n=61):
    """Gapped codon tips from sense-codon state codes [ns, H]: gaps in runs
    of geometric length (mean 10 codons) over about 5 % of each taxon's
    cells, and one N at a random position in 0.2 % of the codons, as
    TipCodes arrays (codes [ns, H] int32, amb [A, n] float64): a code n + a
    names amb row a, row 0 the gap (all ones), the others the sets of
    codons that an N allows (the sense codons agreeing at the two other
    positions)."""
    from paml_tpu_torch.models import codon

    pos = codon.codon_graph(0).pos_nt                   # [n, 3]
    ns, H = states.shape
    codes = np.array(states, dtype=np.int32)
    runs = rng.poisson(0.05 * H / 10, size=ns)
    for t in range(ns):
        for s0, ln in zip(rng.integers(0, H, size=runs[t]),
                          rng.geometric(0.1, size=runs[t])):
            codes[t, s0:s0 + ln] = n
    ti, hi = np.nonzero((rng.random((ns, H)) < 0.002) & (codes < n))
    rows, index = [np.ones(n)], {}
    for t, h, p in zip(ti, hi, rng.integers(0, 3, size=len(ti))):
        others = [q for q in range(3) if q != p]
        key = (int(p),) + tuple(int(x) for x in pos[codes[t, h], others])
        if key not in index:
            index[key] = len(rows)
            rows.append(np.all(pos[:, others] == pos[codes[t, h], others],
                               axis=1).astype(np.float64))
        codes[t, h] = n + index[key]
    return codes, np.stack(rows)


def coded_tips(torch, codes, amb, dtype):
    from paml_tpu_torch.core.tipcodes import TipCodes
    return TipCodes(torch.tensor(codes, device="cuda"),
                    torch.tensor(amb, dtype=dtype, device="cuda"))


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
    elementwise (atol scaled to the array, for sums over many patterns).
    Computed where the tensors lie."""
    import torch
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite values")
    err = (got - ref).abs()
    bound = rtol * (ref.abs() + ref.abs().max())
    if bool((err > bound).any()):
        i = np.unravel_index(int(torch.argmax(err - bound)), err.shape)
        raise AssertionError(f"{what}: |diff| {float(err[i]):.3e} > "
                             f"{float(bound[i]):.3e} at {i} (kernel "
                             f"{float(got[i])!r}, plain {float(ref[i])!r})")
    return float(err.max())


def bound(name, topo, C, H, n, esize, n_amb=0):
    """(bound_ms, bound_by) of kernel `name` on these shapes: the larger
    of its operations over the card's peak rate and its bytes over the
    memory rate (cuda_pruning.kernel_work, PEAK_FLOPS, PEAK_BYTES)."""
    from paml_tpu_torch.core import cuda_pruning as cp
    flop, nbytes = cp.kernel_work(name, topo, C, H, n, esize, n_amb)
    by = "operations" if flop / cp.PEAK_FLOPS >= nbytes / cp.PEAK_BYTES \
        else "bytes"
    return cp.bound_ms(flop, nbytes), by


def record(report, name, dn, ms, plain_ms, bnd):
    report[name][f"ms_{dn}"] = ms
    report[name][f"plain_ms_{dn}"] = plain_ms
    report[name][f"bound_ms_{dn}"], report[name][f"bound_by_{dn}"] = bnd


def n_amb_of(tips):
    from paml_tpu_torch.core import cuda_pruning
    t = cuda_pruning.kernel_tips(tips)
    return getattr(t, "n_amb", 0)


def check_fused(torch, P, tips, topo, pi, gbar, tol, tag):
    """B1 (lnf, S) and B2 (dP, dpi) against the plain versions on the
    card: lnf, dP and dpi against the level path on `topo`, S against the
    residual form on the binary tree the kernels walk.  Returns (max
    |diff| of B1, of B2, S)."""
    from paml_tpu_torch.core import cuda_pruning, pruning

    lnf, S = cuda_pruning.pruning_fwd(P, tips, topo, pi)
    dP, dpi = cuda_pruning.pruning_bwd(P, tips, topo, pi, gbar, S)
    torch.cuda.synchronize()
    with torch.no_grad():
        lnf_r = pruning.class_site_lnf_plain(P, tips, topo, pi)
    e_f = max_err(lnf, lnf_r, tol["val"], f"B1 lnf {tag}")
    del lnf_r
    tb = cuda_pruning.big_tree(topo)
    S_r = pruning.class_site_lnf_big_plain(
        cuda_pruning.with_identity(P, tb), tips, tb, pi)[1]
    e_f = max(e_f, max_err(S, S_r, tol["val"], f"B1 S {tag}"))
    del S_r
    dP_r, dpi_r = pruning.class_site_lnf_bwd_plain(P, tips, topo, pi, gbar)
    e_b = max(max_err(dP, dP_r, tol["grad"], f"B2 dP {tag}"),
              max_err(dpi, dpi_r, tol["grad"], f"B2 dpi {tag}"))
    return e_f, e_b, S


def phase_kernels(torch, rng, report, card):
    from paml_tpu_torch.core import cuda_pruning, pruning

    for cfg in (BENCH, UNEVEN):
        topo, P_np, pi_np, st_np, (hot_np, wide_np), gb_np = kernel_problem(
            rng, **cfg)
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).split(".")[1]
            tol = TOL[dn]
            P = torch.tensor(P_np, dtype=dtype, device="cuda")
            pi = torch.tensor(pi_np, dtype=dtype, device="cuda")
            gbar = torch.tensor(gb_np, dtype=dtype, device="cuda")
            for enc, tips in (
                    ("states", torch.tensor(st_np, device="cuda")),
                    ("multihot", torch.tensor(hot_np, dtype=dtype,
                                              device="cuda")),
                    ("wide", torch.tensor(wide_np, dtype=dtype,
                                          device="cuda"))):
                A = n_amb_of(tips)
                tag = (f"{cfg['shape']} {cfg['ns']}x{cfg['H']}x{cfg['C']} "
                       f"{dn} {enc}, A {A}")
                e_f, e_b, S = check_fused(torch, P, tips, topo, pi, gbar,
                                          tol, tag)
                print(f"B1/B2 vs plain [{tag}]: lnf/S max|diff| {e_f:.3e}, "
                      f"dP/dpi max|diff| {e_b:.3e}", flush=True)
                for name, e in (("pruning_fwd", e_f), ("pruning_bwd", e_b)):
                    key = f"max_abs_err_{dn}"
                    report[name][key] = max(report[name].get(key, 0.0), e)
                if enc == "wide" and cfg is BENCH and dtype == torch.float64:
                    if A <= 64:
                        raise AssertionError(f"{tag}: the wide tips' table "
                                             "should pass 64 rows")
                    # 5 blocks per class: visits of 16 and 10 of the 128
                    # tiles, the tips' dP summed across the visits
                    full = cuda_pruning.big_bwd_grid
                    cuda_pruning.big_bwd_grid = lambda *args: 5
                    try:
                        dP5, dpi5 = cuda_pruning.pruning_bwd(P, tips, topo,
                                                             pi, gbar, S)
                    finally:
                        cuda_pruning.big_bwd_grid = full
                    dP_r, dpi_r = pruning.class_site_lnf_bwd_plain(
                        P, tips, topo, pi, gbar)
                    e5 = max(max_err(dP5, dP_r, tol["grad"], f"dP G=5 {tag}"),
                             max_err(dpi5, dpi_r, tol["grad"],
                                     f"dpi G=5 {tag}"))
                    report["pruning_bwd"]["max_abs_err_float64"] = max(
                        report["pruning_bwd"]["max_abs_err_float64"], e5)
                    print(f"  adjoint with 5 blocks per class over "
                          f"{cuda_pruning.big_tiles(cfg['H'])} tiles "
                          f"[{tag}]: dP/dpi max|diff| {e5:.3e}", flush=True)
                if cfg is BENCH and enc == "multihot":
                    # the tips B1/B2 serve on the M0 path's gapped fits
                    times = {
                        "pruning_fwd": cuda_ms(lambda: cuda_pruning.pruning_fwd(
                            P, tips, topo, pi)),
                        "pruning_bwd": cuda_ms(lambda: cuda_pruning.pruning_bwd(
                            P, tips, topo, pi, gbar, S)),
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
                        bnd = bound(name, topo, cfg["C"], cfg["H"],
                                    P.shape[-1], P.element_size(), A)
                        record(report, name, dn, times[name], plain[name], bnd)
                        print(f"  {name} [{tag}]: bound {bnd[0]:.4f} ms "
                              f"({bnd[1]}), {100 * bnd[0] / times[name]:.1f}"
                              " % of it", flush=True)
                    print(f"  time [{tag}, {card}]: B1 (with S) "
                          f"{times['pruning_fwd']:.3f} "
                          f"ms, plain {plain['pruning_fwd']:.3f} ms; B2 "
                          f"{times['pruning_bwd']:.3f} ms, plain "
                          f"{plain['pruning_bwd']:.3f} ms; value+grad kernel "
                          f"{times['pruning_fwd'] + times['pruning_bwd']:.3f}"
                          f" ms, plain {plain['pruning_fwd'] + plain['pruning_bwd']:.3f} ms",
                          flush=True)
                del S
            torch.cuda.empty_cache()


def phase_big_kernels(torch, rng, report, card):
    from paml_tpu_torch.core import cuda_pruning, pruning

    props = torch.cuda.get_device_properties(0)
    for cfg in (BENCH, BENCH1, UNEVEN, MID, CHUNK):
        topo, P_np, pi_np, st_np, _, gb_np = kernel_problem(
            rng, **cfg, multihot=False)
        # the same states with gaps and Ns: B1/B2's tips
        g_codes, g_amb = gapped_codes(rng, st_np)
        # the tree the kernels walk (nodes of more than BIG_KMAX children
        # resolved); the plain residual versions run on it too
        tb = cuda_pruning.big_tree(topo)
        bp = cuda_pruning.big_plan(tb)
        ntiles = cuda_pruning.big_tiles(cfg["H"])
        for dtype in (torch.float64, torch.float32):
            dn = str(dtype).split(".")[1]
            tol = TOL[dn]
            P = torch.tensor(P_np, dtype=dtype, device="cuda")
            pi = torch.tensor(pi_np, dtype=dtype, device="cuda")
            gbar = torch.tensor(gb_np, dtype=dtype, device="cuda")
            tips = torch.tensor(st_np, device="cuda")
            gap = coded_tips(torch, g_codes, g_amb, dtype)
            tag = f"{cfg['shape']} {cfg['ns']}x{cfg['H']}x{cfg['C']} {dn}"
            lnf, S = cuda_pruning.pruning_big_fwd(P, tips, topo, pi)
            dP, dpi = cuda_pruning.pruning_big_bwd(P, tips, topo, pi, gbar, S)
            torch.cuda.synchronize()
            Pb = cuda_pruning.with_identity(P, tb)
            lnf_r, S_r = pruning.class_site_lnf_big_plain(Pb, tips, tb, pi)
            e_f = max(max_err(lnf, lnf_r, tol["val"], f"B3 lnf {tag}"),
                      max_err(S, S_r, tol["val"], f"B3 S {tag}"))
            del S_r
            dP_r, dpi_r = pruning.class_site_lnf_big_bwd_plain(
                Pb, tips, tb, pi, gbar, S)
            dP_r = dP_r[:topo.nnode]
            e_b = max(max_err(dP, dP_r, tol["grad"], f"B4 dP {tag}"),
                      max_err(dpi, dpi_r, tol["grad"], f"B4 dpi {tag}"))
            del dP_r, dpi_r
            # and against the level path
            with torch.no_grad():
                lnf_l = pruning.class_site_lnf_plain(P, tips, topo, pi)
            dP_l, dpi_l = pruning.class_site_lnf_bwd_plain(P, tips, topo, pi,
                                                           gbar)
            e_l = max(max_err(lnf, lnf_l, tol["val"], f"B3 lnf/level {tag}"),
                      max_err(dP, dP_l, tol["grad"], f"B4 dP/level {tag}"),
                      max_err(dpi, dpi_l, tol["grad"], f"B4 dpi/level {tag}"))
            del dP_l, dpi_l, dP, dpi
            G = cuda_pruning.big_bwd_grid(
                tb.nnode, cfg["C"], ntiles, P.element_size(),
                props.multi_processor_count, props.total_memory,
                bp.work_per_block)
            print(f"B3/B4 vs plain [{tag}]: lnf/S max|diff| {e_f:.3e}, "
                  f"dP/dpi max|diff| {e_b:.3e}; vs level path {e_l:.3e}; "
                  f"blocks B1/B3 {ntiles * cfg['C']}, B2/B4 G = {G} x C = "
                  f"{G * cfg['C']}; S {S.numel() * S.element_size() / 1e9:.3f}"
                  " GB", flush=True)
            for name, e in (("big_fwd", max(e_f, e_l)),
                            ("big_bwd", max(e_b, e_l))):
                key = f"max_abs_err_{dn}"
                report[name][key] = max(report[name].get(key, 0.0), e)
            # B1/B2 on the gapped tips
            A = gap.n_amb
            gtag = f"{tag}, gapped, A {A}"
            g_f, g_b, gS = check_fused(torch, P, gap, topo, pi, gbar, tol,
                                       gtag)
            print(f"B1/B2 vs plain [{gtag}]: lnf/S max|diff| {g_f:.3e}, "
                  f"dP/dpi max|diff| {g_b:.3e}", flush=True)
            for name, e in (("pruning_fwd", g_f), ("pruning_bwd", g_b)):
                key = f"max_abs_err_{dn}"
                report[name][key] = max(report[name].get(key, 0.0), e)
            reps = dict(reps=3, warmup=1) if cfg is CHUNK else {}
            # B1/B2 on the clean state codes too (A = 0): the dispatch
            # sends them to B3/B4, and this says whether that pays
            sS = cuda_pruning.pruning_fwd(P, tips, topo, pi)[1]
            t = {
                "states_fwd": cuda_ms(lambda: cuda_pruning.pruning_fwd(
                    P, tips, topo, pi), **reps),
                "states_bwd": cuda_ms(lambda: cuda_pruning.pruning_bwd(
                    P, tips, topo, pi, gbar, sS), **reps),
                "big_fwd": cuda_ms(lambda: cuda_pruning.pruning_big_fwd(
                    P, tips, topo, pi), **reps),
                "big_bwd": cuda_ms(lambda: cuda_pruning.pruning_big_bwd(
                    P, tips, topo, pi, gbar, S), **reps),
                "pruning_fwd": cuda_ms(lambda: cuda_pruning.pruning_fwd(
                    P, gap, topo, pi), **reps),
                "pruning_bwd": cuda_ms(lambda: cuda_pruning.pruning_bwd(
                    P, gap, topo, pi, gbar, gS), **reps),
                "plain_fwd": cuda_ms(lambda: pruning.class_site_lnf_big_plain(
                    Pb, tips, tb, pi), **reps),
                "plain_bwd": cuda_ms(
                    lambda: pruning.class_site_lnf_big_bwd_plain(
                        Pb, tips, tb, pi, gbar, S), **reps),
            }
            for name in ("big_fwd", "big_bwd", "pruning_fwd", "pruning_bwd"):
                fused = name.startswith("pruning")
                bnd = bound(name, topo, cfg["C"], cfg["H"], P.shape[-1],
                            P.element_size(), A if fused else 0)
                print(f"  {name} [{gtag if fused else tag}]: {t[name]:.3f} "
                      f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
                      f"{100 * bnd[0] / t[name]:.1f} % of it", flush=True)
                if cfg is CHUNK and not fused:
                    record(report, name, dn, t[name], t[f"plain_{name[4:]}"],
                           bnd)
                if cfg is CHUNK and fused:
                    report[name][f"ms_chunk_gapped_{dn}"] = t[name]
                    report[name][f"bound_ms_chunk_gapped_{dn}"] = bnd[0]
            print(f"  time [{tag}, {card}]: B3 {t['big_fwd']:.3f} ms + B4 "
                  f"{t['big_bwd']:.3f} ms = "
                  f"{t['big_fwd'] + t['big_bwd']:.3f} ms on state codes; "
                  f"B1 {t['pruning_fwd']:.3f} + B2 {t['pruning_bwd']:.3f} = "
                  f"{t['pruning_fwd'] + t['pruning_bwd']:.3f} ms gapped "
                  f"({(t['pruning_fwd'] + t['pruning_bwd']) / (t['big_fwd'] + t['big_bwd']):.2f}"
                  f"x); plain {t['plain_fwd']:.3f} + {t['plain_bwd']:.3f} = "
                  f"{t['plain_fwd'] + t['plain_bwd']:.3f} ms", flush=True)
            print(f"  time [{tag}, {card}]: B1 {t['states_fwd']:.3f} + B2 "
                  f"{t['states_bwd']:.3f} = "
                  f"{t['states_fwd'] + t['states_bwd']:.3f} ms on the same "
                  f"state codes (A 0), "
                  f"{(t['states_fwd'] + t['states_bwd']) / (t['big_fwd'] + t['big_bwd']):.3f}"
                  " x B3+B4", flush=True)
            del S, sS, gS, Pb, gap
            torch.cuda.empty_cache()


def simulate_m0(torch, rng, ns, ncod, kappa=2.0, omega=0.3):
    """Codon alignment simulated under M0 on a ladder tree with the port's
    own float64 P(t) (F3x4 frequencies from random nucleotide tables):
    (packed data, topology, the same data with the last taxon's second
    half gaps).  Gaps make that taxon's tips multi-hot partials (every
    sense codon, cleandata = 0), the tips B1/B2 serve."""
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
    half = 3 * (ncod // 2)
    rows[-1] = rows[-1][:half] + "-" * (3 * ncod - half)
    gapped = seqio.pack(seqio.Alignment(names, rows, seqio.CODON_SEQ))
    return data, topo, gapped


def plain_value_grad(torch, neg, x, n_chunks, grad=True):
    """lnL at x (and its gradient in x) with the plain pruning version on
    the objective's device, the patterns in n_chunks chunks, each chunk's
    graph freed before the next: (lnL, d lnL / dx or None)."""
    from paml_tpu_torch.core import pruning
    xt = torch.tensor(x, dtype=torch.float64, device=neg.fpatt.device,
                      requires_grad=grad)
    with torch.set_grad_enabled(grad):
        outs = neg.model_at(xt)
    ins = [o.detach().requires_grad_(o.requires_grad) for o in outs]
    total = 0.0
    for tc, fc in zip(*pruning.split_patterns(neg.tips, neg.fpatt,
                                              n_chunks)):
        with torch.set_grad_enabled(grad):
            lnf = pruning.class_site_lnf_plain(ins[0], tc, neg.topo, ins[1])
            v = torch.sum(fc * torch.logsumexp(
                lnf + torch.log(ins[2])[:, None], dim=0))
        if grad:
            v.backward()
        total += float(v.detach())
    if not grad:
        return total, None
    torch.autograd.backward([o for o in outs if o.requires_grad],
                            [i.grad for i in ins if i.requires_grad])
    return total, xt.grad.cpu().numpy()


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
    clean, topo, gapped = simulate_m0(torch, rng, ns=32, ncod=4096)
    print(f"simulated M0 alignment: {clean.ns} taxa x {clean.ls} codons, "
          f"{clean.npatt} patterns; with the last taxon's second half gaps "
          f"{gapped.npatt} patterns ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    specs = {"M0": codeml.CodemlSpec(NSsites=0, codonf="F3x4"),
             "M2a": codeml.CodemlSpec(NSsites=2, codonf="F3x4")}
    # state-code tips: B3/B4; multi-hot tips: B1/B2
    routes = (("clean", clean, ("big_fwd", "big_bwd")),
              ("gapped", gapped, ("pruning_fwd", "pruning_bwd")))
    fitted = {}
    for route, data, pair in routes:
        # the objective's set-up (frequency counts, with their EM over
        # ambiguous codons, and the tips' coding), which each fit repeats
        t0 = time.perf_counter()
        codeml.make_codon_objective(data, topo, specs["M2a"], device="cuda")
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        cuda_pruning.reset_launch_counts()
        pruning.PLAIN_CALLS["cuda"] = 0
        fits = {}
        for name, spec in specs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = codeml.fit_packed(data, topo, spec, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fits[name] = res
            print(f"fit {name}, {route} [{card}]: lnL {res.lnL:.6f}, kappa "
                  f"{res.kappa}, omegas {res.class_omegas.ravel()}, freqs "
                  f"{res.class_freqs}, {res.fit.n_eval} evals, {wall:.2f} s "
                  f"wall, {1e3 * wall / res.fit.n_eval:.2f} ms/eval, "
                  f"{1e3 * (wall - setup) / res.fit.n_eval:.2f} without the "
                  f"objective's set-up of {setup:.2f} s ({res.fit.message})",
                  flush=True)
        launches = dict(cuda_pruning.LAUNCHES)
        plain_cuda = pruning.PLAIN_CALLS["cuda"]
        print(f"M0 path, {route}: kernel launches {launches}, plain-version "
              f"calls on CUDA {plain_cuda}", flush=True)
        for name, count in launches.items():
            if (count > 0) != (name in pair):
                raise AssertionError(f"M0 path, {route}: {name} launched "
                                     f"{count} times; only {pair} should "
                                     "carry it")
            if count:
                report[name][f"launches_m0_{route}"] = count
        if plain_cuda:
            raise AssertionError(f"plain pruning ran {plain_cuda} times on "
                                 f"CUDA inside the M0 path ({route})")
        check_m0_fits(torch, data, topo, specs, fits, route)
        fitted[route] = fits
    print(f"M0 estimates, clean / gapped: kappa {fitted['clean']['M0'].kappa}"
          f" / {fitted['gapped']['M0'].kappa}, omega "
          f"{fitted['clean']['M0'].class_omegas.ravel()} / "
          f"{fitted['gapped']['M0'].class_omegas.ravel()}", flush=True)


def check_m0_fits(torch, data, topo, specs, fits, route):
    """Each fit's lnL against the plain version on the card at its
    optimum, its convergence, M2a >= M0, and the M0 estimates near the
    simulated kappa 2, omega 0.3."""
    from paml_tpu_torch.apps import codeml

    for name, spec in specs.items():
        res = fits[name]
        neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
            data, topo, spec, device="cuda")
        x = torch.tensor(res.x, dtype=torch.float64, device="cuda")
        with torch.no_grad():
            lnl_kernel = -float(neg(x))
            lnl_x0 = -float(neg(torch.tensor(x0, dtype=torch.float64,
                                             device="cuda")))
        lnl_plain = plain_value_grad(torch, neg, res.x, 1, grad=False)[0]
        pg = proj_grad_max(torch, neg, res.x, bounds)
        rel = abs(lnl_kernel - lnl_plain) / abs(lnl_plain)
        print(f"check {name}, {route}: lnL kernel {lnl_kernel:.9f}, plain "
              f"{lnl_plain:.9f} (rel {rel:.2e}), at x0 {lnl_x0:.4f}, max "
              f"projected |grad| {pg:.2e}, converged {res.fit.converged}",
              flush=True)
        if not np.isfinite(res.lnL) or res.lnL < lnl_x0:
            raise AssertionError(f"{name}, {route}: fit did not improve on "
                                 "its start")
        if not (res.fit.converged or pg < 1e-2):
            raise AssertionError(f"{name}, {route}: not converged "
                                 f"({res.fit.message}, projected gradient "
                                 f"{pg:.2e})")
        if rel > 1e-9 or abs(lnl_kernel - res.lnL) > 1e-9 * abs(res.lnL):
            raise AssertionError(f"{name}, {route}: lnL disagrees with the "
                                 "plain version on the card")
    m0, m2a = fits["M0"], fits["M2a"]
    if m2a.lnL < m0.lnL - 1e-6 * abs(m0.lnL):
        raise AssertionError(f"{route}: M2a (which nests M0) fitted below M0")
    if abs(float(m0.class_omegas.ravel()[0]) - 0.3) > 0.1 or \
            abs(float(m0.kappa[0]) - 2.0) > 0.5:
        raise AssertionError(f"{route}: M0 estimates far from the simulated "
                             "kappa 2, omega 0.3")


def branch_site_tree(rng, ns):
    """bench.py's tree: balanced, #1 on the root's left child, branch
    lengths uniform on [0.02, 0.3]."""
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio

    names = [f"t{i}" for i in range(ns)]

    def bal(lo, hi):
        if hi - lo == 1:
            return names[lo]
        m = (lo + hi) // 2
        return f"({bal(lo, m)},{bal(m, hi)})"
    tree = treeio.parse_newick(f"({bal(0, ns // 2)} #1,{bal(ns // 2, ns)});")
    for node in tree.walk_post():
        node.blen = float(rng.uniform(0.02, 0.3))
    return from_treenode(tree, names), names


def simulate_branch_site(torch, rng, ns, ncod, device):
    """Integer-coded codon data simulated under branch-site model A at
    BS_TRUTH, with P and the class weights from the port's own
    `make_codon_objective(...).model_at` (branch lengths fixed at the
    tree's): (data, topo, spec with fix_blength = 2, the true x)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.io import seqio

    topo, names = branch_site_tree(rng, ns)
    spec = codeml.CodemlSpec(model=2, NSsites=2, codonf="Fequal",
                             fix_blength=2)
    # Fequal: the model does not depend on the data it is built with
    stub = seqio.PackedData(names=names, seqtype=1, nstates=61,
                            tip_partials=np.zeros((ns, 1), np.int32),
                            fpatt=np.ones(1))
    neg = codeml.make_codon_objective(stub, topo, spec, device=device)[0]
    t = BS_TRUTH
    p2 = 1.0 - t["p0"] - t["p1"]
    x_true = np.array([t["kappa"], np.log(t["p0"] / p2), np.log(t["p1"] / p2),
                       t["w0"], t["w2"]])
    with torch.no_grad():
        P, piC, freqs = neg.model_at(torch.tensor(x_true, device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    n = P.shape[-1]
    cls = torch.multinomial(freqs, ncod, replacement=True, generator=gen)
    cum = P.cumsum(-1)
    st = torch.empty((topo.nnode, ncod), dtype=torch.int64, device=device)
    st[topo.root] = torch.multinomial(piC[0], ncod, replacement=True,
                                      generator=gen)
    stack = [topo.root]
    while stack:
        v = stack.pop()
        for c in topo.children[v]:
            if c < 0:
                continue
            u = torch.rand((ncod, 1), dtype=torch.float64, device=device,
                           generator=gen)
            st[c] = (u > cum[c, cls, st[v]]).sum(-1).clamp_max(n - 1)
            stack.append(int(c))
    data = seqio.PackedData(
        names=names, seqtype=1, nstates=n,
        tip_partials=st[:ns].to(torch.int32).cpu().numpy(),
        fpatt=np.ones(ncod), ls=ncod, posG=np.array([0, ncod]))
    return data, topo, spec, x_true


def value_grad(torch, neg, x):
    xt = torch.tensor(x, dtype=torch.float64, device="cuda",
                      requires_grad=True)
    v = neg(xt)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.cpu().numpy()


def branch_site_value_grad(torch, data, topo, spec, report, card):
    """One value + gradient at x0 with every branch length free, in
    BIG_CHUNKS chunks against the chunked plain version on the card, and
    unchunked; both timed, with their peak device memory.  Then B3/B4 at
    the unchunked shape the fit runs, timed, and held against their plain
    versions chunk by chunk (lnf and S per chunk, dP and dpi summed)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    free = dataclasses.replace(spec, fix_blength=0)
    vg = {}
    for nc in (BIG_CHUNKS, 1):
        neg, _, _, x0f, _, _ = codeml.make_codon_objective(
            data, topo, free, device="cuda", n_chunks=nc)
        value_grad(torch, neg, x0f)              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            v, g = value_grad(torch, neg, x0f)
            walls.append(time.perf_counter() - t0)
        vg[nc] = (v, g, neg)
        print(f"value + gradient at x0, {len(x0f)} parameters, n_chunks "
              f"{nc} [{card}]: lnL {-v:.9f}, "
              f"{', '.join(f'{1e3 * w:.1f}' for w in walls)} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
    v, g, neg10 = vg[BIG_CHUNKS]
    lnl_p, g_p = plain_value_grad(torch, neg10, x0f, BIG_CHUNKS)
    rel = abs(-v - lnl_p) / abs(lnl_p)
    gerr = np.abs(g + g_p).max() / np.abs(g_p).max()
    rel1 = abs(vg[1][0] - v) / abs(v)
    gerr1 = np.abs(vg[1][1] - g).max() / np.abs(g).max()
    print(f"check value + gradient at x0: lnL kernel {-v:.9f}, plain "
          f"{lnl_p:.9f} (rel {rel:.2e}); max|grad diff| / max|grad| "
          f"{gerr:.2e}; n_chunks 1 vs {BIG_CHUNKS}: rel {rel1:.2e}, grad "
          f"{gerr1:.2e}", flush=True)
    if rel > 1e-9 or gerr > 1e-8 or rel1 > 1e-9 or gerr1 > 1e-8:
        raise AssertionError("branch-site value + gradient disagrees with "
                             "the plain version or across chunkings")
    # the kernels alone at the unchunked shape, at x0
    neg1 = vg[1][2]
    with torch.no_grad():
        P, piC, _ = neg1.model_at(torch.tensor(x0f, device="cuda"))
    piC = piC.contiguous()
    gbar = torch.ones((P.shape[1], neg1.tips.shape[1]), dtype=P.dtype,
                      device="cuda")
    lnf, S = cuda_pruning.pruning_big_fwd(P, neg1.tips, topo, piC)
    dP, dpi = cuda_pruning.pruning_big_bwd(P, neg1.tips, topo, piC, gbar, S)
    t_f = cuda_ms(lambda: cuda_pruning.pruning_big_fwd(P, neg1.tips, topo,
                                                       piC), reps=3)
    t_b = cuda_ms(lambda: cuda_pruning.pruning_big_bwd(P, neg1.tips, topo,
                                                       piC, gbar, S), reps=3)
    print(f"  unchunked [{card}]: B3 (with S) {t_f:.1f} ms + B4 {t_b:.1f} "
          f"ms = {t_f + t_b:.1f} ms of the value + gradient", flush=True)
    for name, ms in (("big_fwd", t_f), ("big_bwd", t_b)):
        bnd = bound(name, topo, P.shape[1], neg1.tips.shape[1], P.shape[-1],
                    P.element_size())
        print(f"  {name} unchunked: bound {bnd[0]:.3f} ms ({bnd[1]}), "
              f"{100 * bnd[0] / ms:.1f} % of it", flush=True)
    # the float32 instantiation at the same shape, timed only
    P32, pi32, gb32 = P.float(), piC.float(), gbar.float()
    _, S32 = cuda_pruning.pruning_big_fwd(P32, neg1.tips, topo, pi32)
    t_f32 = cuda_ms(lambda: cuda_pruning.pruning_big_fwd(
        P32, neg1.tips, topo, pi32), reps=3)
    t_b32 = cuda_ms(lambda: cuda_pruning.pruning_big_bwd(
        P32, neg1.tips, topo, pi32, gb32, S32), reps=3)
    print(f"  unchunked float32 [{card}]: B3 (with S) {t_f32:.1f} ms + B4 "
          f"{t_b32:.1f} ms", flush=True)
    del P32, S32
    torch.cuda.empty_cache()
    tol = TOL["float64"]
    w = neg1.tips.shape[1] // BIG_CHUNKS
    dP_r, dpi_r = torch.zeros_like(dP), torch.zeros_like(dpi)
    e_f = 0.0
    for k in range(BIG_CHUNKS):
        sl = slice(k * w, (k + 1) * w)
        tc = neg1.tips[:, sl].contiguous()
        lnf_r, S_r = pruning.class_site_lnf_big_plain(P, tc, topo, piC)
        e_f = max(e_f, max_err(lnf[:, sl], lnf_r, tol["val"],
                               f"B3 lnf, patterns {sl}"),
                  max_err(S[..., sl], S_r, tol["val"], f"B3 S, patterns {sl}"))
        del S_r
        d_P, d_pi = pruning.class_site_lnf_big_bwd_plain(
            P, tc, topo, piC, gbar[:, sl].contiguous(),
            S[..., sl].contiguous())
        dP_r += d_P
        dpi_r += d_pi
    e_b = max(max_err(dP, dP_r, tol["grad"], "B4 dP, all patterns"),
              max_err(dpi, dpi_r, tol["grad"], "B4 dpi, all patterns"))
    for name, e in (("big_fwd", e_f), ("big_bwd", e_b)):
        report[name]["max_abs_err_float64"] = max(
            report[name]["max_abs_err_float64"], e)
    print(f"  B3/B4 vs plain at {topo.ns} taxa x {neg1.tips.shape[1]} "
          f"patterns x {P.shape[1]} classes, float64, chunk by chunk: "
          f"lnf/S max|diff| {e_f:.3e}, dP/dpi max|diff| {e_b:.3e}",
          flush=True)


def branch_site_fit(torch, data, topo, spec, x_true, report, card):
    """Branch-site model A fitted through `fit_packed` with the branch
    lengths fixed at the simulated ones; B3/B4 must carry the fit, and a
    second fit must repeat it bit for bit."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    # the objective the fit builds for itself (the fit's own spec), timed:
    # its set-up is reported apart from the evaluations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
        data, topo, spec, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    cuda_pruning.reset_launch_counts()
    pruning.PLAIN_CALLS["cuda"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = codeml.fit_packed(data, topo, spec, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_pruning.LAUNCHES)
    plain_cuda = pruning.PLAIN_CALLS["cuda"]
    print(f"fit branch-site A, fix_blength 2 [{card}]: lnL {res.lnL:.6f}, "
          f"x {np.round(res.x, 4)} (truth {np.round(x_true, 4)}), omegas "
          f"{res.class_omegas.tolist()}, freqs {res.class_freqs}, "
          f"{res.fit.n_eval} evals, {wall:.2f} s wall, "
          f"{1e3 * wall / res.fit.n_eval:.1f} ms/eval, "
          f"{1e3 * (wall - setup) / res.fit.n_eval:.1f} without the "
          f"objective's set-up of {setup:.2f} s ({res.fit.message})",
          flush=True)
    print(f"branch-site path: kernel launches {launches}, plain-version "
          f"calls on CUDA {plain_cuda}", flush=True)
    for name in ("big_fwd", "big_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the "
                                 "branch-site fit")
        report[name]["launches_branch_site"] = launches[name]
    if plain_cuda or launches["pruning_fwd"] or launches["pruning_bwd"]:
        raise AssertionError(f"plain pruning ran {plain_cuda} times on CUDA "
                             "inside the branch-site fit, or B1/B2 did")
    # the same fit again: the slab sums have a fixed order, so the bits
    # repeat
    t0 = time.perf_counter()
    res2 = codeml.fit_packed(data, topo, spec, device="cuda")
    print(f"fit branch-site A again: lnL {res2.lnL!r} against {res.lnL!r}, "
          f"{res2.fit.n_eval} evals, {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    if res2.lnL != res.lnL or not np.array_equal(res2.x, res.x):
        raise AssertionError("branch-site A: a second fit gave other bits")
    with torch.no_grad():
        lnl_kernel = -float(neg(torch.tensor(res.x, device="cuda")))
        lnl_x0 = -float(neg(torch.tensor(x0, device="cuda")))
    lnl_plain = plain_value_grad(torch, neg, res.x, BIG_CHUNKS, grad=False)[0]
    pg = proj_grad_max(torch, neg, res.x, bounds)
    rel = abs(lnl_kernel - lnl_plain) / abs(lnl_plain)
    print(f"check branch-site A: lnL kernel {lnl_kernel:.9f}, plain "
          f"{lnl_plain:.9f} (rel {rel:.2e}), at x0 {lnl_x0:.4f}, max "
          f"projected |grad| {pg:.2e}, converged {res.fit.converged}",
          flush=True)
    if not np.isfinite(res.lnL) or res.lnL < lnl_x0:
        raise AssertionError("branch-site A: fit did not improve on its "
                             "start")
    if not (res.fit.converged or pg < 1e-2):
        raise AssertionError(f"branch-site A: not converged "
                             f"({res.fit.message}, projected gradient "
                             f"{pg:.2e})")
    if rel > 1e-9:
        raise AssertionError("branch-site A: lnL disagrees with the plain "
                             "version on the card")
    if abs(float(res.kappa[0]) - BS_TRUTH["kappa"]) > 0.2:
        raise AssertionError(f"branch-site A: kappa {res.kappa} far from "
                             f"the simulated {BS_TRUTH['kappa']}")


def branch_site_gapped(torch, rng, data, topo, spec, report, card):
    """The branch-site alignment with gaps and Ns (`gapped_codes`): B1/B2
    carry it.  One value + gradient at x0 with every branch length free in
    BIG_CHUNKS chunks, against the chunked plain version on the card; two
    unchunked, timed, which must give the same bits; B1/B2 timed at the
    unchunked shape, with their share of the bound; then the model A fit
    with the branch lengths fixed, carried by B1/B2 alone, its lnL against
    the plain version's at the optimum."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    t0 = time.perf_counter()
    codes, amb = gapped_codes(rng, np.asarray(data.tip_partials))
    n = amb.shape[1]
    share = float((codes == n).mean()), float((codes > n).mean())
    gapped = dataclasses.replace(
        data, tip_partials=np.concatenate([np.eye(n), amb])[codes],
        cleandata=False)
    del codes
    print(f"gapped branch-site alignment: {100 * share[0]:.2f} % gap cells, "
          f"{100 * share[1]:.3f} % with an N, {len(amb)} ambiguity vectors "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    free = dataclasses.replace(spec, fix_blength=0)
    t0 = time.perf_counter()
    neg10, _, _, x0f, _, _ = codeml.make_codon_objective(
        gapped, topo, free, device="cuda", n_chunks=BIG_CHUNKS)
    setup = time.perf_counter() - t0
    print(f"  objective built ({setup:.1f} s: frequency counts and the tips' "
          f"coding on the host; A {neg10.tips.n_amb})", flush=True)
    v10, g10 = value_grad(torch, neg10, x0f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value_grad(torch, neg10, x0f)
    wall10 = time.perf_counter() - t0
    lnl_p, g_p = plain_value_grad(torch, neg10, x0f, BIG_CHUNKS)
    rel = abs(-v10 - lnl_p) / abs(lnl_p)
    gerr = np.abs(g10 + g_p).max() / np.abs(g_p).max()
    del neg10
    torch.cuda.empty_cache()
    neg1 = codeml.make_codon_objective(gapped, topo, free, device="cuda")[0]
    value_grad(torch, neg1, x0f)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(value_grad(torch, neg1, x0f))
        walls.append(time.perf_counter() - t0)
    (v1, g1), (v1b, g1b) = runs
    rel1 = abs(v1 - v10) / abs(v10)
    gerr1 = np.abs(g1 - g10).max() / np.abs(g10).max()
    same = v1 == v1b and np.array_equal(g1, g1b)
    print(f"gapped value + gradient at x0, {len(x0f)} parameters [{card}]: "
          f"lnL {-v10:.9f} at n_chunks {BIG_CHUNKS} ({1e3 * wall10:.1f} ms), "
          f"plain {lnl_p:.9f} (rel {rel:.2e}), max|grad diff| / max|grad| "
          f"{gerr:.2e}; n_chunks 1: "
          f"{', '.join(f'{1e3 * w:.1f}' for w in walls)} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, rel "
          f"{rel1:.2e}, grad {gerr1:.2e} against {BIG_CHUNKS} chunks; the "
          f"two unchunked runs bit for bit the same: {same}", flush=True)
    if rel > 1e-9 or gerr > 1e-8 or rel1 > 1e-9 or gerr1 > 1e-8:
        raise AssertionError("gapped branch-site value + gradient disagrees "
                             "with the plain version or across chunkings")
    if not same:
        raise AssertionError("gapped branch-site value + gradient: a second "
                             "run gave other bits")
    # B1/B2 alone at the unchunked shape, at x0
    with torch.no_grad():
        P, piC, _ = neg1.model_at(torch.tensor(x0f, device="cuda"))
    piC = piC.contiguous()
    tips = neg1.tips
    gbar = torch.ones((P.shape[1], tips.codes.shape[1]), dtype=P.dtype,
                      device="cuda")
    _, S = cuda_pruning.pruning_fwd(P, tips, topo, piC)
    t = {"pruning_fwd": cuda_ms(lambda: cuda_pruning.pruning_fwd(
             P, tips, topo, piC), reps=3),
         "pruning_bwd": cuda_ms(lambda: cuda_pruning.pruning_bwd(
             P, tips, topo, piC, gbar, S), reps=3)}
    for name, ms in t.items():
        bnd = bound(name, topo, P.shape[1], tips.codes.shape[1], P.shape[-1],
                    P.element_size(), tips.n_amb)
        report[name]["ms_unchunked_gapped_float64"] = ms
        report[name]["bound_ms_unchunked_gapped_float64"] = bnd[0]
        print(f"  {name} unchunked, gapped [{card}]: {ms:.1f} ms, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f} % of it",
              flush=True)
    del P, S, gbar, neg1
    torch.cuda.empty_cache()
    # the model A fit, branch lengths fixed, through B1/B2 alone; first the
    # objective the fit builds for itself (the fit's own spec), timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
        gapped, topo, spec, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    cuda_pruning.reset_launch_counts()
    pruning.PLAIN_CALLS["cuda"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = codeml.fit_packed(gapped, topo, spec, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_pruning.LAUNCHES)
    plain_cuda = pruning.PLAIN_CALLS["cuda"]
    print(f"fit branch-site A, gapped, fix_blength 2 [{card}]: lnL "
          f"{res.lnL:.6f}, x {np.round(res.x, 4)}, {res.fit.n_eval} evals, "
          f"{wall:.2f} s wall, {1e3 * wall / res.fit.n_eval:.1f} ms/eval, "
          f"{1e3 * (wall - setup) / res.fit.n_eval:.1f} without the "
          f"objective's set-up of {setup:.2f} s ({res.fit.message}); kernel "
          f"launches {launches}, plain-version calls on CUDA {plain_cuda}",
          flush=True)
    for name in ("pruning_fwd", "pruning_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the gapped "
                                 "branch-site fit")
        report[name]["launches_branch_site_gapped"] = launches[name]
    if plain_cuda or launches["big_fwd"] or launches["big_bwd"]:
        raise AssertionError(f"plain pruning ran {plain_cuda} times on CUDA "
                             "inside the gapped branch-site fit, or B3/B4 did")
    with torch.no_grad():
        lnl_kernel = -float(neg(torch.tensor(res.x, device="cuda")))
        lnl_x0 = -float(neg(torch.tensor(x0, device="cuda")))
    lnl_plain = plain_value_grad(torch, neg, res.x, BIG_CHUNKS, grad=False)[0]
    pg = proj_grad_max(torch, neg, res.x, bounds)
    rel = abs(lnl_kernel - lnl_plain) / abs(lnl_plain)
    print(f"check branch-site A, gapped: lnL kernel {lnl_kernel:.9f}, plain "
          f"{lnl_plain:.9f} (rel {rel:.2e}), at x0 {lnl_x0:.4f}, max "
          f"projected |grad| {pg:.2e}, converged {res.fit.converged}",
          flush=True)
    if not np.isfinite(res.lnL) or res.lnL < lnl_x0:
        raise AssertionError("gapped branch-site A: fit did not improve on "
                             "its start")
    if not (res.fit.converged or pg < 1e-2):
        raise AssertionError(f"gapped branch-site A: not converged "
                             f"({res.fit.message}, projected gradient "
                             f"{pg:.2e})")
    if rel > 1e-9 or abs(lnl_kernel - res.lnL) > 1e-9 * abs(res.lnL):
        raise AssertionError("gapped branch-site A: lnL disagrees with the "
                             "plain version on the card")


def phase_branch_site(torch, rng, report, card):
    t0 = time.perf_counter()
    data, topo, spec, x_true = simulate_branch_site(torch, rng, BIG_TAXA,
                                                    BIG_NPATT, "cuda")
    print(f"simulated branch-site A alignment: {data.ns} taxa x {data.ls} "
          f"codons, {data.npatt} patterns, {topo.nnode} nodes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    branch_site_value_grad(torch, data, topo, spec, report, card)
    torch.cuda.empty_cache()
    branch_site_fit(torch, data, topo, spec, x_true, report, card)
    torch.cuda.empty_cache()
    branch_site_gapped(torch, rng, data, topo, spec, report, card)


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
    paths = _build.build()
    print(f"built {', '.join(p.name for p in paths)} from "
          f"paml_tpu_torch/csrc in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    _build.lib()
    # 3. kernels against the plain version
    rng = np.random.default_rng(SEED)
    report = {name: {"name": name, "route": "cuda",
                     "source": f"paml_tpu_torch/csrc/{src}",
                     "replaces": f"paml_tpu/core/{tpu}"}
              for name, src, tpu in (
                  ("pruning_fwd", "pruning.cu", "pallas_pruning.py:389"),
                  ("pruning_bwd", "pruning.cu", "pallas_pruning.py:406"),
                  ("big_fwd", "pruning_big.cu", "pallas_pruning_big.py:170"),
                  ("big_bwd", "pruning_big.cu", "pallas_pruning_big.py:270"))}
    phase_kernels(torch, rng, report, smi[0])
    # 3b. the large-tree kernels against their plain versions
    phase_big_kernels(torch, rng, report, smi[0])
    # 4. the M0 / M2a path (B3/B4 on clean data, B1/B2 on gapped data)
    phase_slice(torch, rng, report, smi[0])
    # 5. the branch-site path at 1024 taxa (B3/B4)
    phase_branch_site(torch, rng, report, smi[0])
    kernels = []
    for r in report.values():
        # the main paths' launches, each path counted from 0 (M0/M2a fits
        # on clean and gapped data, the branch-site fit)
        r["launches"] = sum(v for k, v in r.items()
                            if k.startswith("launches_"))
        r["max_abs_err"] = r["max_abs_err_float64"]
        r["ms"] = r["ms_float64"]
        r["plain_ms"] = r["plain_ms_float64"]
        r["bound_ms"] = r["bound_ms_float64"]
        r["bound_by"] = r["bound_by_float64"]
        # no single PyTorch call computes a pruning pass
        r["library_ms"] = None
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
