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
6. The program: an alignment simulated under site classes (proportions
   0.6 / 0.3 / 0.1 of the sites under omega 0.1 / 1 / 3, kappa 2; 32 taxa
   on the bench's ladder without its root branch, 4096 codons) is written
   as a PHYLIP file with a tree file and a `codeml.ctl` (`NSsites = 0 1 2
   7 8`, `ncatG = 10`, `getSE = 1`, `CodonFreq = 2`, `cleandata = 0`), and
   `paml_tpu_torch.__main__.main(["codeml", ctl])` runs it in this
   process on the card; then the same alignment with 3b's gaps and Ns,
   `NSsites = 0 8`.  B3/B4 must carry the clean fits and B1/B2 the gapped
   ones, with no plain call during a fit (the Hessians' calls of the plain
   level pass are counted apart); each lnL in `mlc` must match the plain
   version's at the fitted x; both likelihood-ratio tests (M1a-M2a, M7-M8)
   must be significant; the SEs of the free parameters finite and
   positive; M8's BEB sites with P > 0.95 in the majority sites simulated
   under omega 3; BEB's forward (20 classes, no residual) must match the
   plain version, and is timed beside its bound.  One value + gradient
   each, kernel route against plain route, for FMutSel0, FMutSel with
   estFreq, clock 1, M5 and M8, with the host's share (the quantile code).
   Per model: evaluations, wall seconds, ms per evaluation, and the
   seconds in the quantile code, the Hessian and BEB.
7. baseml: a 100-taxon x 100,000-site alignment simulated under REV + G5
   (alpha 0.5, pi TCAG 0.2 / 0.3 / 0.3 / 0.2, fixed exchangeabilities) on
   a random unbalanced unrooted tree with the port's own P(t), with 3b's
   gap runs over about 5 % of the cells and Ns in 0.2 %, is written with
   a tree and a `baseml.ctl` (`model = 7`, `ncatG = 5`, `fix_alpha = 0`,
   `getSE = 1`, `RateAncestor = 1`, `cleandata = 0`) and
   `paml_tpu_torch.__main__.main(["baseml", ctl])` runs it on the card:
   the level route must carry it (no kernel launch, no plain call,
   `pruning.LEVEL_CALLS` counted); the lnL in `mlb` must match the same
   objective on CPU tensors at the fitted x to 1e-9, alpha lie within 10 %
   of 0.5, the SEs be finite and positive, the marginal reconstruction
   equal the CPU's (states equal, probabilities to 1e-9) and `rst` hold
   it; the share of internal-node sites reconstructed as simulated is
   printed.  7b (ROADMAP B5's evidence): one value + gradient at the MLEs
   through the level route and through B1/B2 at N = 64 (the wrappers
   called directly, in chunks), held to each other to the f64 tolerance,
   timed with their peak memory, and the level route repeated bit for bit.
   7c: HKY85 + AdG (K = 5, rho free), one value + gradient over the
   100,000 sites on the card against CPU tensors, timed.  7d: basemlg on 8
   taxa x 2000 sites from the same simulator, and an Mgene = 4 TN93 + G4
   fit with two genes (option G), each lnL against the CPU objective.
8. The rest of codeml (amino acids, aaDist, Mgene).  8a: 50,000 amino
   acids simulated under LG + G4 (alpha 0.5, LG's frequencies) on a
   100-taxon random unrooted tree with 7a's gap runs and X in 0.2 % of
   the cells; `main(["codeml", ctl])` fits LG + F + G4 (`seqtype = 2`,
   `model = 3`, `fix_alpha = 0`) twice from the simulated branch lengths
   (bit for bit, alpha within 10 % of 0.5), then once from the topology
   alone (shown: the JAX package's start stops at a local optimum).  B1/B2
   carry the gapped fits; each lnL in `mlc` against the plain version on
   the card (1e-9).  8b (B5 for 20 states): at the MLEs, on the gapped
   alignment (B1/B2) and its clean copy (B3/B4), one value + gradient
   through the level route and through the kernels at N = 64, held to
   each other, timed (medians of 5) with their peak memory; then each of
   B1-B4 alone at that shape against its plain version, timed beside its
   bounds at n = 20 and N = 64.  8c: phase 6's simulator at 32 x 4096
   codons, one program run each for `seqtype = 3` with JTT, FromCodon0,
   aaDist = 7 (OmegaAA.dat written here, two classes), aaDist = 1 and
   Mgene = 4 over two genes, each lnL against the plain version.
   Phases 3 and 3b also hold B1-B4 at 20 states (the uneven tree, from a
   generator of its own, so that the later phases' data stay as they
   were).
9. The pairwise programs and evolver (no pruning kernel; each program
   through `paml_tpu_torch.__main__.main`, its launches counted from 0
   and required to be 0).  9a: `evolver 6` on a 50-taxon random unrooted
   tree (branch lengths on [0.01, 0.1]) x 1000 codons x 100 replicates
   under phase 6's site classes, twice (mc.paml, siterates.txt and
   ancestral.txt the same bytes); chi-square bounds (the 0.999 quantile)
   on taxon 1's codons against pi, the site classes against p and the
   parent -> child transitions of ancestral.txt against P(t) on three
   branches; replicate 1 refitted by M2a on the card (branch lengths
   fixed at the simulated ones) within stated bounds of the truth; then `evolver 5` at phase 7's 100 taxa x 100,000 sites
   under REV + G5 (alpha 0.5), twice (the same bytes), a tip's bases
   against pi; sampling and writing seconds and peak GiB of each.  9b:
   `yn00` (weighting = 1) on the first 30 taxa of 9a's replicate 1 (435
   pairs) on the card and with `--device cpu` (one CPU thread: PyTorch's
   default count oversubscribes that machine's cores): yn, 2YN.* and 2NG.* the
   same bytes, every field to 1e-9 relative; seconds per pair on each.
   9c: codeml `runmode = -2` on 12 taxa x 500 codons (66 pairs, so that
   phase 9 stays near 90 s; PERF.md has 20 taxa's 190) and `-3` on 6 (15
   pairs), card against `--device cpu`: lnL to 1e-9 relative,
   the estimates to 1e-5, E_t, E_w, their SEs and P(w > 1) to 1e-6,
   2ML.* the same bytes; seconds per pair on each.  9d: `pamp` on 9a's
   nucleotide alignment with its tree, card against CPU (the estimates
   and the pattern matrix equal), and `chi2 1 3.84`.
10. mcmctree and its kin (each program through `paml_tpu_torch.__main__.
   main`).  10a: 4 loci x 2000 sites simulated under HKY85 + G5 (alpha
   0.5, a relaxed clock) on a random dated 30-species tree, the root in
   B(0.9, 1.1), one internal node in a soft interval and one above a lower
   bound; `mcmctree` at usedata = 1, clock 2 then clock 3, twice on the
   card (mcmc.txt the same bytes) and once with `--device cpu` at one
   thread (every sample to 1e-9 relative); ms per `lnL_all` and per
   iteration on each, the card's idle share over one `lnL_all`
   (`torch.profiler`), the seconds of the fossil-error prior's Monte Carlo
   constants (host), and ROADMAP B6: the batched level pass against a
   loop of per-locus passes, on the card and on the host.  10b: usedata = 3
   (in.BV) on 60 species x 8 loci x 5000 sites on the card, per-locus fit
   and Hessian seconds, every locus's gradient at its MLE below 1e-2 off
   the branch-length bound (and pointing below it at the bound); then
   usedata = 2 from that out.BV at clock 2, card against CPU as in 10a.
   10c: infinitesites at clock 1 and 2 on fixed distances from 10b's
   dated tree (posterior root age within 0.2 of the truth), ds on 10a's
   mcmc.txt, `mcmctree --combine` of two 10a chains, bfdriver, multiruns;
   each timed and its files checked.  10d: baseml at clock = 5 and 6 on 3
   loci x 30 species x 3000 sites (locus 3 without a taxon, a point
   fossil '@' on the largest clade), the level route alone, each lnL
   against the objective on CPU tensors at the fitted x (1e-9); then
   `clock56.fit_clock5` on codons (2 loci x 20 species x 1000 codons, M0
   with kappa 2 and omega 0.3, F3x4), clean (B3/B4 alone) and with 3b's
   gaps and Ns (B1/B2 alone), each lnL against the plain version on the
   card (1e-9); their launches join the kernels line.

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
UNEVEN20 = dict(UNEVEN, n=20)                         # amino acids
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

    if shape == "ladder3":
        # the ladder with its root branch removed: an unrooted tree
        s = lab(0, names[0])
        for i, nm in enumerate(names[1:-2], 1):
            s = f"({s},{lab(i, nm)})"
        return (f"({s},{lab(len(names) - 2, names[-2])},"
                f"{lab(len(names) - 1, names[-1])});")

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


AA_SETS = ("ND", "QE", "IL")        # the amino-acid codes B, Z and J


def gapped_codes(rng, states, n=61):
    """Gapped tips from state codes [ns, H]: gaps in runs of geometric
    length (mean 10 cells) over about 5 % of each taxon's cells, and an
    ambiguous cell in 0.2 % of the others, as TipCodes arrays (codes [ns,
    H] int32, amb [A, n] float64): a code n + a names amb row a, row 0 the
    gap (all ones).  Sense codons (n = 61) take one N at a random position
    (the sense codons agreeing at the two other positions); amino acids (n
    = 20) a B, Z or J (AA_SETS)."""
    from paml_tpu_torch.constants import AA_ORDER
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
    if n != 61:
        rows = [np.ones(n)]
        for pair in AA_SETS:
            rows.append(np.isin(np.arange(n),
                                [AA_ORDER.index(a) for a in pair]) * 1.0)
        codes[ti, hi] = n + rng.integers(1, len(rows), size=len(ti))
        return codes, np.stack(rows)
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


def cuda_ms_median(fn, reps=5, warmup=1):
    """The median of `reps` calls of fn, each timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def bound(name, topo, C, H, n, esize, n_amb=0, want_S=True):
    """(bound_ms, bound_by) of kernel `name` on these shapes: the larger
    of its operations over the card's peak rate and its bytes over the
    memory rate (cuda_pruning.kernel_work, PEAK_FLOPS, PEAK_BYTES);
    want_S false for a forward launched without its residual."""
    from paml_tpu_torch.core import cuda_pruning as cp
    flop, nbytes = cp.kernel_work(name, topo, C, H, n, esize, n_amb, want_S)
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

    for cfg in (BENCH, UNEVEN, UNEVEN20):
        # the 20-state case draws from a generator of its own, so that the
        # later phases' data stay as they were before it was added
        r = np.random.default_rng([SEED, 20]) if cfg is UNEVEN20 else rng
        topo, P_np, pi_np, st_np, (hot_np, wide_np), gb_np = kernel_problem(
            r, **cfg)
        n = P_np.shape[-1]
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
                tag = (f"{cfg['shape']} {cfg['ns']}x{cfg['H']}x{cfg['C']}"
                       f"x{n} {dn} {enc}, A {A}")
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
    for cfg in (BENCH, BENCH1, UNEVEN, UNEVEN20, MID, CHUNK):
        r = np.random.default_rng([SEED, 20]) if cfg is UNEVEN20 else rng
        topo, P_np, pi_np, st_np, _, gb_np = kernel_problem(
            r, **cfg, multihot=False)
        n = P_np.shape[-1]
        # the same states with gaps and Ns (B, Z, J): B1/B2's tips
        g_codes, g_amb = gapped_codes(r, st_np, n)
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
            tag = (f"{cfg['shape']} {cfg['ns']}x{cfg['H']}x{cfg['C']}x{n} "
                   f"{dn}")
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


# --- phase 6: the program ---------------------------------------------------

SITE_TRUTH = dict(kappa=2.0, p=(0.6, 0.3, 0.1), w=(0.1, 1.0, 3.0))
CHI2_2DF_05 = 5.991          # the 5 % point of chi-square with 2 d.f.


def simulate_site_classes(torch, rng, ns, ncod, device, shape="ladder3"):
    """A codon alignment simulated under site classes (SITE_TRUTH: the
    proportions p of the sites evolve under the omegas w; kappa 2, equal
    codon frequencies) on a tree of `shape` with branch lengths uniform on
    [0.02, 0.3] (by default the bench's ladder without its root branch:
    codeml's trees are unrooted, and a rooted one leaves the two root
    branches' standard errors undefined), with the port's own P(t) (M3's,
    branch lengths fixed):
    (names, rows of nucleotides, the Newick string, the class of each
    site)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.constants import codon_string
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio
    from paml_tpu_torch.models import codon

    names = [f"t{i}" for i in range(ns)]
    nwk = newick(names, shape, rng.uniform(0.02, 0.3, size=ns))
    tree = treeio.parse_newick(nwk)
    for node in tree.walk_post():
        if node.blen is None:
            node.blen = float(rng.uniform(0.02, 0.3))
    topo = from_treenode(tree, names)
    spec = codeml.CodemlSpec(NSsites=3, codonf="Fequal", fix_blength=2)
    stub = seqio.PackedData(names=names, seqtype=1, nstates=61,
                            tip_partials=np.zeros((ns, 1), np.int32),
                            fpatt=np.ones(1))
    neg = codeml.make_codon_objective(stub, topo, spec, device=device)[0]
    p, w = SITE_TRUTH["p"], SITE_TRUTH["w"]
    x_true = np.array([SITE_TRUTH["kappa"], np.log(p[0] / p[2]),
                       np.log(p[1] / p[2]), *w])
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
    sense = codon.codon_graph(0).sense
    text = np.array([codon_string(int(c)) for c in sense])
    rows = ["".join(text[st[i].cpu().numpy()]) for i in range(ns)]
    return names, rows, treeio.write_newick(tree, branch_lengths=False), \
        cls.cpu().numpy()


def gapped_rows(rng, rows):
    """The rows with `gapped_codes`' gaps and Ns written into the
    nucleotides: a gap codon is '---', an N replaces one position."""
    ns, H = len(rows), len(rows[0]) // 3
    codes, amb = gapped_codes(rng, np.zeros((ns, H), dtype=np.int32))
    n = amb.shape[1]
    out = []
    for t, row in enumerate(rows):
        cods = [row[3 * h:3 * h + 3] for h in range(H)]
        for h in np.nonzero(codes[t] >= n)[0]:
            if codes[t, h] == n:
                cods[h] = "---"
            else:
                k = int(rng.integers(0, 3))
                cods[h] = cods[h][:k] + "N" + cods[h][k + 1:]
        out.append("".join(cods))
    return out


CTL = """      seqfile = {seq}
     treefile = {tree}
      outfile = mlc
        noisy = 0
      verbose = 0
      runmode = 0
      seqtype = 1
    CodonFreq = 2
        model = {model}
      NSsites = {nssites}
        icode = 0
    fix_kappa = 0
        kappa = 2
    fix_omega = 0
        omega = .4
        ncatG = 10
        getSE = 1
    cleandata = 0
"""


def run_program(torch, workdir, tag, names, rows, nwk, nssites, card,
                model=0):
    """Write the alignment, the tree and a control file into workdir/tag,
    run `python -m paml_tpu_torch codeml` there in this process, on the
    card, and return (its summary, the launch counts, the lnL lines of
    mlc)."""
    import os
    import re

    from paml_tpu_torch import __main__ as cli
    from paml_tpu_torch.apps import beb, codeml
    from paml_tpu_torch.core import cuda_pruning, dgamma, pruning

    d = os.path.join(workdir, tag)
    os.makedirs(d)
    with open(os.path.join(d, "seq.phy"), "w") as f:
        f.write(f"{len(names)} {len(rows[0])}\n")
        for nm, row in zip(names, rows):
            f.write(f"{nm}  {row}\n")
    with open(os.path.join(d, "tree.nwk"), "w") as f:
        f.write(nwk + "\n")
    ctl = os.path.join(d, "codeml.ctl")
    with open(ctl, "w") as f:
        f.write(CTL.format(seq="seq.phy", tree="tree.nwk", nssites=nssites,
                           model=model))
    cuda_pruning.reset_launch_counts()
    pruning.PLAIN_CALLS["cuda"] = pruning.TWICE_CALLS["cuda"] = 0
    before = dict(h=codeml.SECONDS["hessian"], b=beb.SECONDS["beb"])
    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        out = cli.main(["codeml", ctl])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = dict(cuda_pruning.LAUNCHES)
    plain, twice = pruning.PLAIN_CALLS["cuda"], pruning.TWICE_CALLS["cuda"]
    for name in ("mlc", "rst", "rst1", "lnf", "rub"):
        if os.path.getsize(os.path.join(d, name)) == 0:
            raise AssertionError(f"program, {tag}: {name} is empty")
    mlc = open(os.path.join(d, "mlc")).read()
    lnls = [float(v) for v in re.findall(r"lnL\(ntime:.*\): *(-?[0-9.]+)",
                                         mlc)]
    print(f"program, {tag} [{card}]: model = {model}, NSsites = {nssites}, "
          f"{wall:.1f} s wall; "
          f"Hessians {codeml.SECONDS['hessian'] - before['h']:.1f} s, BEB "
          f"{beb.SECONDS['beb'] - before['b']:.2f} s; kernel launches "
          f"{launches}, plain-version calls on CUDA during the fits {plain}, "
          f"Hessian-route calls of the plain level pass {twice}", flush=True)
    for run in out["runs"]:
        res = run["res"]
        print(f"  NSsites {run['NSsites']} [{card}]: lnL {res.lnL:.6f}, "
              f"{res.fit.n_eval} evals, {run['fit_seconds']:.2f} s wall, "
              f"{1e3 * run['fit_seconds'] / res.fit.n_eval:.2f} ms/eval, "
              f"quantile code {run['quantile_seconds']:.2f} s, Hessian "
              f"{run.get('hessian_seconds', 0.0):.2f} s, BEB "
              f"{run.get('beb_seconds', 0.0):.2f} s; kappa "
              f"{res.kappa}, omegas {np.round(res.class_omegas.ravel(), 4)}, "
              f"freqs {np.round(res.class_freqs, 4)}", flush=True)
    if plain:
        raise AssertionError(f"program, {tag}: the plain pruning version ran "
                             f"{plain} times on CUDA outside the Hessians")
    if not twice:
        raise AssertionError(f"program, {tag}: getSE = 1 made no Hessian")
    return out, launches, lnls


def check_program(torch, out, lnls, tag):
    """Each model's lnL in mlc against the plain version's at the fitted
    x; the SEs of the free parameters finite and positive."""
    from paml_tpu_torch.apps import codeml

    data = out["data"]
    if len(lnls) != len(out["runs"]):
        raise AssertionError(f"program, {tag}: {len(lnls)} lnL lines in mlc "
                             f"for {len(out['runs'])} fits")
    for run, lnl_mlc in zip(out["runs"], lnls):
        res = run["res"]
        neg, _, _, _, bounds, _ = codeml.make_codon_objective(
            data, res.topo, res.spec, device="cuda")
        lnl_plain = plain_value_grad(torch, neg, res.x, 1, grad=False)[0]
        rel = abs(lnl_mlc - lnl_plain) / abs(lnl_plain)
        lo = np.array([b[0] for b in bounds])
        hi = np.array([b[1] for b in bounds])
        free = (res.x > lo + 1e-6 * (hi - lo)) & (res.x < hi - 1e-6 * (hi - lo))
        ses = run["SEs"]
        print(f"  check NSsites {run['NSsites']}, {tag}: lnL in mlc "
              f"{lnl_mlc:.6f}, plain {lnl_plain:.6f} (rel {rel:.2e}); SEs of "
              f"the {int(free.sum())} free parameters in "
              f"[{ses[free].min():.3g}, {ses[free].max():.3g}], the last "
              f"{np.round(ses[-4:], 4)}", flush=True)
        if rel > 1e-9:
            raise AssertionError(f"program, {tag}, NSsites {run['NSsites']}: "
                                 "lnL disagrees with the plain version")
        if not (np.isfinite(ses).all() and (ses[free] > 0).all()):
            raise AssertionError(f"program, {tag}, NSsites {run['NSsites']}: "
                                 f"SEs {ses}")


def check_beb(torch, out, cls, report, card):
    """M8's BEB sites with P > 0.95 against the simulated classes, and the
    BEB forward (20 classes, no residual) against the plain version, timed
    beside its bound."""
    from paml_tpu_torch.apps import beb

    data = out["data"]
    run = next(r for r in out["runs"] if r["NSsites"] == 8)
    sites = beb.positive_sites(data, run["beb"], 0.95)
    hits = sum(cls[s - 1] == 2 for s, _, _ in sites)
    print(f"  BEB, M8: {len(sites)} sites with P > 0.95, {hits} of them "
          f"simulated under omega {SITE_TRUTH['w'][2]} "
          f"({int((cls == 2).sum())} such sites of {len(cls)})", flush=True)
    if not sites or 2 * hits <= len(sites):
        raise AssertionError("BEB: the sites with P > 0.95 are not, in the "
                             "majority, those simulated under positive "
                             "selection")
    res = run["res"]
    fz = beb._Frozen(data, res.topo, res.spec, res.x, "cuda")
    rK = run["beb"].class_omegas
    wbar = float((res.params["W"] * res.params["freqs"][None, :]).sum(1)[0])
    P = fz.P(rK, 1.0 / (fz.rs + fz.ra * wbar))
    check_beb_forward(torch, fz, P, report, card, f"beb_c{len(rK)}")


def check_beb_forward(torch, fz, P, report, card, key):
    """BEB's forward (P [nnode, K, n, n] of K omega sets, no residual) on
    the frozen problem `fz`: one launch of B3 (state codes) or B1 (coded
    tips) against the plain version, timed beside its bound (S counts
    among neither kernel's bytes here: the launch writes none)."""
    from paml_tpu_torch.core import cuda_pruning, pruning
    from paml_tpu_torch.core.tipcodes import TipCodes

    K = P.shape[1]
    piC = fz.pi.expand(K, fz.n).contiguous()
    fused = not cuda_pruning.use_big_kernels(
        not isinstance(fz.tips, TipCodes))
    name = "pruning_fwd" if fused else "big_fwd"
    before = cuda_pruning.LAUNCHES[name]
    lnf = fz.lnf(P)
    if cuda_pruning.LAUNCHES[name] != before + 1:
        raise AssertionError(f"BEB's forward did not launch {name}")
    with torch.no_grad():
        lnf_r = pruning.class_site_lnf_plain(P, fz.tips, fz.topo, piC)
    err = max_err(lnf, lnf_r, TOL["float64"]["val"], f"BEB lnf {name}")
    del lnf_r
    fwd = cuda_pruning.pruning_fwd if fused else cuda_pruning.pruning_big_fwd
    ms = cuda_ms(lambda: fwd(P, fz.tips, fz.topo, piC, want_S=False))
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: pruning.class_site_lnf_plain(
            P, fz.tips, fz.topo, piC), reps=3, warmup=1)
    H = lnf.shape[1]
    bnd = bound(name, fz.topo, K, H, fz.n, 8, getattr(fz.tips, "n_amb", 0),
                want_S=False)
    report[name]["max_abs_err_float64"] = max(
        report[name]["max_abs_err_float64"], err)
    report[name][f"ms_{key}_float64"] = ms
    report[name][f"plain_ms_{key}_float64"] = plain_ms
    report[name][f"bound_ms_{key}_float64"] = bnd[0]
    report[name][f"bound_by_{key}_float64"] = bnd[1]
    print(f"  BEB forward {name}, {K} classes x {H} patterns, no "
          f"residual [{card}]: lnf max|diff| {err:.3e}; {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
          f"{100 * bnd[0] / ms:.1f} % of it", flush=True)


def check_beb_branch_site(torch, out, gapped, report, card):
    """Branch-site model A's BEB as the program ran it (121 sets of
    (background, foreground) omegas on the class axis): the posteriors,
    then its forward on the clean alignment (B3) and, at the same MLEs, on
    the `gapped` packed data (B1), each against the plain version."""
    from paml_tpu_torch.apps import beb

    run = out["runs"][0]
    res, acd = run["res"], run["beb_A"]
    post = acd["postSite"]
    if not (np.isfinite(post).all()
            and np.abs(post.sum(0) - 1.0).max() < 1e-9):
        raise AssertionError("branch-site BEB: the class posteriors do not "
                             "sum to 1")
    print(f"  branch-site BEB: {int((acd['pos_prob'] > 0.95).sum())} "
          f"patterns with P(class 2) > 0.95 of {post.shape[1]}; ln f(X) "
          f"{acd['lnfX']:.4f}", flush=True)
    w0g, w2g = acd["w0_grid"], acd["w2_grid"]
    for data in (out["data"], gapped):
        fz = beb._Frozen(data, res.topo, res.spec, res.x, "cuda")
        P = beb._branchsite_P_sets(fz, res.topo, res, w0g, w2g)
        check_beb_forward(torch, fz, P, report, card, f"beb_c{P.shape[1]}")
        del P, fz
        torch.cuda.empty_cache()


def check_routes(torch, data, topo, card):
    """One value + gradient each, kernel route against plain route on the
    card, for objectives this slice adds: frequencies from parameters
    (FMutSel0), branch lengths from a clock, omegas from gamma quantiles
    (M5, the incomplete gamma's derivative in its shape)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import dgamma

    for tag, kw in (("FMutSel0", dict(codonf="FMutSel0")),
                    ("FMutSel, estFreq", dict(codonf="FMutSel",
                                              estFreq=True)),
                    ("clock 1", dict(clock=1)),
                    ("M5", dict(NSsites=5, ncatG=10)),
                    ("M8", dict(NSsites=8, ncatG=10))):
        neg, _, _, x0, _, _ = codeml.make_codon_objective(
            data, topo, codeml.CodemlSpec(**kw), device="cuda")
        v, g = value_grad(torch, neg, x0)                # warm-up
        torch.cuda.synchronize()
        q0, t0 = dgamma.SECONDS["host"], time.perf_counter()
        v, g = value_grad(torch, neg, x0)
        wall = time.perf_counter() - t0
        quant = dgamma.SECONDS["host"] - q0
        lnl_p, g_p = plain_value_grad(torch, neg, x0, 1)
        rel = abs(-v - lnl_p) / abs(lnl_p)
        gerr = np.abs(g + g_p).max() / np.abs(g_p).max()
        print(f"  value + gradient, {tag}, {len(x0)} parameters [{card}]: "
              f"lnL kernel {-v:.6f}, plain {lnl_p:.6f} (rel {rel:.2e}), "
              f"max|grad diff| / max|grad| {gerr:.2e}; {1e3 * wall:.2f} ms, "
              f"{1e3 * quant:.2f} ms of it in the quantile code on the host",
              flush=True)
        if rel > 1e-9 or gerr > 1e-8 or not np.isfinite(g).all():
            raise AssertionError(f"{tag}: value + gradient disagrees with "
                                 "the plain version on the card")
    # the continued fraction three ways on the same ten numbers: a loop of
    # tensor operations under autograd on the card, the same loop on CPU
    # tensors, and the package's route (numpy values, dual numbers for the
    # gradient, on the host)
    a, b = (torch.tensor(v, dtype=torch.float64, device="cuda",
                         requires_grad=True) for v in (0.5, 1.2))
    x = (torch.arange(10, dtype=torch.float64, device="cuda") + 0.5) / 10
    ah, bh = (v.detach().cpu().requires_grad_(True) for v in (a, b))
    xh = x.cpu()

    def tensors(a, b, x):
        I = dgamma._betainc_any(a.expand(10), b.expand(10), x)
        return torch.autograd.grad(I.sum(), (a, b))

    def duals():
        return torch.autograd.grad(dgamma.betainc(a, b, x).sum(), (a, b))
    ways = (("card", lambda: tensors(a, b, x)),
            ("host_tensors", lambda: tensors(ah, bh, xh)), ("host", duals))
    got = {name: [float(v) for v in fn()] for name, fn in ways}
    for name in ("card", "host_tensors"):
        if not np.allclose(got[name], got["host"], rtol=1e-10):
            raise AssertionError(f"incomplete beta's gradient, {name}: "
                                 f"{got[name]} against {got['host']}")
    torch.cuda.synchronize()
    t = {}
    for name, fn in ways:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) / 3
    print(f"  incomplete beta, value + gradient of 10 numbers [{card}]: "
          f"{1e3 * t['card']:.1f} ms as a loop of tensor operations under "
          f"autograd on the card, {1e3 * t['host_tensors']:.1f} ms as the "
          f"same loop on CPU tensors, {1e3 * t['host']:.2f} ms with numpy "
          f"values and dual numbers on the host "
          f"({t['host_tensors'] / t['host']:.1f} x)", flush=True)


def phase_program(torch, rng, report, card):
    import tempfile

    t0 = time.perf_counter()
    names, rows, nwk, cls = simulate_site_classes(torch, rng, 32, 4096,
                                                  "cuda")
    print(f"simulated site-class alignment: {len(names)} taxa x "
          f"{len(rows[0]) // 3} codons, classes {SITE_TRUTH} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with tempfile.TemporaryDirectory() as work:
        out, launches, lnls = run_program(torch, work, "clean", names, rows,
                                          nwk, "0 1 2 7 8", card)
        for name, count in launches.items():
            if (count > 0) != name.startswith("big"):
                raise AssertionError(f"program, clean: {name} launched "
                                     f"{count} times; B3/B4 should carry it")
            if count:
                report[name]["launches_program_clean"] = count
        check_program(torch, out, lnls, "clean")
        lnl = {r["NSsites"]: r["res"].lnL for r in out["runs"]}
        lrt = {"M1a-M2a": 2 * (lnl[2] - lnl[1]), "M7-M8": 2 * (lnl[8] - lnl[7])}
        print(f"  likelihood-ratio tests: {lrt} against {CHI2_2DF_05} "
              "(chi-square, 2 d.f., 5 %)", flush=True)
        if min(lrt.values()) < CHI2_2DF_05:
            raise AssertionError("the tests of positive selection are not "
                                 "significant on simulated selection")
        check_beb(torch, out, cls, report, card)
        data, topo = out["data"], out["runs"][0]["res"].topo
        check_routes(torch, data, topo, card)
        out, launches, lnls = run_program(torch, work, "gapped", names,
                                          gapped_rows(rng, rows), nwk, "0 8",
                                          card)
        for name, count in launches.items():
            if (count > 0) != name.startswith("pruning"):
                raise AssertionError(f"program, gapped: {name} launched "
                                     f"{count} times; B1/B2 should carry it")
            if count:
                report[name]["launches_program_gapped"] = count
        check_program(torch, out, lnls, "gapped")
        check_beb(torch, out, cls, report, card)
        gapped = out["data"]
        # branch-site model A on the clean alignment, the first cherry's
        # branch as foreground: its BEB puts 121 sets on the class axis
        if "(t0, t1)" not in nwk:
            raise AssertionError(f"no cherry (t0, t1) in {nwk[:60]}...")
        out, launches, lnls = run_program(
            torch, work, "branch-site", names, rows,
            nwk.replace("(t0, t1)", "(t0, t1) #1"), "2", card, model=2)
        for name, count in launches.items():
            if (count > 0) != name.startswith("big"):
                raise AssertionError(f"program, branch-site: {name} launched "
                                     f"{count} times; B3/B4 should carry it")
            if count:
                report[name]["launches_program_branch_site"] = count
        check_program(torch, out, lnls, "branch-site")
        check_beb_branch_site(torch, out, gapped, report, card)


# --- phase 7: baseml on the card --------------------------------------------

# REV + G5: the exchangeabilities of (T,C), (T,A), (T,G), (C,A), (C,G), with
# (A,G) = 1; frequencies of T, C, A, G
NUC_TRUTH = dict(alpha=0.5, pi=(0.2, 0.3, 0.3, 0.2),
                 rev=(2.5, 0.4, 0.6, 0.5, 0.7))
NUC_TAXA, NUC_SITES = 100, 100_000


def random_unrooted_tree(rng, names, blen=(0.01, 0.1)):
    """A random binary tree: lineages joined in random pairs until three
    remain, which meet at the root (a random rooted tree with its root
    removed, as baseml's trees are unrooted at clock = 0; unbalanced, as
    real trees are), branch lengths uniform on `blen`.  Newick."""
    nodes = list(names)
    while len(nodes) > 3:
        i, j = sorted(rng.choice(len(nodes), size=2, replace=False))
        b = rng.uniform(*blen, size=2)
        joined = f"({nodes[i]}:{b[0]:.6f},{nodes[j]}:{b[1]:.6f})"
        nodes = [v for k, v in enumerate(nodes) if k not in (i, j)]
        nodes.append(joined)
    b = rng.uniform(*blen, size=3)
    return "(" + ",".join(f"{v}:{x:.6f}" for v, x in zip(nodes, b)) + ");"


def simulate_nuc(torch, rng, ns, ls, device, truth=NUC_TRUTH):
    """An alignment simulated under REV + G5 (`truth`) on
    `random_unrooted_tree` with the port's own P(t) (`nuc.pmats_for_model`)
    and its discrete gamma: (names, rows, the Newick string, the states of
    every node [nnode, ls] (numpy), the Topology)."""
    from paml_tpu_torch.core.dgamma import discrete_gamma
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio
    from paml_tpu_torch.models import nuc

    names = [f"t{i}" for i in range(ns)]
    nwk = random_unrooted_tree(rng, names)
    topo = from_treenode(treeio.parse_newick(nwk), names)
    f64 = dict(dtype=torch.float64, device=device)
    r, w = discrete_gamma(torch.tensor(truth["alpha"], **f64), 5)
    pi = torch.tensor(truth["pi"], **f64)
    t = torch.tensor(topo.blen0, **f64)
    P, _ = nuc.pmats_for_model("REV", torch.tensor(truth["rev"], **f64), pi,
                               t[:, None] * r[None, :])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    cls = torch.multinomial(w, ls, replacement=True, generator=gen)
    cum = P.cumsum(-1)
    st = torch.empty((topo.nnode, ls), dtype=torch.int64, device=device)
    st[topo.root] = torch.multinomial(pi, ls, replacement=True, generator=gen)
    stack = [topo.root]
    while stack:
        v = stack.pop()
        for c in topo.children[v]:
            if c < 0:
                continue
            u = torch.rand((ls, 1), generator=gen, **f64)
            st[c] = (u > cum[c, cls, st[v]]).sum(-1).clamp_max(3)
            stack.append(int(c))
    st = st.cpu().numpy()
    letters = np.frombuffer(b"TCAG", dtype="S1")
    rows = [letters[st[i]].tobytes().decode() for i in range(ns)]
    return names, rows, nwk, st, topo


def gapped_nuc_rows(rng, rows, amb=b"N"):
    """The rows with gaps in runs of geometric length (mean 10 sites) over
    about 5 % of each taxon's cells, and `amb` (N; X for amino acids) in
    0.2 % of the others, as phase 3b's gapped tips."""
    ns, L = len(rows), len(rows[0])
    arr = np.frombuffer("".join(rows).encode(), dtype="S1").reshape(ns, L)
    arr = arr.copy()
    runs = rng.poisson(0.05 * L / 10, size=ns)
    for t in range(ns):
        for s0, ln in zip(rng.integers(0, L, size=runs[t]),
                          rng.geometric(0.1, size=runs[t])):
            arr[t, s0:s0 + ln] = b"-"
    arr[(rng.random((ns, L)) < 0.002) & (arr != b"-")] = amb
    return [arr[t].tobytes().decode() for t in range(ns)]


BASEML_CTL = """      seqfile = seq.phy
     treefile = tree.nwk
      outfile = mlb
        noisy = 0
      runmode = 0
        model = {model}
        Mgene = {mgene}
        clock = 0
    fix_kappa = 0
        kappa = 5
    fix_alpha = 0
        alpha = 1.0
        ncatG = {ncatG}
        getSE = {getSE}
 RateAncestor = {rateancestor}
    cleandata = 0
"""


def write_baseml_problem(workdir, tag, names, rows, nwk, genes=None, **kw):
    """The alignment (PHYLIP; `genes` lengths as option G), the tree and a
    baseml.ctl in workdir/tag; returns the ctl's path."""
    import os
    import re

    d = os.path.join(workdir, tag)
    os.makedirs(d)
    with open(os.path.join(d, "seq.phy"), "w") as f:
        f.write(f"{len(names)} {len(rows[0])}" + (" G" if genes else "")
                + "\n")
        if genes:
            f.write(f"G {len(genes)} " + " ".join(map(str, genes)) + "\n")
        for nm, row in zip(names, rows):
            f.write(f"{nm}  {row}\n")
    with open(os.path.join(d, "tree.nwk"), "w") as f:
        # the topology alone: the fit starts from no branch lengths
        f.write(re.sub(r":[0-9.]+", "", nwk) + "\n")
    opts = dict(model=7, mgene=0, ncatG=5, getSE=1, rateancestor=1)
    opts.update(kw)
    ctl = os.path.join(d, "baseml.ctl")
    with open(ctl, "w") as f:
        f.write(BASEML_CTL.format(**opts))
    return ctl


def reset_counts():
    from paml_tpu_torch.core import cuda_pruning, pruning
    cuda_pruning.reset_launch_counts()
    pruning.PLAIN_CALLS["cuda"] = pruning.TWICE_CALLS["cuda"] = 0
    pruning.LEVEL_CALLS["cuda"] = 0


def read_counts():
    """The kernel launches and the calls of the level route, the plain
    version and the Hessian route on the card since `reset_counts`."""
    from paml_tpu_torch.core import cuda_pruning, pruning
    return dict(launches=dict(cuda_pruning.LAUNCHES),
                level=pruning.LEVEL_CALLS["cuda"],
                plain=pruning.PLAIN_CALLS["cuda"],
                twice=pruning.TWICE_CALLS["cuda"])


def run_ctl_program(torch, ctl, prog="baseml", outfile="mlb"):
    """`paml_tpu_torch.__main__.main([prog, ctl])` in ctl's directory, in
    this process, on the card, the counts set to 0 just before: (its
    summary, wall seconds, a dict of the kernel launches, level-route calls,
    plain-version calls, Hessian-route calls and peak GiB, the lnL lines of
    `outfile`)."""
    import os
    import re

    from paml_tpu_torch import __main__ as cli

    cwd = os.getcwd()
    os.chdir(os.path.dirname(ctl))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        out = cli.main([prog, ctl])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = dict(read_counts(),
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    text = open(os.path.join(os.path.dirname(ctl), outfile)).read()
    lnls = [float(v) for v in re.findall(r"lnL\(ntime:.*\): *(-?[0-9.]+)",
                                         text)]
    return out, wall, counts, lnls


def check_baseml_routes(tag, counts):
    """The level route carried the program on the card: no kernel launch,
    no plain-version call, level-route calls counted."""
    if any(counts["launches"].values()) or counts["plain"] \
            or not counts["level"]:
        raise AssertionError(f"baseml, {tag}: kernel launches "
                             f"{counts['launches']}, plain calls "
                             f"{counts['plain']}, level-route calls "
                             f"{counts['level']}: 4 states must take the "
                             "level route alone")


def cpu_objective_lnl(torch, data, topo, spec, x):
    """The program's objective on CPU tensors at x: (-value, objective)."""
    from paml_tpu_torch.apps import baseml

    neg = baseml.make_objective(data, topo, spec, device="cpu")[0]
    with torch.no_grad():
        return -float(neg(torch.as_tensor(x))), neg


def rst_sample(path, sites):
    """(states, probabilities) of the given 0-based sites in rst's
    marginal reconstruction table."""
    want = {s + 1 for s in sites}
    st, pr = {}, {}
    with open(path) as f:
        for line in f:
            if line.startswith("site node#"):
                break
        for line in f:
            toks = line.split()
            if not toks or not toks[0].isdigit():
                break
            site = int(toks[0])
            if site in want:
                cells = [c.rstrip(")").split("(") for c in toks[1:]]
                st[site - 1] = [c[0] for c in cells]
                pr[site - 1] = [float(c[1]) for c in cells]
    return st, pr


def baseml_value_grad(torch, neg, x, device, reps=1):
    """-lnL and its gradient at x on device; ms per call (the last of
    reps, after a warm-up call)."""
    xt = torch.tensor(x, dtype=torch.float64, device=device,
                      requires_grad=True)
    for _ in range(reps + 1):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        g = g.cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0)
    return float(v.detach()), g, ms


def phase_baseml_program(torch, rng, card):
    """7a: the program on the 100-taxon x 100,000-site REV + G5 alignment
    with gaps and Ns."""
    import os
    import tempfile

    from paml_tpu_torch.apps import ancestral, baseml

    t0 = time.perf_counter()
    names, rows, nwk, st, topo_sim = simulate_nuc(torch, rng, NUC_TAXA,
                                                  NUC_SITES, "cuda")
    rows = gapped_nuc_rows(rng, rows)
    gap_share = sum(r.count("-") for r in rows) / (NUC_TAXA * NUC_SITES)
    print(f"simulated REV + G5 alignment (alpha {NUC_TRUTH['alpha']}, pi "
          f"{NUC_TRUTH['pi']}): {NUC_TAXA} taxa x {NUC_SITES} sites, "
          f"{100 * gap_share:.2f} % gap cells "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    work = tempfile.mkdtemp(prefix="baseml_")
    ctl = write_baseml_problem(work, "rev_g5", names, rows, nwk)
    out, wall, counts, lnls = run_ctl_program(torch, ctl)
    check_baseml_routes("REV + G5", counts)
    run = out["runs"][0]
    res, spec, data = run["res"], run["spec"], out["data"]
    if counts["twice"] == 0:
        raise AssertionError("baseml: getSE = 1 made no Hessian")
    t1 = time.perf_counter()
    lnl_cpu, neg_cpu = cpu_objective_lnl(torch, data, res.topo, spec, res.x)
    cpu_s = time.perf_counter() - t1
    rel = abs(lnls[0] - lnl_cpu) / abs(lnl_cpu)
    alpha = float(res.alpha[0])
    _, _, _, bounds = baseml.make_objective(data, res.topo, spec,
                                            device="cpu")
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    free = (res.x > lo + 1e-6 * (hi - lo)) & (res.x < hi - 1e-6 * (hi - lo))
    ses = res.SEs
    n_eval = res.fit.n_eval
    print(f"baseml, REV + G5 [{card}]: {data.npatt} patterns, {res.np} "
          f"parameters; {wall:.1f} s wall: fit {run['fit_seconds']:.2f} s "
          f"in {n_eval} evaluations ({1e3 * run['fit_seconds'] / n_eval:.2f}"
          f" ms each), Hessian {run['hessian_seconds']:.2f} s, ancestral "
          f"reconstruction {run['ancestral_seconds']:.2f} s; peak "
          f"{counts['peak_gib']:.2f} GiB; level-route calls "
          f"{counts['level']}, Hessian-route calls {counts['twice']}, kernel "
          f"launches {counts['launches']}", flush=True)
    print(f"  lnL in mlb {lnls[0]:.6f}, CPU objective at the fitted x "
          f"{lnl_cpu:.6f} (rel {rel:.2e}; {cpu_s:.1f} s on the host); alpha "
          f"{alpha:.4f} (simulated {NUC_TRUTH['alpha']}); exchangeabilities "
          f"{np.round(res.rate_params, 3)} (simulated {NUC_TRUTH['rev']}); "
          f"SEs of the {int(free.sum())} free parameters in "
          f"[{ses[free].min():.3g}, {ses[free].max():.3g}]", flush=True)
    if rel > 1e-9:
        raise AssertionError("baseml: the lnL in mlb disagrees with the CPU "
                             "objective at the fitted x")
    if abs(alpha - NUC_TRUTH["alpha"]) > 0.1 * NUC_TRUTH["alpha"]:
        raise AssertionError(f"baseml: alpha {alpha} is not within 10 % of "
                             f"{NUC_TRUTH['alpha']}")
    if not (np.isfinite(ses).all() and (ses[free] > 0).all()):
        raise AssertionError(f"baseml: SEs {ses}")
    # the reconstruction the program wrote, against the CPU's at the same x
    best, prob = run["ancestral"]
    t1 = time.perf_counter()
    with torch.no_grad():
        P, piC, w, _ = neg_cpu.model_at(res.x)
        best_c, prob_c, _ = ancestral.marginal_reconstruction(
            P, neg_cpu.tips, res.topo, piC, w, neg_cpu.fpatt)
    cpu_s = time.perf_counter() - t1
    sp = data.site_pattern
    nint = topo_sim.nnode - topo_sim.ns
    sample = np.linspace(0, NUC_SITES - 1, 2000).astype(int)
    st_rst, pr_rst = rst_sample(os.path.join(os.path.dirname(ctl), "rst"),
                                sample)
    rst_ok = all(st_rst[s] == ["TCAG"[v] for v in best[:, sp[s]]]
                 and np.abs(np.array(pr_rst[s]) - prob[:, sp[s]]).max()
                 <= 5e-4 + 1e-9 for s in sample)
    truth = st[topo_sim.ns:]                                # [nint, ls]
    hit = float((best[:, sp] == truth).mean())
    perr = float(np.abs(prob - prob_c).max())
    print(f"  marginal reconstruction: {nint} internal nodes x "
          f"{NUC_SITES} sites; states equal to the CPU's "
          f"{bool((best == best_c).all())}, probabilities max|diff| "
          f"{perr:.2e} ({cpu_s:.1f} s on the host); rst holds them at "
          f"{len(sample)} sampled sites: {rst_ok}; {100 * hit:.2f} % of the "
          "internal-node sites reconstructed as simulated", flush=True)
    if not (best == best_c).all() or perr > 1e-9 or not rst_ok:
        raise AssertionError("baseml: the marginal reconstruction disagrees "
                             "with the CPU's")
    return out, names, rows, nwk


def level_kernel_value_grad(torch, P, tips, topo, piC, w, fpatt, report,
                            card, key="b5"):
    """ROADMAP B5's evidence: one value + gradient in P and pi through the
    level route (`pruning.class_site_lnf_levels`), and through the kernel
    pair that the tips take at N = 64 (B1/B2 for coded tips with a table,
    B3/B4 for state codes; the wrappers called directly, the patterns in
    chunks so that S and the walk's workspace fit), held to each other; ms
    and peak GiB of each; the level route repeated bit for bit.  Records
    the times and the pair's bounds at the real n and at N = 64 under
    `key` in the pair's report rows, and returns them."""
    from paml_tpu_torch.core import cuda_pruning as cp
    from paml_tpu_torch.core import pruning
    from paml_tpu_torch.core.tipcodes import TipCodes

    H, C, n = fpatt.shape[0], P.shape[1], P.shape[-1]

    def level():
        P_ = P.detach().requires_grad_(True)
        pi_ = piC.detach().clone().requires_grad_(True)
        v = pruning.lnL(P_, tips, topo, pi_, w, fpatt,
                        lnf=pruning.class_site_lnf_levels)
        dP, dpi = torch.autograd.grad(v, (P_, pi_))
        return v.detach(), dP, dpi

    codes = cp.kernel_tips(tips)
    fused = isinstance(codes, TipCodes)
    names = ("pruning_fwd", "pruning_bwd") if fused else ("big_fwd",
                                                          "big_bwd")
    fwd, bwd = (cp.pruning_fwd, cp.pruning_bwd) if fused else \
        (cp.pruning_big_fwd, cp.pruning_big_bwd)
    bp = cp.big_plan(cp.big_tree(topo))
    per_pattern = (bp.n_srows * C * n + C * bp.nslots * cp.N) * 8
    n_chunks = max(1, -(-per_pattern * H // (8 << 30)))
    w_chunk = -(-H // n_chunks)

    chunks = (codes.split(w_chunk) if fused else
              [c.contiguous() for c in codes.split(w_chunk, dim=1)])

    def kernels():
        total, dP, dpi = 0.0, torch.zeros_like(P), torch.zeros_like(piC)
        for h0, tc in zip(range(0, H, w_chunk), chunks):
            sl = slice(h0, min(h0 + w_chunk, H))
            lnf, S = fwd(P, tc, topo, piC)
            z = lnf + torch.log(w)[:, None]
            site = torch.logsumexp(z, 0)
            total = total + (fpatt[sl] * site).sum()
            gbar = fpatt[sl][None, :] * torch.softmax(z, 0)
            a, b = bwd(P, tc, topo, piC, gbar, S)
            dP, dpi = dP + a, dpi + b
            del S
        return total, dP, dpi

    out = {}
    for name, fn in (("level", level), ("kernels", kernels)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms_median(fn, reps=5, warmup=1)
        out[name] = dict(ms=ms, gib=(torch.cuda.max_memory_allocated()
                                     - base) / 2 ** 30, res=fn())
    (v1, dP1, dpi1), (v2, dP2, dpi2) = out["level"]["res"], \
        out["kernels"]["res"]
    tol = TOL["float64"]
    rel = abs(float(v1) - float(v2)) / abs(float(v1))
    gerr = max(float((dP1 - dP2).abs().max() / dP1.abs().max()),
               float((dpi1 - dpi2).abs().max() / dpi1.abs().max()))
    again = out["level"]["res"], level()
    same = all(torch.equal(a, b) for a, b in zip(*again))
    n_amb = getattr(codes, "n_amb", 0)
    bnd = {m: [bound(k, topo, C, H, m, 8, n_amb) for k in names]
           for m in (n, cp.N)}
    pair = "B1/B2" if fused else "B3/B4"
    print(f"  {key}, value + gradient at the MLEs [{card}], {C} classes x "
          f"{H} patterns x {n} states: level route {out['level']['ms']:.2f}"
          f" ms, peak {out['level']['gib']:.2f} GiB; {pair} at N = {cp.N} "
          f"in {n_chunks} chunk(s) {out['kernels']['ms']:.2f} ms, peak "
          f"{out['kernels']['gib']:.2f} GiB (bounds at n = {n}: "
          f"{bnd[n][0][0]:.3f} + {bnd[n][1][0]:.3f} ms; at N = {cp.N}: "
          f"{bnd[cp.N][0][0]:.3f} + {bnd[cp.N][1][0]:.3f} ms); lnL rel "
          f"{rel:.2e}, gradient {gerr:.2e} of the largest; the level route "
          f"repeated bit for bit: {same}", flush=True)
    if rel > tol["val"] or gerr > tol["grad"] or not same:
        raise AssertionError(f"{key}: the level route and {pair} disagree, "
                             "or the level route does not repeat")
    for k, name in enumerate(names):
        report[name][f"{key}_kernel_pair_ms_float64"] = out["kernels"]["ms"]
        report[name][f"{key}_level_route_ms_float64"] = out["level"]["ms"]
        report[name][f"{key}_bound_ms_float64"] = bnd[n][k][0]
        report[name][f"{key}_bound_ms_N64_float64"] = bnd[cp.N][k][0]
    return dict(level_ms=out["level"]["ms"], kernel_ms=out["kernels"]["ms"],
                level_gib=out["level"]["gib"],
                kernel_gib=out["kernels"]["gib"], rel=rel, gerr=gerr)


def phase_baseml(torch, rng, report, card):
    """Phase 7: baseml and basemlg on the card (the level route)."""
    import tempfile

    from paml_tpu_torch.apps import baseml

    out, names, rows, nwk = phase_baseml_program(torch, rng, card)
    run = out["runs"][0]
    res, spec, data = run["res"], run["spec"], out["data"]
    neg = baseml.make_objective(data, res.topo, spec, device="cuda")[0]
    with torch.no_grad():
        P, piC, w, _ = neg.model_at(res.x)
    level_kernel_value_grad(torch, P, neg.tips, res.topo, piC.contiguous(),
                            w, neg.fpatt, report, card)
    del P, piC, neg
    torch.cuda.empty_cache()
    # 7c: HKY85 + AdG, the rate HMM over the 100,000 sites
    spec_adg = baseml.BasemlSpec(model="HKY85", ncatG=5, fix_alpha=False,
                                 fix_rho=False)
    neg, _, x0, _ = baseml.make_objective(data, res.topo, spec_adg,
                                          device="cuda")
    reset_counts()
    v, g, ms = baseml_value_grad(torch, neg, x0, "cuda", reps=3)
    check_baseml_routes("HKY85 + AdG", read_counts())
    neg_c = baseml.make_objective(data, res.topo, spec_adg, device="cpu")[0]
    t0 = time.perf_counter()
    v_c, g_c, _ = baseml_value_grad(torch, neg_c, x0, "cpu", reps=0)
    cpu_s = time.perf_counter() - t0
    rel = abs(v - v_c) / abs(v_c)
    gerr = np.abs(g - g_c).max() / np.abs(g_c).max()
    print(f"  HKY85 + AdG (K = 5, rho free), value + gradient over "
          f"{data.ls} sites [{card}]: {ms:.2f} ms on the card, "
          f"{cpu_s:.1f} s on CPU tensors; lnL rel {rel:.2e}, gradient "
          f"{gerr:.2e} of the largest", flush=True)
    if rel > 1e-9 or gerr > 1e-8 or not np.isfinite(g).all():
        raise AssertionError("rate HMM: value + gradient on the card "
                             "disagrees with CPU tensors")
    del neg, neg_c
    torch.cuda.empty_cache()
    # 7d: basemlg, and Mgene = 4 with two genes (option G)
    work = tempfile.mkdtemp(prefix="basemlg_")
    names, rows, nwk, _, _ = simulate_nuc(torch, rng, 8, 2000, "cuda")
    for tag, prog, genes, kw in (
            ("basemlg", "basemlg", None, dict(model=4, getSE=0)),
            ("mgene4", "baseml", [1000, 1000],
             dict(model=6, mgene=4, ncatG=4, getSE=0, rateancestor=0))):
        ctl = write_baseml_problem(work, tag, names, rows, nwk, genes=genes,
                                   **kw)
        out, wall, counts, lnls = run_ctl_program(torch, ctl, prog)
        check_baseml_routes(tag, counts)
        run = out["runs"][0]
        lnl_cpu, _ = cpu_objective_lnl(torch, out["data"], run["res"].topo,
                                       run["spec"], run["res"].x)
        rel = abs(lnls[0] - lnl_cpu) / abs(lnl_cpu)
        print(f"  {tag} [{card}]: 8 taxa x 2000 sites, {out['data'].ngene} "
              f"gene(s), {run['res'].np} parameters; {wall:.2f} s wall, "
              f"{run['res'].fit.n_eval} evaluations; lnL in mlb "
              f"{lnls[0]:.6f}, CPU objective {lnl_cpu:.6f} (rel {rel:.2e});"
              f" alpha {np.round(run['res'].alpha, 4)}", flush=True)
        if rel > 1e-9:
            raise AssertionError(f"{tag}: the lnL in mlb disagrees with the "
                                 "CPU objective")


# --- phase 8: amino acids, aaDist and Mgene (codeml) -------------------------

AA_TRUTH = dict(matrix="lg", alpha=0.5)           # LG + F + G4, pi LG's
AA_TAXA, AA_SITES = 100, 50_000

AA_CTL = """      seqfile = seq.phy
     treefile = tree.nwk
      outfile = mlc
        noisy = 0
      runmode = 0
      seqtype = {seqtype}
    CodonFreq = 2
        model = {model}
   aaRatefile = {aaRatefile}
      NSsites = 0
        icode = 0
        Mgene = {mgene}
       aaDist = {aaDist}
    fix_kappa = 0
        kappa = 2
    fix_omega = 0
        omega = .4
    fix_alpha = {fix_alpha}
        alpha = 0.5
        ncatG = 4
        getSE = 0
    cleandata = 0
"""

# two omega classes over the one-step pairs (OmegaAA.dat, aaDist = 7):
# the pairs of similar side chains against all others
OMEGA_AA = "2\n1: AG AS AT VI IL LM FY DE KR ST NS QE\n0: all others\n"


def simulate_aa(torch, rng, ns, ls, device, truth=AA_TRUTH):
    """An amino-acid alignment simulated under an empirical matrix + G4
    (`truth`: the matrix's own frequencies, discrete gamma of shape alpha)
    on `random_unrooted_tree` with the port's own P(t): (names, rows, the
    Newick string)."""
    from paml_tpu_torch.constants import AA_ORDER
    from paml_tpu_torch.core.dgamma import discrete_gamma
    from paml_tpu_torch.core.pmat import pmat_rev
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio
    from paml_tpu_torch.models import aa

    names = [f"t{i}" for i in range(ns)]
    nwk = random_unrooted_tree(rng, names)
    topo = from_treenode(treeio.parse_newick(nwk), names)
    f64 = dict(dtype=torch.float64, device=device)
    S, pi_np = aa.load_empirical(truth["matrix"])
    pi = torch.tensor(pi_np / pi_np.sum(), **f64)
    Sd = torch.tensor(S, **f64)
    Q = aa.build_aa_Q(Sd - torch.diag(torch.diagonal(Sd)), pi)
    r, w = discrete_gamma(torch.tensor(truth["alpha"], **f64), 4)
    P = pmat_rev(Q, pi, torch.tensor(topo.blen0, **f64)[:, None] * r)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    cls = torch.multinomial(w, ls, replacement=True, generator=gen)
    cum = P.cumsum(-1)
    st = torch.empty((topo.nnode, ls), dtype=torch.int64, device=device)
    st[topo.root] = torch.multinomial(pi, ls, replacement=True, generator=gen)
    stack = [topo.root]
    while stack:
        v = stack.pop()
        for c in topo.children[v]:
            if c < 0:
                continue
            u = torch.rand((ls, 1), generator=gen, **f64)
            st[c] = (u > cum[c, cls, st[v]]).sum(-1).clamp_max(19)
            stack.append(int(c))
    letters = np.frombuffer(AA_ORDER.encode(), dtype="S1")
    rows = [letters[st[i].cpu().numpy()].tobytes().decode()
            for i in range(ns)]
    return names, rows, nwk


def write_codeml_problem(workdir, tag, names, rows, nwk, genes=None,
                         lengths=False, **kw):
    """The alignment (PHYLIP; `genes` lengths as option G), the tree (its
    topology, or with `lengths` its branch lengths too, the fit's start),
    an `AA_CTL` control file and, for aaDist = 7, OmegaAA.dat in
    workdir/tag; returns the ctl's path."""
    import os
    import re

    d = os.path.join(workdir, tag)
    os.makedirs(d)
    with open(os.path.join(d, "seq.phy"), "w") as f:
        f.write(f"{len(names)} {len(rows[0])}" + (" G" if genes else "")
                + "\n")
        if genes:
            f.write(f"G {len(genes)} " + " ".join(map(str, genes)) + "\n")
        for nm, row in zip(names, rows):
            f.write(f"{nm}  {row}\n")
    with open(os.path.join(d, "tree.nwk"), "w") as f:
        f.write((nwk if lengths else re.sub(r":[0-9.]+", "", nwk)) + "\n")
    opts = dict(seqtype=1, model=0, aaRatefile="jones", mgene=0, aaDist=0,
                fix_alpha=1)
    opts.update(kw)
    if opts["aaDist"] == 7:
        with open(os.path.join(d, "OmegaAA.dat"), "w") as f:
            f.write(OMEGA_AA)
    ctl = os.path.join(d, "codeml.ctl")
    with open(ctl, "w") as f:
        f.write(AA_CTL.format(**opts))
    return ctl


def a9_objective(data, topo, spec, device):
    """The objective that `codeml.fit_packed` fits for an A9 setting."""
    from paml_tpu_torch.apps import codeml
    if spec.seqtype in (2, 3):
        make = (codeml.make_fromcodon0_objective
                if spec.aa_model == "FromCodon0" else codeml.make_aa_objective)
        return make(data, topo, spec, device=device)[0]
    if spec.aaDist:
        return codeml.make_aadist_objective(data, topo, spec,
                                            device=device)[0]
    return codeml.make_codon_mgene_objective(data, topo, spec, spec.Mgene,
                                             device=device)[0]


def plain_lnl(torch, neg, x):
    """lnL at x with the plain pruning version on the objective's device."""
    from paml_tpu_torch.core import pruning
    with torch.no_grad():
        return -float(neg(torch.as_tensor(x, device="cuda"),
                          lnf=pruning.class_site_lnf_plain))


def run_a9_program(torch, ctl, tag, card, report=None):
    """The program on ctl, its launches recorded under launches_{tag} in
    `report` (when given); its lnL in mlc held against the plain version
    on the card at the fitted x (1e-9 relative).  Returns (summary, wall,
    counts, lnL in mlc)."""
    out, wall, counts, lnls = run_ctl_program(torch, ctl, "codeml", "mlc")
    run = out["runs"][0]
    res = run["res"]
    lnl_p = plain_lnl(torch, a9_objective(out["data"], res.topo, res.spec,
                                          "cuda"), res.x)
    rel = abs(lnls[0] - lnl_p) / abs(lnl_p)
    print(f"  {tag} [{card}]: {out['data'].ns} taxa x {out['data'].ls} "
          f"sites, {out['data'].npatt} patterns, {res.np} parameters; "
          f"{wall:.2f} s wall, fit {run['fit_seconds']:.2f} s in "
          f"{res.fit.n_eval} evaluations "
          f"({1e3 * run['fit_seconds'] / res.fit.n_eval:.2f} ms each; "
          f"{res.fit.message}); "
          f"peak {counts['peak_gib']:.2f} GiB; launches "
          f"{counts['launches']}, level-route calls {counts['level']}, "
          f"plain calls {counts['plain']}; lnL in mlc {lnls[0]:.6f}, plain "
          f"version {lnl_p:.6f} (rel {rel:.2e})", flush=True)
    if counts["plain"]:
        raise AssertionError(f"{tag}: the plain version ran on the card")
    if rel > 1e-9:
        raise AssertionError(f"{tag}: the lnL in mlc disagrees with the "
                             "plain version")
    for name, count in counts["launches"].items():
        if count and report is not None:
            report[name][f"launches_{tag}"] = count
    return out, wall, counts, lnls


def check_aa_kernels(torch, P, tips, topo, piC, w, fpatt, report, card,
                     tag):
    """B1/B2 (coded tips with a table) or B3/B4 (state codes), launched
    alone at the shape of the amino-acid fit with the fit's own cotangent,
    against their plain versions (f64: 1e-10 on values, 1e-8 on
    gradients); each kernel timed beside its plain version and its bounds
    at n = 20 and at N = 64."""
    from paml_tpu_torch.core import cuda_pruning as cp
    from paml_tpu_torch.core import pruning
    from paml_tpu_torch.core.tipcodes import TipCodes

    tol = TOL["float64"]
    C, n, H = P.shape[1], P.shape[-1], fpatt.shape[0]
    codes = cp.kernel_tips(tips)
    fused = isinstance(codes, TipCodes)
    with torch.no_grad():
        z = pruning.class_site_lnf_levels(P, tips, topo, piC) \
            + torch.log(w)[:, None]
        gbar = (fpatt[None, :] * torch.softmax(z, 0)).contiguous()
    del z
    if fused:
        names = ("pruning_fwd", "pruning_bwd")
        e_f, e_b, S = check_fused(torch, P, codes, topo, piC, gbar, tol, tag)
        fwd, bwd = cp.pruning_fwd, cp.pruning_bwd
    else:
        names = ("big_fwd", "big_bwd")
        fwd, bwd = cp.pruning_big_fwd, cp.pruning_big_bwd
        lnf, S = fwd(P, codes, topo, piC)
        dP, dpi = bwd(P, codes, topo, piC, gbar, S)
        tb = cp.big_tree(topo)
        Pb = cp.with_identity(P, tb)
        lnf_r, S_r = pruning.class_site_lnf_big_plain(Pb, codes, tb, piC)
        e_f = max(max_err(lnf, lnf_r, tol["val"], f"B3 lnf {tag}"),
                  max_err(S, S_r, tol["val"], f"B3 S {tag}"))
        del S_r, lnf_r, Pb
        dP_r, dpi_r = pruning.class_site_lnf_bwd_plain(P, codes, topo, piC,
                                                       gbar)
        e_b = max(max_err(dP, dP_r, tol["grad"], f"B4 dP {tag}"),
                  max_err(dpi, dpi_r, tol["grad"], f"B4 dpi {tag}"))
        del dP_r, dpi_r, dP, dpi
    torch.cuda.empty_cache()
    t = {names[0]: cuda_ms_median(lambda: fwd(P, codes, topo, piC)),
         names[1]: cuda_ms_median(lambda: bwd(P, codes, topo, piC, gbar, S))}
    with torch.no_grad():
        plain_f = cuda_ms_median(lambda: pruning.class_site_lnf_plain(
            P, codes, topo, piC))
    plain_b = cuda_ms_median(lambda: pruning.class_site_lnf_bwd_plain(
        P, codes, topo, piC, gbar))
    n_amb = getattr(codes, "n_amb", 0)
    for name, e, pl in ((names[0], e_f, plain_f), (names[1], e_b, plain_b)):
        report[name]["max_abs_err_float64"] = max(
            report[name].get("max_abs_err_float64", 0.0), e)
        b20 = bound(name, topo, C, H, n, 8, n_amb)
        b64 = bound(name, topo, C, H, cp.N, 8, n_amb)
        report[name][f"ms_{tag}_float64"] = t[name]
        report[name][f"plain_ms_{tag}_float64"] = pl
        report[name][f"bound_ms_{tag}_n20_float64"] = b20[0]
        report[name][f"bound_ms_{tag}_N64_float64"] = b64[0]
        print(f"  {name} [{tag}, {C} classes x {H} patterns x {n} states, "
              f"A {n_amb}, {card}]: {t[name]:.3f} ms (plain {pl:.3f} ms); "
              f"max|diff| against the plain version {e:.3e}; bound at n = "
              f"{n} {b20[0]:.4f} ms ({b20[1]}, {100 * b20[0] / t[name]:.2f}"
              f" % of it), at N = {cp.N} {b64[0]:.4f} ms ({b64[1]}, "
              f"{100 * b64[0] / t[name]:.2f} %)", flush=True)
    del S
    torch.cuda.empty_cache()


def phase_aa(torch, rng, report, card):
    """Phase 8: the amino-acid program at full width (8a), the routes of
    20 states and the kernels alone at its shape (8b), then one program
    run for each of the other A9 settings (8c)."""
    import tempfile

    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.io import seqio

    t_phase = time.perf_counter()
    # 8a
    t0 = time.perf_counter()
    names, clean_rows, nwk = simulate_aa(torch, rng, AA_TAXA, AA_SITES,
                                         "cuda")
    rows = gapped_nuc_rows(rng, clean_rows, amb=b"X")
    gap_share = sum(r.count("-") for r in rows) / (AA_TAXA * AA_SITES)
    print(f"simulated amino-acid alignment (LG + G4, alpha "
          f"{AA_TRUTH['alpha']}): {AA_TAXA} taxa x {AA_SITES} sites, "
          f"{100 * gap_share:.2f} % gap cells "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    work = tempfile.mkdtemp(prefix="aaml_")
    fits = []
    for rep in range(2):
        # the fit starts from the simulated branch lengths
        ctl = write_codeml_problem(work, f"lg_{rep}", names, rows, nwk,
                                   lengths=True, seqtype=2, model=3,
                                   aaRatefile="lg", fix_alpha=0)
        # the second run repeats the first: its launches count once
        out, wall, counts, lnls = run_a9_program(
            torch, ctl, f"aa_{rep}", card, None if rep else report)
        fits.append(out["runs"][0]["res"])
    res, data = fits[0], out["data"]
    # from the topology alone (every branch 0.1, the JAX package's start)
    # the fit stops at a local optimum (ROADMAP C): shown, not checked
    ctl = write_codeml_problem(work, "lg_topology", names, rows, nwk,
                               seqtype=2, model=3, aaRatefile="lg",
                               fix_alpha=0)
    topo_res = run_a9_program(torch, ctl, "aa_topology", card)[0][
        "runs"][0]["res"]
    print(f"  aaml from the topology alone: lnL {topo_res.lnL:.6f} "
          f"({topo_res.lnL - res.lnL:+.3f} against the fit from the "
          f"simulated lengths), alpha {topo_res.params['alpha']:.4f}, tree "
          f"length {topo_res.blens.sum():.3f} (from the simulated lengths "
          f"{res.blens.sum():.3f})", flush=True)
    alpha = res.params["alpha"]
    same = fits[0].lnL == fits[1].lnL and np.array_equal(fits[0].x,
                                                         fits[1].x)
    print(f"  aaml, LG + F + G4: alpha {alpha:.4f} (simulated "
          f"{AA_TRUTH['alpha']}); the fit repeated bit for bit: {same}",
          flush=True)
    if not same:
        raise AssertionError("aaml: the fit does not repeat bit for bit")
    if abs(alpha - AA_TRUTH["alpha"]) > 0.1 * AA_TRUTH["alpha"]:
        raise AssertionError(f"aaml: alpha {alpha} is not within 10 % of "
                             f"{AA_TRUTH['alpha']}")
    # 8b: at the MLEs, the gapped alignment (B1/B2) and its clean copy
    # (B3/B4): the level route against the kernels, then each kernel alone
    t0 = time.perf_counter()
    seqio.pack(seqio.Alignment(names, rows, seqio.AA_SEQ))
    pack_s = time.perf_counter() - t0
    clean = seqio.pack(seqio.Alignment(names, clean_rows, seqio.AA_SEQ))
    for tag, d in (("aa_gapped", data), ("aa_clean", clean)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        neg = codeml.make_aa_objective(d, res.topo, res.spec,
                                       device="cuda")[0]
        torch.cuda.synchronize()
        if tag == "aa_gapped":
            print(f"  aaml's host set-up: pack {pack_s:.2f} s, the "
                  f"objective {time.perf_counter() - t0:.2f} s", flush=True)
        with torch.no_grad():
            P, piC, w = neg.model_at(torch.as_tensor(res.x, device="cuda"))
        piC = piC.contiguous()
        level_kernel_value_grad(torch, P, neg.tips, res.topo, piC, w,
                                neg.fpatt, report, card, key=f"b5_{tag}")
        torch.cuda.empty_cache()
        check_aa_kernels(torch, P, neg.tips, res.topo, piC, w, neg.fpatt,
                         report, card, tag)
        del P, piC, w, neg
        torch.cuda.empty_cache()
    # 8c: phase 6's alignment, one program run per setting
    t0 = time.perf_counter()
    names, rows, nwk, _ = simulate_site_classes(torch, rng, 32, 4096, "cuda")
    print(f"simulated site-class alignment for 8c: {len(names)} taxa x "
          f"{len(rows[0]) // 3} codons ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    for tag, genes, kw in (
            ("codon2aa_jtt", None, dict(seqtype=3, model=2)),
            ("fromcodon0", None, dict(seqtype=3, model=5)),
            ("aadist7", None, dict(aaDist=7)),
            ("aadist1", None, dict(aaDist=1)),
            ("mgene4", [2048, 2048], dict(mgene=4))):
        ctl = write_codeml_problem(work, tag, names, rows, nwk, genes, **kw)
        run_a9_program(torch, ctl, tag, card, report)
    print(f"  8c: five programs in {time.perf_counter() - t0:.1f} s; phase 8 "
          f"in {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 9: the pairwise programs and evolver (ROADMAP A11)
# ---------------------------------------------------------------------------

EVO_CODON = dict(taxa=50, codons=1000, repl=100, seed=4321)
EVO_NUC = dict(seed=8765)            # phase 7's shape: NUC_TAXA x NUC_SITES
YN_TAXA, YN_CODONS = 30, 1000
PW_ML_TAXA, PW_BAYES_TAXA, PW_CODONS = 12, 6, 500
CHI2_Q = 0.999                       # the distribution checks' quantile
M2A_BOUNDS = dict(kappa=0.3, p0=0.08, p2=0.05, w0=0.05, w2=1.5)
# the host CPU's runs of 9b-9d: one thread (PyTorch's default count on
# the card's machine oversubscribes its cores; the work is 61 x 61)
CPU_THREADS = 1


def codon_dat(nwk, ns, ncod, nrepl, seed):
    """evolver's codon .dat (MCcodon.dat layout): NSsites classes as in
    phase 6 (SITE_TRUTH), equal codon frequencies."""
    p, w = SITE_TRUTH["p"], SITE_TRUTH["w"]
    freqs = "\n".join(" ".join(["0.015625"] * 4) for _ in range(16))
    return (f"0\n{seed}\n{ns} {ncod} {nrepl}\n-1\n{nwk}\n{len(p)}\n"
            f"{' '.join(map(str, p))}\n{' '.join(map(str, w))}\n"
            f"{SITE_TRUTH['kappa']}\n{freqs}\n0\n")


def nuc_dat(nwk, ns, ls, seed):
    """evolver's nucleotide .dat: REV + G5 as phase 7 (NUC_TRUTH)."""
    t = NUC_TRUTH
    return (f"0\n{seed}\n{ns} {ls} 1\n-1\n{nwk}\n7\n"
            f"{' '.join(map(str, t['rev']))}\n{t['alpha']} 5\n"
            f"{' '.join(map(str, t['pi']))}\n")


def codon_states(seqs, ncod):
    """Codon strings -> sense-codon indices [len(seqs), ncod]."""
    from paml_tpu_torch.models import codon

    lut = np.full(256, 255, dtype=np.int64)
    for k, c in enumerate(b"TCAG"):
        lut[c] = k
    b = lut[np.frombuffer("".join(seqs).encode(), dtype=np.uint8)]
    idx64 = (b.reshape(-1, 3) * np.array([16, 4, 1])).sum(1)
    to61 = -np.ones(64, dtype=np.int64)
    to61[codon.codon_graph(0).sense] = np.arange(61)
    st = to61[idx64].reshape(len(seqs), ncod)
    assert (st >= 0).all()
    return st


def read_evolver_codon(d, ns, nint, ncod, nrepl):
    """mc.paml, ancestral.txt and siterates.txt as written by evolver 6:
    (tips [R, ns, ncod], internal nodes [R, nint, ncod], 0-based site
    classes [R, ncod])."""
    import os

    def seq_lines(path):
        return [ln.split()[1] for ln in open(os.path.join(d, path))
                if len(ln.split()) == 2 and len(ln.split()[1]) == 3 * ncod]

    tips = codon_states(seq_lines("mc.paml"), ncod)
    anc = codon_states(seq_lines("ancestral.txt"), ncod)
    cls = [ln.split() for ln in open(os.path.join(d, "siterates.txt"))]
    cls = np.array([c for c in cls if len(c) == ncod], dtype=np.int64) - 1
    return (tips.reshape(nrepl, ns, ncod), anc.reshape(nrepl, nint, ncod),
            cls)


def chi2_stat(obs, exp):
    """Pearson's statistic of counts `obs` against expectations `exp`,
    rows of cells [..., k] that each sum to the same total: the cells with
    an expectation of 5 or more, and per row the rest pooled into one more
    cell, or into the row's largest cell when the rest expects under 5
    (rows that expect under 5 in all are left out); the degrees of
    freedom (cells less one per row) and the CHI2_Q quantile."""
    from scipy.stats import chi2

    k = obs.shape[-1]
    obs, exp = obs.reshape(-1, k).astype(float), exp.reshape(-1, k)
    keep = exp >= 5
    o_rest, e_rest = (obs * ~keep).sum(1), (exp * ~keep).sum(1)
    o, e = np.where(keep, obs, 0.0), np.where(keep, exp, 0.0)
    fold = np.nonzero((e_rest < 5) & keep.any(1))[0]
    big = e.argmax(1)[fold]
    o[fold, big] += o_rest[fold]
    e[fold, big] += e_rest[fold]
    own = e_rest >= 5
    o = np.concatenate([o[keep], o_rest[own]])
    e = np.concatenate([e[keep], e_rest[own]])
    rows = int((keep.any(1) | own).sum())
    df = max(len(o) - rows, 1)
    return float(((o - e) ** 2 / e).sum()), df, float(chi2.ppf(CHI2_Q, df))


def run_cli(torch, d, argv, cpu=False):
    """`paml_tpu_torch.__main__.main(argv)` in directory d on the card, or
    with `--device cpu` and CPU_THREADS threads, the counts set to 0 just
    before: (its summary, wall seconds, counts with the program's peak GiB
    on the card)."""
    import os

    from paml_tpu_torch import __main__ as cli

    cwd = os.getcwd()
    os.chdir(d)
    threads = torch.get_num_threads()
    if cpu:
        torch.set_num_threads(CPU_THREADS)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    try:
        t0 = time.perf_counter()
        out = cli.main(argv + (["--device", "cpu"] if cpu else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    # the program's own peak: above what earlier phases still hold
    counts = dict(read_counts(), peak_gib=(torch.cuda.max_memory_allocated()
                                           - held) / 2 ** 30)
    return out, wall, counts


def no_launch(counts, what):
    """Phase 9 reaches no pruning kernel and no pruning pass."""
    n = sum(counts["launches"].values())
    if n or counts["level"] or counts["plain"] or counts["twice"]:
        raise RuntimeError(f"{what}: pruning ran ({counts})")
    return n


def evolver_codon(torch, rng, work, card):
    """9a, codons: evolver 6 twice (the same bytes), the distribution
    checks and the M2a refit.  Returns the directory, the names and the
    launch count."""
    import os

    from paml_tpu_torch.apps import codeml, evolver
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio

    c = EVO_CODON
    names = [f"t{i}" for i in range(c["taxa"])]
    nwk = random_unrooted_tree(rng, names)
    dat = codon_dat(nwk, c["taxa"], c["codons"], c["repl"], c["seed"])
    dirs = [os.path.join(work, f"evolver6_{k}") for k in (1, 2)]
    for d in dirs:
        os.makedirs(d)
        with open(os.path.join(d, "mc.dat"), "w") as f:
            f.write(dat)
    runs = [run_cli(torch, d, ["evolver", "6", "mc.dat"]) for d in dirs]
    launches = sum(no_launch(r[2], "evolver 6") for r in runs)
    for name in ("mc.paml", "siterates.txt", "ancestral.txt"):
        a, b = (open(os.path.join(d, name), "rb").read() for d in dirs)
        if a != b:
            raise RuntimeError(f"evolver 6: {name} differs between two runs "
                               "of one seed")
    out, wall, counts = runs[0]
    rate = (2 * c["taxa"] - 2) * c["codons"] * c["repl"] / out[
        "sample_seconds"]
    print(f"9a evolver 6 [{card}]: {c['taxa']} taxa x {c['codons']} codons "
          f"x {c['repl']} replicates, 3 site classes: wall {wall:.2f} s "
          f"(second run {runs[1][1]:.2f} s), sampling "
          f"{out['sample_seconds']:.3f} s ({rate:.4g} node-codons/s), "
          f"writing {out['write_seconds']:.3f} s, peak "
          f"{counts['peak_gib']:.3f} GiB; mc.paml, siterates.txt and "
          f"ancestral.txt the same bytes twice", flush=True)
    model = evolver.prepare_codon(os.path.join(dirs[0], "mc.dat"),
                                  device="cuda")
    topo = model.topo
    tips, anc, cls = read_evolver_codon(dirs[0], topo.ns, topo.nnode - topo.ns,
                                        c["codons"], c["repl"])
    checks = []
    # tip codons against pi: taxon 0 (one draw per site and replicate)
    obs = np.bincount(tips[:, 0].ravel(), minlength=61)
    checks.append(("tip codons vs pi", *chi2_stat(
        obs, model.pi.cpu().numpy() * obs.sum())))
    p = np.asarray(SITE_TRUTH["p"])
    obs = np.bincount(cls.ravel(), minlength=3)
    checks.append(("site classes vs p", *chi2_stat(obs, p * obs.sum())))
    # parent -> child transitions of ancestral.txt against P(t): the root's
    # first child, a deep internal branch and an internal node's tip child
    P = model.P.cpu().numpy()
    states = np.concatenate([tips, anc], axis=1)        # [R, nnode, ncod]
    kids = [int(k) for k in topo.children[topo.root] if k >= 0]
    internal = [v for v in range(topo.ns, topo.nnode)
                if v != topo.root and topo.parent[v] != topo.root]
    tip_kid = next(v for v in range(topo.ns)
                   if topo.parent[v] != topo.root)
    for node in (next(k for k in kids if k >= topo.ns), internal[-1],
                 tip_kid):
        par = topo.parent[node]
        obs = np.zeros((3, 61, 61))
        np.add.at(obs, (cls.ravel(), states[:, par].ravel(),
                        states[:, node].ravel()), 1)
        exp = obs.sum(-1, keepdims=True) * P[node]
        checks.append((f"branch {par + 1}..{node + 1} transitions vs P(t)",
                       *chi2_stat(obs, exp)))
    for what, stat, df, q in checks:
        print(f"  {what}: chi2 {stat:.2f} on {df} df ({CHI2_Q} quantile "
              f"{q:.2f})")
        if not stat < q:
            raise RuntimeError(f"evolver 6: {what} fails its chi-square "
                               f"bound ({stat:.2f} >= {q:.2f})")
    # refit one replicate with M2a on the card, the branch lengths fixed
    # at the simulated ones
    aln = seqio.read_alignment(os.path.join(dirs[0], "mc.paml"),
                               seqio.CODON_SEQ)
    data = seqio.pack(aln, cleandata=True)
    topo_fit = from_treenode(treeio.parse_newick(nwk), data.names)
    spec = codeml.CodemlSpec(NSsites=2, codonf="Fequal", fix_blength=2)
    t0 = time.perf_counter()
    res = codeml.fit_packed(data, topo_fit, spec, device="cuda")
    wall = time.perf_counter() - t0
    w, f = res.class_omegas.ravel(), res.class_freqs.ravel()
    kappa = float(res.kappa[0])
    got = dict(kappa=kappa, p0=f[0], p2=f[2], w0=w[0], w2=w[2])
    truth = dict(kappa=SITE_TRUTH["kappa"], p0=p[0], p2=p[2],
                 w0=SITE_TRUTH["w"][0], w2=SITE_TRUTH["w"][2])
    print(f"  M2a refit of replicate 1 [{card}]: lnL {res.lnL:.4f}, kappa "
          f"{kappa:.4f}, p {np.round(f, 4)}, omegas {np.round(w, 4)} "
          f"({res.fit.n_eval} evaluations, {wall:.2f} s); bounds "
          f"{M2A_BOUNDS}", flush=True)
    for k, b in M2A_BOUNDS.items():
        if not abs(got[k] - truth[k]) <= b:
            raise RuntimeError(f"M2a refit: {k} {got[k]:.4f} is more than "
                               f"{b} from the truth {truth[k]}")
    return dirs[0], aln, launches


def evolver_nuc(torch, rng, work, card):
    """9a, nucleotides: evolver 5 at phase 7's shape, twice (the same
    bytes); base frequencies of a tip against pi.  Returns the directory,
    the tree and the launch count."""
    import os

    from paml_tpu_torch.io import seqio

    names = [f"t{i}" for i in range(NUC_TAXA)]
    nwk = random_unrooted_tree(rng, names)
    dat = nuc_dat(nwk, NUC_TAXA, NUC_SITES, EVO_NUC["seed"])
    dirs = [os.path.join(work, f"evolver5_{k}") for k in (1, 2)]
    for d in dirs:
        os.makedirs(d)
        with open(os.path.join(d, "mc.dat"), "w") as f:
            f.write(dat)
    runs = [run_cli(torch, d, ["evolver", "5", "mc.dat"]) for d in dirs]
    launches = sum(no_launch(r[2], "evolver 5") for r in runs)
    a, b = (open(os.path.join(d, "mc.paml"), "rb").read() for d in dirs)
    if a != b:
        raise RuntimeError("evolver 5: mc.paml differs between two runs of "
                           "one seed")
    out, wall, counts = runs[0]
    aln = seqio.read_alignment(os.path.join(dirs[0], "mc.paml"),
                               seqio.BASE_SEQ)
    if (aln.ns, aln.ls) != (NUC_TAXA, NUC_SITES):
        raise RuntimeError(f"evolver 5: {aln.ns} x {aln.ls}")
    obs = np.array([aln.rows[0].count(ch) for ch in "TCAG"])
    stat, df, q = chi2_stat(obs, np.asarray(NUC_TRUTH["pi"]) * obs.sum())
    rate = (2 * NUC_TAXA - 2) * NUC_SITES / out["sample_seconds"]
    print(f"9a evolver 5 [{card}]: REV + G5 (alpha {NUC_TRUTH['alpha']}), "
          f"{NUC_TAXA} taxa x {NUC_SITES} sites x 1 replicate: wall "
          f"{wall:.2f} s (second run {runs[1][1]:.2f} s), sampling "
          f"{out['sample_seconds']:.3f} s ({rate:.4g} node-sites/s), "
          f"writing {out['write_seconds']:.3f} s, peak "
          f"{counts['peak_gib']:.3f} GiB; the same bytes twice; taxon 1's "
          f"bases vs pi: chi2 {stat:.2f} on {df} df (quantile {q:.2f})",
          flush=True)
    if not stat < q:
        raise RuntimeError("evolver 5: base frequencies fail their "
                           "chi-square bound")
    with open(os.path.join(dirs[0], "tree.nwk"), "w") as f:
        f.write(nwk + "\n")
    return dirs[0], launches


def same_number(a, b, rtol):
    if a is None or b is None:
        return a is None and b is None
    if not (np.isfinite(a) and np.isfinite(b)):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return abs(a - b) <= rtol * max(abs(b), 1e-12)


def card_and_cpu(torch, work, tag, argv, inputs, files):
    """Run one program on the card and with `--device cpu`, each in its own
    directory under `work` holding the `inputs` ({name: text}); no pruning
    on the card, and the output `files` the same bytes.  Returns the two
    summaries and the card's launch count."""
    import os

    out = {}
    for dev in ("card", "cpu"):
        d = os.path.join(work, f"{tag}_{dev}")
        os.makedirs(d)
        for name, text in inputs.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        out[dev] = run_cli(torch, d, argv, cpu=dev == "cpu")
    launches = no_launch(out["card"][2], tag)
    for name in files:
        a, b = (open(os.path.join(work, f"{tag}_{dev}", name), "rb").read()
                for dev in ("card", "cpu"))
        if a != b:
            raise RuntimeError(f"{tag}: {name} differs between card and CPU")
    return out["card"][0], out["cpu"][0], launches


def phylip(names, rows):
    return f"{len(names)} {len(rows[0])}\n" + "".join(
        f"{nm}  {r}\n" for nm, r in zip(names, rows))


def yn00_both(torch, work, aln, card):
    """9b: yn00 with weighting = 1 on the card and on the CPU; every
    number in yn, 2YN.* and 2NG.* (the files the same bytes) and every
    field of each pair to 1e-9 relative."""
    from paml_tpu_torch.apps import yn00

    # the code tables are built once per process: outside both timings
    t0 = time.perf_counter()
    yn00._tables(0), yn00._path_tables(0)
    tables_s = time.perf_counter() - t0
    rows = [r[:3 * YN_CODONS] for r in aln.rows[:YN_TAXA]]
    ctl = ("seqfile = seq.phy\noutfile = yn\nweighting = 1\n"
           "commonf3x4 = 0\nicode = 0\n")
    ot, oc, launches = card_and_cpu(
        torch, work, "yn00", ["yn00", "yn00.ctl"],
        {"seq.phy": phylip(aln.names[:YN_TAXA], rows), "yn00.ctl": ctl},
        ("yn", "2YN.dS", "2YN.dN", "2YN.t", "2NG.dS", "2NG.dN", "2NG.t"))
    pt, pc = ot["pairs"], oc["pairs"]
    npair = len(pt)
    worst = 0.0
    for a, b in zip(pt, pc):
        for fld in ("ng_S", "ng_N", "ng_dS", "ng_dN", "ng_t", "S", "N", "t",
                    "kappa", "omega", "dN", "dS", "SEdN", "SEdS"):
            u, v = getattr(a, fld), getattr(b, fld)
            if not same_number(u, v, 1e-9):
                raise RuntimeError(f"yn00 pair ({a.i + 1}, {a.j + 1}) {fld}: "
                                   f"card {u!r}, CPU {v!r}")
            if u is not None and np.isfinite(u) and np.isfinite(v):
                worst = max(worst, abs(u - v) / max(abs(v), 1e-12))
        for fam, vals in b.lwl.items():
            for k, v in vals.items():
                if not same_number(a.lwl[fam][k], v, 1e-9):
                    raise RuntimeError(f"yn00 {fam} {k}: card / CPU differ")
    st, sc = ot["seconds"], oc["seconds"]
    print(f"9b yn00, weighting = 1, {YN_TAXA} taxa x {YN_CODONS} codons "
          f"({npair} pairs): card [{card}] {st:.2f} s ({1e3 * st / npair:.2f}"
          f" ms per pair), host CPU {sc:.2f} s ({1e3 * sc / npair:.2f} ms "
          f"per pair; the code tables {tables_s:.2f} s once before); yn, "
          f"2YN.*, 2NG.* the same bytes, fields to {worst:.2e} (bound "
          f"1e-9)", flush=True)
    return dict(pairs=npair, card_s=st, cpu_s=sc), launches


PW_CTL = """      seqfile = seq.phy
      outfile = mlc
      runmode = {runmode}
      seqtype = 1
    CodonFreq = 2
        model = 0
      NSsites = 0
        icode = 0
    fix_kappa = 0
        kappa = 2
    fix_omega = 0
        omega = .4
    cleandata = 1
"""


def pairwise_both(torch, work, aln, runmode, ntaxa, card):
    """9c: codeml runmode -2 or -3 on the card and on the CPU; lnL to 1e-9
    relative, the estimates to 1e-5 (ML) and the posterior summaries to
    1e-6 (Bayesian); 2ML.* the same bytes."""
    rows = [r[:3 * PW_CODONS] for r in aln.rows[:ntaxa]]
    ot, oc, launches = card_and_cpu(
        torch, work, f"codeml runmode {runmode}", ["codeml", "codeml.ctl"],
        {"seq.phy": phylip(aln.names[:ntaxa], rows),
         "codeml.ctl": PW_CTL.format(runmode=runmode)},
        ("2ML.t", "2ML.dS", "2ML.dN"))
    pt, pc = ot["pairs"], oc["pairs"]
    if runmode == -2:
        fields = dict(t=1e-5, kappa=1e-5, omega=1e-5, dN=1e-5, dS=1e-5)
    else:
        fields = dict(E_t=1e-6, E_w=1e-6, p_w_gt1=1e-6, SE_t=1e-6,
                      SE_w=1e-6, kappa=1e-5)
    worst_lnl = 0.0
    worst = {k: 0.0 for k in fields}
    for a, b in zip(pt, pc):
        d = abs(a.lnL - b.lnL) / abs(b.lnL)
        worst_lnl = max(worst_lnl, d)
        if d > 1e-9:
            raise RuntimeError(f"runmode {runmode} pair ({a.i + 1}, "
                               f"{a.j + 1}): lnL card {a.lnL!r}, CPU "
                               f"{b.lnL!r}")
        for k, tol in fields.items():
            u, v = getattr(a, k), getattr(b, k)
            e = abs(u - v) / max(abs(v), 1.0)
            worst[k] = max(worst[k], e)
            if e > tol:
                raise RuntimeError(f"runmode {runmode} pair ({a.i + 1}, "
                                   f"{a.j + 1}) {k}: card {u!r}, CPU {v!r}")
    npair = len(pt)
    st, sc = ot["seconds"], oc["seconds"]
    extra = ""
    if runmode == -3:
        extra = (f"; P(w > 1) {np.round([p.p_w_gt1 for p in pt], 3)}")
    print(f"9c codeml runmode {runmode}, {ntaxa} taxa x {PW_CODONS} codons "
          f"({npair} pairs): card [{card}] {st:.2f} s ({st / npair:.3f} s "
          f"per pair), host CPU {sc:.2f} s ({sc / npair:.3f} s per pair); "
          f"lnL to {worst_lnl:.2e}, "
          + ", ".join(f"{k} to {v:.2e}" for k, v in worst.items())
          + extra, flush=True)
    return dict(pairs=npair, card_s=st, cpu_s=sc), launches


def pamp_both(torch, work, d_nuc, card):
    """9d: pamp on evolver 5's alignment with its tree, card and CPU (mp
    names the seqfile's path, so the estimates are compared instead)."""
    import os

    inputs = {name: open(os.path.join(d_nuc, name)).read()
              for name in ("mc.paml", "tree.nwk")}
    inputs["pamp.ctl"] = ("seqfile = mc.paml\ntreefile = tree.nwk\n"
                          "outfile = mp\nncatG = 8\n")
    ot, oc, launches = card_and_cpu(torch, work, "pamp",
                                    ["pamp", "pamp.ctl"], inputs, ())
    a, b = ot["result"], oc["result"]
    for k in ("mean", "var", "alpha_mm", "alpha_sullivan", "alpha_yk96"):
        if getattr(a, k) != getattr(b, k):
            raise RuntimeError(f"pamp {k}: card {getattr(a, k)!r}, CPU "
                               f"{getattr(b, k)!r}")
    ndiff = int((a.pattern_matrix != b.pattern_matrix).sum())
    if ndiff:
        raise RuntimeError(f"pamp: {ndiff} cells of the pattern matrix "
                           f"differ between card and CPU")
    print(f"9d pamp, {NUC_TAXA} taxa x {NUC_SITES} sites: alpha MM "
          f"{a.alpha_mm:.5f}, Sullivan {a.alpha_sullivan:.5f}, YK96 "
          f"{a.alpha_yk96:.5f} (simulated {NUC_TRUTH['alpha']}); card "
          f"[{card}] {ot['seconds']:.2f} s, host CPU {oc['seconds']:.2f} s; "
          f"estimates and pattern matrix equal", flush=True)
    return launches


def chi2_program():
    import contextlib
    import io

    from paml_tpu_torch import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["chi2", "1", "3.84"])
    text = buf.getvalue().strip()
    p = float(text.split("prob = ")[1].split()[0])
    if not abs(p - 0.05004352) < 1e-6:
        raise RuntimeError(f"chi2 1 3.84: {text}")
    print(f"9d chi2 1 3.84: {text}", flush=True)


def phase_pairwise(torch, rng, report, card):
    """Phase 9: evolver 6 and 5 (9a), yn00 (9b), codeml runmode -2 / -3
    (9c), pamp and chi2 (9d), each program through
    `paml_tpu_torch.__main__.main` on the card, and 9b-9d once more with
    `--device cpu`; no pruning kernel on this path."""
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pairwise_")
    print(f"phase 9: the host CPU's runs take {CPU_THREADS} thread(s) "
          f"(PyTorch's default here: {torch.get_num_threads()})", flush=True)
    d_codon, aln, n6 = evolver_codon(torch, rng, work, card)
    d_nuc, n5 = evolver_nuc(torch, rng, work, card)
    yn, nyn = yn00_both(torch, work, aln, card)
    ml, nml = pairwise_both(torch, work, aln, -2, PW_ML_TAXA, card)
    by, nby = pairwise_both(torch, work, aln, -3, PW_BAYES_TAXA, card)
    npamp = pamp_both(torch, work, d_nuc, card)
    chi2_program()
    launches = n6 + n5 + nyn + nml + nby + npamp
    for r in report.values():
        r["launches_phase9"] = launches
    print(f"phase 9: {launches} pruning launches; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(yn00=yn, ml=ml, bayes=by)


# ---------------------------------------------------------------------------
# phase 10: mcmctree and its kin
# ---------------------------------------------------------------------------

# 10a: 30 species, 4 loci x 2000 sites, HKY85 + G5 (alpha 0.5)
DATE_TAXA, DATE_LOCI, DATE_SITES = 30, 4, 2000
DATE_TRUTH = dict(kappa=4.0, alpha=0.5, pi=(0.25, 0.25, 0.25, 0.25))
# the chains (burnin, sampfreq, nsample): 10a's host CPU runs take 80 ms
# per lnL_all, so its chains are 3 iterations and 10b's 6; PERF.md §4
CHAIN_EXACT = dict(burnin=1, sampfreq=1, nsample=2)
CHAIN_APPROX = dict(burnin=2, sampfreq=1, nsample=4)
# 10b: in.BV at 60 species x 8 loci x 5000 sites
BV_TAXA, BV_LOCI, BV_SITES = 60, 8, 5000
# 10d: clock 5 / 6 on 3 loci x 30 species x 3000 sites (locus 3 lacks a
# taxon); codons: 2 loci x 20 species x 1000 codons
C56_TAXA, C56_LOCI, C56_SITES = 30, 3, 3000
C56_CODON_TAXA, C56_CODON_LOCI, C56_CODONS = 20, 2, 1000
# infinitesites: (burnin, nsample) at sampfreq 2 for clock 1 and clock 2
IS_CHAIN = {1: (200, 500), 2: (20, 50)}

MCMC_CTL = """         seed = 7
      seqfile = seq.txt
     treefile = tree.nwk
     mcmcfile = mcmc.txt
      outfile = out.txt
        ndata = {ndata}
      usedata = {usedata}
        clock = {clock}
        model = 4
        alpha = 0.5
        ncatG = 5
    cleandata = 0
      BDparas = 1 1 0.1
  kappa_gamma = 6 2
  alpha_gamma = 1 1
  rgene_gamma = 2 4 1
 sigma2_gamma = 1 10 1
        print = 1
       burnin = {burnin}
     sampfreq = {sampfreq}
      nsample = {nsample}
"""


def dated_tree(rng, names, root_age=1.0):
    """A random rooted binary tree with node ages: random pairs of lineages
    join at ages drawn uniformly below root_age, the last pair at root_age.
    Returns (internal nodes as (Newick without lengths, age, tip set) in
    the order they were joined, the root last)."""
    nodes = [(nm, 0.0, frozenset([nm])) for nm in names]
    ages = sorted(rng.uniform(0.05, 0.95, size=len(names) - 2) * root_age)
    ages.append(root_age)
    joined = []
    for t in ages:
        i, j = sorted(rng.choice(len(nodes), size=2, replace=False))
        a, b = nodes[i], nodes[j]
        # a parent is older than its children
        t = max(t, a[1] * 1.01 + 1e-3, b[1] * 1.01 + 1e-3)
        new = (f"({a[0]}, {b[0]})", t, a[2] | b[2])
        nodes = [v for k, v in enumerate(nodes) if k not in (i, j)]
        nodes.append(new)
        joined.append(new)
    return joined


def annotated_newick(names, joined, cals):
    """The species tree of `dated_tree` with the calibrations `cals` ({tip
    set: annotation}) after their nodes."""
    nodes = {frozenset([nm]): nm for nm in names}
    kids = {}
    for nwk, _, tips in joined:
        # the two children are the largest earlier clades that partition it
        subs = sorted((s for s in nodes if s < tips), key=len, reverse=True)
        a = subs[0]
        b = next(s for s in subs if s == tips - a)
        kids[tips] = (a, b)
        nodes[tips] = None

    def build(tips):
        if len(tips) == 1:
            return next(iter(tips))
        a, b = kids[tips]
        s = f"({build(a)}, {build(b)})"
        return s + (f" '{cals[tips]}'" if tips in cals else "")
    return build(joined[-1][2]) + ";"


def simulate_dated(torch, rng, names, joined, rates, ls, model="HKY85",
                   truth=DATE_TRUTH, fossil=None):
    """Sequences of each locus simulated on the dated tree under
    HKY85 + G5 with the port's P(t): branch length = duration x the
    locus's rate x a lognormal factor per branch (sd 0.2: a relaxed
    clock).  Returns the rows per locus and the Topology with ages."""
    from paml_tpu_torch.core import simulate
    from paml_tpu_torch.core.dgamma import discrete_gamma
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio
    from paml_tpu_torch.models import nuc

    topo = from_treenode(treeio.parse_newick(
        annotated_newick(names, joined, {})), names)
    desc = topo.tip_descendants()
    age_of = {tips: t for _, t, tips in joined}
    ages = np.array([age_of.get(frozenset(names[k] for k in desc[v]), 0.0)
                     for v in range(topo.nnode)])
    f64 = dict(dtype=torch.float64, device="cuda")
    r, w = discrete_gamma(torch.tensor(truth["alpha"], **f64), 5)
    pi = torch.tensor(truth["pi"], **f64)
    par = np.where(topo.parent >= 0, topo.parent, topo.root)
    out = []
    for rate, L in zip(rates, ls):
        t = (ages[par] - ages) * rate * np.exp(
            0.2 * rng.standard_normal(topo.nnode))
        t[topo.root] = 0.0
        P, _ = nuc.pmats_for_model(model, torch.tensor([truth["kappa"]],
                                                       **f64), pi,
                                   torch.tensor(t, **f64)[:, None]
                                   * r[None, :])
        st, _ = simulate.simulate_states(topo, P, pi, L, 1, class_probs=w,
                                         seed=int(rng.integers(2 ** 31)),
                                         device="cuda")
        out.append(simulate.states_to_rows(st[0, :topo.ns].cpu().numpy(),
                                           "TCAG"))
    return out, topo, ages


def stacked_phylip(blocks):
    return "\n".join(phylip(nm, rows) for nm, rows in blocks)


def chain_stats(before, after):
    """(lnL_all calls, ms per lnL_all, iterations, ms per iteration) of a
    run between two snapshots of mcmctree's counters."""
    n = after[1]["lnL_all"] - before[1]["lnL_all"]
    it = after[1]["iterations"] - before[1]["iterations"]
    return (n, 1e3 * (after[0]["lnL_all"] - before[0]["lnL_all"]) / max(n, 1),
            it, 1e3 * (after[0]["chain"] - before[0]["chain"]) / max(it, 1))


def snapshot():
    from paml_tpu_torch.apps import mcmctree
    return dict(mcmctree.SECONDS), dict(mcmctree.COUNTS)


def chain_card_cpu(torch, work, tag, inputs, card, cards=2):
    """One mcmctree control file run `cards` times on the card (mcmc.txt
    the same bytes each time) and once with `--device cpu` at
    CPU_THREADS: every sample to 1e-9 relative.  Returns a dict of the
    runs' numbers."""
    import os

    from paml_tpu_torch.apps.mcmcutils import read_mcmc_txt

    runs = {}
    for k, dev in enumerate(["card"] * cards + ["cpu"]):
        d = os.path.join(work, f"{tag}_{dev}{k}")
        os.makedirs(d)
        for name, text in inputs.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        s0 = snapshot()
        _, wall, counts = run_cli(torch, d, ["mcmctree", "mcmctree.ctl"],
                                  cpu=dev == "cpu")
        runs[f"{dev}{k}"] = dict(dir=d, wall=wall, counts=counts,
                                 stats=chain_stats(s0, snapshot()))
        if dev == "card" and (any(counts["launches"].values())
                              or counts["plain"]):
            raise RuntimeError(f"{tag}: a kernel or the plain version ran "
                               f"({counts})")
    card_runs = [v for k, v in runs.items() if k.startswith("card")]
    first = open(os.path.join(card_runs[0]["dir"], "mcmc.txt"), "rb").read()
    for r in card_runs[1:]:
        if open(os.path.join(r["dir"], "mcmc.txt"), "rb").read() != first:
            raise RuntimeError(f"{tag}: two card runs differ")
    hc, a = read_mcmc_txt(os.path.join(card_runs[0]["dir"], "mcmc.txt"))
    cpu = runs[f"cpu{cards}"]
    hp, b = read_mcmc_txt(os.path.join(cpu["dir"], "mcmc.txt"))
    rel = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-12)).max())
    if hc != hp or a.shape != b.shape or not rel <= 1e-9:
        raise RuntimeError(f"{tag}: card and CPU chains differ (rel {rel})")
    c0 = card_runs[0]
    n, ms, it, ms_it = c0["stats"]
    _, ms_cpu, _, ms_it_cpu = cpu["stats"]
    print(f"  {tag} [{card}]: {it} iterations, {n} lnL_all calls; card "
          f"{ms:.3f} ms per lnL_all, {ms_it:.1f} ms per iteration (wall "
          f"{c0['wall']:.2f} s, peak {c0['counts']['peak_gib']:.3f} GiB, "
          f"level-route calls {c0['counts']['level']}); host CPU "
          f"{ms_cpu:.3f} ms per lnL_all, {ms_it_cpu:.1f} ms per iteration "
          f"(wall {cpu['wall']:.2f} s); {len(card_runs)} card runs the "
          f"same bytes, card vs CPU samples to {rel:.2e}; {a.shape[0]} "
          f"samples x {a.shape[1]} columns", flush=True)
    return dict(lnL_all_ms=ms, iter_ms=ms_it, lnL_all_ms_cpu=ms_cpu,
                iter_ms_cpu=ms_it_cpu, calls=n, iterations=it, rel=rel,
                dirs=[r["dir"] for r in runs.values()])


def profile_lnl_all(torch, mc, reps=20):
    """torch.profiler over `reps` calls of mc.lnL_all(): (wall ms per call,
    device busy ms per call, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    mc.lnL_all()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            mc.lnL_all()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / reps
    if busy <= 0:
        busy = sum(getattr(e, "self_cuda_time_total", 0)
                   for e in prof.key_averages()) / 1e3 / reps
    return wall, busy, 1.0 - busy / wall


def b6_routes(torch, mc, where, reps=20):
    """ROADMAP B6: the exact likelihood of every locus as one batched level
    pass against a loop of one level pass per locus, on mc's device, each
    call ending in its copy to the host (medians of `reps`, in turns)."""
    ex = mc._exact
    b = mc._branch_lengths_all()
    out, ms = {}, {}
    for route in ("batched", "loop", "loop", "batched"):
        ex.lnl(b, mc.kappa, mc.alpha_g, route=route)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            v = ex.lnl(b, mc.kappa, mc.alpha_g, route=route)
            ts.append(time.perf_counter() - t0)
        out[route] = v
        ms.setdefault(route, []).append(1e3 * float(np.median(ts)))
    rel = float(np.abs(out["batched"] - out["loop"]).max()
                / np.abs(out["loop"]).max())
    if rel > 1e-12:
        raise RuntimeError(f"B6: the routes disagree ({rel})")
    print(f"  10a B6 [{where}]: lnL of {mc.g} loci, batched level pass "
          f"{np.round(ms['batched'], 3).tolist()} ms, loop of per-locus "
          f"passes {np.round(ms['loop'], 3).tolist()} ms (medians of "
          f"{reps}, in turns); values to {rel:.1e}", flush=True)
    return {k: min(v) for k, v in ms.items()}


def date_exact(torch, rng, work, card):
    """10a: mcmctree usedata = 1 at clock 2 and 3, card against CPU; the
    profile of one lnL_all and B6's two routes."""
    from paml_tpu_torch.apps import mcmctree
    from paml_tpu_torch.io import seqio, treeio

    names = [f"s{i}" for i in range(DATE_TAXA)]
    joined = dated_tree(rng, names)
    rows, topo, ages = simulate_dated(
        torch, rng, names, joined, rng.uniform(0.3, 0.8, DATE_LOCI),
        [DATE_SITES] * DATE_LOCI)
    # the root and two internal nodes calibrated: a soft-bound interval
    # and a lower bound
    inner = sorted(joined[:-1], key=lambda v: -len(v[2]))
    cals = {joined[-1][2]: "B(0.9, 1.1)",
            inner[1][2]: f"B({inner[1][1] * 0.8:.4f}, "
                         f"{inner[1][1] * 1.2:.4f})",
            inner[3][2]: f">{inner[3][1] * 0.8:.4f}"}
    nwk = annotated_newick(names, joined, cals)
    inputs = {"seq.txt": stacked_phylip([(names, r) for r in rows]),
              "tree.nwk": f"{DATE_TAXA} 1\n\n{nwk}\n"}
    res = {}
    for clock in (2, 3):
        inputs["mcmctree.ctl"] = MCMC_CTL.format(ndata=DATE_LOCI, usedata=1,
                                                 clock=clock, **CHAIN_EXACT)
        res[clock] = chain_card_cpu(torch, work, f"10a usedata 1 clock "
                                    f"{clock}", inputs, card)
    # one lnL_all under the profiler, and B6, on a chain object
    d = res[2]["dirs"][0]
    alns = seqio.read_alignments(f"{d}/seq.txt", seqio.BASE_SEQ, DATE_LOCI)
    st = mcmctree.build_species_tree(
        treeio.read_trees(f"{d}/tree.nwk", names)[0], names)
    spec = mcmctree.McmcSpec(clock=2, usedata=1, alpha=0.5, ncatG=5)
    mc = mcmctree.MCMCTree(st, [seqio.pack(a, cleandata=False)
                                for a in alns], spec, device="cuda")
    wall, busy, idle = profile_lnl_all(torch, mc)
    print(f"  10a one lnL_all [{card}]: {wall:.3f} ms wall, device busy "
          f"{busy:.3f} ms, idle share {idle:.3f} (torch.profiler, 20 "
          f"calls); {sum(a.npatt for a in mc.loci)} patterns over "
          f"{mc.g} loci", flush=True)
    res["profile"] = dict(wall_ms=wall, busy_ms=busy, idle=idle)
    # the fossil-error prior's Monte Carlo constants (host): one per subset
    # of the three calibrations, 1e5 draws each
    st.pfossilerror = (2.0, 20.0, 0)
    f0 = mcmctree.SECONDS["fossil_constant"]
    lnp = mcmctree.ln_prior_times(st, mc.ages, 0.1)
    fsec = mcmctree.SECONDS["fossil_constant"] - f0
    print(f"  10a fossil errors (host): the {2 ** len(st.calibrations)} "
          f"Monte Carlo constants of the time prior in {fsec:.2f} s; lnp "
          f"{lnp:.4f}", flush=True)
    if not np.isfinite(lnp):
        raise RuntimeError("10a: the fossil-error prior is not finite")
    st.pfossilerror = None
    res["fossil_s"] = fsec
    res["b6"] = b6_routes(torch, mc, card)
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        mc_cpu = mcmctree.MCMCTree(st, mc.loci, spec, device="cpu")
        res["b6_cpu"] = b6_routes(torch, mc_cpu, f"host CPU, {CPU_THREADS} "
                                  "thread", reps=5)
    finally:
        torch.set_num_threads(threads)
    return res, inputs


def date_bv(torch, rng, work, card):
    """10b: usedata = 3 (in.BV) on the card, each locus's gradient at its
    MLE; then usedata = 2 from that out.BV at clock 2, card against
    CPU."""
    import os

    from paml_tpu_torch.apps import codeml, mcmctree

    names = [f"s{i}" for i in range(BV_TAXA)]
    joined = dated_tree(rng, names)
    rows, topo, ages = simulate_dated(
        torch, rng, names, joined, rng.uniform(0.3, 0.8, BV_LOCI),
        [BV_SITES] * BV_LOCI)
    inner = sorted(joined[:-1], key=lambda v: -len(v[2]))
    cals = {joined[-1][2]: "B(0.9, 1.1)",
            inner[2][2]: f"B({inner[2][1] * 0.8:.4f}, "
                         f"{inner[2][1] * 1.2:.4f})"}
    nwk = annotated_newick(names, joined, cals)
    d = os.path.join(work, "10b_usedata3")
    os.makedirs(d)
    inputs = {"seq.txt": stacked_phylip([(names, r) for r in rows]),
              "tree.nwk": f"{BV_TAXA} 1\n\n{nwk}\n",
              "mcmctree.ctl": MCMC_CTL.format(ndata=BV_LOCI, usedata=3,
                                              clock=2, **CHAIN_APPROX)}
    for name, text in inputs.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    s0 = snapshot()
    h0 = codeml.SECONDS["hessian"]
    _, wall, counts = run_cli(torch, d, ["mcmctree", "mcmctree.ctl"])
    s1 = snapshot()
    fit_s = s1[0]["bv_fit"] - s0[0]["bv_fit"]
    hess_s = s1[0]["bv_hessian"] - s0[0]["bv_hessian"]
    if any(counts["launches"].values()) or counts["plain"]:
        raise RuntimeError(f"10b usedata 3: a kernel or the plain version "
                           f"ran ({counts})")
    loci = mcmctree.read_BV(os.path.join(d, "out.BV"), BV_LOCI,
                            transform="none")
    # a branch at baseml's lower bound (4e-6, written 0.000004) keeps a
    # gradient that points below it, as the reference's in.BV does
    at_bound = [l.bl <= 1e-5 for l in loci]
    gmax = [float(np.abs(l.gradient[~b]).max()) for l, b in
            zip(loci, at_bound)]
    gbound = max([float(l.gradient[b].max()) for l, b in zip(loci, at_bound)
                  if b.any()] or [-np.inf])
    print(f"  10b usedata 3 [{card}]: {BV_LOCI} loci x {BV_TAXA} species x "
          f"{BV_SITES} sites, HKY85 + G5: wall {wall:.2f} s, per locus fit "
          f"{fit_s / BV_LOCI:.2f} s and gradient + Hessian "
          f"{hess_s / BV_LOCI:.2f} s ({len(loci[0].bl)} branches; "
          f"codeml.hessian {codeml.SECONDS['hessian'] - h0:.2f} s in all); "
          f"peak {counts['peak_gib']:.3f} GiB; level-route calls "
          f"{counts['level']}, Hessian-route calls {counts['twice']}; "
          f"largest gradient component per locus at its MLE, off the lower "
          f"bound {np.round(gmax, 6).tolist()}; branches at the bound "
          f"{[int(b.sum()) for b in at_bound]}, their largest dlnL/db "
          f"{gbound:.4g}", flush=True)
    if max(gmax) >= 1e-2 or gbound >= 1e-2:
        raise RuntimeError("10b: a locus's gradient at its MLE is not "
                           "below 1e-2 (off the bound), or points above "
                           "the bound")
    inputs2 = {"seq.txt": inputs["seq.txt"], "tree.nwk": inputs["tree.nwk"],
               "in.BV": open(os.path.join(d, "out.BV")).read(),
               "mcmctree.ctl": MCMC_CTL.format(
                   ndata=BV_LOCI, usedata="2 in.BV", clock=2,
                   **CHAIN_APPROX)}
    res = chain_card_cpu(torch, work, "10b usedata 2 clock 2", inputs2,
                         card)
    res.update(bv_fit_s=fit_s / BV_LOCI, bv_hess_s=hess_s / BV_LOCI,
               bv_wall=wall, gmax=max(gmax))
    return res, joined, names, ages


def host_program(torch, d, argv, files):
    """A host program through the CLI in d: its files must exist; returns
    (output, seconds)."""
    import contextlib
    import io
    import os

    from paml_tpu_torch import __main__ as cli

    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = cli.main(argv)
        sec = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    for f in files:
        if not os.path.exists(os.path.join(d, f)) \
                or not os.path.getsize(os.path.join(d, f)):
            raise RuntimeError(f"{argv[0]}: {f} missing or empty")
    return out, sec


def host_programs(torch, work, card, exact, bv):
    """10c: infinitesites clock 1 and 2 on fixed distances from 10b's tree,
    ds, mcmctree --combine, bfdriver, multiruns."""
    import os

    from paml_tpu_torch.apps.mcmcutils import read_mcmc_txt

    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio

    res_bv, joined, names, _ = bv
    d = os.path.join(work, "10c")
    os.makedirs(d)
    nwk = annotated_newick(names, joined, {joined[-1][2]: "B(0.9, 1.1)"})
    with open(os.path.join(d, "tree.nwk"), "w") as f:
        f.write(f"{len(names)} 1\n\n{nwk}\n")
    topo = from_treenode(treeio.parse_newick(nwk), names)
    desc = topo.tip_descendants()
    age_of = {tips: t for _, t, tips in joined}
    ages = np.array([age_of.get(frozenset(names[k] for k in desc[v]), 0.0)
                     for v in range(topo.nnode)])
    rates = [0.4, 0.7]
    s = topo.ns
    d1 = [ages[j] * rates[0] for j in range(s, topo.nnode)]
    with open(os.path.join(d, "FixedDsClock1.txt"), "w") as f:
        f.write(f"{s}\n" + " ".join(f"{v:.6f}" for v in d1) + "\n"
                + f"{ages[topo.root] * rates[1]:.6f}\n")
    par = np.where(topo.parent >= 0, topo.parent, topo.root)
    with open(os.path.join(d, "FixedDsClock23.txt"), "w") as f:
        f.write(f"{s}\n")
        for r in rates:
            bl = {i: (ages[par[i]] - ages[i]) * r for i in range(topo.nnode)}
            f.write(_tree_with_lengths(topo, bl) + "\n")
    out = {}
    for clock in (1, 2):
        with open(os.path.join(d, f"is{clock}.ctl"), "w") as f:
            f.write(f"seed = 5\ntreefile = tree.nwk\nndata = 2\n"
                    f"clock = {clock}\nburnin = {IS_CHAIN[clock][0]}\n"
                    f"sampfreq = 2\nnsample = {IS_CHAIN[clock][1]}\n"
                    f"rgene_gamma = 2 4 1\n"
                    f"sigma2_gamma = 1 10 1\nBDparas = 1 1 0.1\n")
        o, sec = host_program(torch, d, ["infinitesites", f"is{clock}.ctl"],
                              ())
        out[f"infinitesites clock {clock}"] = sec
        t0 = (o["t0_mean"] if clock == 1 else
              float(np.mean([r[f"t_n{topo.root + 1}"] for r in o])))
        print(f"  10c infinitesites clock {clock} ({s} species, 2 loci, "
              f"{IS_CHAIN[clock][0] + 2 * IS_CHAIN[clock][1]} iterations): "
              f"{sec:.2f} s on the host; posterior mean "
              f"root age {t0:.4f} (true 1.0, bounds B(0.9, 1.1))",
              flush=True)
        if not 0.8 < t0 < 1.2:
            raise RuntimeError(f"infinitesites clock {clock}: root age "
                               f"{t0}")
    c2 = exact[2]["dirs"]
    mc1, mc2 = (os.path.join(c2[k], "mcmc.txt") for k in (0, 2))
    stats, sec = host_program(torch, d, ["ds", mc1], ())
    out["ds"] = sec
    n, sec2 = host_program(torch, d, ["mcmctree", "--combine",
                                      "combined.txt", mc1, mc2],
                           ("combined.txt",))
    out["combine"] = sec2
    nrow = len(read_mcmc_txt(mc1)[1]) + len(read_mcmc_txt(mc2)[1])
    if n != nrow or len(read_mcmc_txt(os.path.join(d, "combined.txt"))[1]) \
            != nrow:
        raise RuntimeError("mcmctree --combine: wrong row count")
    with open(os.path.join(d, "template.ctl"), "w") as f:
        f.write(open(os.path.join(c2[0], "mcmctree.ctl")).read())
    _, sec3 = host_program(torch, d, ["bfdriver", "template.ctl", "8"],
                           ("bf/runbf.sh", "bf/beta_weights.txt",
                            "bf/b8/mcmctree.ctl"))
    out["bfdriver"] = sec3
    rng = np.random.default_rng(3)
    for k in range(3):
        with open(os.path.join(d, f"rst1_{k}"), "w") as f:
            for i in range(50):
                f.write(f"{i + 1} {rng.uniform(0, 1):.4f} "
                        f"{-1000 - rng.uniform(0, 5):.6f}\n")
    n, sec4 = host_program(torch, d, ["multiruns", "best.txt"]
                           + [f"rst1_{k}" for k in range(3)], ("best.txt",))
    out["multiruns"] = sec4
    if n != 50:
        raise RuntimeError(f"multiruns: {n} data sets")
    print(f"  10c ds on 10a's mcmc.txt ({len(stats)} columns) {sec:.3f} s; "
          f"--combine of two 10a chains ({nrow} rows) {sec2:.3f} s; "
          f"bfdriver (8 betas) {sec3:.3f} s; multiruns (3 x 50 lines) "
          f"{sec4:.3f} s; host only", flush=True)
    return out


def _tree_with_lengths(topo, bl):
    def build(i):
        kids = [c for c in topo.children[i] if c >= 0]
        s = (topo.node_names[i] if not kids
             else "(" + ", ".join(build(c) for c in kids) + ")")
        return s + (f": {bl[i]:.6f}" if i != topo.root else "")
    return build(topo.root) + ";"


C56_CTL = """      seqfile = seq.txt
     treefile = tree.nwk
      outfile = mlb
        noisy = 0
        ndata = {ndata}
        clock = {clock}
        model = 4
    fix_kappa = 0
        kappa = 2
    fix_alpha = 1
        alpha = 0
        ncatG = 1
    cleandata = 0
"""


def fossil_tree(rng, names, joined):
    """The dated tree with its largest non-root clade's age fixed by '@'
    (a point fossil) and no other calibration."""
    inner = sorted(joined[:-1], key=lambda v: -len(v[2]))
    return annotated_newick(names, joined,
                            {inner[0][2]: f"@{inner[0][1]:.4f}"})


def c56_check(torch, res, hd, spec, device, tag, card, plain=False):
    """The fitted lnL against the step-3 objective at the fitted x: on CPU
    tensors (nucleotides), or with the plain pruning version on the card
    (codons); 1e-9 relative."""
    from paml_tpu_torch.apps import clock56
    from paml_tpu_torch.core import pruning

    nb = [len(r) for r in res.rates]
    neg = clock56.make_step3_objective(hd, spec, res.labels, nb,
                                       device=device)[0]
    saved = pruning.class_site_lnf
    if plain:
        pruning.class_site_lnf = pruning.class_site_lnf_plain
    try:
        with torch.no_grad():
            v = -float(neg(torch.as_tensor(res.fit.x, device=device)))
    finally:
        pruning.class_site_lnf = saved
    rel = abs(v - res.lnL) / abs(v)
    if rel > 1e-9:
        raise RuntimeError(f"{tag}: lnL {res.lnL!r} against {v!r}")
    return v, rel


def clock56_phase(torch, rng, work, report, card):
    """10d: baseml clock = 5 and 6 on nucleotides through the CLI (level
    route), then `clock56.fit_clock5` on codons, clean (B3/B4) and with
    3b's gaps and Ns (B1/B2), each lnL against its plain version."""
    import dataclasses
    import os

    from paml_tpu_torch.apps import clock56
    from paml_tpu_torch.constants import codon_string
    from paml_tpu_torch.core import simulate
    from paml_tpu_torch.core.pmat import pmat_rev_multi
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio
    from paml_tpu_torch.models import codon

    names = [f"s{i}" for i in range(C56_TAXA)]
    joined = dated_tree(rng, names)
    rows, topo, ages = simulate_dated(
        torch, rng, names, joined, rng.uniform(0.3, 0.8, C56_LOCI),
        [C56_SITES] * C56_LOCI)
    blocks = [(names, r) for r in rows]
    blocks[-1] = (names[:-1], rows[-1][:-1])       # locus 3 lacks a taxon
    nwk = fossil_tree(rng, names, joined)
    out = {}
    for clock in (5, 6):
        d = os.path.join(work, f"10d_clock{clock}")
        os.makedirs(d)
        for name, text in {"seq.txt": stacked_phylip(blocks),
                           "tree.nwk": f"{C56_TAXA} 1\n\n{nwk}\n",
                           "baseml.ctl": C56_CTL.format(ndata=C56_LOCI,
                                                        clock=clock)}.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        o, wall, counts = run_cli(torch, d, ["baseml", "baseml.ctl"])
        check_baseml_routes(f"clock {clock}", counts)
        res = o["result"]
        spec = clock56.Clock56Spec(model="HKY85", clock=clock, kappa=[2.0],
                                   alpha=[0.0], ncatG=1)
        hd = clock56.read_tree_seqs(os.path.join(d, "tree.nwk"),
                                    os.path.join(d, "seq.txt"), C56_LOCI)
        v, rel = c56_check(torch, res, hd, spec, "cpu", f"clock {clock}",
                           card)
        mlb = open(os.path.join(d, "mlb")).read()
        if f"lnL = {res.lnL:.6f}" not in mlb:
            raise RuntimeError(f"clock {clock}: mlb lacks the lnL")
        print(f"  10d baseml clock = {clock} [{card}]: {C56_LOCI} loci x "
              f"{C56_TAXA} species x {C56_SITES} sites (locus 3 without "
              f"{names[-1]}), HKY85: lnL {res.lnL:.6f}, {res.np} "
              f"parameters, {o['seconds']:.2f} s ({res.fit.n_eval} "
              f"evaluations in the last fit, "
              f"{res.fit.message}); level-route calls {counts['level']}, "
              f"Hessian-route calls {counts['twice']}, peak "
              f"{counts['peak_gib']:.3f} GiB; CPU objective at the fitted "
              f"x {v:.6f} (rel {rel:.1e}); root age "
              f"{res.ages[res.sp_topo.root]:.4f} (simulated 1.0)",
              flush=True)
        out[f"clock{clock}"] = dict(seconds=o["seconds"],
                                    evals=res.fit.n_eval, lnL=res.lnL)
    # codons: M0 (kappa 2, omega 0.3) on a dated tree, F3x4 frequencies
    cnames = [f"c{i}" for i in range(C56_CODON_TAXA)]
    cjoined = dated_tree(rng, cnames)
    ctopo_rows, ctopo, cages = [], None, None
    graph = codon.codon_graph(0)
    f3x4 = rng.dirichlet(np.full(4, 8.0), size=3)
    pi_np = codon.codon_pi("F3x4", None, f3x4, f3x4.mean(0), graph)
    f64 = dict(dtype=torch.float64, device="cuda")
    T = codon.dense_tables(0, "cuda")
    pi = torch.tensor(pi_np, **f64)
    s = codon.mutation_dense(T, torch.tensor([2.0], **f64))
    Q = codon.build_Q_dense(T, s, torch.tensor([0.3], **f64), pi)
    rs, ra = codon.flux_dense(T, s, pi)
    ctopo = from_treenode(treeio.parse_newick(
        annotated_newick(cnames, cjoined, {})), cnames)
    desc = ctopo.tip_descendants()
    age_of = {tips: t for _, t, tips in cjoined}
    cages = np.array([age_of.get(frozenset(cnames[k] for k in desc[v]), 0.0)
                      for v in range(ctopo.nnode)])
    par = np.where(ctopo.parent >= 0, ctopo.parent, ctopo.root)
    sense = [codon_string(int(c)) for c in graph.sense]
    for rate in rng.uniform(0.4, 0.8, C56_CODON_LOCI):
        t = torch.tensor((cages[par] - cages) * rate, **f64)
        P = pmat_rev_multi(Q, pi, (t / (rs + ra * 0.3))[:, None])[:, :1]
        st, _ = simulate.simulate_states(ctopo, P, pi, C56_CODONS, 1,
                                         seed=int(rng.integers(2 ** 31)),
                                         device="cuda")
        ctopo_rows.append(simulate.states_to_rows(
            st[0, :ctopo.ns].cpu().numpy(), sense))
    cnwk = fossil_tree(rng, cnames, cjoined)
    spec = clock56.Clock56Spec(clock=5, seqtype=seqio.CODON_SEQ,
                               codonf="F3x4", ncatG=1)
    for tag, rowsets in (("clean", ctopo_rows),
                         ("gapped", [gapped_rows(rng, r)
                                     for r in ctopo_rows])):
        d = os.path.join(work, f"10d_codon_{tag}")
        os.makedirs(d)
        with open(os.path.join(d, "seq.txt"), "w") as f:
            f.write(stacked_phylip([(cnames, r) for r in rowsets]))
        with open(os.path.join(d, "tree.nwk"), "w") as f:
            f.write(f"{C56_CODON_TAXA} 1\n\n{cnwk}\n")
        hd = clock56.read_tree_seqs(os.path.join(d, "tree.nwk"),
                                    os.path.join(d, "seq.txt"),
                                    C56_CODON_LOCI, seqtype=seqio.CODON_SEQ)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = clock56.fit_clock5(hd, spec, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = ("big_fwd", "big_bwd") if tag == "clean" else \
            ("pruning_fwd", "pruning_bwd")
        if counts["plain"] or not all(counts["launches"][k] for k in want):
            raise RuntimeError(f"codon clock 5 {tag}: launches "
                               f"{counts['launches']}, plain calls "
                               f"{counts['plain']}")
        for name, count in counts["launches"].items():
            report[name][f"launches_clock5_codon_{tag}"] = count
        v, rel = c56_check(torch, res, hd, dataclasses.replace(spec), "cuda",
                           f"codon clock 5 {tag}", card, plain=True)
        print(f"  10d codon clock 5, {tag} [{card}]: {C56_CODON_LOCI} loci "
              f"x {C56_CODON_TAXA} species x {C56_CODONS} codons (F3x4): lnL "
              f"{res.lnL:.6f}, {res.np} parameters, {sec:.2f} s in "
              f"{res.fit.n_eval} evaluations "
              f"({1e3 * sec / res.fit.n_eval:.2f} ms each); launches "
              f"{counts['launches']}, plain calls {counts['plain']}; peak "
              f"{peak:.3f} GiB; plain version at the fitted x {v:.6f} (rel "
              f"{rel:.1e}); kappa {np.round(res.kappa.ravel(), 3).tolist()} "
              f"(simulated 2), omega "
              f"{np.round(res.omega, 3).tolist()} (0.3)", flush=True)
        out[f"codon_{tag}"] = dict(seconds=sec, evals=res.fit.n_eval)
    return out


def phase_dating(torch, rng, report, card):
    """Phase 10: mcmctree usedata 1 (10a), in.BV and usedata 2 (10b), the
    host programs (10c), clock 5 / 6 (10d)."""
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dating_")
    t = {}
    t0 = time.perf_counter()
    exact, _ = date_exact(torch, rng, work, card)
    t["10a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bv = date_bv(torch, rng, work, card)
    t["10b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_programs(torch, work, card, exact, bv)
    t["10c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    clock56_phase(torch, rng, work, report, card)
    t["10d"] = time.perf_counter() - t0
    print(f"phase 10: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)

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
    torch.cuda.empty_cache()
    # 6. the program: codeml from a control file (B3/B4 clean, B1/B2 gapped)
    phase_program(torch, rng, report, smi[0])
    torch.cuda.empty_cache()
    # 7. baseml and basemlg: nucleotides on the level route, B5's evidence
    phase_baseml(torch, rng, report, smi[0])
    torch.cuda.empty_cache()
    # 8. amino acids, aaDist and Mgene: 20 states on B1-B4, B5 for them
    phase_aa(torch, rng, report, smi[0])
    torch.cuda.empty_cache()
    # 9. evolver, yn00, codeml's pairwise runmodes, pamp, chi2: no kernel
    phase_pairwise(torch, rng, report, smi[0])
    torch.cuda.empty_cache()
    # 10. mcmctree, in.BV, the MCMC utilities, clock 5 / 6 (B1-B4 on codons)
    phase_dating(torch, rng, report, smi[0])
    kernels = []
    for r in report.values():
        # the main paths' launches, each path counted from 0 (M0/M2a fits
        # on clean and gapped data, the branch-site fits, the program on
        # clean and gapped data; phase 9's programs, which launch none;
        # phase 10's codon clock 5 fits)
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
