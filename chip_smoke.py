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
   At 20 states (the uneven tree) the pair runs its N = 32 instance, and
   that against its N = 64 instance (the wrappers' `npad`) on the same
   inputs: bit for bit where the adjoints' grids agree, each instance
   timed beside the bounds at n = 20 and N = 32 (`check_instances`).
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
   bound; at 20 states B3/B4 and B1/B2 at N = 32 against N = 64 as in 3.
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
   ones, with no plain call during a fit, and the Hessians behind the SEs
   must launch H1 / H2 and call the plain level pass on CUDA no time
   (`pruning.TWICE_CALLS` 0); each lnL in `mlc` must match the plain
   version's at the fitted x; both likelihood-ratio tests (M1a-M2a, M7-M8)
   must be significant; every fit replays its evaluations from a CUDA
   graph, E2 carrying M7 / M8's quantiles (no host second in the quantile
   code); the SEs of the free parameters finite and positive; M8's BEB sites with P > 0.95 in the majority sites simulated
   under omega 3; BEB's forward (20 classes, no residual) must match the
   plain version, and is timed beside its bound.  One value + gradient
   each, kernel route against plain route, for FMutSel0, FMutSel with
   estFreq, clock 1, M5 and M8 (no host second in the quantile code), and
   the incomplete beta's gradient through E2, the host route and a tensor
   loop.  Per model: evaluations, wall seconds, ms per evaluation, and the
   seconds in the Hessian and BEB.
7. baseml: the first 25,000 sites of a 100-taxon x 100,000-site alignment
   simulated under REV + G5 (alpha 0.5, pi TCAG 0.2 / 0.3 / 0.3 / 0.2,
   fixed exchangeabilities) on a random unbalanced unrooted tree with the
   port's own P(t), with 3b's gap runs over about 5 % of the cells and Ns
   in 0.2 %, are written with
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
   through the level route and through B1/B2 at N = 32 (the wrappers
   called directly, in chunks), held to each other to the f64 tolerance,
   timed with their peak memory, and the level route repeated bit for bit.
   7c: HKY85 + AdG (K = 5, rho free), one value + gradient over the
   25,000 sites on the card against CPU tensors, timed.  7d: basemlg on 8
   taxa x 2000 sites from the same simulator, and an Mgene = 4 TN93 + G4
   fit with two genes (option G), each lnL against the CPU objective.
8. The rest of codeml (amino acids, aaDist, Mgene).  8a: 50,000 amino
   acids simulated under LG + G4 (alpha 0.5, LG's frequencies) on a
   100-taxon random unrooted tree with 7a's gap runs and X in 0.2 % of
   the cells; `main(["codeml", ctl])` fits LG + F + G4 (`seqtype = 2`,
   `model = 3`, `fix_alpha = 0`) twice from the simulated branch lengths
   (bit for bit, alpha within 10 % of 0.5), then once from the topology
   alone (shown: the JAX package's start stops at a local optimum).  B1/B2
   carry the gapped fits, their N = 32 instances alone (no launch of an
   N = 64 instance); each lnL in `mlc` against the plain version on the
   card (1e-9); the program's seconds beside N = 64's.  8b (B5 for 20
   states): at the MLEs, on the gapped alignment (B1/B2) and its clean
   copy (B3/B4), one value + gradient through the level route and through
   the kernels at N = 32 and at N = 64, held to each other (the instances
   bit for bit where their grids agree), timed (medians of 5) with their
   peak memory; then each of B1-B4 alone at that shape against its plain
   version in float64 and float32 and against its N = 64 instance, timed
   at N = 32 (both dtypes) and N = 64 beside its bounds at n = 20, N = 32
   and N = 64.  8c: phase 6's simulator at 32 x 4096
   codons, one program run each for `seqtype = 3` with JTT, FromCodon0,
   aaDist = 7 (OmegaAA.dat written here, two classes), aaDist = 1 and
   Mgene = 4 over two genes, each lnL against the plain version, and each
   program's launches of the instance its state count takes alone.
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
   fixed at the simulated ones) within stated bounds of the truth; then
   `evolver 5` at phase 7's 100 taxa x 25,000 sites under REV + G5
   (alpha 0.5), twice (the same bytes), a tip's bases against pi;
   sampling and writing seconds and peak GiB of each.  9b:
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
11. Tree search (each program through `paml_tpu_torch.__main__.main`, the
   objectives' host set-up timed with `utils.timing`).  11a: baseml
   runmode 3 (stepwise addition, 63 fits) on 10 taxa x 20,000 sites
   simulated under HKY85 + G5 (kappa 5, alpha 0.5) on a random unrooted
   tree, fitted with HKY85 + G5 at alpha 0.5, on the level route alone;
   11d: runmode 2 (star decomposition, 81 fits) on 8 taxa x 5000 sites,
   HKY85; 11b: codeml runmode 3 (35 fits) on 8 taxa x 2000 codons
   simulated under M0 with 3b's gaps and Ns, B1/B2 alone; 11c: runmode 4
   (NNI from the parsimony stepwise tree) on their clean copy, B3/B4
   alone.  Each search must find the simulated tree (partition distance
   0), its best lnL match the objective at the best fit's x on CPU tensors
   (nucleotides) or with the plain version on the card (codons) to 1e-9;
   fits, seconds per fit and the host set-up's share are printed, and the
   codon searches' launches join the kernels line.  11e: one value +
   gradient of M2a on the 32-taxon x 4096-codon star tree (resolved under
   identity-P nodes for the kernels) through B3/B4 (clean) and B1/B2 (3b's
   gaps and Ns), each against the plain version on the star itself.  11f:
   evolver 1-4, 8 and 9 and pamp's `pattern_ls` on 11a's alignment, with
   no pruning launch.
12. The pattern axis (`pruning.set_pattern_mesh`).  12a: a mesh of two
   shards on cuda:0: one value + gradient of M2a at the bench shape on
   clean codons (B3/B4) and with 3b's gaps and Ns (B1/B2), and of model A
   on phase 5's 1024-taxon alignment unchunked, each equal to unsharded
   (1e-12 relative on the value, 1e-10 of the largest gradient
   component), each kernel of the pair launched once per shard, timed
   beside unsharded; an M0 fit at the bench shape on the mesh twice (bit
   for bit; lnL within 1e-9 of unsharded; its launches join the kernels
   line).  12b: `python -m torch.distributed.run --nproc_per_node 2 -m
   paml_tpu_torch codeml` (M0 on the bench alignment) on the one card,
   two gloo ranks: one mlc and one rank's output, with the one-process
   lnL to 1e-9.  12c: a NCCL group of `torch.cuda.device_count()` ranks
   (one process each): value + gradient of B3/B4 at the bench shape on
   the group's mesh against unsharded.  12d: `entry.entry()` and
   `entry.dryrun_multichip(2, ["cuda:0", "cuda:0"])`.
13. The float32 path.  13a: float32 P(t) (uniformization) of M2a's three
   rate matrices at phase 4's F3x4 frequencies over the bench's 63
   branches, three of them long enough for one to six squarings and the
   root's at 0, against the same function on CPU tensors (2e-6) and the
   float64 spectral P on the card (1e-5); P and its VJP with TF32
   allowed bit-equal to TF32 off, the flag left on; both dtypes timed,
   forward and forward + backward, and the six masked squarings alone.
   13b: one value + gradient of M0 and M2a on phase 4's alignment, clean
   (B3/B4) and gapped (B1/B2), float32 against the plain float32 version
   on the card (2e-6 relative on the value, 3e-5 of the largest gradient
   component) and against float64 (5e-6 relative); ms per evaluation of
   both dtypes, the launches counted over the float32 runs alone.  13c:
   `fit_packed(dtype=torch.float32)` under M0 on both routes, within 0.1
   lnL of phase 4's float64 fits, carried by the float32 instances of
   its pair alone.  13d: `maximize_device_bounded` on the clean M0
   objective in float64 (within 2e-4 of phase 4's scipy fit) and float32
   (0.1): iterations (line searches), trials, evaluations, wall; then
   each again under `torch.cuda.set_sync_debug_mode("warn")`, its
   synchronizing operations by source line, the optimizer's own between
   its checks required 0 (the objective's own per evaluation: none; the
   eigensolver's status word is read with the stop flag); these fits
   dispatch their passes op by op.  13e: one float32 value + gradient
   of phase 5's 1024-taxon model A alignment in 10 chunks against float64
   (5e-6 relative), timed, with peak memory.  The float32 runs' launches join the kernels line
   (`launches_f32_*`), with the float64 device fit's.
14. The port's bench: `python -m paml_tpu_torch.bench` as a subprocess.
   The bench stops with an error unless one float32 value + gradient of
   its primary problem (M3 on `entry._synthetic_codon_problem(32, 4096,
   seed=1)`) runs under `torch.cuda.set_sync_debug_mode("error")`, B3/B4
   alone carry every part of it (30 launches each at the capture of its
   30-step CUDA graph), and the graph's step 0 is the eager step bit for
   bit; so exit 0 is required.  Then its last line (bench.py's): f32_rel
   within 2e-6, mfu_vs_fp32_peak in (0, 1]; its clock56 M0 device fit:
   the card's value and gradient at the start and at the fitted x against
   the CPU's (2e-6 relative; 3e-5 of the gradient's largest component at
   the start, where the optimum's own is float32 noise) and the lnL within
   0.1 of the float64 optimum; the fit replays its line-search trials
   from one CUDA graph (one capture, the start evaluated op by op).  Its
   numbers are printed; its launches join the kernels line
   (`launches_bench`).
15. CUDA graphs (`core/graphs.py`), the port's counterpart of `jax.jit`.
   15a: the float64 eigensolver (`csrc/eigh.cu`, parallel cyclic Jacobi,
   its status word on the card) on the bench's M2a class matrices, the
   1024-taxon model A's and random reversible matrices of every order the
   kernel's instances split on (1-5, 20, 33, 60-64): against its plain
   version (`cuda_eigh.jacobi_plain`) bit for bit, with the same status
   words and sweeps, and P(t) and its VJP against `torch.linalg.eigh`'s (1e-12 of
   the largest entry); a NaN entry gives status 1 and raises, through
   `eigh` and through a graphed value + gradient; the kernel timed at 3 x
   61, 8 x 61, 4 x 20 and 1 x 4 beside its bound, its plain version and
   `torch.linalg.eigh` (its `library_ms`), and one round at 3 x 61 split
   by the kernel's debug instance (`cuda_eigh.eigh_probe`: A alone with V
   skipped, the rotation chain alone, each warp's clock).  15b: M2a and M3 on
   phase 4's clean (B3/B4) and gapped (B1/B2) alignments, float64 and
   float32: value + gradient from `graphs.GraphedValueGrad` against the
   eager one at three x, bit for bit; ms per evaluation both ways, the
   capture's cost and one replay's kernels (`torch.profiler`).  15c:
   `fit_packed` M0 and M2a, float64, on both routes, graphed against
   eager: the same x bit for bit and the same evaluations; wall, ms and
   host syncs per evaluation (1 graphed).  15d: the bench's clock56
   device fit (float32) with its trials replayed from graphs of
   CHECK_EVERY passes against the same passes dispatched: the same
   iterations and x bit for bit, the syncs at the stop flag equal to
   `optim.CHECKS["reads"]` (`optim.GRAPHS` counts the captures and the
   graphed and eager evaluations).  15e: phase 5's 1024-taxon model A, every
   branch free, 10 checkpointed chunks, float64: graphed against eager
   bit for bit, ms, the capture's peak memory and its pool.  15f: in a
   process of its own, a fit whose objective is declared capturable but
   reads the host: its capture raises, and the fit stops.  Phase 6's
   programs also require every fit to run from its graph
   (`optim.GRAPHS`).  The graphed paths' host launches join the kernels
   line (`launches_graph_*`), with the eigensolver's.
16. E2, the quantile code on the card (`csrc/quantile.cu`,
   `core/cuda_quantile.py`).  16a: each entry (the incomplete beta and
   gamma functions, their inverses, at orders 0, 1 and 2) against its
   plain version on CPU copies of the inputs (the beta inverse's on the
   card) at
   tests/test_torch_quantile.py's grids (p, q to 0.005 and 99, alpha 0.02
   to 49), M8's and M5's ten medians, a discrete gamma's cuts and BEB's
   10 x 10 x 9 grid (1e-12 relative on values, 1e-9 of the largest
   partial, the same status words); the mixture brackets of M6, M9-M13
   at their x0 with 10 quantiles, M9's with 40 and M12's and M13's with
   modes far apart (1e-12, status 0); the kernels'
   digamma and trigamma against torch.special (1e-14); a NaN input
   raising through
   dgamma; E2 timed per launch at M8's, M5's, the cuts' (order 0 beside
   torch.special.gammainc, which gives values alone, and order 1) and
   BEB's shapes and the M9 bracket beside its bound and its plain
   version.  16b: M5, M7, M8 and M10 (ncatG
   10) on phase 4's clean alignment, an amino-acid LG + F + G4 fit and a
   nucleotide REV + G5 fit, alpha free (20 simulated taxa each): each fit
   from its CUDA graph against eagerly, the same x, lnL and evaluations
   bit for bit, one host sync per graphed evaluation, no host second in
   the quantile code; ms per evaluation both ways; the codon fits' lnL
   against the plain versions' at their x (1e-9).  Then M11 at ncatG 10
   and its start point on clock56.codon (ROADMAP C1) through E2 against
   the host route on CPU tensors: value 1e-8, gradient 1e-6; mu's and
   sigma's components, far below that, each route's within 1e-3 of its
   own central differences, and the tenth omega's landing above 1 on
   each.  E2's
   launches in phase 6's programs and 16b's fits join the kernels line.
17. The rest of the compiled fits: each fit from its objective's CUDA
   graph against eagerly (`graphed_against_eager`: the same x, lnL and
   evaluations bit for bit, one host sync per graphed evaluation, its
   syncs by source line printed): 17a codon M0 under clock 1 and clock 2
   (a local clock on a clade of half the tips) on phase 4's 32 x 4096
   alignment, clean (B3/B4) and gapped (B1/B2); 17b FromCodon and REVaa_0
   + G4 on 20 simulated taxa x 2000 amino acids (a cut of phase 8a's
   alignment, for time), on the N = 32 instances alone (their host
   launches, and one replay's kernels counted by name); 17c REV + G5
   under clock 1, UNREST, HKY85 + AdG, nparK 4 and nhomo 1 on 20 x 5000
   simulated sites (a cut of phase 7's, for time).  17d mcmctree's exact
   likelihood on a dated tree of 60 species x 8 loci x 5000 sites:
   `lnL_all` and each `lnL_locus` from their value-only graphs against op
   by op at three proposals, bit for bit, ms per call both ways, one host
   sync per graphed call.  17e the failure paths: an expm past its S_MAX
   and a singular solve, in a graph and op by op, raise
   `DeviceStatusError`; a capture that fails raises (a subprocess).
18. The pairwise programs from one CUDA graph per program and x-length,
   clock 5 / 6 from one per fit (`optim.GRAPHS` counts the captures,
   `eager_evals` 0 on graphed runs; host syncs by source line, one per
   graphed evaluation; value + gradient at the first fit's start from a
   graph against op by op, bit for bit, with the capture's ms and its
   pool).  18a: codeml -2 through `main(["codeml", ctl])` on phase 9a's
   alignment at YN_TAXA x YN_CODONS (435 pairs) graphed; at phase 9's
   PW_ML_TAXA x PW_CODONS graphed, dispatched and on the host CPU at
   CPU_THREADS threads, every pair's fit (x, lnL, evaluations) graphed =
   dispatched bit for bit and the CPU's lnL within 1e-9; the same with
   `fix_kappa` (graphed, dispatched) and aaml -2 (`pairwise.pairwise_aa`,
   translated); s per pair each way.  18b: codeml -3 at PW_BAYES_TAXA x
   PW_CODONS three ways, and the sliding window on one pair of YN_CODONS
   codons, graphed and dispatched.  18c: clock 5 on phase 10d's codon
   loci, clean (B3/B4) and gapped (B1/B2), and nucleotide loci (HKY85;
   HKY85 + G4 with alpha free, E2), each fit graphed against eagerly
   (`graphed_against_eager`) and value + gradient at its start timed;
   clock 6 on the nucleotide loci, its five fits graphed against
   dispatched bit for bit, step 1's Hessians recomputed in each run
   (`codeml.hessian` runs under PyTorch's deterministic algorithms).
19. The Hessian's kernels, H1 and H2 (`csrc/pruning_tangent.cuh`), at
   phase 4's shape (32 taxa x 4096 codons, M2a's 3 classes at its fitted
   x, float64), clean (the B3/B4 walk) and gapped (B1/B2's coded tips):
   each against its plain version on the card on 4 random directions
   (lnfd and Sd 1e-10, dPd and dpid 1e-8), timed at 4 and at 16 directions
   (medians of 5) beside its bound (`cuda_pruning.tan_work`), with each
   grid's blocks, blocks per SM and waves (`cuda_pruning.tan_grid`), the
   plain versions timed too; then M2a's Hessian by the kernels against the
   plain route on the card (1e-8 of its largest entry), and by the kernels
   twice, bit for bit, with no plain level pass, and bit for bit against
   the first Hessian of a fresh process (`FIRST_HESSIAN`).

Prints a kernels JSON line (B1-B4's rows with their launches by instance,
`instance_launches`, and their N = 32 times at aaml's shape; H1 / H2's
rows with phase 6's launches and phase 19's times) and, last,
{"ok": true, "device": {...}}.  Any
failed phase raises, so the script exits non-zero; so it does with no
CUDA device, or without the paml_tpu_torch package beside it.
"""
from __future__ import annotations

import contextlib
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


class Counts(dict):
    """A snapshot of `cuda_pruning.LAUNCHES` (the walk's kernels), with
    `instances`, the same moment's `INSTANCE_LAUNCHES`."""

    def plus(self, **more):
        out = Counts(self, **more)
        out.instances = self.instances
        return out


def launch_counts() -> Counts:
    from paml_tpu_torch.core import cuda_pruning
    out = Counts(cuda_pruning.LAUNCHES)
    out.instances = dict(cuda_pruning.INSTANCE_LAUNCHES)
    return out


def put_launches(report, name, key, count, counts=None, split=None):
    """report[name][key] = count, kernel `name`'s launches on one main path
    (its counts set to 0 just before it).  The walk's kernels also add the
    path's launches by instance to their row's `instance_launches`: from
    `split` ({N: launches}), the snapshot `counts` (`launch_counts`), or
    else `INSTANCE_LAUNCHES` as it stands; where these do not add up to
    count, the launches go to "unsplit"."""
    from paml_tpu_torch.core import cuda_pruning as cp
    report[name][key] = count
    if name not in cp.KERNELS or not count:
        return
    inst = cp.INSTANCE_LAUNCHES if counts is None else counts.instances
    if split is None:
        split = {m: inst[f"{name}_n{m}"] for m in cp.INSTANCES}
    by = report[name].setdefault(
        "instance_launches",
        dict.fromkeys([f"n{m}" for m in cp.INSTANCES] + ["unsplit"], 0))
    if sum(split.values()) == count:
        for m, v in split.items():
            by[f"n{m}"] += v
    else:
        by["unsplit"] += count
        print(f"  {key}: {name}'s {count} launches not split by instance "
              f"({split})", flush=True)


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


def adjoint_grid(torch, topo, C, H, esize, npad):
    """The adjoint's blocks along the tiles (G) at N = npad, as the
    wrappers size them (`cuda_pruning.big_bwd_grid`)."""
    from paml_tpu_torch.core import cuda_pruning as cp
    props = torch.cuda.get_device_properties(0)
    tb = cp.big_tree(topo)
    return cp.big_bwd_grid(tb.nnode, C, cp.big_tiles(H), esize,
                           props.multi_processor_count, props.total_memory,
                           cp.big_plan(tb).work_per_block(npad), npad)


def instances_agree(torch, tag, outs, grids, dn,
                    what=("lnf", "S", "dP", "dpi")):
    """outs {N: tensors named by `what`} of one pair's two instances on the
    same inputs: bit for bit where the adjoints' grids agree (padding adds
    exact zeros, the products take their k-steps in the same order, and
    the root's sum over the states groups its rows as N = 64 does), else
    within 1e-12 relative in float64 (the kernels' tolerances in float32),
    the reason printed.  Returns the verdict as words."""
    a, b = outs[32], outs[64]
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    if grids[32] == grids[64]:
        if not same:
            diff = [float((x.double() - y.double()).abs().max())
                    for x, y in zip(a, b)]
            raise AssertionError(f"{tag}: the N = 32 and N = 64 instances "
                                 f"differ with the same adjoint grid (G "
                                 f"{grids[32]}): max |diff| of "
                                 f"{', '.join(what)} {diff}")
        return f"bit for bit (G {grids[32]} both)"
    tol = dict(val=1e-12, grad=1e-12) if dn == "float64" else TOL[dn]
    for w, x, y in zip(what, a, b):
        max_err(x, y, tol["grad" if w.startswith("d") else "val"],
                f"{tag}: N = 32 against N = 64, {w}")
    return (f"{'bit for bit' if same else 'within ' + str(tol['val'])}: "
            f"the adjoints' grids differ (G {grids[32]} against "
            f"{grids[64]}), so their dP slabs are summed in another order")


def check_instances(torch, names, P, tips, topo, pi, gbar, tag, card):
    """The pair `names` (B1/B2 or B3/B4) on 20-state inputs: the default
    call launches the N = 32 instance; it against the N = 64 instance
    (`npad=64`) on the same inputs (`instances_agree`); each instance
    timed beside the bounds at n and at N = 32."""
    from paml_tpu_torch.core import cuda_pruning as cp

    fused = names[0] == "pruning_fwd"
    fwd, bwd = (cp.pruning_fwd, cp.pruning_bwd) if fused else \
        (cp.pruning_big_fwd, cp.pruning_big_bwd)
    n, C, H = P.shape[-1], P.shape[1], gbar.shape[1]
    before = dict(cp.INSTANCE_LAUNCHES)
    fwd(P, tips, topo, pi, want_S=False)
    got = {k: v - before[k] for k, v in cp.INSTANCE_LAUNCHES.items() if
           v != before[k]}
    if got != {f"{names[0]}_n{cp.padded_states(n)}": 1} or \
            cp.padded_states(n) != 32:
        raise AssertionError(f"{tag}: {n} states launched {got}, not the "
                             "N = 32 instance")
    outs, grids, ms = {}, {}, {}
    for m in cp.INSTANCES:
        lnf, S = fwd(P, tips, topo, pi, npad=m)
        outs[m] = (lnf, S) + bwd(P, tips, topo, pi, gbar, S, npad=m)
        grids[m] = adjoint_grid(torch, topo, C, H, P.element_size(), m)
        ms[m] = (cuda_ms(lambda: fwd(P, tips, topo, pi, npad=m)),
                 cuda_ms(lambda: bwd(P, tips, topo, pi, gbar, S, npad=m)))
    torch.cuda.synchronize()
    dn = str(P.dtype).split(".")[1]
    how = instances_agree(torch, tag, outs, grids, dn)
    n_amb = getattr(cp.kernel_tips(tips), "n_amb", 0)
    b = {m: [bound(k, topo, C, H, m, P.element_size(), n_amb)[0]
             for k in names] for m in (n, 32)}
    print(f"  {'B1/B2' if fused else 'B3/B4'} N = 32 against N = 64 "
          f"[{tag}, {card}]: {how}; ms {ms[32][0]:.3f} + {ms[32][1]:.3f} at "
          f"N = 32, {ms[64][0]:.3f} + {ms[64][1]:.3f} at N = 64; bounds at "
          f"n = {n} {b[n][0]:.5f} + {b[n][1]:.5f}, at N = 32 {b[32][0]:.5f}"
          f" + {b[32][1]:.5f} ms", flush=True)
    del outs


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
                if cfg is UNEVEN20:
                    check_instances(torch, ("pruning_fwd", "pruning_bwd"), P,
                                    tips, topo, pi, gbar, tag, card)
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
            npad = cuda_pruning.padded_states(n)
            G = cuda_pruning.big_bwd_grid(
                tb.nnode, cfg["C"], ntiles, P.element_size(),
                props.multi_processor_count, props.total_memory,
                bp.work_per_block(npad), npad)
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
            if cfg is UNEVEN20:
                check_instances(torch, ("big_fwd", "big_bwd"), P, tips, topo,
                                pi, gbar, tag, card)
                check_instances(torch, ("pruning_fwd", "pruning_bwd"), P,
                                gap, topo, pi, gbar, gtag, card)
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


def simulate_m0_rows(torch, rng, ns, ncod, kappa=2.0, omega=0.3,
                     device="cuda"):
    """Codon rows simulated under M0 on a ladder tree (branch lengths
    uniform on [0.02, 0.3]) with the port's own float64 P(t) on `device`
    (F3x4 frequencies from random nucleotide tables): (names, rows, the
    Topology)."""
    from paml_tpu_torch.constants import codon_string
    from paml_tpu_torch.core.pmat import pmat_rev_multi
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import treeio
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
    T = codon.dense_tables(0, device)
    pi = torch.tensor(pi_np, dtype=torch.float64, device=device)
    s = codon.mutation_dense(T, torch.tensor([kappa], dtype=torch.float64,
                                             device=device))
    Q = codon.build_Q_dense(T, s, torch.tensor([omega], dtype=torch.float64,
                                               device=device), pi)
    rs, ra = codon.flux_dense(T, s, pi)
    t = torch.tensor(topo.blen0, dtype=torch.float64, device=device)
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
    return names, rows, topo


def simulate_m0(torch, rng, ns, ncod, kappa=2.0, omega=0.3):
    """Codon alignment simulated under M0 on a ladder tree
    (`simulate_m0_rows`, on the card): (packed data, topology, the same
    data with the last taxon's second half gaps).  Gaps make that taxon's
    tips multi-hot partials (every sense codon, cleandata = 0), the tips
    B1/B2 serve."""
    from paml_tpu_torch.io import seqio

    names, rows, topo = simulate_m0_rows(torch, rng, ns, ncod, kappa, omega)
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
        launches = launch_counts()
        plain_cuda = pruning.PLAIN_CALLS["cuda"]
        print(f"M0 path, {route}: kernel launches {launches}, plain-version "
              f"calls on CUDA {plain_cuda}", flush=True)
        for name, count in launches.items():
            if (count > 0) != (name in pair):
                raise AssertionError(f"M0 path, {route}: {name} launched "
                                     f"{count} times; only {pair} should "
                                     "carry it")
            if count:
                put_launches(report, name, f"launches_m0_{route}", count,
                             launches)
        if plain_cuda:
            raise AssertionError(f"plain pruning ran {plain_cuda} times on "
                                 f"CUDA inside the M0 path ({route})")
        check_m0_fits(torch, data, topo, specs, fits, route)
        fitted[route] = fits
    print(f"M0 estimates, clean / gapped: kappa {fitted['clean']['M0'].kappa}"
          f" / {fitted['gapped']['M0'].kappa}, omega "
          f"{fitted['clean']['M0'].class_omegas.ravel()} / "
          f"{fitted['gapped']['M0'].class_omegas.ravel()}", flush=True)
    return clean, gapped, topo, fitted


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
    launches = launch_counts()
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
        put_launches(report, name, "launches_branch_site", launches[name],
                     launches)
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
    launches = launch_counts()
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
        put_launches(report, name, "launches_branch_site_gapped",
                     launches[name], launches)
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
    return data, topo, spec, x_true


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
    from paml_tpu_torch.core import cuda_pruning, cuda_quantile, dgamma
    from paml_tpu_torch.core import pruning

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
    reset_e2()
    pruning.PLAIN_CALLS["cuda"] = pruning.TWICE_CALLS["cuda"] = 0
    before = dict(h=codeml.SECONDS["hessian"], b=beb.SECONDS["beb"],
                  q=dgamma.SECONDS["host"])
    checks0 = fit_counts()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        out = cli.main(["codeml", ctl])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = launch_counts()
    e2 = cuda_quantile.LAUNCHES["quantile"]
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
          f"{launches}, E2 {e2}, plain-version calls on CUDA during the fits "
          f"{plain}, Hessian-route calls of the plain level pass {twice}; "
          f"host seconds in the quantile code "
          f"{dgamma.SECONDS['host'] - before['q']}", flush=True)
    for run in out["runs"]:
        res = run["res"]
        print(f"  NSsites {run['NSsites']} [{card}]: lnL {res.lnL:.6f}, "
              f"{res.fit.n_eval} evals, {run['fit_seconds']:.2f} s wall, "
              f"{1e3 * run['fit_seconds'] / res.fit.n_eval:.2f} ms/eval, "
              f"quantile code on the card (E2), Hessian "
              f"{run.get('hessian_seconds', 0.0):.2f} s, BEB "
              f"{run.get('beb_seconds', 0.0):.2f} s; kappa "
              f"{res.kappa}, omegas {np.round(res.class_omegas.ravel(), 4)}, "
              f"freqs {np.round(res.class_freqs, 4)}", flush=True)
    check_graphed_runs(out["runs"], checks0, tag, card)
    if dgamma.SECONDS["host"] != before["q"] or \
            any(r["quantile_seconds"] is not None for r in out["runs"]):
        raise AssertionError(f"program, {tag}: the quantile code ran on "
                             "the host")
    if plain:
        raise AssertionError(f"program, {tag}: the plain pruning version ran "
                             f"{plain} times on CUDA outside the Hessians")
    if twice:
        raise AssertionError(f"program, {tag}: the Hessians called the plain "
                             f"level pass {twice} times on CUDA")
    if not (launches["tan_fwd"] and launches["tan_bwd"]):
        raise AssertionError(f"program, {tag}: getSE = 1 launched no H1 / H2 "
                             f"({launches})")
    return out, launches.plus(quantile=e2), lnls


def check_graphed_runs(runs, checks0, tag, card):
    """The program's fits from their CUDA graphs, every NSsites model's
    objective being capturable (no clock: one capture each, every
    evaluation replayed)."""
    d = {k: v - checks0[k] for k, v in fit_counts().items()}
    n_eval = sum(r["res"].fit.n_eval for r in runs)
    print(f"  {tag}: NSsites {[r['NSsites'] for r in runs]} from their "
          f"graphs ({n_eval} evaluations); counts {d}", flush=True)
    if d["captures"] != len(runs) or d["graphed_evals"] != n_eval or \
            d["eager_evals"]:
        raise AssertionError(f"program, {tag}: every fit must run from its "
                             f"graph: {d}")


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
        if rel > 1e-9 or gerr > 1e-8 or not np.isfinite(g).all() or quant:
            raise AssertionError(f"{tag}: value + gradient disagrees with "
                                 "the plain version on the card")
    # the incomplete beta three ways on the same ten numbers: E2 on the
    # card (dgamma's card route), the host route on CPU tensors (numpy
    # values, dual numbers for the gradient), and the same continued
    # fraction as a loop of tensor operations under autograd on the card
    a, b = (torch.tensor(v, dtype=torch.float64, device="cuda",
                         requires_grad=True) for v in (0.5, 1.2))
    x = (torch.arange(10, dtype=torch.float64, device="cuda") + 0.5) / 10
    ah, bh = (v.detach().cpu().requires_grad_(True) for v in (a, b))
    xh = x.cpu()

    def tensors():
        I = dgamma._betainc_any(a.expand(10), b.expand(10), x)
        return torch.autograd.grad(I.sum(), (a, b))

    def route(a, b, x):
        return torch.autograd.grad(dgamma.betainc(a, b, x).sum(), (a, b))
    ways = (("E2", lambda: route(a, b, x)), ("host", lambda: route(ah, bh, xh)),
            ("tensor_loop", tensors))
    got = {name: [float(v) for v in fn()] for name, fn in ways}
    for name in ("E2", "tensor_loop"):
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
          f"{1e3 * t['E2']:.2f} ms through E2 on the card, "
          f"{1e3 * t['host']:.2f} ms on the host route, "
          f"{1e3 * t['tensor_loop']:.1f} ms as a loop of tensor operations "
          "under autograd on the card", flush=True)


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
            # E2 carries M7 / M8's quantiles, B3/B4 the pruning, H1 / H2
            # the Hessians
            if (count > 0) != (name.startswith(("big", "tan"))
                               or name == "quantile"):
                raise AssertionError(f"program, clean: {name} launched "
                                     f"{count} times; B3/B4, H1/H2 and E2 "
                                     "should carry it")
            if count:
                put_launches(report, name, "launches_program_clean", count,
                             launches)
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
            if (count > 0) != (name.startswith(("pruning", "tan"))
                               or name == "quantile"):
                raise AssertionError(f"program, gapped: {name} launched "
                                     f"{count} times; B1/B2, H1/H2 and E2 "
                                     "should carry it")
            if count:
                put_launches(report, name, "launches_program_gapped", count,
                             launches)
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
            if (count > 0) != name.startswith(("big", "tan")):
                raise AssertionError(f"program, branch-site: {name} launched "
                                     f"{count} times; B3/B4 and H1/H2 should "
                                     "carry it")
            if count:
                put_launches(report, name, "launches_program_branch_site",
                             count, launches)
        check_program(torch, out, lnls, "branch-site")
        check_beb_branch_site(torch, out, gapped, report, card)


# --- phase 7: baseml on the card --------------------------------------------

# REV + G5: the exchangeabilities of (T,C), (T,A), (T,G), (C,A), (C,G), with
# (A,G) = 1; frequencies of T, C, A, G
NUC_TRUTH = dict(alpha=0.5, pi=(0.2, 0.3, 0.3, 0.2),
                 rev=(2.5, 0.4, 0.6, 0.5, 0.7))
# phase 7 simulates NUC_SIM_SITES sites and runs the program on the first
# NUC_SITES, for the script's time limit: the generator's draws, and so
# the later phases' data, are those of the whole simulation
NUC_TAXA, NUC_SITES, NUC_SIM_SITES = 100, 25_000, 100_000


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
    return dict(launches=launch_counts(),
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
    """7a: the program on the 100-taxon x 25,000-site REV + G5 alignment
    with gaps and Ns."""
    import os
    import tempfile

    from paml_tpu_torch.apps import ancestral, baseml

    t0 = time.perf_counter()
    names, rows, nwk, st, topo_sim = simulate_nuc(torch, rng, NUC_TAXA,
                                                  NUC_SIM_SITES, "cuda")
    rows = gapped_nuc_rows(rng, rows)
    rows, st = [r[:NUC_SITES] for r in rows], st[:, :NUC_SITES]
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
                            card, key="b5", instances=(None,)):
    """ROADMAP B5's evidence: one value + gradient in P and pi through the
    level route (`pruning.class_site_lnf_levels`), and through the kernel
    pair that the tips take (B1/B2 for coded tips with a table, B3/B4 for
    state codes; the wrappers called directly, the patterns in chunks so
    that S and the walk's workspace fit) at each of `instances` (None: the
    instance n takes, `padded_states`; 64 forces N = 64), held to the
    level route and the instances to each other (`instances_agree`); ms
    (medians of 5) and peak GiB of each; the level route repeated bit for
    bit.  Records the times and the pair's bounds at the real n and at each
    N under `key` in the pair's report rows, and returns them."""
    from paml_tpu_torch.core import cuda_pruning as cp
    from paml_tpu_torch.core import pruning
    from paml_tpu_torch.core.tipcodes import TipCodes

    H, C, n = fpatt.shape[0], P.shape[1], P.shape[-1]
    npads = [cp.padded_states(n) if m is None else m for m in instances]

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
    per_pattern = (bp.n_srows * C * n + C * bp.nslots * max(npads)) * 8
    n_chunks = max(1, -(-per_pattern * H // (8 << 30)))
    w_chunk = -(-H // n_chunks)

    chunks = (codes.split(w_chunk) if fused else
              [c.contiguous() for c in codes.split(w_chunk, dim=1)])

    def kernels(m):
        total, dP, dpi = 0.0, torch.zeros_like(P), torch.zeros_like(piC)
        for h0, tc in zip(range(0, H, w_chunk), chunks):
            sl = slice(h0, min(h0 + w_chunk, H))
            lnf, S = fwd(P, tc, topo, piC, npad=m)
            z = lnf + torch.log(w)[:, None]
            site = torch.logsumexp(z, 0)
            total = total + (fpatt[sl] * site).sum()
            gbar = fpatt[sl][None, :] * torch.softmax(z, 0)
            a, b = bwd(P, tc, topo, piC, gbar, S, npad=m)
            dP, dpi = dP + a, dpi + b
            del S
        return total, dP, dpi

    out = {}
    for name, fn in [("level", level)] + [
            (f"N{m}", lambda m=m: kernels(m)) for m in npads]:
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms_median(fn, reps=5, warmup=1)
        out[name] = dict(ms=ms, gib=(torch.cuda.max_memory_allocated()
                                     - base) / 2 ** 30, res=fn())
    tol = TOL["float64"]
    v1, dP1, dpi1 = out["level"]["res"]
    errs = {}
    for m in npads:
        v2, dP2, dpi2 = out[f"N{m}"]["res"]
        errs[m] = (abs(float(v1) - float(v2)) / abs(float(v1)),
                   max(float((dP1 - dP2).abs().max() / dP1.abs().max()),
                       float((dpi1 - dpi2).abs().max() / dpi1.abs().max())))
    again = out["level"]["res"], level()
    same = all(torch.equal(a, b) for a, b in zip(*again))
    n_amb = getattr(codes, "n_amb", 0)
    bnd = {m: [bound(k, topo, C, H, m, 8, n_amb) for k in names]
           for m in [n] + npads}
    pair = "B1/B2" if fused else "B3/B4"
    how = ""
    if len(npads) == 2:
        grids = {m: tuple(adjoint_grid(torch, topo, C, h, 8, m)
                          for h in (w_chunk, H - w_chunk * (n_chunks - 1)))
                 for m in npads}
        res = {m: out[f"N{m}"]["res"] for m in npads}
        how = "; N = 32 against N = 64 " + instances_agree(
            torch, f"{key} value + gradient",
            {m: (r[0].reshape(1),) + r[1:] for m, r in res.items()}, grids,
            "float64", what=("lnL", "dP", "dpi"))
    print(f"  {key}, value + gradient at the MLEs [{card}], {C} classes x "
          f"{H} patterns x {n} states: level route {out['level']['ms']:.2f}"
          f" ms, peak {out['level']['gib']:.2f} GiB; "
          + "; ".join(f"{pair} at N = {m} in {n_chunks} chunk(s) "
                      f"{out[f'N{m}']['ms']:.2f} ms, peak "
                      f"{out[f'N{m}']['gib']:.2f} GiB (bounds "
                      f"{bnd[m][0][0]:.3f} + {bnd[m][1][0]:.3f} ms; lnL rel "
                      f"{errs[m][0]:.2e}, "
                      f"gradient {errs[m][1]:.2e} of the largest)"
                      for m in npads)
          + f"; bounds at n = {n}: {bnd[n][0][0]:.3f} + {bnd[n][1][0]:.3f} "
          f"ms; the level route repeated bit for bit: {same}{how}",
          flush=True)
    if any(r > tol["val"] or g > tol["grad"] for r, g in errs.values()) \
            or not same:
        raise AssertionError(f"{key}: the level route and {pair} disagree, "
                             "or the level route does not repeat")
    for k, name in enumerate(names):
        report[name][f"{key}_kernel_pair_ms_float64"] = \
            out[f"N{npads[0]}"]["ms"]
        report[name][f"{key}_level_route_ms_float64"] = out["level"]["ms"]
        report[name][f"{key}_bound_ms_float64"] = bnd[n][k][0]
        for m in npads:
            report[name][f"{key}_kernel_pair_N{m}_ms_float64"] = \
                out[f"N{m}"]["ms"]
            report[name][f"{key}_bound_ms_N{m}_float64"] = bnd[m][k][0]
    m = npads[0]
    return dict(level_ms=out["level"]["ms"], kernel_ms=out[f"N{m}"]["ms"],
                level_gib=out["level"]["gib"],
                kernel_gib=out[f"N{m}"]["gib"], rel=errs[m][0],
                gerr=errs[m][1])


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
    # 7c: HKY85 + AdG, the rate HMM over the 25,000 sites
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
    on the card at the fitted x (1e-9 relative); every launch of the
    instance its state count takes (N = 32 for amino acids, N = 64 for
    codons).  Returns (summary, wall, counts, lnL in mlc)."""
    from paml_tpu_torch.core import cuda_pruning as cp

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
          f"{counts['launches']}, by instance "
          f"{ {k: v for k, v in counts['launches'].instances.items() if v} }"
          f", level-route calls {counts['level']}, "
          f"plain calls {counts['plain']}; lnL in mlc {lnls[0]:.6f}, plain "
          f"version {lnl_p:.6f} (rel {rel:.2e})", flush=True)
    if counts["plain"]:
        raise AssertionError(f"{tag}: the plain version ran on the card")
    # amino acids, or codons translated (seqtype 3 but FromCodon0, a codon
    # model): 20 states; codons: 61
    aa = res.spec.seqtype == 2 or (res.spec.seqtype == 3 and
                                   res.spec.aa_model != "FromCodon0")
    npad = cp.padded_states(20 if aa else 61)
    other = {k: v for k, v in counts["launches"].instances.items()
             if v and not k.endswith(f"_n{npad}")}
    if other:
        raise AssertionError(f"{tag}: launches {other} outside the N = "
                             f"{npad} instances")
    if rel > 1e-9:
        raise AssertionError(f"{tag}: the lnL in mlc disagrees with the "
                             "plain version")
    for name, count in counts["launches"].items():
        if count and report is not None:
            put_launches(report, name, f"launches_{tag}", count,
                         counts["launches"])
    return out, wall, counts, lnls


def check_aa_kernels(torch, P, tips, topo, piC, w, fpatt, report, card,
                     tag):
    """B1/B2 (coded tips with a table) or B3/B4 (state codes), launched
    alone at the shape of the amino-acid fit with the fit's own cotangent,
    at N = 32 (their instance for 20 states) against their plain versions
    (f64: 1e-10 on values, 1e-8 on gradients; f32, on the same inputs cast:
    2e-6, 3e-5) and against the N = 64 instance (`instances_agree`); each
    kernel timed (medians of 5) at N = 32 in float64 and float32 and at
    N = 64 in float64, beside its plain version and its bounds at n = 20,
    N = 32 and N = 64."""
    from paml_tpu_torch.core import cuda_pruning as cp
    from paml_tpu_torch.core import pruning
    from paml_tpu_torch.core.tipcodes import TipCodes

    C, n, H = P.shape[1], P.shape[-1], fpatt.shape[0]
    codes = cp.kernel_tips(tips)
    fused = isinstance(codes, TipCodes)
    with torch.no_grad():
        z = pruning.class_site_lnf_levels(P, tips, topo, piC) \
            + torch.log(w)[:, None]
        gbar = (fpatt[None, :] * torch.softmax(z, 0)).contiguous()
    del z
    names = ("pruning_fwd", "pruning_bwd") if fused else ("big_fwd",
                                                          "big_bwd")
    fwd, bwd = (cp.pruning_fwd, cp.pruning_bwd) if fused else \
        (cp.pruning_big_fwd, cp.pruning_big_bwd)
    errs, t = {}, {}
    for dt in (torch.float64, torch.float32):
        dn = str(dt).split(".")[1]
        tol = TOL[dn]
        Pd, pid, gd = P.to(dt), piC.to(dt), gbar.to(dt)
        cd = TipCodes(codes.codes, codes.amb.to(dt)) if fused else codes
        if fused:
            e_f, e_b, S = check_fused(torch, Pd, cd, topo, pid, gd, tol,
                                      f"{tag} {dn}")
        else:
            lnf, S = fwd(Pd, cd, topo, pid)
            dP, dpi = bwd(Pd, cd, topo, pid, gd, S)
            tb = cp.big_tree(topo)
            Pb = cp.with_identity(Pd, tb)
            lnf_r, S_r = pruning.class_site_lnf_big_plain(Pb, cd, tb, pid)
            e_f = max(max_err(lnf, lnf_r, tol["val"], f"B3 lnf {tag} {dn}"),
                      max_err(S, S_r, tol["val"], f"B3 S {tag} {dn}"))
            del S_r, lnf_r, Pb
            dP_r, dpi_r = pruning.class_site_lnf_bwd_plain(Pd, cd, topo, pid,
                                                           gd)
            e_b = max(max_err(dP, dP_r, tol["grad"], f"B4 dP {tag} {dn}"),
                      max_err(dpi, dpi_r, tol["grad"], f"B4 dpi {tag} {dn}"))
            del dP_r, dpi_r, dP, dpi
        errs[dn] = (e_f, e_b)
        torch.cuda.empty_cache()
        t[dn, 32] = (
            cuda_ms_median(lambda: fwd(Pd, cd, topo, pid)),
            cuda_ms_median(lambda: bwd(Pd, cd, topo, pid, gd, S)))
        if dt == torch.float64:
            with torch.no_grad():
                plain_f = cuda_ms_median(lambda: pruning.class_site_lnf_plain(
                    P, codes, topo, piC))
            plain_b = cuda_ms_median(lambda: pruning.class_site_lnf_bwd_plain(
                P, codes, topo, piC, gbar))
            # the N = 64 instance on the same inputs
            outs, grids = {}, {}
            for m in cp.INSTANCES:
                lnf, Sm = fwd(P, codes, topo, piC, npad=m)
                outs[m] = (lnf, Sm) + bwd(P, codes, topo, piC, gbar, Sm,
                                          npad=m)
                grids[m] = adjoint_grid(torch, topo, C, H, 8, m)
            how = instances_agree(torch, tag, outs, grids, dn)
            del outs, lnf, Sm
            torch.cuda.empty_cache()
            S64 = fwd(P, codes, topo, piC, npad=64)[1]
            t[dn, 64] = (
                cuda_ms_median(lambda: fwd(P, codes, topo, piC, npad=64)),
                cuda_ms_median(lambda: bwd(P, codes, topo, piC, gbar, S64,
                                           npad=64)))
            del S64
        del S, Pd, pid, gd, cd
        torch.cuda.empty_cache()
    n_amb = getattr(codes, "n_amb", 0)
    print(f"  {'B1/B2' if fused else 'B3/B4'} N = 32 against N = 64 [{tag}, "
          f"{card}]: {how}", flush=True)
    for k, name in enumerate(names):
        e, pl = errs["float64"][k], (plain_f, plain_b)[k]
        report[name]["max_abs_err_float64"] = max(
            report[name].get("max_abs_err_float64", 0.0), e)
        report[name]["max_abs_err_float32"] = max(
            report[name].get("max_abs_err_float32", 0.0), errs["float32"][k])
        b = {m: bound(name, topo, C, H, m, 8, n_amb) for m in (n, 32, 64)}
        b32 = bound(name, topo, C, H, n, 4, n_amb)
        ms32, ms64, ms32f = (t["float64", 32][k], t["float64", 64][k],
                             t["float32", 32][k])
        row = report[name]
        row[f"ms_{tag}_float64"] = row[f"ms_n32_{tag}_float64"] = ms32
        row[f"ms_n64_{tag}_float64"] = ms64
        row[f"ms_n32_{tag}_float32"] = ms32f
        row[f"plain_ms_{tag}_float64"] = pl
        row[f"bound_ms_{tag}_n20_float64"] = b[n][0]
        row[f"bound_ms_{tag}_N32_float64"] = b[32][0]
        row[f"bound_ms_{tag}_N64_float64"] = b[64][0]
        row[f"bound_ms_{tag}_n20_float32"] = b32[0]
        # the kernel's own route at aaml's shape: B1/B2 on the gapped
        # alignment, B3/B4 on its clean copy
        row["ms_n32_float64"], row["ms_n32_float32"] = ms32, ms32f
        row["ms_n64_float64"] = ms64
        row["bound_ms_n20_float64"] = b[n][0]
        print(f"  {name} [{tag}, {C} classes x {H} patterns x {n} states, "
              f"A {n_amb}, {card}]: {ms32:.3f} ms at N = 32 (float32 "
              f"{ms32f:.3f}), {ms64:.3f} at N = 64 ({ms64 / ms32:.2f} x); "
              f"plain {pl:.3f} ms; max|diff| against the plain version "
              f"{e:.3e} (float32 {errs['float32'][k]:.3e}); bound at n = {n} "
              f"{b[n][0]:.4f} ms ({b[n][1]}, {100 * b[n][0] / ms32:.2f} % of"
              f" it at N = 32, {100 * b[n][0] / ms64:.2f} % at N = 64), at "
              f"N = 32 {b[32][0]:.4f} ms ({100 * b[32][0] / ms32:.2f} %), at "
              f"N = 64 {b[64][0]:.4f} ms ({100 * b[64][0] / ms64:.2f} %)",
              flush=True)
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
    fits, walls = [], []
    for rep in range(2):
        # the fit starts from the simulated branch lengths
        ctl = write_codeml_problem(work, f"lg_{rep}", names, rows, nwk,
                                   lengths=True, seqtype=2, model=3,
                                   aaRatefile="lg", fix_alpha=0)
        # the second run repeats the first: its launches count once
        out, wall, counts, lnls = run_a9_program(
            torch, ctl, f"aa_{rep}", card, None if rep else report)
        fits.append(out["runs"][0]["res"])
        walls.append(wall)
        inst = counts["launches"].instances
        if not inst["pruning_fwd_n32"] or any(
                v for k, v in inst.items() if k.endswith("_n64")):
            raise AssertionError(f"aaml: the N = 32 instances must carry "
                                 f"the program alone: {inst}")
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
          f"{AA_TRUTH['alpha']}); the fit repeated bit for bit: {same}; "
          f"the program {walls[0]:.2f} and {walls[1]:.2f} s wall on the N = "
          f"32 instances (at N = 64: 11.07 s, PERF.md section 5)",
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
                                neg.fpatt, report, card, key=f"b5_{tag}",
                                instances=(None, 64))
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
    return dict(yn00=yn, ml=ml, bayes=by, aln=aln)


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
                                    evals=res.fit.n_eval, lnL=res.lnL, dir=d)
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
            put_launches(report, name, f"launches_clock5_codon_{tag}", count,
                         counts["launches"])
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
        out[f"codon_{tag}"] = dict(seconds=sec, evals=res.fit.n_eval, dir=d)
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
    c56 = clock56_phase(torch, rng, work, report, card)
    t["10d"] = time.perf_counter() - t0
    print(f"phase 10: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return c56

# ---------------------------------------------------------------------------
# phase 11: tree search and tree generation (ROADMAP A14)
# ---------------------------------------------------------------------------

# 11a: baseml runmode 3 (stepwise addition, 63 fits) on 10 taxa x 20,000
# sites simulated under HKY85 + G5 (kappa 5, alpha 0.5), fitted with
# HKY85 + G5 at alpha 0.5 (fix_alpha, which keeps the phase's time; a free
# alpha took 1.8 s per fit against about 0.6 while the gamma quantiles ran
# on the host, before E2; phase 16 fits one with alpha free); 11d: runmode
# 2 (star decomposition, 81 fits) on 8 taxa x 5000 sites under HKY85 + G5,
# fitted with HKY85; 11b / 11c: codeml runmode 3 (35 fits) and 4 on M0
# data, 8 taxa x 2000 codons
TS_NUC_TAXA, TS_NUC_SITES = 10, 20_000
TS_STAR_TAXA, TS_STAR_SITES = 8, 5000
TS_CODON_TAXA, TS_CODONS = 8, 2000
HKY_TRUTH = dict(pi=(0.2, 0.3, 0.3, 0.2), rev=(1.0, 0.2, 0.2, 0.2, 0.2),
                 alpha=0.5)
# 11e: the star tree at the bench shape
STAR_TAXA, STAR_CODONS = 32, 4096

TS_BASEML_CTL = """      seqfile = seq.phy
     treefile = tree.nwk
      outfile = mlb
        noisy = 0
      runmode = {runmode}
        model = 4
        Mgene = 0
        clock = 0
    fix_kappa = 0
        kappa = 5
    fix_alpha = 1
        alpha = {alpha}
        ncatG = {ncatG}
        getSE = 0
 RateAncestor = 0
    cleandata = 0
"""

TS_CODEML_CTL = """      seqfile = seq.phy
     treefile = tree.nwk
      outfile = mlc
        noisy = 0
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
        getSE = 0
    cleandata = 0
"""


def write_search(workdir, tag, names, rows, nwk, template, runmode, **kw):
    """The alignment, the simulated tree (which a search does not read)
    and a control file in workdir/tag; returns the directory."""
    import os

    d = os.path.join(workdir, tag)
    os.makedirs(d)
    with open(os.path.join(d, "seq.phy"), "w") as f:
        f.write(phylip(names, rows))
    with open(os.path.join(d, "tree.nwk"), "w") as f:
        f.write(nwk + "\n")
    with open(os.path.join(d, "search.ctl"), "w") as f:
        f.write(template.format(runmode=runmode, **kw))
    return d


class SetupTimer:
    """Times the objectives' set-up inside the fits (`codeml.
    make_codon_objective`, `baseml.make_objective`: the frequency counts,
    the tips' coding, their check) with `utils.timing.phase("setup")`,
    the functions wrapped in their modules while the block runs."""

    def __enter__(self):
        from paml_tpu_torch.apps import baseml, codeml
        from paml_tpu_torch.utils import timing

        def timed(fn):
            def run(*a, **kw):
                with timing.phase("setup"):
                    return fn(*a, **kw)
            return run
        self.saved = (codeml.make_codon_objective, baseml.make_objective)
        codeml.make_codon_objective = timed(self.saved[0])
        baseml.make_objective = timed(self.saved[1])
        timing.reset()
        return self

    def __exit__(self, *exc):
        from paml_tpu_torch.apps import baseml, codeml
        from paml_tpu_torch.utils import timing

        codeml.make_codon_objective, baseml.make_objective = self.saved
        self.seconds = timing.report().get("setup", {}).get("seconds", 0.0)
        return False


def unrooted(topo):
    from paml_tpu_torch.core.topology import deroot, is_rooted
    return deroot(topo) if is_rooted(topo) else topo


def run_search(torch, d, prog, card):
    """`main([prog, search.ctl])` in d on the card, the counts set to 0
    just before: (its summary, wall seconds, counts, set-up seconds)."""
    with SetupTimer() as st:
        out, wall, counts = run_cli(torch, d, [prog, "search.ctl"])
    return out, wall, counts, st.seconds


def check_search(torch, tag, prog, d, truth, out, wall, counts, setup,
                 card):
    """The search found the simulated tree (partition distance 0), and
    its best lnL is the objective's at the best fit's x: on CPU tensors
    for nucleotides, with the plain version on the card for codons
    (1e-9).  Prints the fits, seconds per fit and the host set-up's
    share; returns the number of fits."""
    import os

    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.apps.bootstrap import partition_distance
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import ctl as ctlmod

    data = out["data"]
    found = from_treenode(out["tree"], data.names)
    dist = partition_distance(unrooted(found), unrooted(truth))
    if dist:
        raise AssertionError(f"{tag}: the search found a tree at partition "
                             f"distance {dist} from the simulated one")
    best = [f for f in out["fits"] if f["res"].lnL == out["lnL"]
            and f["data"].ns == data.ns][-1]
    ctl = os.path.join(d, "search.ctl")
    opts = ctlmod.read_ctl(ctl)
    if prog == "baseml":
        spec = ctlmod.baseml_spec(opts, ctl)[0]
        ref, _ = cpu_objective_lnl(torch, best["data"], best["topo"], spec,
                                   best["res"].x)
        where = "CPU tensors"
    else:
        spec = ctlmod.codeml_spec(opts, ctl)[0]
        neg = codeml.make_codon_objective(best["data"], best["topo"], spec,
                                          device="cuda")[0]
        ref, _ = plain_value_grad(torch, neg, best["res"].x, 1, grad=False)
        where = "the plain version on the card"
    if not same_number(out["lnL"], ref, 1e-9):
        raise AssertionError(f"{tag}: best lnL {out['lnL']!r} against "
                             f"{ref!r} on {where}")
    text = open(os.path.join(d, "mlb" if prog == "baseml" else "mlc")).read()
    if f"best lnL = {out['lnL']:.6f}" not in text:
        raise AssertionError(f"{tag}: the output file lacks the best lnL")
    n = len(out["fits"])
    fit_s = sum(f["seconds"] for f in out["fits"])
    print(f"{tag} [{card}]: {prog} found the simulated tree, lnL "
          f"{out['lnL']:.6f} (against {where}: {out['lnL'] - ref:+.2e}); "
          f"{n} fits, {fit_s / n:.3f} s per fit, {wall:.1f} s wall, the "
          f"objectives' host set-up {setup:.1f} s ({setup / wall:.3f} of "
          f"the wall); launches {counts['launches']}, level-route calls "
          f"{counts['level']}, plain calls {counts['plain']}", flush=True)
    return n


def codon_routes(tag, counts, pair, report, key):
    """B1/B2 or B3/B4 alone carried a codon search: their launches go to
    the kernels line under `key`."""
    from paml_tpu_torch.core import cuda_pruning

    for name in cuda_pruning.LAUNCHES:
        n = counts["launches"][name]
        if (n > 0) != (name in pair) or counts["plain"]:
            raise AssertionError(f"{tag}: launches {counts['launches']}, "
                                 f"plain calls {counts['plain']}: only "
                                 f"{pair} should carry it")
        if n:
            put_launches(report, name, key, n, counts["launches"])


def star_value_grad(torch, rng, card):
    """11e: one value + gradient of M2a on the 32-taxon x 4096-codon star
    tree (the root's 32 children resolved under big_tree's identity-P
    nodes for the kernels) through B3/B4 (clean) and B1/B2 (phase 3b's
    gaps and Ns), each against the plain version on the star itself."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio

    names, rows, _ = simulate_m0_rows(torch, rng, STAR_TAXA, STAR_CODONS)
    star = from_treenode(treeio.parse_newick("(" + ",".join(names) + ");"),
                         names)
    spec = codeml.CodemlSpec(NSsites=2, codonf="F3x4", cleandata=False)
    tol = TOL["float64"]
    for route, rws, pair in (("clean", rows, ("big_fwd", "big_bwd")),
                             ("gapped", gapped_rows(rng, rows),
                              ("pruning_fwd", "pruning_bwd"))):
        data = seqio.pack(seqio.Alignment(names, rws, seqio.CODON_SEQ),
                          cleandata=False)
        neg, _, _, x0, _, _ = codeml.make_codon_objective(data, star, spec,
                                                          device="cuda")
        cuda_pruning.reset_launch_counts()
        t0 = time.perf_counter()
        v, g = value_grad(torch, neg, x0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        la = dict(cuda_pruning.LAUNCHES)
        if any((la[k] > 0) != (k in pair) for k in la):
            raise AssertionError(f"11e {route}: launches {la}, not {pair}")
        t0 = time.perf_counter()
        lp, gp = plain_value_grad(torch, neg, x0, 1)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        dv = abs(-v - lp) / abs(lp)
        dg = float(np.abs(-g - gp).max() / np.abs(gp).max())
        if dv > tol["val"] or dg > tol["grad"]:
            raise AssertionError(f"11e {route}: value off by {dv:.2e}, "
                                 f"gradient by {dg:.2e} of its largest "
                                 f"component, against the plain version")
        print(f"11e star tree {STAR_TAXA} x {data.npatt} patterns, {route} "
              f"({'+'.join(pair)}) [{card}]: lnL {-v:.6f}, value {dv:.1e} "
              f"and gradient {dg:.1e} off the plain version; {ms:.1f} ms "
              f"against {plain_ms:.1f} ms plain", flush=True)


def tree_modes(torch, work, nuc, card):
    """11f: evolver 1-4, 8 and 9, and pamp's `pattern_ls` on 11a's
    alignment and tree, with no pruning at all."""
    import os

    from paml_tpu_torch.apps import pamp
    from paml_tpu_torch.io import seqio, treeio

    d = os.path.join(work, "trees")
    os.makedirs(d)
    t0 = time.perf_counter()
    n = 0
    _, _, c = run_cli(torch, d, ["evolver", "1", "8", "12", "3"])
    n += no_launch(c, "evolver 1")
    sample = open(os.path.join(d, "evolver.out")).read()
    if sample.count(";") != 12:
        raise AssertionError("evolver 1: not 12 trees")
    with open(os.path.join(d, "sample.trees"), "w") as f:
        f.write(sample)
    _, _, c = run_cli(torch, d, ["evolver", "2", "6", "5", "3", "2", "1",
                                 "0.5", "1"])
    n += no_launch(c, "evolver 2")
    for mode, ns, want in (("3", 7, 945), ("4", 6, 945)):
        _, _, c = run_cli(torch, d, ["evolver", mode, str(ns)])
        n += no_launch(c, f"evolver {mode}")
        got = open(os.path.join(d, "evolver.out")).read().count(";")
        if got != want:
            raise AssertionError(f"evolver {mode} {ns}: {got} trees, not "
                                 f"{want}")
    _, _, c = run_cli(torch, d, ["evolver", "8", "sample.trees"])
    n += no_launch(c, "evolver 8")
    _, _, c = run_cli(torch, d, ["evolver", "9", "sample.trees"])
    n += no_launch(c, "evolver 9")
    main = treeio.parse_newick(open(os.path.join(d, "evolver.out")).read())
    sup = [float(v.name) for v in main.walk_post()
           if v.children and v is not main]
    # the main tree is the sample's first: each of its clades at least 1 / 12
    if len(sup) != 5 or not all(100 / 12 - 0.05 <= s <= 100.0 for s in sup):
        raise AssertionError(f"evolver 9: clade supports {sup}")
    names, rows, nwk, topo = nuc
    data = seqio.pack(seqio.Alignment(names, rows, seqio.BASE_SEQ))
    reset_counts()
    t1 = time.perf_counter()
    res = pamp.pattern_ls(topo, data, alpha=HKY_TRUTH["alpha"])
    ls_s = time.perf_counter() - t1
    n += no_launch(read_counts(), "pattern_ls")
    bn = topo.branch_nodes()
    est, true = res["blens"][bn].sum(), topo.blen0[bn].sum()
    if not (np.isfinite(res["blens"]).all() and abs(est / true - 1) < 0.25):
        raise AssertionError(f"pattern_ls: tree length {est} against the "
                             f"simulated {true}")
    print(f"11f [{card}]: evolver 1-4, 8, 9 and pattern_ls with no pruning "
          f"launch; pattern_ls tree length {est:.4f} (simulated {true:.4f})"
          f" in {ls_s:.2f} s; {time.perf_counter() - t0:.1f} s", flush=True)
    return n


def phase_search(torch, rng, report, card):
    """Phase 11: baseml runmode 3 (11a) and 2 (11d), codeml runmode 3 on
    gapped codons (11b, B1/B2) and 4 on their clean copy (11c, B3/B4), the
    star tree through the kernels (11e), evolver's tree modes and
    pattern_ls (11f)."""
    import tempfile

    from paml_tpu_torch.io import treeio

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="search_")
    t = {}
    # 11a / 11d: nucleotides, the level route
    for tag, ns, ls, runmode, gamma in (
            ("11a", TS_NUC_TAXA, TS_NUC_SITES, 3,
             dict(alpha=HKY_TRUTH["alpha"], ncatG=5)),
            ("11d", TS_STAR_TAXA, TS_STAR_SITES, 2, dict(alpha=0, ncatG=1))):
        t0 = time.perf_counter()
        names, rows, nwk, _, topo = simulate_nuc(torch, rng, ns, ls, "cuda",
                                                 truth=HKY_TRUTH)
        if tag == "11a":
            nuc = (names, rows, nwk, topo)
        d = write_search(work, tag, names, rows, nwk, TS_BASEML_CTL,
                         runmode, **gamma)
        out, wall, counts, setup = run_search(torch, d, "baseml", card)
        check_baseml_routes(tag, counts)
        check_search(torch, tag, "baseml", d, topo, out, wall, counts, setup,
                     card)
        t[tag] = time.perf_counter() - t0
    # 11b / 11c: codons through the kernels
    names, rows, topo = simulate_m0_rows(torch, rng, TS_CODON_TAXA, TS_CODONS)
    nwk = treeio.write_newick(treeio.parse_newick(
        newick(names, "ladder")), branch_lengths=False)
    for tag, rws, runmode, pair in (
            ("11b", gapped_rows(rng, rows), 3, ("pruning_fwd",
                                                "pruning_bwd")),
            ("11c", rows, 4, ("big_fwd", "big_bwd"))):
        t1 = time.perf_counter()
        d = write_search(work, tag, names, rws, nwk, TS_CODEML_CTL, runmode)
        out, wall, counts, setup = run_search(torch, d, "codeml", card)
        codon_routes(tag, counts, pair, report, f"launches_search_{tag}")
        check_search(torch, tag, "codeml", d, topo, out, wall, counts, setup,
                     card)
        t[tag] = time.perf_counter() - t1
    t0 = time.perf_counter()
    star_value_grad(torch, rng, card)
    t["11e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree_modes(torch, work, nuc, card)
    t["11f"] = time.perf_counter() - t0
    print("phase 11: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 12: the pattern axis over devices and ranks (ROADMAP A13)
# ---------------------------------------------------------------------------

MESH_RANK_WORKER = r'''
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["LOCAL_RANK"] = str(rank)
from paml_tpu_torch import entry
from paml_tpu_torch.core import cuda_pruning, pruning
from paml_tpu_torch.parallel import distributed
distributed.initialize(backend="nccl", init_method=f"tcp://localhost:{port}",
                       world_size=world, rank=rank)
dev = distributed.local_device()
P, tips, topo, pi = entry._random_kernel_problem(32, 4096, 3, seed=1,
                                                 device=dev)
w = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2.0, 4096),
                    device=dev)
def vg():
    Pg, pig = P.detach().requires_grad_(True), pi.detach().requires_grad_(True)
    v = (w * pruning.class_site_lnf(Pg, tips, topo, pig).sum(0)).sum()
    return (float(v),) + torch.autograd.grad(v, (Pg, pig))
ref = vg()
pruning.set_pattern_mesh(distributed.global_data_mesh())
cuda_pruning.reset_launch_counts()
got = vg()
dv = abs(got[0] - ref[0]) / abs(ref[0])
dg = max(float((a - b).abs().max() / b.abs().max())
         for a, b in zip(got[1:], ref[1:]))
print(f"RANK {rank} {dv!r} {dg!r} {cuda_pruning.LAUNCHES['big_fwd']} "
      f"{cuda_pruning.LAUNCHES['big_bwd']}", flush=True)
torch.distributed.destroy_process_group()
'''


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_value_grad(torch, neg, x, mesh, pair, tag, card):
    """One value + gradient unsharded and on `mesh` (two shards on one
    card), each timed (medians of 3); the sharded one must equal the
    unsharded one (1e-12 relative on the value, 1e-10 of the largest
    gradient component) and launch each kernel of `pair` once per shard."""
    from paml_tpu_torch.core import cuda_pruning, pruning

    def timed():
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, g = value_grad(torch, neg, x)
            ts.append(1e3 * (time.perf_counter() - t0))
        return v, g, float(np.median(ts))

    v1, g1, ms1 = timed()
    pruning.set_pattern_mesh(mesh)
    try:
        cuda_pruning.reset_launch_counts()
        v2, g2 = value_grad(torch, neg, x)
        la = dict(cuda_pruning.LAUNCHES)
        v2, g2, ms2 = timed()
    finally:
        pruning.set_pattern_mesh(None)
    want = {k: (mesh.n_shards if k in pair else 0) for k in la}
    if la != want:
        raise AssertionError(f"12a {tag}: launches {la} per sharded "
                             f"evaluation, not {want}")
    dv = abs(v2 - v1) / abs(v1)
    dg = float(np.abs(g2 - g1).max() / np.abs(g1).max())
    if dv > 1e-12 or dg > 1e-10:
        raise AssertionError(f"12a {tag}: sharded value off by {dv:.2e}, "
                             f"gradient by {dg:.2e}")
    print(f"12a {tag} [{card}]: {mesh.n_shards} shards on one card equal "
          f"unsharded (value {dv:.1e}, gradient {dg:.1e}); {ms2:.2f} ms "
          f"sharded against {ms1:.2f} ms unsharded; launches per "
          f"evaluation {la}", flush=True)


def mesh_fit(torch, data, topo, mesh, report, card):
    """12a: M0 at the bench shape fitted unsharded and twice on the mesh:
    the lnL within 1e-9 of unsharded, the two sharded fits bit for bit;
    the sharded fits' launches go to the kernels line."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    spec = codeml.CodemlSpec(NSsites=0, codonf="F3x4")
    t0 = time.perf_counter()
    one = codeml.fit_packed(data, topo, spec, device="cuda")
    t1 = time.perf_counter() - t0
    pruning.set_pattern_mesh(mesh)
    try:
        cuda_pruning.reset_launch_counts()
        t0 = time.perf_counter()
        a = codeml.fit_packed(data, topo, spec, device="cuda")
        t2 = time.perf_counter() - t0
        la = launch_counts()
        b = codeml.fit_packed(data, topo, spec, device="cuda")
    finally:
        pruning.set_pattern_mesh(None)
    if a.lnL != b.lnL or not np.array_equal(a.x, b.x):
        raise AssertionError(f"12a: sharded fits differ: {a.lnL!r}, "
                             f"{b.lnL!r}")
    if not same_number(a.lnL, one.lnL, 1e-9):
        raise AssertionError(f"12a: sharded fit lnL {a.lnL!r} against "
                             f"{one.lnL!r} unsharded")
    for name, n in la.items():
        if n:
            put_launches(report, name, "launches_mesh_fit", n, la)
    print(f"12a M0 fit [{card}]: lnL {a.lnL:.6f} sharded ({a.fit.n_eval} "
          f"evals, {t2:.2f} s, bit for bit twice), {one.lnL:.6f} unsharded "
          f"({one.fit.n_eval} evals, {t1:.2f} s); launches {la}", flush=True)


def two_ranks(torch, work, names, rows, nwk, card):
    """12b: `python -m torch.distributed.run --nproc_per_node 2 -m
    paml_tpu_torch codeml` (M0 on the bench alignment) on the one card
    (gloo: NCCL refuses two ranks on one device); rank 0 alone writes mlc
    and prints, with the single-process lnL to 1e-9."""
    import os
    import re

    d = os.path.join(work, "ranks")
    os.makedirs(d)
    with open(os.path.join(d, "seq.phy"), "w") as f:
        f.write(phylip(names, rows))
    with open(os.path.join(d, "tree.nwk"), "w") as f:
        f.write(nwk + "\n")
    with open(os.path.join(d, "codeml.ctl"), "w") as f:
        f.write(TS_CODEML_CTL.format(runmode=0))
    out, one_s, _ = run_cli(torch, d, ["codeml", "codeml.ctl"])
    one = out["runs"][0]["res"].lnL
    os.rename(os.path.join(d, "mlc"), os.path.join(d, "mlc.one"))
    env = dict(os.environ, PYTHONPATH=os.getcwd() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(free_port()), "-m", "paml_tpu_torch",
         "codeml", "codeml.ctl"], cwd=d, env=env, capture_output=True,
        text=True, timeout=300)
    wall = time.perf_counter() - t0
    if p.returncode:
        raise AssertionError(f"12b: torchrun exited {p.returncode}:\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    printed = p.stdout.count("results written to mlc")
    lnl = [float(v) for v in re.findall(
        r"lnL\(ntime:.*\): *(-?[0-9.]+)", open(os.path.join(d, "mlc")).read())]
    if printed != 1 or len(lnl) != 1:
        raise AssertionError(f"12b: {printed} ranks printed, mlc has "
                             f"{len(lnl)} lnL lines: one rank writes")
    if not same_number(lnl[0], one, 1e-9):
        raise AssertionError(f"12b: two ranks' lnL {lnl[0]!r} against "
                             f"{one!r} in one process")
    print(f"12b [{card}]: two gloo ranks on one card wrote one mlc, lnL "
          f"{lnl[0]:.6f} (one process: {one:.6f}); {wall:.1f} s for the "
          f"two ranks against {one_s:.1f} s in one process", flush=True)


def nccl_group(torch, card):
    """12c: a NCCL group of torch.cuda.device_count() ranks, one value +
    gradient of B3/B4 at the bench shape on the group's mesh against
    unsharded in each rank."""
    import os

    world = torch.cuda.device_count()
    port = free_port()
    worker = os.path.join(os.getcwd(), "build", "mesh_rank_worker.py")
    os.makedirs(os.path.dirname(worker), exist_ok=True)
    with open(worker, "w") as f:
        f.write(MESH_RANK_WORKER)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(world),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    for pr in procs:
        try:
            outs.append(pr.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            pr.kill()
            outs.append(pr.communicate()[0])
    for r, (pr, o) in enumerate(zip(procs, outs)):
        line = [ln for ln in o.splitlines() if ln.startswith("RANK")]
        if pr.returncode or not line:
            raise AssertionError(f"12c rank {r}: exit {pr.returncode}\n"
                                 f"{o[-3000:]}")
        _, _, dv, dg, nf, nb = line[0].split()
        if float(dv) > 1e-12 or float(dg) > 1e-10 or (nf, nb) != ("1", "1"):
            raise AssertionError(f"12c rank {r}: {line[0]}")
    print(f"12c [{card}]: a NCCL group of {world} rank(s): value + gradient "
          f"on the group's mesh equal unsharded ({time.perf_counter() - t0:.1f}"
          f" s)", flush=True)


def phase_mesh(torch, rng, report, card, big):
    """Phase 12: the pattern mesh of two shards on one card (12a), two
    gloo ranks running codeml (12b), a NCCL group (12c), `entry()` and
    `dryrun_multichip` (12d).  `big`: phase 5's (data, topo, spec, x)."""
    import tempfile

    from paml_tpu_torch import entry
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.io import seqio, treeio
    from paml_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="mesh_")
    mesh = sharding.data_mesh(["cuda:0", "cuda:0"])
    t = {}
    t0 = time.perf_counter()
    names, rows, topo = simulate_m0_rows(torch, rng, 32, 4096)
    spec = codeml.CodemlSpec(NSsites=2, codonf="F3x4", cleandata=False)
    for tag, rws, pair in (("bench clean", rows, ("big_fwd", "big_bwd")),
                           ("bench gapped", gapped_rows(rng, rows),
                            ("pruning_fwd", "pruning_bwd"))):
        data = seqio.pack(seqio.Alignment(names, rws, seqio.CODON_SEQ),
                          cleandata=False)
        neg, _, _, x0, _, _ = codeml.make_codon_objective(data, topo, spec,
                                                          device="cuda")
        mesh_value_grad(torch, neg, x0, mesh, pair, tag, card)
    data, btopo, bspec, x_true = big
    free = dataclasses.replace(bspec, fix_blength=0)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(data, btopo, free,
                                                      device="cuda")
    mesh_value_grad(torch, neg, x0, mesh, ("big_fwd", "big_bwd"),
                    f"{data.ns} taxa model A, unchunked", card)
    del neg
    torch.cuda.empty_cache()
    clean = seqio.pack(seqio.Alignment(names, rows, seqio.CODON_SEQ))
    mesh_fit(torch, clean, topo, mesh, report, card)
    t["12a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nwk = treeio.write_newick(treeio.parse_newick(newick(names, "ladder")),
                              branch_lengths=False)
    two_ranks(torch, work, names, rows, nwk, card)
    t["12b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl_group(torch, card)
    t["12c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, (x,) = entry.entry()
    v, g = fn(x)
    if not (torch.isfinite(v) and torch.isfinite(g).all()):
        raise AssertionError("12d: entry() is not finite")
    entry.dryrun_multichip(2, ["cuda:0", "cuda:0"])
    t["12d"] = time.perf_counter() - t0
    print("phase 12: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)



# --- phase 13: the float32 path ---------------------------------------------

F32_CHECK = dict(P_cpu=2e-6, P_f64=1e-5, val=2e-6, grad=3e-5, f64_rel=5e-6)


def bench_Qs(torch, neg, topo, dtype):
    """M2a's three rate matrices at the bench alignment's F3x4 frequencies
    (kappa 2, omegas 0.1 / 1 / 3, proportions 0.6 / 0.3 / 0.1) and the
    scaled branch lengths [63, 3] of `topo`, as the codon objective builds
    them, with the first three branches at lengths that need one to six
    squarings and the root's at 0: (Qs, pi, ts)."""
    from paml_tpu_torch.models import codon

    T = codon.dense_tables(0, "cuda", dtype)
    pi = torch.tensor(neg.pi_np, dtype=dtype, device="cuda")
    w = torch.tensor([0.1, 1.0, 3.0], dtype=dtype, device="cuda")
    s = codon.mutation_dense(T, torch.tensor([2.0], dtype=dtype,
                                             device="cuda"))
    rs, ra = codon.flux_dense(T, s, pi)
    Qs = codon.build_Q_dense(T, s, w, pi)
    wbar = (w * torch.tensor([0.6, 0.3, 0.1], dtype=dtype,
                             device="cuda")).sum()
    t = torch.tensor(topo.blen0, dtype=dtype, device="cuda")
    t[topo.root] = 0.0
    t[:3] = torch.tensor([3.0, 10.0, 60.0], dtype=dtype, device="cuda")
    return Qs, pi, t[:, None] / (rs + ra * wbar) * torch.ones_like(w)


def f32_pmat(torch, neg, topo, card):
    """13a: float32 P(t) by uniformization at the bench's 3 classes x 63
    branches against the same function on CPU tensors and against the
    float64 spectral P on the card; both timed, forward and forward +
    backward, and the six masked squarings alone."""
    from paml_tpu_torch.core import pmat

    Qs, pi, ts = bench_Qs(torch, neg, topo, torch.float32)
    P = pmat.pmat_rev_multi(Qs, pi, ts)
    P_cpu = pmat.pmat_rev_multi(Qs.cpu(), pi.cpu(), ts.cpu())
    args64 = [a.double() for a in (Qs, pi, ts)]
    P64 = pmat.pmat_rev_multi(*args64)
    e_cpu = float((P.cpu() - P_cpu).abs().max())
    e_64 = float((P.double() - P64).abs().max())
    nsq = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(
        Qs.diagonal(dim1=-2, dim2=-1).neg().amax(-1) * ts / pmat._UNIF_AMAX,
        1.0))), max=pmat._UNIF_NSQ)
    print(f"13a P(t) float32, {tuple(P.shape)} [{card}]: max|card - CPU| "
          f"{e_cpu:.3e}, max|float32 - float64 spectral| {e_64:.3e}; "
          f"squarings per branch 0-{int(nsq.max())} "
          f"({int((nsq > 0).sum())} of {nsq.numel()} need any)", flush=True)
    if e_cpu > F32_CHECK["P_cpu"] or e_64 > F32_CHECK["P_f64"]:
        raise AssertionError("13a: float32 P(t) off its CPU run or the "
                             "float64 P")
    ct = torch.randn(P.shape, dtype=torch.float64, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(13))
    f32_tf32(torch, (Qs, pi, ts), ct.float(), card)
    t = {}
    for tag, args in (("float32", (Qs, pi, ts)), ("float64", args64)):
        t[tag] = cuda_ms(lambda: pmat.pmat_rev_multi(*args))
        lf = [a.detach().requires_grad_(a is not args[1]) for a in args]
        c = ct.to(args[0].dtype)

        def fwd_bwd():
            torch.autograd.grad((pmat.pmat_rev_multi(*lf) * c).sum(),
                                (lf[0], lf[2]))
        t[tag + " + backward"] = cuda_ms(fwd_bwd)
    t["six masked squarings"] = cuda_ms(
        lambda: pmat._square_masked(P, torch.zeros_like(ts)))
    print("13a P(t) ms [" + card + "]: " + ", ".join(
        f"{k} {v:.3f}" for k, v in t.items()), flush=True)


def f32_tf32(torch, args, ct, card):
    """13a: float32 P(t) and its VJP (cotangent ct) with TF32 allowed are
    bit for bit those with it off, and the flag is left as the caller set
    it; the same P(t) with its products as plain `bmm` under TF32 (`_mm`
    swapped for the call) shows what the setting would change."""
    from paml_tpu_torch.core import pmat

    def p_and_vjp():
        lf = [a.detach().requires_grad_(a is not args[1]) for a in args]
        P = pmat.pmat_rev_multi(*lf)
        return (P.detach(),) + torch.autograd.grad((P * ct).sum(),
                                                   (lf[0], lf[2]))

    m = torch.backends.cuda.matmul
    off = p_and_vjp()
    m.allow_tf32 = True
    try:
        on = p_and_vjp()
        kept = m.allow_tf32
        mm, pmat._mm = pmat._mm, torch.bmm
        try:
            tf32 = p_and_vjp()
        finally:
            pmat._mm = mm
    finally:
        m.allow_tf32 = False
    same = [torch.equal(a, b) for a, b in zip(on, off)]
    gaps = ", ".join(f"{float((a - b).abs().max() / b.abs().max()):.2e}"
                     for a, b in zip(tf32, off))
    print(f"13a TF32 allowed [{card}]: P, dQ, dt bit-equal to TF32 off "
          f"{same}, flag still on after {kept}; with plain bmm under TF32 "
          f"they would be off by {gaps} of their largest", flush=True)
    if not all(same) or not kept:
        raise AssertionError("13a: float32 P(t) depends on the TF32 setting "
                             "or changed it")


def f32_value_grads(torch, bench, report, card):
    """13b: one value + gradient of M0 and M2a on phase 4's alignment,
    clean (B3/B4) and gapped (B1/B2), in float32 against the plain float32
    version on the card and against float64; ms per evaluation of both
    dtypes, medians of 5.  The float32 runs' launches (counted before the
    float64 timing) join the kernels line (`launches_f32_vg_<route>`)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    clean, gapped, topo, _ = bench
    for route, data, pair in (("clean", clean, ("big_fwd", "big_bwd")),
                              ("gapped", gapped,
                               ("pruning_fwd", "pruning_bwd"))):
        launches = {k: 0 for k in cuda_pruning.LAUNCHES}
        inst = dict.fromkeys(cuda_pruning.INSTANCE_LAUNCHES, 0)
        for name in ("M0", "M2a"):
            spec = codeml.CodemlSpec(NSsites=2 if name == "M2a" else 0,
                                     codonf="F3x4")
            negs = {dt: codeml.make_codon_objective(
                data, topo, spec, device="cuda", dtype=dt)[0]
                for dt in (torch.float32, torch.float64)}
            x0 = codeml.make_codon_objective(data, topo, spec,
                                             device="cuda")[3]
            ms = {}
            for dt, neg in negs.items():
                cuda_pruning.reset_launch_counts()
                pruning.PLAIN_CALLS["cuda"] = 0
                if dt == torch.float32:
                    v32, g32 = value_grad(torch, neg, x0)
                walls = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    value_grad(torch, neg, x0)
                    walls.append(time.perf_counter() - t0)
                ms[dt] = 1e3 * float(np.median(walls[1:]))
                if dt == torch.float32:
                    # the float32 runs' own launches, before float64's
                    own = launch_counts()
                    plain = pruning.PLAIN_CALLS["cuda"]
            for k, v in own.items():
                launches[k] += v
            for k, v in own.instances.items():
                inst[k] += v
            if plain or not all(own[k] for k in pair):
                raise AssertionError(f"13b {name} {route}: {pair} must carry "
                                     "the float32 value + gradient alone")
            v64, g64 = value_grad(torch, negs[torch.float64], x0)
            lp, gp = plain_value_grad(torch, negs[torch.float32], x0, 1)
            rel_p = abs(-v32 - lp) / abs(lp)
            gerr = float(np.abs(g32 + gp).max() / np.abs(gp).max())
            rel64 = abs(v32 - v64) / abs(v64)
            gerr64 = float(np.abs(g32 - g64).max() / np.abs(g64).max())
            print(f"13b {name}, {route} [{card}]: float32 lnL {-v32:.6f}, "
                  f"against plain float32 rel {rel_p:.2e} (gradient "
                  f"{gerr:.2e} of its largest), against float64 "
                  f"{-v64:.6f} rel {rel64:.2e} (gradient {gerr64:.2e}); "
                  f"ms per evaluation float32 {ms[torch.float32]:.2f}, "
                  f"float64 {ms[torch.float64]:.2f} "
                  f"({ms[torch.float64] / ms[torch.float32]:.2f} x)",
                  flush=True)
            if rel_p > F32_CHECK["val"] or gerr > F32_CHECK["grad"] or \
                    rel64 > F32_CHECK["f64_rel"]:
                raise AssertionError(f"13b {name} {route}: float32 value + "
                                     "gradient off the plain version or "
                                     "float64")
        for name in pair:
            put_launches(report, name, f"launches_f32_vg_{route}",
                         launches[name],
                         split={m: inst[f"{name}_n{m}"]
                                for m in cuda_pruning.INSTANCES})
        if any(launches[k] for k in launches if k not in pair):
            raise AssertionError(f"13b {route}: launches {launches}")


def f32_fits(torch, bench, report, card):
    """13c: `fit_packed(dtype=torch.float32)` under M0 on phase 4's clean
    (B3/B4) and gapped (B1/B2) alignments, each within 0.1 lnL of phase
    4's float64 fit, carried by its pair alone."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    clean, gapped, topo, fitted = bench
    spec = codeml.CodemlSpec(NSsites=0, codonf="F3x4")
    for route, data, pair in (("clean", clean, ("big_fwd", "big_bwd")),
                              ("gapped", gapped,
                               ("pruning_fwd", "pruning_bwd"))):
        ref = fitted[route]["M0"]
        cuda_pruning.reset_launch_counts()
        pruning.PLAIN_CALLS["cuda"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = codeml.fit_packed(data, topo, spec, device="cuda",
                                dtype=torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        print(f"13c fit_packed float32 M0, {route} [{card}]: lnL "
              f"{res.lnL:.6f} (float64 {ref.lnL:.6f}, {ref.fit.n_eval} "
              f"evals), {res.fit.n_eval} evals, {wall:.2f} s wall, "
              f"{1e3 * wall / res.fit.n_eval:.2f} ms/eval; launches "
              f"{launches}, plain calls {pruning.PLAIN_CALLS['cuda']}",
              flush=True)
        if abs(res.lnL - ref.lnL) > 0.1 or pruning.PLAIN_CALLS["cuda"]:
            raise AssertionError(f"13c {route}: the float32 fit is off the "
                                 "float64 one, or ran the plain version")
        for name, count in launches.items():
            if (count > 0) != (name in pair):
                raise AssertionError(f"13c {route}: {name} launched {count}"
                                     f" times; only {pair} should carry it")
            if count:
                put_launches(report, name, f"launches_f32_fit_{route}", count,
                             launches)


def sync_census(torch, fn):
    """fn() under `torch.cuda.set_sync_debug_mode("warn")`: (its result,
    the synchronizing operations counted by the file and line of the
    Python call that made them)."""
    import collections
    import os
    import warnings

    counts = collections.Counter()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in rec:
        if "called a synchronizing CUDA operation" in str(w.message):
            counts[(os.path.relpath(w.filename), w.lineno)] += 1
    return out, counts


def _lines_of(fn):
    import inspect
    src, first = inspect.getsourcelines(fn)
    return range(first, first + len(src))


def f32_device_fits(torch, bench, report, card):
    """13d: `maximize_device_bounded` on phase 4's clean M0 objective in
    float64 (within 2e-4 lnL of phase 4's scipy fit) and float32 (within
    0.1): iterations, evaluations, wall, launches (`launches_f32_device_fit`,
    `launches_device_fit_f64`); then each again under the CUDA sync debug
    mode, its synchronizing operations by source line: the optimizer's own
    between its checks must be 0 (its loop, `optim._lbfgs_run`, its pass
    and the line search's helpers, reads only the stop flag and the status
    word, `optim._stop_read`); the objective's own are printed (none per
    evaluation: the eigensolver's status word goes to the loop's state).
    The objective is called through `fn`, which declares nothing, so these
    fits dispatch their passes op by op (15d replays them from graphs)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, optim, pruning

    clean, _, topo, fitted = bench
    ref = fitted["clean"]["M0"]
    spec = codeml.CodemlSpec(NSsites=0, codonf="F3x4")
    loop = set().union(*(_lines_of(f) for f in (
        optim._lbfgs_run, optim._lbfgs_state, optim._lbfgs_pass,
        optim._direction, optim._scale0, optim._ls_start, optim._zoom_trial,
        optim._cubicmin, optim._quadmin, optim._wolfe_errors)))
    reads = _lines_of(optim._stop_read)
    grads = _lines_of(optim._value_grad)
    for dt, tol, key in ((torch.float64, 2e-4, "launches_device_fit_f64"),
                         (torch.float32, 0.1, "launches_f32_device_fit")):
        neg, _, _, x0, bounds, _ = codeml.make_codon_objective(
            clean, topo, spec, device="cuda", dtype=dt)
        calls = [0]

        def fn(x):
            calls[0] += 1
            return neg(x)

        def fit():
            optim.CHECKS.update(reads=0, trials=0)
            calls[0] = 0
            return optim.maximize_device_bounded(fn, x0, bounds,
                                                 device="cuda", dtype=dt)
        fit()                                      # warm-up
        cuda_pruning.reset_launch_counts()
        pruning.PLAIN_CALLS["cuda"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, lnl, it = fit()
        wall = time.perf_counter() - t0
        launches, n_eval = launch_counts(), calls[0]
        n_reads, trials = optim.CHECKS["reads"], optim.CHECKS["trials"]
        print(f"13d maximize_device_bounded {str(dt)[6:]} M0 [{card}]: lnL "
              f"{lnl:.6f} (scipy float64 {ref.lnL:.6f}, {ref.fit.n_eval} "
              f"evals), {it} iterations, {trials} line-search trials, "
              f"{n_eval} evaluations, {n_reads} reads of the stop flag, "
              f"{wall:.3f} s wall, {1e3 * wall / n_eval:.2f} ms/eval; "
              f"launches {launches}", flush=True)
        if abs(lnl - ref.lnL) > tol or pruning.PLAIN_CALLS["cuda"] or \
                n_reads > -(-trials // optim.CHECK_EVERY) + 1:
            raise AssertionError(f"13d {dt}: the device fit is off the scipy"
                                 " fit, ran the plain version or read the "
                                 "stop flag too often")
        for name in ("big_fwd", "big_bwd"):
            if not launches[name]:
                raise AssertionError(f"13d {dt}: {name} did not carry the "
                                     "device fit")
            put_launches(report, name, key, launches[name], launches)
        (_, _, it2), counts = sync_census(torch, fit)
        own = {k: v for k, v in counts.items()
               if k[0].endswith("core/optim.py") and k[1] in loop
               and k[1] not in reads and k[1] not in grads}
        n_read = sum(v for k, v in counts.items()
                     if k[0].endswith("core/optim.py") and k[1] in reads)
        print(f"13d host syncs, {str(dt)[6:]}, {it2} iterations, "
              f"{calls[0]} evaluations: the optimizer's own between checks "
              f"{sum(own.values())} ({sum(own.values()) / max(it2, 1):.2f} "
              f"per iteration), stop-flag reads {n_read}; by line:",
              flush=True)
        for (f, line), v in sorted(counts.items(), key=lambda kv: -kv[1]):
            where = ("the stop flag" if f.endswith("core/optim.py")
                     and line in reads else
                     "the objective's backward, replayed at its gradient "
                     "call" if f.endswith("core/optim.py") and line in grads
                     else "")
            print(f"    {f}:{line} {v} ({v / max(calls[0], 1):.2f} per "
                  f"evaluation) {where}", flush=True)
        if own:
            raise AssertionError(f"13d {dt}: the optimizer synchronized "
                                 f"between its checks: {own}")


def f32_big(torch, big, report, card):
    """13e: one float32 value + gradient of phase 5's 1024-taxon model A
    alignment (every branch length free) in 10 chunks against float64,
    both timed with their peak memory; the float32 run's launches join the
    kernels line (`launches_f32_big`)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, pruning

    data, topo, spec, _ = big
    free = dataclasses.replace(spec, fix_blength=0)
    out = {}
    for dt in (torch.float32, torch.float64):
        neg, _, _, x0, _, _ = codeml.make_codon_objective(
            data, topo, free, device="cuda", dtype=dt, n_chunks=BIG_CHUNKS)
        cuda_pruning.reset_launch_counts()
        pruning.PLAIN_CALLS["cuda"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            v, g = value_grad(torch, neg, x0)
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[dt] = (v, g)
        if dt == torch.float32:
            launches = launch_counts()
            if pruning.PLAIN_CALLS["cuda"] or launches["pruning_fwd"] or \
                    not launches["big_fwd"] or not launches["big_bwd"]:
                raise AssertionError(f"13e: B3/B4 must carry it: {launches}")
            for name in ("big_fwd", "big_bwd"):
                put_launches(report, name, "launches_f32_big", launches[name],
                             launches)
        print(f"13e model A, {data.ns} taxa x {data.npatt} patterns, "
              f"{BIG_CHUNKS} chunks, {str(dt)[6:]} [{card}]: lnL {-v:.6f}, "
              f"{', '.join(f'{1e3 * w:.1f}' for w in walls)} ms, peak "
              f"{peak:.2f} GiB", flush=True)
        del neg
        torch.cuda.empty_cache()
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    rel = abs(v32 - v64) / abs(v64)
    gerr = float(np.abs(g32 - g64).max() / np.abs(g64).max())
    print(f"13e float32 against float64: lnL rel {rel:.2e}, gradient "
          f"{gerr:.2e} of its largest", flush=True)
    if rel > F32_CHECK["f64_rel"]:
        raise AssertionError("13e: the float32 lnL is off float64")


def phase_f32(torch, report, card, bench, big):
    """Phase 13: the float32 path on the card (13a-13e); `bench`: phase
    4's (clean, gapped, topology, fits), `big`: phase 5's (data, topo,
    spec, x)."""
    from paml_tpu_torch.apps import codeml

    t_phase = time.perf_counter()
    t = {}
    clean, _, topo, _ = bench
    neg = codeml.make_codon_objective(
        clean, topo, codeml.CodemlSpec(NSsites=2, codonf="F3x4"),
        device="cuda")[0]
    for tag, fn, args in (("13a", f32_pmat, (torch, neg, topo, card)),
                          ("13b", f32_value_grads, (torch, bench, report,
                                                    card)),
                          ("13c", f32_fits, (torch, bench, report, card)),
                          ("13d", f32_device_fits, (torch, bench, report,
                                                    card)),
                          ("13e", f32_big, (torch, big, report, card))):
        t0 = time.perf_counter()
        fn(*args)
        t[tag] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 13: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)


# --- phase 14: the port's bench ---------------------------------------------

BENCH_CHECK = dict(f32_rel=2e-6, fit_val=F32_CHECK["val"],
                   fit_grad=F32_CHECK["grad"], fit_lnl=0.1, timeout=600)


def phase_bench(torch, report, card):
    """Phase 14: `python -m paml_tpu_torch.bench` as a subprocess from the
    checkout's root.  The bench itself raises, so exits non-zero, on a host
    sync in the primary step, on a launch other than B3/B4's or on a graph
    whose step 0 is not the eager step; here: its last line (f32_rel,
    mfu_vs_fp32_peak) and its device fit, held to BENCH_CHECK.  Its
    numbers are printed and its launches join the kernels line
    (`launches_bench`: host launches, a graph's once)."""
    import os

    from paml_tpu_torch.core import cuda_pruning

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "paml_tpu_torch.bench"],
                       cwd=root, capture_output=True, text=True,
                       timeout=BENCH_CHECK["timeout"])
    wall = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        if line.startswith("paml_tpu_torch.bench:"):
            print("  " + line, flush=True)
    if r.returncode:
        raise AssertionError(f"14: the bench exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    last = json.loads(r.stdout.strip().splitlines()[-1])
    extra = last["extra"]
    with open(os.path.join(root, extra["detail_file"])) as f:
        detail = json.load(f)
    g = detail["graph"]
    fit = detail["onchip_fit_clock56_M0"]
    print(f"14 python -m paml_tpu_torch.bench [{card}], {wall:.1f} s: "
          f"{last['value']} {last['unit']}, vs_baseline "
          f"{last['vs_baseline']}; primary {extra['primary_ms_per_eval']} ms "
          f"per eval (graph of {g['steps']} steps), "
          f"{detail['primary_ms_per_eval_with_dispatch']:.3f} dispatched, "
          f"float64 {detail['primary_f64_ms_per_eval_with_dispatch']:.3f} "
          f"dispatched; model_at "
          f"{detail['phase_split']['model_at_fwd_ms']:.3f} ms; "
          f"mfu_vs_fp32_peak {extra['mfu_vs_fp32_peak']} (B3/B4's own "
          f"products {detail['kernel_flops_share_of_fp32_peak']:.4f}); "
          f"f32_rel {extra['f32_rel']}; 1024 taxa {extra['big_ms_per_eval']}"
          f" ms ({detail['big_roofline']['share_of_step']:.3f} of it the "
          f"kernels' bound); launches at the capture "
          f"{g['launches_at_capture']}, per replay (profiler) "
          f"{g['launches_per_replay']}, step 0 equal to the eager step "
          f"{g['step0_equal_eager']}", flush=True)
    start, end = fit["card_vs_cpu_at_start"], fit["card_vs_cpu_at_fit"]
    print(f"14 clock56 M0 device fit, float32: {fit['wall_s']:.3f} s, lnL "
          f"{fit['lnL']:.4f} ({fit['lnL_gap_vs_f64_optimum']:+.2e} from the "
          f"float64 optimum), {fit['iters']} iterations, {fit['evaluations']}"
          f" evaluations, {fit['captures']} capture, {fit['replays']} "
          f"replays, {fit['stop_reads']} stop-flag reads; card against CPU "
          + "; ".join(f"{at}: value {d['value_rel']:.2e} relative, gradient "
                      f"{d['grad_abs']:.2e} (largest {d['grad_max']:.2e})"
                      for at, d in (("at the start", start),
                                    ("at the fit", end))), flush=True)
    if not extra["f32_rel"] <= BENCH_CHECK["f32_rel"] or \
            not 0 < extra["mfu_vs_fp32_peak"] <= 1:
        raise AssertionError(f"14: the bench's line is off: {last}")
    g_tol = BENCH_CHECK["fit_grad"] * start["grad_max"]
    if any(not d["value_rel"] <= BENCH_CHECK["fit_val"] or
           not d["grad_abs"] <= g_tol for d in (start, end)) or \
            not abs(fit["lnL_gap_vs_f64_optimum"]) <= BENCH_CHECK["fit_lnl"]:
        raise AssertionError(f"14: the bench's device fit is off: {fit}")
    for name in ("big_fwd", "big_bwd"):
        total = detail["launches_total"]
        put_launches(report, name, "launches_bench", total[name],
                     split={m: total[f"{name}_n{m}"]
                            for m in cuda_pruning.INSTANCES})
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)


# --- phase 15: CUDA graphs ----------------------------------------------------

# the eigensolver against torch.linalg.eigh: P(t) and its VJP, of their
# largest entry (the same float64 arithmetic up to the eigenvectors' basis
# within clusters, ~1e-14 measured); the kernel against its plain version
# bit for bit (the same rotations, each rounding in the same order)
GRAPH_CHECK = dict(P=1e-12, vjp=1e-12)
# the orders 15a holds the kernel at: each instance's (npad 4, 20, 60, 62,
# 64, the generic one at 1, 2, 5 and 33), odd and even
EIGH_ORDERS = (1, 2, 3, 4, 5, 20, 33, 60, 61, 62, 63, 64)


def model_a_Qs(torch, topo):
    """The 1024-taxon branch-site A alignment's 8 rate matrices (2 branch
    types x 4 classes at BS_TRUTH, Fequal) and their scaled branch lengths
    [nnode, 8], as the codon objective builds them: (Qs, pi [8, n],
    ts)."""
    from paml_tpu_torch.models import codon

    f64 = dict(dtype=torch.float64, device="cuda")
    T = codon.dense_tables(0, "cuda", torch.float64)
    t = BS_TRUTH
    pi = torch.full((61,), 1 / 61, **f64)
    s = codon.mutation_dense(T, torch.tensor([t["kappa"]], **f64))
    rs, ra = codon.flux_dense(T, s, pi)
    W = torch.tensor([[t["w0"], 1.0, t["w0"], 1.0],
                      [t["w0"], 1.0, t["w2"], t["w2"]]], **f64)
    p0, p1 = t["p0"], t["p1"]
    q = (1 - p0 - p1) / (p0 + p1)
    freqs = torch.tensor([p0, p1, q * p0, q * p1], **f64)
    Qs = codon.build_Q_dense(T, s, W.reshape(-1), pi)
    scale = (1.0 / (rs + ra * (W * freqs).sum(1))).repeat_interleave(4)
    ts = torch.tensor(topo.blen0, **f64)[:, None] * scale
    return Qs, pi.expand(8, -1), ts


def eigh_case(torch, tag, Qs, pi, ts, root, card):
    """15a on one set of rate matrices: the kernel against its plain
    version (`cuda_eigh.jacobi_plain`) and P(t) and its VJP against
    `torch.linalg.eigh`'s (the root's cotangent 0: its P is never used and
    its branch has length 0, where the off-diagonal P is rounding noise
    around 0 and the clip's mask follows the noise's sign); returns (the
    P(t) error, sweeps per matrix)."""
    from paml_tpu_torch.core import cuda_eigh, pmat

    S = pmat.symmetrize(Qs, pi)
    bits, info, ip = kernel_bits(torch, S)
    ct = torch.randn(ts.shape + Qs.shape[-2:], dtype=torch.float64,
                     device="cuda",
                     generator=torch.Generator("cuda").manual_seed(15))
    ct[root] = 0.0

    def p_and_vjp():
        a = [Qs.detach().requires_grad_(), pi, ts.detach().requires_grad_()]
        P = pmat.pmat_rev_multi(*a)
        return (P.detach(),) + torch.autograd.grad((P * ct).sum(),
                                                   (a[0], a[2]))
    got = p_and_vjp()
    orig = cuda_eigh.eigh
    cuda_eigh.eigh = torch.linalg.eigh
    try:
        ref = p_and_vjp()
    finally:
        cuda_eigh.eigh = orig
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, ref)]
    sweeps = info[:, 1].tolist()
    print(f"15a eigh, {tag}, {tuple(S.shape)} [{card}]: status "
          f"{info[:, 0].tolist()}, sweeps {sweeps} (plain {ip[:, 1].tolist()})"
          f"; kernel against its plain version bit for bit {bits}; against "
          f"torch.linalg.eigh, of the largest: P(t) {errs[0]:.2e}, dQ "
          f"{errs[1]:.2e}, dt {errs[2]:.2e}", flush=True)
    if not info[:, 0].eq(0).all() or not bits or \
            errs[0] > GRAPH_CHECK["P"] or max(errs[1:]) > GRAPH_CHECK["vjp"]:
        raise AssertionError(f"15a {tag}: the eigensolver is off")
    return float((got[0] - ref[0]).abs().max()), S, sweeps


def kernel_bits(torch, S):
    """The eigh kernel against its plain version on S: (eigenvalues,
    eigenvectors and status words identical to the bit, info, the plain
    version's info)."""
    from paml_tpu_torch.core import cuda_eigh

    lam, U, info = cuda_eigh.eigh_kernel(S)
    lp, Up, ip = cuda_eigh.jacobi_plain(S)
    bits = (torch.equal(info, ip) and
            torch.equal(lam.view(torch.int64), lp.view(torch.int64)) and
            torch.equal(U.view(torch.int64), Up.view(torch.int64)))
    return bits, info, ip


def reversible_S(torch, rng, n, G):
    """S = D^{1/2} Q D^{-1/2} of G random reversible rate matrices of order
    n under one frequency vector (as tests/test_torch_graphs.py::_small_Q
    builds them), on the card."""
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


def eigh_orders(torch, card):
    """15a: the kernel bit for bit against its plain version at every order
    of EIGH_ORDERS (random reversible matrices, three each)."""
    rng = np.random.default_rng(SEED + 14)
    out = []
    for n in EIGH_ORDERS:
        bits, info, _ = kernel_bits(torch, reversible_S(torch, rng, n, 3))
        out.append((n, bits, info[:, 1].tolist()))
        if not bits or not info[:, 0].eq(0).all():
            raise AssertionError(f"15a: the eigh kernel is off at n = {n}: "
                                 f"info {info.tolist()}")
    print(f"15a eigh, every instance's orders [{card}]: bit for bit with "
          f"the same status and sweeps at n = "
          + ", ".join(f"{n} ({'/'.join(map(str, sw))})" for n, _, sw in out),
          flush=True)


def eigh_round(torch, S, sweeps, card):
    """15a: one round at S (3 x 61) split by the kernel's debug instance:
    the full round, A alone (V skipped), the rotation chain alone (A and V
    skipped), all but the chain, per round at the sweeps the kernel took;
    and each warp's clock around its part of a round (work, then the wait
    at the barrier), the mean over the first sweep."""
    from paml_tpu_torch.core import cuda_eigh as ce

    sw, rounds = max(sweeps), max(sweeps) * (S.shape[-1] + S.shape[-1] % 2
                                             - 1)
    modes = {"full": 0, "A alone": ce.SKIP_V,
             "chain alone": ce.SKIP_V | ce.SKIP_A,
             "without the chain": ce.SKIP_CHAIN}
    us = {k: cuda_ms(lambda f=f: ce.eigh_probe(S, f, sw)) * 1e3 / rounds
          for k, f in modes.items()}
    st = ce.round_stamps(S, sw)
    print(f"15a eigh, one round at {tuple(S.shape)} [{card}], us: "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
          + f"; clock cycles of a round {st['round']:.0f}, per warp (work / "
          f"wait) " + ", ".join(f"{w} {a:.0f}/{b:.0f}" for w, (a, b) in
                                  st["warps"].items()), flush=True)
    return us


def graph_eigh(torch, bench, big, report, card):
    """15a: the Jacobi kernel at the bench's M2a class matrices, the
    1024-taxon model A's and every order of EIGH_ORDERS, against its plain
    version (bit for bit) and against torch.linalg.eigh (P(t), VJP); a NaN
    entry gives status 1 and raises, through `eigh` and through a graphed
    value + gradient; the kernel, its plain version and torch.linalg.eigh
    timed beside the kernel's bound at four shapes; one round split."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_eigh, graphs, pmat
    from paml_tpu_torch.core import cuda_pruning as cp

    clean, _, topo, _ = bench
    spec = codeml.CodemlSpec(NSsites=2, codonf="F3x4")
    neg, _, _, x0, _, _ = codeml.make_codon_objective(clean, topo, spec,
                                                      device="cuda")
    Qs, pi, ts = bench_Qs(torch, neg, topo, torch.float64)
    err, S, sweeps = eigh_case(torch, "bench M2a", Qs, pi.expand(3, -1), ts,
                               topo.root, card)
    _, btopo, _, _ = big
    Qb, pib, tsb = model_a_Qs(torch, btopo)
    err_b, _, _ = eigh_case(torch, "1024-taxon model A", Qb, pib, tsb,
                            btopo.root, card)
    bad = S.clone()
    bad[1, 3, 3] = float("nan")
    status = cuda_eigh.eigh_kernel(bad)[2][:, 0].tolist()
    raised = []
    try:
        cuda_eigh.eigh(bad)
    except graphs.DeviceStatusError as e:
        raised.append(str(e))
    x_nan = np.array(x0, float)
    x_nan[len(topo.branch_nodes())] = np.nan          # kappa
    gv = graphs.GraphedValueGrad(neg, torch.as_tensor(np.asarray(x0, float))
                                 .cuda())
    try:
        gv(x_nan)
    except graphs.DeviceStatusError as e:
        raised.append(str(e))
    gv.close()
    print(f"15a a NaN entry [{card}]: status {status}; raised {raised}",
          flush=True)
    if status != [0, 1, 0] or len(raised) != 2:
        raise AssertionError("15a: a NaN matrix must give status 1 and raise")
    eigh_orders(torch, card)
    rng = np.random.default_rng(SEED + 15)
    r = report["eigh"]
    r["max_abs_err_float64"] = max(err, err_b)
    r["shapes"] = {}
    for tag, Sx in (("3x61", S), ("8x61", pmat.symmetrize(Qb, pib)),
                    ("4x20", reversible_S(torch, rng, 20, 4)),
                    ("1x4", reversible_S(torch, rng, 4, 1))):
        sw = cuda_eigh.eigh_kernel(Sx)[2][:, 1].tolist()
        ms = cuda_ms(lambda: cuda_eigh.eigh_kernel(Sx))
        plain_ms = cuda_ms(lambda: cuda_eigh.jacobi_plain(Sx),
                           reps=2 if tag == "3x61" else 1,
                           warmup=1 if tag == "3x61" else 0)
        lib_ms = cuda_ms(lambda: torch.linalg.eigh(Sx))
        flop, nbytes = cuda_eigh.kernel_work(Sx.shape[-1], sw)
        bnd = (cp.bound_ms(flop, nbytes),
               "operations" if flop / cp.PEAK_FLOPS >= nbytes / cp.PEAK_BYTES
               else "bytes")
        r["shapes"][tag] = dict(sweeps=sw, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bnd[0])
        if tag == "3x61":
            record(report, "eigh", "float64", ms, plain_ms, bnd)
            r["library_ms_float64"] = lib_ms
        print(f"15a eigh timed, {tag} [{card}]: kernel {ms:.4f} ms, plain "
              f"version {plain_ms:.1f} ms, torch.linalg.eigh {lib_ms:.4f} ms"
              f"; bound {bnd[0]:.3g} ms by {bnd[1]} ({flop:.3g} operations, "
              f"sweeps {sw})", flush=True)
    r["round_us"] = eigh_round(torch, S, sweeps, card)


def fit_counts() -> dict:
    """The fits' counters: the device L-BFGS's stop-flag reads and trials
    (`optim.CHECKS`) and the evaluations replayed from graphs, dispatched
    op by op, and the captures (`optim.GRAPHS`)."""
    from paml_tpu_torch.core import optim
    return {**optim.CHECKS, **optim.GRAPHS}


def reset_all_launches():
    from paml_tpu_torch.core import cuda_eigh, cuda_pruning
    cuda_pruning.reset_launch_counts()
    cuda_eigh.LAUNCHES["eigh"] = 0


def record_launches(report, key, keys):
    """The wrappers' launch counts since `reset_all_launches`, as
    report[name][key] for each of keys; every one of them launched."""
    from paml_tpu_torch.core import graphs
    launches = graphs.kernel_launches()
    for name in keys:
        if not launches[name]:
            raise AssertionError(f"{key}: {name} did not launch: {launches}")
        put_launches(report, name, key, launches[name])
    return launches


def mismatch(a, b):
    """() where the float arrays a and b are equal (`np.array_equal`),
    else (the entries that differ, the first of them, the largest
    difference)."""
    d = np.flatnonzero(~(a == b))
    if not len(d):
        return ()
    return (len(d), int(d[0]), float(np.max(np.abs(a[d] - b[d]))))


GRAPH_ROUTES = (("clean", ("big_fwd", "big_bwd")),
                ("gapped", ("pruning_fwd", "pruning_bwd")))


def graph_value_grads(torch, bench, report, card):
    """15b: M2a and M3 on phase 4's clean (B3/B4) and gapped (B1/B2)
    alignments, float32 and float64: a value + gradient replayed from its
    CUDA graph against the eager one at three x, bit for bit; ms per
    evaluation both ways (the graph's with its copies in and out), the
    kernels of one replay, the capture's own cost."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import graphs

    clean, gapped, topo, _ = bench
    for (route, pair), data in zip(GRAPH_ROUTES, (clean, gapped)):
        reset_all_launches()
        for dt in (torch.float64, torch.float32):
            for name in ("M2a", "M3"):
                spec = codeml.CodemlSpec(NSsites=2 if name == "M2a" else 3,
                                         codonf="F3x4")
                neg, _, _, x0, _, _ = codeml.make_codon_objective(
                    data, topo, spec, device="cuda", dtype=dt)
                x0 = np.asarray(x0, float)
                xs = [x0 * (1.0 + 1e-3 * i) for i in range(3)]
                eager = [graphs.value_grad_eager(neg, x, "cuda") for x in xs]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gv = graphs.GraphedValueGrad(neg, torch.as_tensor(x0).cuda())
                torch.cuda.synchronize()
                cap_ms = 1e3 * (time.perf_counter() - t0)
                got = [gv(x) for x in xs]
                same = all(np.array_equal(g, e) for g, e in zip(got, eager))
                if not same:
                    # the same points once more both ways: which side moved
                    moved = [mismatch(g, e) for g, e in zip(got, eager)]
                    moved += [mismatch(graphs.value_grad_eager(neg, x, "cuda"),
                                       e) for x, e in zip(xs, eager)]
                    moved += [mismatch(gv(x), e) for x, e in zip(xs, eager)]
                t0 = time.perf_counter()
                for x in xs * 7:
                    gv(x)
                ms_g = 1e3 * (time.perf_counter() - t0) / 21
                t0 = time.perf_counter()
                for x in xs * 3:
                    graphs.value_grad_eager(neg, x, "cuda")
                ms_e = 1e3 * (time.perf_counter() - t0) / 9
                want = {k: 1 for k in pair}
                want["eigh"] = int(dt == torch.float64)
                kern = graphs.replay_kernels(gv.graph)
                kern_ok = all(kern[k] == want.get(k, 0) for k in want) and \
                    not any(kern[k] for k in ("pruning_fwd", "big_fwd")
                            if k not in pair)
                # a census that misses: a second replay's, which tells a
                # graph without the kernel from a census that lost events
                again = None if kern_ok else graphs.replay_kernels(gv.graph)
                gv.close()
                print(f"15b {name}, {route}, {str(dt)[6:]} [{card}]: lnL "
                      f"{-eager[0][0]:.6f}; graphed = eager bit for bit "
                      f"{same}; ms per evaluation graphed {ms_g:.3f}, eager "
                      f"{ms_e:.3f}; capture {cap_ms:.1f} ms; one replay "
                      f"{kern}", flush=True)
                if not same:
                    raise AssertionError(
                        f"15b {name} {route} {dt}: the graph is not the eager "
                        "evaluation; against the first eager values at x0..x2 "
                        "(each: entries that differ of "
                        f"{len(eager[0])}, the first of them, the largest "
                        "difference) the graph, then the eager evaluation "
                        f"and the graph once more: {moved}")
                if not kern_ok:
                    raise AssertionError(
                        f"15b {name} {route} {dt}: one replay ran the kernels "
                        f"{kern}, a second {again}, want {want}")
        record_launches(report, f"launches_graph_vg_{route}",
                        pair + ("eigh",))


def graph_fits(torch, bench, report, card):
    """15c: `fit_packed` under M0 and M2a in float64 on phase 4's clean
    and gapped alignments, from the objective's CUDA graph and eagerly
    (the same objective with `capturable` set False here, the declared
    route of an objective with host code): the same x bit for bit and the
    same evaluations; wall, ms per evaluation and host syncs per
    evaluation (the graph's: its one copy back, plus the first copy of x
    in)."""
    from paml_tpu_torch.apps import codeml

    clean, gapped, topo, fitted = bench
    for (route, pair), data in zip(GRAPH_ROUTES, (clean, gapped)):
        reset_all_launches()
        for name in ("M0", "M2a"):
            spec = codeml.CodemlSpec(NSsites=2 if name == "M2a" else 0,
                                     codonf="F3x4")
            got = {}
            for kind in ("eager", "graph"):
                obj = codeml.make_codon_objective(data, topo, spec,
                                                  device="cuda")
                obj[0].capturable = kind == "graph"
                before = fit_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, counts = sync_census(torch, lambda: codeml.fit_packed(
                    data, topo, spec, device="cuda", objective=obj))
                wall = time.perf_counter() - t0
                checks = {k: v - before[k] for k, v in fit_counts().items()}
                got[kind] = (res, wall, sum(counts.values()), checks)
            (rg, wg, sg, cg), (re_, we, se, ce) = got["graph"], got["eager"]
            same = np.array_equal(rg.x, re_.x) and rg.lnL == re_.lnL
            n = rg.fit.n_eval
            print(f"15c fit_packed {name}, {route}, float64 [{card}]: lnL "
                  f"{rg.lnL:.6f} (phase 4 {fitted[route][name].lnL:.6f}); "
                  f"graphed = eager x bit for bit {same}, evaluations {n} / "
                  f"{re_.fit.n_eval}; wall {wg:.3f} / {we:.3f} s, ms per "
                  f"evaluation {1e3 * wg / n:.3f} / "
                  f"{1e3 * we / re_.fit.n_eval:.3f}; host syncs per "
                  f"evaluation {sg / n:.3f} / {se / re_.fit.n_eval:.3f}; "
                  f"counts {cg} / {ce}", flush=True)
            if not same or n != re_.fit.n_eval or cg["captures"] != 1 or \
                    cg["graphed_evals"] != n or cg["eager_evals"] or \
                    ce["captures"] or ce["eager_evals"] != n or sg > n + 3:
                raise AssertionError(f"15c {name} {route}: the graphed fit is "
                                     "not the eager fit, or not graphed")
        record_launches(report, f"launches_graph_fit_{route}",
                        pair + ("eigh",))


def graph_device_fit(torch, report, card):
    """15d: the bench's clock56 device fit (`maximize_device_bounded`, M0
    F3x4, float32), its trials replayed from CUDA graphs of CHECK_EVERY
    passes, against the same passes dispatched op by op (the objective
    behind a plain function, which declares nothing): the same iterations
    and x bit for bit; wall; the host syncs at the stop flag equal to
    CHECKS["reads"]."""
    from paml_tpu_torch.bench import clock56_objective
    from paml_tpu_torch.core import optim

    neg, x0, bounds, ns, npatt = clock56_objective("cuda")
    reads = _lines_of(optim._stop_read)
    got = {}
    for kind, fn in (("eager", lambda x: neg(x)), ("graph", neg)):
        reset_all_launches()
        before = fit_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (x, lnl, it), counts = sync_census(
            torch, lambda: optim.maximize_device_bounded(
                fn, x0, bounds, device="cuda", dtype=torch.float32))
        wall = time.perf_counter() - t0
        at_reads = sum(v for k, v in counts.items()
                       if k[0].endswith("core/optim.py") and k[1] in reads)
        got[kind] = (x, lnl, it, wall, at_reads, sum(counts.values()),
                     {k: v - before[k] for k, v in fit_counts().items()})
    (xg, lg, ig, wg, rg, sg, cg), (xe, le, ie, we, re_, se, ce) = (
        got["graph"], got["eager"])
    same = np.array_equal(xg, xe) and lg == le and ig == ie
    print(f"15d device L-BFGS, clock56 ({ns} taxa x {npatt} patterns) M0 "
          f"float32 [{card}]: lnL {lg:.6f}, {ig} iterations; graphed = eager"
          f" bit for bit {same}; wall {wg:.3f} / {we:.3f} s; syncs at the "
          f"stop flag {rg} / {re_} (CHECKS reads {cg['reads']} / "
          f"{ce['reads']}), all syncs {sg} / {se}; counts {cg} / {ce}",
          flush=True)
    if not same or rg != cg["reads"] or cg["captures"] != 1 or \
            cg["eager_evals"] != 1 or not cg["graphed_evals"]:
        raise AssertionError("15d: the graphed device fit is not the eager "
                             "one, or not graphed")
    record_launches(report, "launches_graph_device_fit",
                    ("big_fwd", "big_bwd"))


def graph_big(torch, big, report, card):
    """15e: one float64 model A value + gradient on phase 5's 1024-taxon
    alignment, every branch length free, in 10 chunks (checkpointed),
    replayed from its CUDA graph against the eager one: bits, ms, and the
    peak memory of the capture (its pool) and of an eager evaluation."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import graphs

    data, topo, spec, _ = big
    free = dataclasses.replace(spec, fix_blength=0)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(
        data, topo, free, device="cuda", n_chunks=BIG_CHUNKS)
    x0 = np.asarray(x0, float)
    reset_all_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eager = graphs.value_grad_eager(neg, x0, "cuda")
    ms_e = 1e3 * (time.perf_counter() - t0)
    peak_e = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gv = graphs.GraphedValueGrad(neg, torch.as_tensor(x0).cuda())
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    peak_g = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    # what stays reserved once the allocator's cache is emptied: the
    # graph's private pool (and its static buffers)
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    same = np.array_equal(gv(x0), eager)
    t0 = time.perf_counter()
    for _ in range(2):
        gv(x0)
    ms_g = 1e3 * (time.perf_counter() - t0) / 2
    kern = graphs.replay_kernels(gv.graph)
    gv.close()
    print(f"15e model A, {data.ns} taxa x {data.npatt} patterns, "
          f"{BIG_CHUNKS} chunks, float64 [{card}]: lnL {-eager[0]:.6f}; "
          f"graphed = eager bit for bit {same}; ms graphed {ms_g:.1f}, eager "
          f"{ms_e:.1f}; capture {cap_s:.2f} s; peak GiB over the objective "
          f"eager {peak_e:.2f}, at the capture {peak_g:.2f}, held by the "
          f"graph's pool {held:.2f}; one replay {kern}", flush=True)
    if not same or kern["big_fwd"] != 2 * BIG_CHUNKS or \
            kern["big_bwd"] != BIG_CHUNKS or kern["eigh"] != 1:
        raise AssertionError("15e: the graphed 1024-taxon evaluation is not "
                             "the eager one")
    record_launches(report, "launches_graph_big",
                    ("big_fwd", "big_bwd", "eigh"))


CAPTURE_FAILS = r'''
import sys
import numpy as np
import torch
from paml_tpu_torch.core import optim


def neg(x):
    v = ((x - 1.0) ** 2).sum()
    return v + 0.0 * float(v.detach())  # a host read: no graph holds it
neg.capturable = True                  # declared capturable all the same
try:
    optim.maximize(neg, np.zeros(3), device="cuda")
except RuntimeError as e:
    print(f"raised {type(e).__name__}: {str(e).splitlines()[0][:160]}; "
          f"counts {optim.GRAPHS}")
    sys.exit(0)
print("no error: the fit went on without its graph")
sys.exit(1)
'''


def graph_capture_fails(torch, card):
    """15f: `maximize` on CUDA with an objective declared capturable that
    reads the host: its capture raises and the fit stops (no fallback to
    eager evaluation).  In a process of its own, since a failed capture
    leaves the allocator's routing to the dead graph's pool in place."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], cwd=root,
                       capture_output=True, text=True, timeout=300)
    print(f"15f a capture that fails [{card}]: exit {r.returncode}; "
          f"{r.stdout.strip()}", flush=True)
    if r.returncode:
        raise AssertionError(f"15f: a failed capture must raise:\n"
                             f"{r.stdout}{r.stderr[-2000:]}")


def phase_graphs(torch, report, card, bench, big):
    """Phase 15: CUDA graphs (15a-15f); `bench` and `big` as phase 13's."""
    t_phase = time.perf_counter()
    t = {}
    for tag, fn, args in (
            ("15a", graph_eigh, (torch, bench, big, report, card)),
            ("15b", graph_value_grads, (torch, bench, report, card)),
            ("15c", graph_fits, (torch, bench, report, card)),
            ("15d", graph_device_fit, (torch, report, card)),
            ("15e", graph_big, (torch, big, report, card)),
            ("15f", graph_capture_fails, (torch, card))):
        t0 = time.perf_counter()
        fn(*args)
        t[tag] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 15: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)


# --- phase 16: the quantile code on the card (E2) ------------------------------

# E2 against its plain versions: values relative, partials of the largest
# entry of each (the same arithmetic; the kernel stops its loops on
# convergence and fuses multiply-adds, the plain version runs its fixed
# trip counts with converged entries held).  The plain versions run on CPU
# copies of the inputs (one thread): thousands of small operations, which
# the host runs in a fraction of the time the card's launches take.  The
# beta inverse's stays on the card: its roots' condition (up to 1 / p =
# 200 at p = 0.005) lifts the last-bit differences between the host's and
# the card's lgamma at q = 99 past 1e-12 (1.1e-11 measured on the H100).
E2_PLAIN_ON_CARD = {("inc_inv", 0)}
E2_TOL = dict(val=1e-12, part=1e-9)
E2_PQ = [(0.05, 0.05), (0.05, 2.0), (0.5, 1.2), (2.0, 3.0), (30.0, 0.3),
         (0.005, 0.005), (0.005, 99.0), (99.0, 0.005)]
E2_ALPHAS = [0.02, 0.6, 1.0, 5.0, 49.0]
# the mixtures of M6, M9-M13, each at its x0 (codeml.nssites_x0_bounds)
E2_MIX = (6, 9, 10, 11, 12, 13)
# M12 and M13 with modes far apart, median targets on the flat stretches
# between them (tests/test_torch_quantile.py's SEPARATED): the bracket's
# Newton clusters miss there, and it multisects
E2_MIX_SEPARATED = [(12, [0.2, 0.55, 8.0, 0.05, 0.3], 10),
                    (12, [0.2, 0.3, 30.0, 0.02, 2.0], 10),
                    (13, [float(np.log(2.0)), 0.0, 10.0, 0.05, 0.05, 0.5],
                     2),
                    (13, [0.0, 0.0, 20.0, 0.01, 0.02, 1.0], 10)]


def e2_grids(torch):
    """The inputs 16a holds E2 at: {name: (entry, kind, a, b, x)}, CUDA
    float64: the test grids of tests/test_torch_quantile.py, the medians
    of M8 (10 roots at p 0.3, q 1.7) and M5 (alpha 0.6), the cuts of a
    discrete gamma's mean method (alpha + 1 at 4 cuts) and BEB's p x q x
    edge grid (10 x 10 x 9)."""
    f64 = dict(dtype=torch.float64, device="cuda")
    ys = (np.arange(10) + 0.5) / 10
    xs = np.random.default_rng(3).uniform(0.001, 0.999, 9)

    def g(pairs, xv):
        return (np.repeat([a for a, _ in pairs], len(xv)),
                np.repeat([b for _, b in pairs], len(xv)),
                np.tile(xv, len(pairs)))
    a = np.repeat(E2_ALPHAS, 9)
    xg = np.concatenate([[1e-5, 0.01, 0.3, 1.0, 3.0, al, al + 1.5,
                          4 * al + 2, 60.0] for al in E2_ALPHAS])
    ga = [(al, 1.0) for al in E2_ALPHAS]
    pg = (np.arange(10) + 0.5) * 0.2
    beb = [v.ravel() for v in np.meshgrid(pg, pg, np.arange(1, 10) / 10,
                                          indexing="ij")]
    cuts = np.array([0.3, 0.9, 1.7, 3.1])
    grids = {"beta": ("inc", 0, *g(E2_PQ, xs)),
             "gamma": ("inc", 1, a, np.ones_like(a), xg),
             "beta_inv": ("inc_inv", 0, *g(E2_PQ, ys)),
             "gamma_inv": ("inc_inv", 1, *g(ga, ys)),
             "M8": ("inc_inv", 0, np.full(10, 0.3), np.full(10, 1.7), ys),
             "M5": ("inc_inv", 1, np.full(10, 0.6), np.ones(10), ys),
             "gamma_cuts": ("inc", 1, np.full(4, 1.6), np.ones(4), cuts),
             "BEB": ("inc", 0, *beb)}
    return {k: (e, kind) + tuple(torch.tensor(np.asarray(v, float), **f64)
                                 for v in vs)
            for k, (e, kind, *vs) in grids.items()}


def e2_check(torch, name, got, ref):
    """The kernel's (value, d1, d2, info) against the plain version's (on
    the CPU)."""
    got, ref = (tuple(None if t is None else t.cpu() for t in r)
                for r in (got, ref))
    errs = {"val": float(((got[0] - ref[0]).abs()
                          / ref[0].abs().clamp_min(1e-300)).max())}
    for k, g, r in (("d1", got[1], ref[1]), ("d2", got[2], ref[2])):
        if g is not None:
            errs[k] = float((g - r).abs().max()
                            / r.abs().max().clamp_min(1e-300))
    same_status = torch.equal(got[3][..., 0], ref[3][..., 0])
    if errs["val"] > E2_TOL["val"] or \
            max(errs.get("d1", 0.0), errs.get("d2", 0.0)) > E2_TOL["part"] \
            or not same_status or int(got[3][..., 0].max()):
        raise AssertionError(f"16a E2 {name}: {errs}, status kernel "
                             f"{got[3][..., 0].unique().tolist()} plain "
                             f"{ref[3][..., 0].unique().tolist()}")
    return errs


def e2_kernels(torch, report, card):
    """16a: E2 against its plain versions (on CPU copies of the inputs but
    for the beta inverse, E2_PLAIN_ON_CARD; every entry and order at the
    test grids, M8's and M5's medians, a discrete gamma's cuts and BEB's
    grid, the grids of one entry in one call; the mixture bracket of each
    model at its x0 with 10 quantiles, M9's with 40, and M12's and M13's
    with modes far apart: a block per quantile), its digamma and trigamma against torch.special, a NaN
    input's status raising through dgamma, and E2 timed at each path's
    shape beside its bound, with its plain version's time for M8 (on the
    card, the kernels line's row) and the M9 bracket (on the CPU) and, for
    P(a, x), torch.special.gammainc."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, dgamma, graphs
    from paml_tpu_torch.core import cuda_quantile as cq

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)

    worst, plain_ms = 0.0, {}
    grids = e2_grids(torch)
    groups = {}             # the grids of one entry and kind in one call
    for name, (entry, kind, a, b, x) in grids.items():
        if name != "M5":    # alpha 0.6 is in gamma_inv's grid
            groups.setdefault((entry, kind), []).append((name, a, b, x))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for (entry, kind), members in groups.items():
            a, b, x = (torch.cat([m[i] for m in members]) for i in (1, 2, 3))
            on_card = (entry, kind) in E2_PLAIN_ON_CARD
            plain = getattr(cq, entry + "_plain")
            ref, ms = ((wall_ms(lambda: plain(kind, a, b, x, 2))) if on_card
                       else host_ms(lambda: plain(kind, a.cpu(), b.cpu(),
                                                  x.cpu(), 2)))
            names = "+".join(m[0] for m in members)
            for order in (0, 1, 2):
                got = getattr(cq, entry)(kind, a, b, x, order)
                errs = e2_check(torch, f"{names} order {order}", got, ref)
                worst = max([worst] + list(errs.values()))
            print(f"16a E2 {entry} {names} ({a.numel()} values) [{card}]: "
                  f"against the plain version {errs}, operations "
                  f"{int(got[3][..., 1].sum())}; the plain version (order "
                  f"2, {'card' if on_card else 'CPU'}) {ms:.0f} ms",
                  flush=True)
    finally:
        torch.set_num_threads(threads)
    mix_worst = 0.0
    for model, th, K in ([(m, None, 10) for m in E2_MIX] + [(9, None, 40)]
                         + E2_MIX_SEPARATED):
        if th is None:
            th = codeml.nssites_x0_bounds(model, K, False, 0.4)[0]
        t = torch.tensor(th, dtype=torch.float64, device="cuda")
        xk, ik = cq.mix_quantiles(model, t, K)
        torch.set_num_threads(1)
        try:
            (xp, ip), plain_ms[f"M{model}_bracket_{K}"] = host_ms(
                lambda: cq.mix_quantiles_plain(model, t.cpu(), K))
        finally:
            torch.set_num_threads(threads)
        xk = xk.cpu()
        err = float(((xk - xp).abs() / xp.abs()).max())
        mix_worst = max(mix_worst, err)
        if xk.shape != (K,) or err > E2_TOL["val"] or \
                int(ik[:, 0].max()) or int(ip[:, 0].max()):
            raise AssertionError(f"16a E2 mixture M{model}, K {K}: {err}")
    worst = max(worst, mix_worst)
    print(f"16a E2 mixture brackets M6, M9-M13 (10 quantiles), M9 (40) and "
          f"M12 / M13 with modes far apart [{card}]: against the plain "
          f"version within {mix_worst:.2e}",
          flush=True)
    z = torch.tensor(np.exp(np.linspace(np.log(0.004), np.log(300.0), 400)),
                     dtype=torch.float64, device="cuda")
    psi, psi1 = cq.polygamma_kernel(z)
    dg, tg = torch.special.digamma(z), torch.special.polygamma(1, z)
    e_psi = float(((psi - dg).abs() / dg.abs().clamp_min(1.0)).max())
    e_psi1 = float(((psi1 - tg).abs() / tg).max())
    print(f"16a E2 digamma / trigamma on [0.004, 300] against "
          f"torch.special [{card}]: {e_psi:.2e} / {e_psi1:.2e}", flush=True)
    # torch's trigamma truncates its asymptotic series at x^-7 from x >= 6
    # (4.9e-10 relative off scipy's on the CPU; E2's and the plain
    # versions' own 7e-16)
    if e_psi > 1e-14 or e_psi1 > 1e-9:
        raise AssertionError("16a E2's digamma or trigamma disagrees")
    nan = torch.tensor([0.3, float("nan")], dtype=torch.float64,
                       device="cuda")
    try:
        dgamma.betainc(nan, 1.2, 0.4)
        raise AssertionError("16a a NaN input did not raise")
    except graphs.DeviceStatusError as e:
        print(f"16a E2 NaN input [{card}]: raises ({e})", flush=True)

    # times at each path's shape: the kernel and its bound; the plain
    # version's on the card for M8 at the fit's order 1, and on the CPU
    # for the M9 bracket from the check above
    def bound(flop, nbytes):
        return dict(bound_ms=cuda_pruning.bound_ms(flop, nbytes),
                    bound_by=("operations" if flop / cuda_pruning.PEAK_FLOPS
                              > nbytes / cuda_pruning.PEAK_BYTES
                              else "bytes"))

    rows = {}
    for name, grid, order in (("M8", "M8", 1), ("M5", "M5", 1),
                              ("gamma_cuts", "gamma_cuts", 0),
                              ("gamma_cuts_order1", "gamma_cuts", 1),
                              ("BEB", "BEB", 0)):
        entry, kind, a, b, x = grids[grid]
        kern = getattr(cq, entry)
        info = kern(kind, a, b, x, order)[3]
        flop, nbytes = cq.kernel_work(entry, order, info)
        rows[name] = dict(ms=cuda_ms(lambda: kern(kind, a, b, x, order),
                                     reps=50),
                          **bound(flop, nbytes))
    entry, kind, a, b, x = grids["M8"]
    rows["M8"]["plain_ms"] = wall_ms(
        lambda: cq.inc_inv_plain(kind, a, b, x, 1))[1]
    # torch.special.gammainc gives values alone: against the cuts at order 0
    entry, kind, a, b, x = grids["gamma_cuts"]
    rows["gamma_cuts"]["library_ms"] = cuda_ms(
        lambda: torch.special.gammainc(a, x), reps=50)
    t = torch.tensor(codeml.nssites_x0_bounds(9, 10, False, 0.4)[0],
                     dtype=torch.float64, device="cuda")
    info = cq.mix_quantiles(9, t, 10)[1]
    flop, nbytes = cq.kernel_work("mix", 0, info, 5)
    rows["M9_bracket"] = dict(
        ms=cuda_ms(lambda: cq.mix_quantiles(9, t, 10), reps=20),
        plain_cpu_ms=plain_ms["M9_bracket_10"], **bound(flop, nbytes))
    for name, r in rows.items():
        plain = (f"{r['plain_ms']:.1f} ms on the card" if "plain_ms" in r
                 else f"{r['plain_cpu_ms']:.1f} ms on the CPU (one thread)"
                 if "plain_cpu_ms" in r else "not timed")
        print(f"16a E2 {name} [{card}]: {r['ms']:.4f} ms per launch, "
              f"plain version {plain}, bound "
              f"{r['bound_ms']:.2e} ms ({r['bound_by']})"
              + (f", torch.special.gammainc {r['library_ms']:.4f} ms "
                 "(values, as E2 at order 0)"
                 if "library_ms" in r else ""), flush=True)
    # the kernels line's row: M8's quantile step (no PyTorch call computes
    # I_x(a, b) or its inverse: library_ms null)
    r = rows["M8"]
    report["quantile"].update(
        max_abs_err_float64=worst, ms_float64=r["ms"],
        plain_ms_float64=r["plain_ms"], bound_ms_float64=r["bound_ms"],
        bound_by_float64=r["bound_by"], library_ms_float64=None,
        times=rows)


def reset_e2():
    from paml_tpu_torch.core import cuda_quantile as cq
    cq.LAUNCHES["quantile"] = 0


def graphed_against_eager(torch, tag, fit, build, card, phase="16b",
                          e2=True):
    """One fit from its objective's CUDA graph and one eagerly (`fit(kind)`
    builds the objective with `capturable` as `kind` says and fits it):
    the same x, lnL and evaluations bit for bit, one host sync per graphed
    evaluation (beside those of building the objective, `build()`, counted
    apart, and at most 8 more: the capture's copy of x, the result's
    read-back), no host second in the quantile code, E2 launched where
    `e2`; returns (graphed result, ms per evaluation graphed and eager,
    E2's launches in the graphed fit).  Phase 17 prints the graphed fit's
    syncs by source line."""
    from paml_tpu_torch.core import cuda_quantile as cq
    from paml_tpu_torch.core import dgamma

    setup = sum(sync_census(torch, build)[1].values())
    got = {}
    for kind in ("eager", "graph"):
        before, q0 = fit_counts(), dgamma.SECONDS["host"]
        reset_e2()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, counts = sync_census(torch, lambda: fit(kind))
        wall = time.perf_counter() - t0
        checks = {k: v - before[k] for k, v in fit_counts().items()}
        got[kind] = (res, wall, sum(counts.values()), checks,
                     dgamma.SECONDS["host"] - q0, cq.LAUNCHES["quantile"],
                     counts)
    (rg, wg, sg, cg, hg, lg, lines), (re_, we, se, ce, he, le, _) = (
        got["graph"], got["eager"])
    n = rg.fit.n_eval
    same = np.array_equal(rg.x, re_.x) and rg.lnL == re_.lnL
    print(f"{phase} {tag} [{card}]: lnL {rg.lnL:.6f}, graphed = eager bit for "
          f"bit {same}, evaluations {n} / {re_.fit.n_eval}; ms per "
          f"evaluation {1e3 * wg / n:.3f} graphed / "
          f"{1e3 * we / re_.fit.n_eval:.3f} dispatched; host syncs per "
          f"evaluation {(sg - setup) / n:.3f} / "
          f"{(se - setup) / re_.fit.n_eval:.3f} (the objective's set-up's "
          f"{setup} apart); host seconds "
          f"in the quantile code {hg} / {he}; E2 launches {lg} / {le}; counts "
          f"{cg} / {ce}", flush=True)
    bad = not same or n != re_.fit.n_eval or cg["captures"] != 1 or \
        cg["graphed_evals"] != n or cg["eager_evals"] or \
        ce["captures"] or ce["eager_evals"] != n or \
        sg - setup > n + 8 or hg or he or (e2 and not lg)
    if bad or phase != "16b":
        top = sorted(lines.items(), key=lambda kv: -kv[1])[:4]
        print(f"  {phase} syncs by line, graphed fit: "
              + ", ".join(f"{f}:{ln} {c}" for (f, ln), c in top), flush=True)
    if bad:
        raise AssertionError(f"{phase} {tag}: the graphed fit is not the "
                             "eager fit, not graphed, or not on E2")
    return rg, 1e3 * wg / n, 1e3 * we / re_.fit.n_eval, lg


def e2_m11_kink(torch, report, card):
    """16b: M11 at ncatG 10 and its start point on tests/data/clock56.codon
    (its tenth median target on the kink at omega = 1, ROADMAP C1) through
    E2 on the card against the host route on CPU tensors: the value within
    1e-8 relative, the gradient within 1e-6 relative of each component or
    1e-6 of the largest (the CPU tests' tolerance against the JAX
    package's) but p0's (x[-5]: the kink).  mu and sigma (x[-2], x[-1])
    move the value only through the tenth omega's landing just above 1,
    where the first Newton step's clamped pdf turns the last bits of F(1)
    into a step of about 1e-3 and the second lands about its square above
    the root, so their components are far below that tolerance and differ
    between the routes as the landings do: each route's are held within
    1e-3 of its own value's central differences (h = 1e-3), and the
    landings and the components' spread are printed."""
    import os
    from paml_tpu_torch import interop
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                     "data")
    aln = seqio.read_alignment(os.path.join(d, "clock56.codon"),
                               seqio.CODON_SEQ)
    data = seqio.pack(aln)
    topo = from_treenode(treeio.read_trees(os.path.join(
        d, "clock56.trees"), data.names)[0], data.names)
    spec = codeml.CodemlSpec(NSsites=11, ncatG=10)
    got = {}
    for dev in ("cuda", "cpu"):
        neg, _, _, x0, _, _ = codeml.make_codon_objective(data, topo, spec,
                                                         device=dev)
        xn = np.asarray(x0, float)
        x = interop.params_from(xn, device=dev).requires_grad_(True)
        v = neg(x)
        (g,) = torch.autograd.grad(v, x)
        fd = []
        with torch.no_grad():
            for i in (-2, -1):
                e = np.zeros_like(xn)
                e[i] = 1e-3
                fd.append(float(neg(interop.params_from(xn + e, device=dev))
                                - neg(interop.params_from(xn - e,
                                                          device=dev)))
                          / 2e-3)
            w = codeml._mixture_quantiles(
                11, interop.params_from(xn, device=dev)[-5:], 10)
        got[dev] = (float(v.detach()), g.detach().cpu().numpy(),
                    np.array(fd), float(w[-1]) - 1.0)
    (vc, gc, fc, lc), (vh, gh, fh, lh) = got["cuda"], got["cpu"]
    err_v = abs(vc - vh) / abs(vh)
    ok = np.abs(gc - gh) <= np.maximum(1e-6 * np.abs(gh),
                                       1e-6 * np.abs(gh).max())
    ok[-5] = np.isfinite(gc[-5])
    own = [float(np.abs(gr[-2:] - fr).max() / np.abs(fr).min())
           for gr, fr in ((gc, fc), (gh, fh))]
    spread = np.abs(gc[-2:] - gh[-2:]) / np.abs(gh[-2:])
    print(f"16b M11 ncatG 10 at x0 [{card}]: value {vc:.9f} (host route "
          f"{vh:.9f}, {err_v:.2e} relative), gradient but p0 within "
          f"{np.delete(np.abs(gc - gh), -5).max():.2e} of the host route's "
          f"(largest {np.abs(gh).max():.4g}); p0 {gc[-5]:.4f} (host "
          f"{gh[-5]:.4f}); mu, sigma {gc[-2]:.4e}, {gc[-1]:.4e} (host "
          f"{gh[-2]:.4e}, {gh[-1]:.4e}; {spread[0]:.3f}, {spread[1]:.3f} "
          f"of the host's apart), each route's within {own[0]:.2e} / "
          f"{own[1]:.2e} of its own central differences; the tenth omega "
          f"1 + {lc:.4e} (host 1 + {lh:.4e}, ratio {lc / lh:.4f})",
          flush=True)
    if not err_v <= 1e-8 or not ok.all() or not np.isfinite(gc).all() \
            or not max(own) <= 1e-3:
        raise AssertionError(f"16b M11 at its kink: value {err_v:.2e}, "
                             f"gradient entries {np.nonzero(~ok)[0]}, mu "
                             f"and sigma off their central differences by "
                             f"{own}")
    report["quantile"]["m11_kink"] = dict(
        value_rel=err_v, grad=gc.tolist(), host=gh.tolist(),
        fd_mu_sigma=fc.tolist(), host_fd_mu_sigma=fh.tolist(),
        omega10_minus_1=lc, host_omega10_minus_1=lh)


def e2_plain_lnl(torch, build, x):
    """-lnL of an objective (`build()`) at x through E2's plain versions on
    the card (`dgamma._e2` sent to them)."""
    from paml_tpu_torch import interop
    from paml_tpu_torch.core import cuda_quantile as cq
    from paml_tpu_torch.core import dgamma

    e2 = dgamma._e2
    dgamma._e2 = lambda t: cq.PLAIN if t.is_cuda else None
    try:
        neg = build()[0]
        with torch.no_grad():
            return float(neg(interop.params_from(np.asarray(x, float),
                                                 device="cuda")))
    finally:
        dgamma._e2 = e2


def e2_fits(torch, bench, report, card):
    """16b: M5, M7, M8 and M10 (ncatG = 10) on phase 4's clean alignment
    (B3/B4), an amino-acid LG + F + G4 fit with alpha free and a
    nucleotide REV + G5 fit with alpha free (simulated, 20 taxa): each
    from its CUDA graph against eagerly (`graphed_against_eager`)."""
    from paml_tpu_torch.apps import baseml, codeml
    from paml_tpu_torch.io import seqio, treeio
    from paml_tpu_torch.core.topology import from_treenode

    clean, _, topo, _ = bench
    launches = 0
    for name, ns in (("M5", 5), ("M7", 7), ("M8", 8), ("M10", 10)):
        spec = codeml.CodemlSpec(NSsites=ns, ncatG=10, codonf="F3x4")

        def build(spec=spec):
            return codeml.make_codon_objective(clean, topo, spec,
                                               device="cuda")

        def fit(kind, spec=spec, build=build):
            obj = build()
            obj[0].capturable = kind == "graph"
            return codeml.fit_packed(clean, topo, spec, device="cuda",
                                     objective=obj)
        res, msg, mse, n = graphed_against_eager(torch, f"{name} fit", fit,
                                                 build, card)
        report["quantile"][f"ms_per_eval_{name}"] = (msg, mse)
        launches += n
        # the fitted lnL against the same objective at the fitted x
        # through the plain versions
        lp = -e2_plain_lnl(torch, build, res.x)
        err = abs(res.lnL - lp) / abs(lp)
        print(f"16b {name} fit [{card}]: lnL {res.lnL:.9f} against "
              f"{lp:.9f} through the plain versions at its x ({err:.2e} "
              "relative)", flush=True)
        if not err <= 1e-9:
            raise AssertionError(f"16b {name}: the fitted lnL is {err:.2e} "
                                 "off the plain versions'")
    rng = np.random.default_rng(SEED + 16)
    names, rows, nwk = simulate_aa(torch, rng, 20, 2000, "cuda")
    data = seqio.pack(seqio.Alignment(names, rows, seqio.AA_SEQ))
    atopo = from_treenode(treeio.parse_newick(nwk), data.names)
    aspec = codeml.CodemlSpec(seqtype=2, aa_model="Empirical_F",
                              aa_rate_file="lg", fix_alpha=False, alpha=0.5,
                              ncatG=4)
    make = codeml.make_aa_objective

    def afit(kind):
        def made(*a, **kw):
            out = make(*a, **kw)
            out[0].capturable = kind == "graph"
            return out
        codeml.make_aa_objective = made
        try:
            return codeml.fit_packed(data, atopo, aspec, device="cuda")
        finally:
            codeml.make_aa_objective = make
    _, msg, mse, n = graphed_against_eager(
        torch, "aa LG + F + G4 fit", afit,
        lambda: make(data, atopo, aspec, device="cuda"), card)
    report["quantile"]["ms_per_eval_aa_G4"] = (msg, mse)
    launches += n
    names, rows, nwk, _, _ = simulate_nuc(torch, rng, 20, 5000, "cuda")
    data = seqio.pack(seqio.Alignment(names, rows, seqio.BASE_SEQ))
    ntopo = from_treenode(treeio.parse_newick(nwk), data.names)
    nspec = baseml.BasemlSpec(model="REV", ncatG=5, fix_alpha=False,
                              alpha=0.5)

    def nbuild():
        return baseml.make_objective(data, ntopo, nspec, device="cuda")

    def nfit(kind):
        obj = nbuild()
        obj[0].capturable = kind == "graph"
        return baseml.fit_packed(data, ntopo, nspec, device="cuda",
                                 objective=obj)
    res, msg, mse, n = graphed_against_eager(torch, "nucleotide REV + G5 "
                                             "fit, alpha free", nfit, nbuild,
                                             card)
    report["quantile"]["ms_per_eval_REV_G5"] = (msg, mse)
    report["quantile"]["launches_graph_quantile_fits"] = launches + n


def phase_quantile(torch, report, card, bench):
    """Phase 16: E2 (16a) and the fits it frees (16b); `bench` as phase
    13's, `report` holding a "quantile" entry."""
    t_phase = time.perf_counter()
    t = {}
    for tag, fn, args in (("16a", e2_kernels, (torch, report, card)),
                          ("16b", e2_fits, (torch, bench, report, card)),
                          ("16b M11", e2_m11_kink, (torch, report, card))):
        t0 = time.perf_counter()
        fn(*args)
        t[tag] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 16: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)


# --- phase 17: the rest of the compiled fits -----------------------------------

def with_flag(module, name, kind):
    """module.name (an objective's maker) wrapped so that the objectives it
    makes declare `capturable` as `kind` says ("graph" or "eager"); the
    wrapper's undo."""
    make = getattr(module, name)

    def made(*a, **kw):
        out = make(*a, **kw)
        out[0].capturable = kind == "graph"
        return out
    setattr(module, name, made)
    return lambda: setattr(module, name, make)


def labelled_clade(topo):
    """topo with #1 on the branches of the clade of about half the tips
    below the root (a local clock's second rate class)."""
    desc = topo.tip_descendants()
    v = min((n for n in range(topo.ns, topo.nnode) if n != topo.root),
            key=lambda n: abs(len(desc[n]) - topo.ns // 2))
    labels = topo.labels.copy()
    stack = [v]
    while stack:
        n = stack.pop()
        labels[n] = 1
        stack += [int(c) for c in topo.children[n] if c >= 0]
    return dataclasses.replace(topo, labels=labels)


def codon_clock_fits(torch, bench, report, card):
    """17a: codon M0 fits under clock 1 and clock 2 (a local clock on a
    clade of half the tips) on phase 4's 32 x 4096 alignment, clean (B3/B4)
    and gapped (B1/B2), each from its CUDA graph against eagerly; clock 2
    starts from clock 1's optimum with its class rate at 1 (from the
    objective's own start it takes some 1,700-1,900 evaluations, a third
    of the phase's time)."""
    from paml_tpu_torch.apps import codeml

    clean, gapped, topo, _ = bench
    for (route, pair), data in zip(GRAPH_ROUTES, (clean, gapped)):
        reset_all_launches()
        start = None
        for clock, tp in ((1, topo), (2, labelled_clade(topo))):
            spec = codeml.CodemlSpec(clock=clock, codonf="F3x4")

            def build(data=data, tp=tp, spec=spec, start=start):
                obj = codeml.make_codon_objective(data, tp, spec,
                                                  device="cuda")
                if start is None:
                    return obj
                lo, hi = np.array(obj[4]).T
                return obj[:3] + (np.clip(start, lo, hi),) + obj[4:]

            def fit(kind, data=data, tp=tp, spec=spec, build=build):
                obj = build()
                obj[0].capturable = kind == "graph"
                return codeml.fit_packed(data, tp, spec, device="cuda",
                                         objective=obj)
            res, _, _, _ = graphed_against_eager(
                torch, f"codon clock {clock} M0, {route}, {data.ns} x "
                f"{data.ls} codons" + (", from clock 1's optimum"
                                       if start is not None else ""),
                fit, build, card, phase="17a", e2=False)
            # clock 1's x: the time parameters, then kappa and omega
            start = np.concatenate([res.x[:-2], [1.0], res.x[-2:]])
        record_launches(report, f"launches_graph_clock_{route}",
                        pair + ("eigh",))


def aa_graph_fits(torch, rng, report, card):
    """17b: FromCodon and REVaa_0 + G4 fits on 20 simulated taxa x 2000
    amino acids (a cut of phase 8a's 100 x 50,000 alignment, for time),
    B3/B4 at 20 states, each from its CUDA graph against eagerly."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning, graphs
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio

    names, rows, nwk = simulate_aa(torch, rng, 20, 2000, "cuda")
    data = seqio.pack(seqio.Alignment(names, rows, seqio.AA_SEQ))
    topo = from_treenode(treeio.parse_newick(nwk), data.names)
    e2 = 0
    reset_all_launches()
    for tag, kw in (("FromCodon", dict(aa_model="FromCodon")),
                    ("REVaa_0 + G4", dict(aa_model="REVaa_0",
                                          fix_alpha=False, alpha=0.5,
                                          ncatG=4))):
        spec = codeml.CodemlSpec(seqtype=2, **kw)

        def fit(kind, spec=spec):
            undo = with_flag(codeml, "make_aa_objective", kind)
            try:
                return codeml.fit_packed(data, topo, spec, device="cuda")
            finally:
                undo()
        e2 += graphed_against_eager(
            torch, f"aa {tag}, {data.ns} x {data.ls} amino acids (cut)", fit,
            lambda spec=spec: codeml.make_aa_objective(data, topo, spec,
                                                       device="cuda"),
            card, phase="17b", e2="G4" in tag)[3]
    inst = {k: v for k, v in cuda_pruning.INSTANCE_LAUNCHES.items() if v}
    record_launches(report, "launches_graph_aa_fits",
                    ("big_fwd", "big_bwd", "eigh"))
    report["quantile"]["launches_graph_aa_fits"] = e2
    # the census of one replay of the REVaa_0 + G4 value + gradient: the
    # kernels by instance (their names carry N)
    neg, _, x0, _, _ = codeml.make_aa_objective(data, topo, spec,
                                                device="cuda")
    gv = graphs.GraphedValueGrad(neg, torch.as_tensor(x0).cuda())
    kern = graphs.replay_kernels(gv.graph)
    gv.close()
    print(f"17b census [{card}]: the fits' host launches by instance "
          f"{inst}; one replay of REVaa_0 + G4's value + gradient "
          f"{ {k: v for k, v in kern.items() if v} }", flush=True)
    want = {"big_fwd_n32": 1, "big_bwd_n32": 1, "big_fwd_n64": 0,
            "big_bwd_n64": 0, "pruning_fwd": 0, "pruning_bwd": 0}
    if any(kern[k] != v for k, v in want.items()) or \
            set(inst) != {"big_fwd_n32", "big_bwd_n32"}:
        raise AssertionError(f"17b: the amino-acid fits' kernels are not "
                             f"the N = 32 instances: {inst}, {kern}")


# (tag, spec, whether the fit runs E2)
NUC17 = (("REV + G5, clock 1", dict(model="REV", ncatG=5, fix_alpha=False,
                                    alpha=0.5, clock=1), True),
         ("UNREST", dict(model="UNREST"), False),
         ("HKY85 + AdG", dict(model="HKY85", ncatG=4, fix_alpha=False,
                              alpha=0.5, fix_rho=False, rho=0.4), True),
         ("HKY85 nparK 4", dict(model="HKY85", ncatG=3, nparK=4), False),
         ("HKY85 nhomo 1", dict(model="HKY85", nhomo=1), False))


def nuc_graph_fits(torch, rng, report, card):
    """17c: REV + G5 under clock 1, UNREST, AdG, nparK 4 and nhomo 1 on
    20 simulated taxa x 5000 sites (a cut of phase 7's 100 x 25,000,
    for time; phase 16's nucleotide shape) on the level route, each
    `optim.maximize` from the objective's x0 alone (`fit_packed`'s extra
    starts of nparK 4, seven in all, left out for time) from its CUDA
    graph against eagerly."""
    import types

    from paml_tpu_torch.apps import baseml
    from paml_tpu_torch.core import optim
    from paml_tpu_torch.core.topology import from_treenode
    from paml_tpu_torch.io import seqio, treeio

    names, rows, nwk, _, _ = simulate_nuc(torch, rng, 20, 5000, "cuda")
    data = seqio.pack(seqio.Alignment(names, rows, seqio.BASE_SEQ))
    topo = from_treenode(treeio.parse_newick(nwk), data.names)
    e2 = 0
    for tag, kw, with_e2 in NUC17:
        spec = baseml.BasemlSpec(**kw)
        maker = getattr(baseml, "make_nhomo_objective" if spec.nhomo
                        else "make_objective")

        def build(spec=spec, maker=maker):
            return maker(data, topo, spec, device="cuda")

        def fit(kind, build=build):
            neg, _, x0, bounds = build()
            neg.capturable = kind == "graph"
            r = optim.maximize(neg, x0, bounds, device="cuda")
            return types.SimpleNamespace(x=r.x, lnL=r.lnL, fit=r)
        e2 += graphed_against_eager(
            torch, f"nucleotide {tag}, {data.ns} x {data.ls} sites (cut), "
            "one start", fit, build, card, phase="17c", e2=with_e2)[3]
    report["quantile"]["launches_graph_nuc_fits"] = e2


def mcmctree_graphs(torch, rng, card):
    """17d: mcmctree's exact likelihood on a dated tree of 60 species x 8
    loci x 5000 sites (phase 10b's shape, HKY85 + G5): `lnL_all` from its
    CUDA graph against the same loci op by op at three proposals, bit for
    bit, and each `lnL_locus` from its own graph; ms per call both ways,
    the host syncs of graphed calls by source line, optim.GRAPHS."""
    from paml_tpu_torch.apps import mcmctree
    from paml_tpu_torch.core import optim
    from paml_tpu_torch.io import seqio, treeio

    names = [f"s{i}" for i in range(BV_TAXA)]
    joined = dated_tree(rng, names)
    rows, _, _ = simulate_dated(torch, rng, names, joined,
                                rng.uniform(0.3, 0.8, BV_LOCI),
                                [BV_SITES] * BV_LOCI)
    nwk = annotated_newick(names, joined, {joined[-1][2]: "B(0.9, 1.1)"})
    st = mcmctree.build_species_tree(treeio.parse_newick(nwk), names)
    loci = [seqio.pack(seqio.Alignment(names, r, seqio.BASE_SEQ),
                       cleandata=False) for r in rows]
    spec = mcmctree.McmcSpec(clock=2, usedata=1, alpha=0.5, ncatG=5)
    mc = mcmctree.MCMCTree(st, loci, spec, device="cuda")
    ex = mc._exact
    g0 = dict(optim.GRAPHS)
    same, prng = True, np.random.default_rng(SEED + 17)
    for _ in range(3):
        mc.kappa = prng.uniform(2, 6, mc.g)
        mc.alpha_g = prng.uniform(0.3, 1.5, mc.g)
        b = mc._branch_lengths_all()
        # the graphs lnL_all and lnL_locus replay, on the same inputs
        for rows in [None] + [[i] for i in range(mc.g)]:
            sl = slice(None) if rows is None else slice(rows[0],
                                                        rows[0] + 1)
            args = (b[sl], mc.kappa[sl], mc.alpha_g[sl])
            same &= np.array_equal(ex.lnl(*args, rows=rows),
                                   ex.lnl(*args, rows=rows, graphed=False))
        mc.lnL_all()
        mc.lnL_locus(0)
    counts = {k: v - g0[k] for k, v in optim.GRAPHS.items()}

    def ms(fn, reps=20):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts))
    b = mc._branch_lengths_all()
    t = dict(all_graph=ms(mc.lnL_all),
             all_eager=ms(lambda: ex.lnl(b, mc.kappa, mc.alpha_g,
                                         graphed=False)),
             locus_graph=ms(lambda: mc.lnL_locus(0)),
             locus_eager=ms(lambda: ex.lnl(b[:1], mc.kappa[:1],
                                           mc.alpha_g[:1], rows=[0],
                                           graphed=False)))
    _, lines = sync_census(torch, lambda: [mc.lnL_all() for _ in range(10)])
    per = sum(lines.values()) / 10
    top = sorted(lines.items(), key=lambda kv: -kv[1])[:3]
    print(f"17d mcmctree exact likelihood, {BV_TAXA} species x {mc.g} loci x"
          f" {BV_SITES} sites, HKY85 + G5 [{card}]: graphed = eager bit for "
          f"bit {same} (lnL_all and each lnL_locus at 3 proposals); ms per "
          f"lnL_all graphed {t['all_graph']:.3f}, dispatched "
          f"{t['all_eager']:.3f}; per lnL_locus {t['locus_graph']:.3f} / "
          f"{t['locus_eager']:.3f} (medians of 20); host syncs per graphed "
          f"lnL_all {per:.2f} ("
          + ", ".join(f"{f}:{ln} {c}" for (f, ln), c in top)
          + f"); optim.GRAPHS {counts}", flush=True)
    if not same or per != 1 or counts["captures"] != 1 + mc.g:
        raise AssertionError("17d: mcmctree's graphed likelihood is not the "
                             "eager one, or not one sync per call")
    return t


CAPTURE_FAILS17 = r"""
import sys
import numpy as np
import torch
from paml_tpu_torch.core import optim, pmat


def neg(x):
    Q = torch.stack([torch.stack([-x[0], x[0]]), torch.stack([x[1], -x[1]])])
    P = pmat.pmat_expm(Q, x.new_full((3,), 0.5))
    w = pmat.solve_small(Q + 2 * torch.eye(2, dtype=x.dtype, device=x.device),
                         x.new_ones(2))
    v = -torch.log(P[:, 0, 0]).sum() + (w * w).sum() + ((x - 1.0) ** 2).sum()
    return v + 0.0 * float(v.detach())  # a host read: no graph holds it
neg.capturable = True                  # declared capturable all the same
try:
    optim.maximize(neg, np.full(2, 0.5), [(0.1, 5.0)] * 2, device="cuda")
except RuntimeError as e:
    print(f"raised {type(e).__name__}: {str(e).splitlines()[0][:160]}; "
          f"counts {optim.GRAPHS}")
    sys.exit(0)
print("no error: the fit went on without its graph")
sys.exit(1)
"""


def failure_paths(torch, card):
    """17e: the status words and a failed capture.  An expm past its S_MAX
    and a singular solve, each inside a CUDA graph of a value + gradient,
    raise `DeviceStatusError` at the evaluation's one read (and op by op
    at once); a capture of an objective declared capturable that reads the
    host raises (in a process of its own, as 15f)."""
    import os

    from paml_tpu_torch.core import graphs, pmat

    x = torch.tensor([0.3, 0.7], dtype=torch.float64, device="cuda")

    def expm_fn(y):
        Q = torch.stack([torch.stack([-y[0], y[0]]),
                         torch.stack([y[1], -y[1]])])
        return pmat.pmat_expm(Q, y[:1] * 1e3, s_max=4).sum()

    def solve_fn(y):
        A = torch.stack([torch.stack([y[0], y[1]]),
                         torch.stack([2 * y[0], y[1] + y[1]])])
        return pmat.solve_small(A, y.new_ones(2), "singular test").sum()
    raised = {}
    for tag, fn, at in (("expm past S_MAX", expm_fn, [0.3, 0.7]),
                        ("singular solve", solve_fn, [0.3, 0.7])):
        got = []
        for how in ("graph", "eager"):
            try:
                if how == "graph":
                    gv = graphs.GraphedValueGrad(fn, x)
                    gv(np.asarray(at))
                    gv.close()
                else:
                    graphs.value_grad_eager(fn, np.asarray(at), "cuda")
                got.append(f"{how}: no error")
            except graphs.DeviceStatusError as e:
                got.append(f"{how}: {type(e).__name__} ({e})")
        raised[tag] = got
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", CAPTURE_FAILS17], cwd=root,
                       capture_output=True, text=True, timeout=300)
    print(f"17e failure paths [{card}]: "
          + "; ".join(f"{k}: {', '.join(v)}" for k, v in raised.items())
          + f"; a capture that fails (expm and solve beside a host read): "
          f"exit {r.returncode}, {r.stdout.strip()}", flush=True)
    if any("no error" in g for v in raised.values() for g in v) or \
            r.returncode:
        raise AssertionError(f"17e: a failure did not raise: {raised}\n"
                             f"{r.stdout}{r.stderr[-2000:]}")


def phase_more_graphs(torch, report, card, bench):
    """Phase 17: the rest of the compiled fits (17a-17e); `bench` as phase
    13's, `report` holding the kernel entries."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 170)
    t = {}
    for tag, fn, args in (
            ("17a", codon_clock_fits, (torch, bench, report, card)),
            ("17b", aa_graph_fits, (torch, rng, report, card)),
            ("17c", nuc_graph_fits, (torch, rng, report, card)),
            ("17d", mcmctree_graphs, (torch, rng, card)),
            ("17e", failure_paths, (torch, card))):
        t0 = time.perf_counter()
        fn(*args)
        t[tag] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 17: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 18: the pairwise programs' and clock 5 / 6's fits from CUDA graphs
# ---------------------------------------------------------------------------

PW_WINDOW = dict(wlen=100, offset=100)   # 18b: 10 windows over 1000 codons
PW_EAGER_PAIRS = 15                      # 18a's dispatched runs: the first
                                         # 15 pairs of each program (for
                                         # the script's time)


@contextlib.contextmanager
def dispatched():
    """Every fit in the block evaluated op by op (`optim.graphed` answers
    no): the eager run a graphed one is held to."""
    from paml_tpu_torch.core import optim
    saved = optim.graphed
    optim.graphed = lambda neg_fn, device: False
    try:
        yield
    finally:
        optim.graphed = saved


class _Enough(Exception):
    """A program stopped after the fits it was asked for."""


def run_fits(torch, module, fn, how, limit=None):
    """fn("cuda") once, `how` "graph" as the port runs it or "eager" with
    every fit dispatched; with `limit`, stopped after that many fits.
    Returns a namespace: its result (None if stopped), wall s, the fits
    (`module.maximize`'s results), `optim.GRAPHS`'s counts over the run
    and the host syncs by source line."""
    import types

    from paml_tpu_torch.core import optim

    before = dict(optim.GRAPHS)
    fits, real = [], module.maximize

    def maximize(*a, **kw):
        fits.append(real(*a, **kw))
        if len(fits) == limit:
            raise _Enough
        return fits[-1]

    def run():
        try:
            return fn("cuda")
        except _Enough:
            return None
    module.maximize = maximize
    try:
        with contextlib.ExitStack() as stack:
            if how == "eager":
                stack.enter_context(dispatched())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, lines = sync_census(torch, run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        module.maximize = real
    return types.SimpleNamespace(
        out=out, wall=wall, fits=fits, lines=lines,
        evals=sum(f.n_eval for f in fits),
        counts={k: v - before[k] for k, v in optim.GRAPHS.items()})


def same_fits(a, b):
    """b's fits (all of them, or the first ones where b was stopped) the
    same bits as a's first ones: x, lnL and evaluations, fit by fit."""
    return 0 < len(b.fits) <= len(a.fits) and all(
        np.array_equal(u.x, v.x) and u.lnL == v.lnL and u.n_eval == v.n_eval
        for u, v in zip(a.fits, b.fits))


def graph_syncs(run):
    """(host syncs in `GraphedValueGrad.__call__`, a graphed evaluation's
    copy back, per evaluation; the run's other syncs by source line, the
    largest first)."""
    from paml_tpu_torch.core import graphs
    span = _lines_of(graphs.GraphedValueGrad.__call__)
    inside = {k for k in run.lines
              if k[0].endswith("graphs.py") and k[1] in span}
    rest = sorted(((f"{f}:{ln}", c) for (f, ln), c in run.lines.items()
                   if (f, ln) not in inside), key=lambda kv: -kv[1])
    return sum(run.lines[k] for k in inside) / max(run.evals, 1), rest


def check_graphed(tag, g, e, captures):
    """A graphed run against its eager twin: the same fits bit for bit,
    every graphed evaluation from a graph, `captures` graphs in all, one
    host sync per graphed evaluation at the copy back."""
    per, _ = graph_syncs(g)
    bad = (not same_fits(g, e) or g.counts["eager_evals"]
           or g.counts["graphed_evals"] != g.evals
           or g.counts["captures"] != captures or e.counts["captures"]
           or e.counts["graphed_evals"] or per != 1.0)
    if bad:
        raise AssertionError(f"{tag}: graphed {g.counts} / eager "
                             f"{e.counts}, same fits {same_fits(g, e)}, "
                             f"syncs per evaluation {per}")


def start_point(torch, module, run, n):
    """The n-th objective that run() hands module.maximize (the earlier
    fits run), at its start x0: value + gradient from a CUDA graph (its
    capture timed, its pool measured as the memory reserved above what
    was before) against op by op, bit for bit, and both timed (medians of
    20).  Returns a dict."""
    from paml_tpu_torch.core import graphs

    got, real = [], module.maximize

    def stub(neg, x0, bounds=None, **kw):
        got.append((neg, np.asarray(x0, np.float64)))
        if len(got) == n:
            raise _Enough
        return real(neg, x0, bounds, **kw)
    module.maximize = stub
    try:
        run("cuda")
        raise AssertionError(f"the program made fewer than {n} fits")
    except _Enough:
        pass
    finally:
        module.maximize = real
    neg, x0 = got[-1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    gv = graphs.GraphedValueGrad(neg, torch.as_tensor(x0, device="cuda"))
    torch.cuda.synchronize()
    capture_ms = 1e3 * (time.perf_counter() - t0)
    pool = (torch.cuda.memory_reserved() - held) / 2 ** 30
    a, b = gv(x0), graphs.value_grad_eager(neg, x0, "cuda")

    def ms(fn, reps=20):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts))
    out = dict(same=bool(np.array_equal(a, b)), capture_ms=capture_ms,
               pool_gib=pool, graph_ms=ms(lambda: gv(x0)),
               eager_ms=ms(lambda: graphs.value_grad_eager(neg, x0, "cuda")))
    gv.close()
    if not out["same"]:
        raise AssertionError(f"start point: graphed {a} against eager {b}")
    return out


def pair_program(torch, work, tag, names, rows, runmode, fix_kappa=0,
                 limit=None, dispatch=True):
    """codeml runmode -2 / -3 from a control file through the program, in
    a directory of its own: graphed over every pair, and with `dispatch`
    dispatched over every pair or, with `limit`, the first ones
    (`run_fits`)."""
    import os

    from paml_tpu_torch import __main__ as cli
    from paml_tpu_torch.apps import pairwise

    d = os.path.join(work, tag)
    os.makedirs(d)
    with open(os.path.join(d, "seq.phy"), "w") as f:
        f.write(phylip(names, rows))
    with open(os.path.join(d, "codeml.ctl"), "w") as f:
        f.write(PW_CTL.format(runmode=runmode).replace(
            "fix_kappa = 0", f"fix_kappa = {fix_kappa}"))

    def program(dev):
        cwd = os.getcwd()
        os.chdir(d)
        try:
            return cli.main(["codeml", "codeml.ctl"])
        finally:
            os.chdir(cwd)
    runs = {"graph": run_fits(torch, pairwise, program, "graph")}
    if dispatch:
        runs["eager"] = run_fits(torch, pairwise, program, "eager", limit)
    return runs


def pair_line(tag, runs, per_fit, card, start, host=""):
    """18a / 18b's printed line for one program; `per_fit` fits make a
    pair (a window), `host` phase 9c's host-thread time of the same
    program."""
    from paml_tpu_torch.apps import pairwise

    g = runs["graph"]
    npair = len(g.fits) // per_fit
    per, rest = graph_syncs(g)
    ways = ", ".join(
        f"{how} {r.wall / (len(r.fits) // per_fit):.4f} s per pair over "
        f"{len(r.fits) // per_fit} ({1e3 * r.wall / r.evals:.3f} ms per "
        f"evaluation)" for how, r in runs.items())
    fill = set(_lines_of(pairwise._Slot.fill)) | set(
        _lines_of(pairwise._CodonPair.load))
    slot = sum(c for (f, ln), c in g.lines.items()
               if f.endswith("pairwise.py") and ln in fill)
    print(f"{tag} [{card}]: {npair} pairs, {g.evals} evaluations; {ways}"
          f"{host}; graphed = eager bit for bit (every fit the eager run made"
          f": x, lnL, evaluations; start point {start['same']}); "
          f"optim.GRAPHS graphed {g.counts}; host syncs per evaluation "
          f"{per:.3f} at the copy back, per pair "
          f"{sum(c for _, c in rest) / npair:.2f} beside ({slot / npair:.2f}"
          f" filling the slot; top "
          + ", ".join(f"{k} {c}" for k, c in rest[:4]) + "); capture "
          f"{start['capture_ms']:.1f} ms, pool {start['pool_gib']:.4f} GiB; "
          f"value + gradient at the start {start['graph_ms']:.3f} ms graphed"
          f" / {start['eager_ms']:.3f} dispatched", flush=True)


def pair_graphs(torch, work, pw, report, card):
    """18a: codeml -2 through the program on phase 9a's alignment at
    YN_TAXA x YN_CODONS (every pair, graphed), then at 9c's PW_ML_TAXA x
    PW_CODONS graphed and, over its first PW_EAGER_PAIRS pairs,
    dispatched (the host thread's time is 9c's); the same with
    `fix_kappa`, and aaml -2 (`pairwise.pairwise_aa` on the translated
    alignment)."""
    from paml_tpu_torch.apps import pairwise
    from paml_tpu_torch.io import seqio

    reset_all_launches()
    aln = pw["aln"]
    names = aln.names[:YN_TAXA]
    rows = [r[:3 * YN_CODONS] for r in aln.rows[:YN_TAXA]]
    full = pair_program(torch, work, "18a_full", names, rows, -2,
                        dispatch=False)["graph"]
    npair = len(full.fits)
    per, rest = graph_syncs(full)
    print(f"18a codeml -2, {YN_TAXA} taxa x {YN_CODONS} codons [{card}]: "
          f"{npair} pairs graphed in {full.wall:.2f} s "
          f"({full.wall / npair:.4f} s per pair, {full.evals} evaluations, "
          f"{1e3 * full.wall / full.evals:.3f} ms each); optim.GRAPHS "
          f"{full.counts}; host syncs per evaluation {per:.3f} at the copy "
          f"back, per pair {sum(c for _, c in rest) / npair:.2f} beside",
          flush=True)
    if full.counts["captures"] != 1 or full.counts["eager_evals"] or \
            per != 1.0 or npair != YN_TAXA * (YN_TAXA - 1) // 2:
        raise AssertionError(f"18a: the full-width run {full.counts}")
    names = aln.names[:PW_ML_TAXA]
    rows = [r[:3 * PW_CODONS] for r in aln.rows[:PW_ML_TAXA]]
    data = seqio.pack(seqio.Alignment(names, rows, seqio.CODON_SEQ),
                      cleandata=True)
    ml = pw["ml"]
    host = (f", host thread {ml['cpu_s'] / ml['pairs']:.4f} s per pair (9c,"
            f" {CPU_THREADS} thread)")
    for tag, fix_kappa in (("-2", 0), ("-2 fix_kappa", 1)):
        runs = pair_program(torch, work, f"18a{tag.replace(' ', '_')}",
                            names, rows, -2, fix_kappa, PW_EAGER_PAIRS)
        check_graphed(f"18a codeml {tag}", runs["graph"], runs["eager"], 1)
        start = start_point(torch, pairwise, lambda dev: pairwise.
                            pairwise_codon(data, fix_kappa=bool(fix_kappa),
                                           device=dev), 1)
        pair_line(f"18a codeml {tag}, {PW_ML_TAXA} taxa x {PW_CODONS} "
                  "codons", runs, 1, card, start, "" if fix_kappa else host)
    aa = seqio.pack(seqio.Alignment(
        names, seqio.translate_codon_rows(rows), seqio.AA_SEQ),
        cleandata=True)

    def aaml(dev):
        return pairwise.pairwise_aa(aa, device=dev)
    runs = {"graph": run_fits(torch, pairwise, aaml, "graph"),
            "eager": run_fits(torch, pairwise, aaml, "eager",
                              PW_EAGER_PAIRS)}
    check_graphed("18a aaml -2", runs["graph"], runs["eager"], 1)
    pair_line(f"18a aaml -2 (Empirical_F), {PW_ML_TAXA} taxa x {PW_CODONS} "
              "amino acids", runs, 1, card,
              start_point(torch, pairwise, aaml, 1))
    record_launches(report, "launches_graph_pairwise", ("eigh",))


def bayes_window_graphs(torch, work, pw, report, card):
    """18b: codeml -3 through the program at 9c's PW_BAYES_TAXA x
    PW_CODONS, graphed and dispatched (the host thread's time is 9c's);
    the sliding window (`pairwise.sliding_window_codon`, PW_WINDOW) on
    phase 9a's first pair x YN_CODONS, graphed and dispatched."""
    from paml_tpu_torch.apps import pairwise
    from paml_tpu_torch.io import seqio

    reset_all_launches()
    aln = pw["aln"]
    names = aln.names[:PW_BAYES_TAXA]
    rows = [r[:3 * PW_CODONS] for r in aln.rows[:PW_BAYES_TAXA]]
    runs = pair_program(torch, work, "18b-3", names, rows, -3)
    g = runs["graph"]
    npair = PW_BAYES_TAXA * (PW_BAYES_TAXA - 1) // 2
    # the ML fit's graph, and the MAP fit's where a pair takes it
    check_graphed("18b codeml -3", g, runs["eager"],
                  1 + (len(g.fits) > npair))
    if len(runs["eager"].fits) != len(g.fits):
        raise AssertionError("18b codeml -3: the eager run made other fits")
    data = seqio.pack(seqio.Alignment(names, rows, seqio.CODON_SEQ),
                      cleandata=True)
    by = pw["bayes"]
    print(f"18b codeml -3, {PW_BAYES_TAXA} taxa x {PW_CODONS} codons: "
          f"{len(g.fits) - npair} MAP fits; s per pair graphed "
          f"{g.wall / npair:.4f}, dispatched {runs['eager'].wall / npair:.4f}"
          f", host thread {by['cpu_s'] / by['pairs']:.4f} (9c); each pair's"
          f" curvature and grid eager, as in the JAX package", flush=True)
    pair_line("  18b codeml -3 (a pair here is one fit)", runs, 1, card,
              start_point(torch, pairwise, lambda dev: pairwise.
                          bayes_pairwise_codon(data, device=dev), 1))
    pair = seqio.pack(seqio.Alignment(
        aln.names[:2], [r[:3 * YN_CODONS] for r in aln.rows[:2]],
        seqio.CODON_SEQ), cleandata=True)

    def window(dev):
        return pairwise.sliding_window_codon(pair, device=dev, **PW_WINDOW)
    runs = {how: run_fits(torch, pairwise, window, how)
            for how in ("graph", "eager")}
    check_graphed("18b sliding window", runs["graph"], runs["eager"], 2)
    if len(runs["eager"].fits) != len(runs["graph"].fits):
        raise AssertionError("18b sliding window: the eager run made other "
                             "fits")
    pair_line(f"18b sliding window, 1 pair x {YN_CODONS} codons, windows of "
              f"{PW_WINDOW['wlen']} every {PW_WINDOW['offset']} (a pair here"
              " is a window: two fits)", runs, 2, card,
              start_point(torch, pairwise, window, 2))
    record_launches(report, "launches_graph_bayes_window", ("eigh",))


def clock56_graphs(torch, dating, report, card):
    """18c: clock 5 on 10d's codon loci, clean (B3/B4) and gapped (B1/B2),
    and on its nucleotide loci, with HKY85 and with HKY85 + G4 (alpha
    free, E2), each from its CUDA graph against eagerly
    (`graphed_against_eager`), and value + gradient at each fit's start
    timed both ways (a fit of fewer than 10 evaluations is said so); then
    clock 6 on the nucleotide loci, every step graphed against every step
    dispatched (one capture per fit; step 1's Hessians, eager and not
    bit-reproducible on the card, replayed from the graphed run into the
    eager one)."""
    import os
    import types

    from paml_tpu_torch.apps import clock56
    from paml_tpu_torch.core import cuda_quantile as cq
    from paml_tpu_torch.io import seqio

    def jobs():
        for route, pair in GRAPH_ROUTES:
            d = dating[f"codon_{route}"]["dir"]
            yield (f"codon clock 5, {route}, {C56_CODON_LOCI} loci x "
                   f"{C56_CODON_TAXA} species x {C56_CODONS} codons (F3x4)",
                   d, seqio.CODON_SEQ, C56_CODON_LOCI,
                   dict(codonf="F3x4"), pair + ("eigh",), route)
        d = dating["clock5"]["dir"]
        for tag, kw in (("HKY85", {}),
                        ("HKY85 + G4", dict(ncatG=4, fix_alpha=False,
                                            alpha=0.5))):
            yield (f"nucleotide clock 5, {tag}, {C56_LOCI} loci x {C56_TAXA}"
                   f" species x {C56_SITES} sites", d, seqio.BASE_SEQ,
                   C56_LOCI, dict(model="HKY85", **kw), (), None)

    for tag, d, seqtype, nloci, kw, keys, route in jobs():
        hd = clock56.read_tree_seqs(os.path.join(d, "tree.nwk"),
                                    os.path.join(d, "seq.txt"), nloci,
                                    seqtype=seqtype)
        spec = clock56.Clock56Spec(clock=5, seqtype=seqtype,
                                   **{"ncatG": 1, **kw})
        labels = [np.zeros(gt.topo.nnode, dtype=np.int64)
                  for gt in hd.loci]

        def build(hd=hd, spec=spec, labels=labels):
            return clock56.make_step3_objective(hd, spec, labels,
                                                [1] * len(hd.loci),
                                                device="cuda")

        def fit(kind, hd=hd, spec=spec):
            undo = with_flag(clock56, "make_step3_objective", kind)
            try:
                r = clock56.fit_clock5(hd, spec, device="cuda")
            finally:
                undo()
            return types.SimpleNamespace(x=r.fit.x, lnL=r.lnL, fit=r.fit)
        reset_all_launches()
        reset_e2()
        e2 = spec.ncatG > 1
        res = graphed_against_eager(torch, tag, fit, build, card,
                                    phase="18c", e2=e2)[0]
        if keys:
            record_launches(report, f"launches_graph_clock5_{route}", keys)
        if e2:
            report["quantile"]["launches_graph_clock5"] = \
                cq.LAUNCHES["quantile"]
        start = start_point(torch, clock56, lambda dev, hd=hd, spec=spec:
                            clock56.fit_clock5(hd, spec, device=dev), 1)
        short = (f"the fit stops after {res.fit.n_eval} evaluations "
                 "(ROADMAP C); " if res.fit.n_eval < 10 else "")
        print(f"  18c {tag}: {short}value + gradient at the start "
              f"{start['graph_ms']:.3f} ms graphed / "
              f"{start['eager_ms']:.3f} dispatched (medians of 20), bit for "
              f"bit {start['same']}; capture {start['capture_ms']:.1f} ms, "
              f"pool {start['pool_gib']:.4f} GiB", flush=True)
    # clock 6: step 1's per-locus fits and Hessians, the AHRS smoothing,
    # step 3
    d = dating["clock6"]["dir"]
    hd = clock56.read_tree_seqs(os.path.join(d, "tree.nwk"),
                                os.path.join(d, "seq.txt"), C56_LOCI)
    spec = clock56.Clock56Spec(clock=6, model="HKY85", ncatG=1)

    def clock6(dev):
        return clock56.fit_clock6(hd, spec, device=dev)
    runs = {how: run_fits(torch, clock56, clock6, how)
            for how in ("graph", "eager")}
    g, e = runs["graph"], runs["eager"]
    check_graphed("18c clock 6", g, e, C56_LOCI + 2)
    rg, re_ = g.out, e.out
    same = (rg.lnL == re_.lnL and np.array_equal(rg.ages, re_.ages)
            and rg.step2["objective"] == re_.step2["objective"])
    if not same:
        raise AssertionError("18c clock 6: graphed and eager results differ")
    per, rest = graph_syncs(g)
    print(f"18c nucleotide clock 6, {C56_LOCI} loci x {C56_TAXA} species x "
          f"{C56_SITES} sites, HKY85 [{card}]: lnL {rg.lnL:.6f}, graphed = "
          f"eager bit for bit {same} ({len(g.fits)} fits: "
          + ", ".join(str(f.n_eval) for f in g.fits) + " evaluations); "
          f"s {g.wall:.2f} graphed / {e.wall:.2f} dispatched, ms per "
          f"evaluation {1e3 * g.wall / g.evals:.3f} / "
          f"{1e3 * e.wall / e.evals:.3f} (step 1's Hessians included); "
          f"optim.GRAPHS {g.counts}; host syncs per evaluation {per:.3f} at "
          f"the copy back; top others "
          + ", ".join(f"{k} {c}" for k, c in rest[:4]) + "; step 1's "
          f"Hessians (eager, outside the graphs, PyTorch's deterministic "
          f"algorithms) recomputed in each run", flush=True)


def phase_pair_graphs(torch, report, card, pw, dating):
    """Phase 18: the pairwise programs' fits from one CUDA graph per
    program and x-length (18a, 18b) and clock 5 / 6's from one per fit
    (18c); `pw` phase 9's summary (9a's alignment, 9c's host-thread
    times), `dating` phase 10d's runs (their directories)."""
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pairgraphs_")
    t = {}
    for tag, fn, args in (
            ("18a", pair_graphs, (torch, work, pw, report, card)),
            ("18b", bayes_window_graphs, (torch, work, pw, report, card)),
            ("18c", clock56_graphs, (torch, dating, report, card))):
        t0 = time.perf_counter()
        fn(*args)
        t[tag] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 18: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)


def tangent_checks(torch, route, P, tips, topo, pi, gz, g, D, card):
    """H1 and H2 (`cuda_pruning.ClassSiteLnfKernelTwice.tan_fwd` /
    `tan_bwd`) on the card against their plain versions on the same
    inputs, D random directions (Pdot, pidot) and gdot from the generator
    g, gbar = gz: max |diff| of each, the directions for the timings, S,
    Sd, the gapped tip tables' max |diff| and each kernel's max |diff|
    over its largest plain value."""
    from paml_tpu_torch.core import cuda_pruning as cp, pruning

    nnode, C, n = P.shape[0], P.shape[1], P.shape[-1]
    f64 = dict(dtype=torch.float64, device="cuda")
    Pd = torch.tensor(g.normal(0.0, 0.1, (D, nnode, C, n, n)), **f64)
    pid = torch.tensor(g.normal(0.0, 0.01, (D, C, n)), **f64)
    gd = torch.tensor(g.normal(0.0, 1.0, (D,) + tuple(gz.shape)), **f64) \
        * gz.abs().max()
    r = cp.ClassSiteLnfKernelTwice(P, tips, topo, pi)
    lnfd = r.tan_fwd(Pd, pid)
    Sd, TA = r.Sd, r.TA
    dPd, dpid = r.tan_bwd(gz, gd)
    torch.cuda.synchronize()
    tol = TOL["float64"]
    # the tip tables H1 built (tip_table_kernel over the directions; coded
    # tips with ambiguity alone)
    e_ta = None if TA is None else max_err(
        TA, cp.tip_tables_plain(r.x.P, cp._tan_dirs(r.x, Pd, pid)[0],
                                r.x.amb, r.x.ns),
        tol["val"], f"19 H1 tip tables {route}")
    del TA
    lnfd_r, Sd_r = pruning.class_site_lnf_tan_plain(P, tips, topo, pi, Pd,
                                                    pid)
    errs = [(max_err(got, ref, tol[k], f"19 {what} {route}"),
             float(ref.abs().max()))
            for got, ref, k, what in ((lnfd, lnfd_r, "val", "H1 lnfd"),
                                      (Sd, Sd_r, "val", "H1 Sd"))]
    del lnfd_r, Sd_r
    dPd_r, dpid_r = pruning.class_site_lnf_bwd_tan_plain(P, tips, topo, pi,
                                                         gz, Pd, pid, gd)
    errs += [(max_err(got, ref, tol["grad"], f"19 {what} {route}"),
              float(ref.abs().max()))
             for got, ref, what in ((dPd, dPd_r, "H2 dPd"),
                                    (dpid, dpid_r, "H2 dpid"))]
    del dPd_r, dpid_r
    # max |diff| of H1 and H2, and each over the largest |plain value|
    e1, e2 = max(e for e, _ in errs[:2]), max(e for e, _ in errs[2:])
    r1 = max(e / m for e, m in errs[:2])
    r2 = max(e / m for e, m in errs[2:])
    return e1, e2, (Pd, pid, gd), r.S, Sd, e_ta, (r1, r2)


def tan_grids(torch, topo, C, H, n, D):
    """The tangents' grids on this card at these shapes: (G, Z) of H1 and
    (G, Z, TV) of H2 (`cuda_pruning.tan_grid`, `tan_bwd_grid`), and the
    card's SM count and N."""
    from paml_tpu_torch.core import cuda_pruning as cp

    props = torch.cuda.get_device_properties(0)
    sms, npad = props.multi_processor_count, cp.padded_states(n)
    tb = cp.big_tree(topo)
    ntiles = cp.big_tiles(H)
    return (cp.tan_grid(ntiles, C, D, sms, npad),
            cp.tan_bwd_grid(tb.nnode, C, D, ntiles, 8, sms,
                            props.total_memory, cp.full_plan(tb).nslots,
                            npad), sms, npad)


def tangent_shapes(torch, route, data, topo, neg, P, pi, gz, g, card):
    """H1 and H2 against their plain versions (`tangent_checks`) where the
    grid differs from M2a's at the bench shape: M8's 11 classes there
    (12 tile ranges of 10-11 tiles, so an H2 block visits its range twice
    and adds its second visit to its slabs), and a chunk of 86 patterns
    (3 tiles, the last one partial) at `codeml.HESSIAN_ROWS` directions,
    where the directions split into groups of unequal size."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning as cp

    spec = codeml.CodemlSpec(NSsites=8, ncatG=10, codonf="F3x4")
    neg8, _, _, x8, _, _ = codeml.make_codon_objective(data, topo, spec,
                                                       device="cuda")
    with torch.no_grad():
        P8, pi8, w8 = neg8.model_at(torch.as_tensor(
            np.asarray(x8, float), dtype=torch.float64, device="cuda"))
    P8, pi8 = P8.contiguous(), pi8.contiguous()
    gz8 = codeml._mixture(cp.ClassSiteLnfKernelTwice(
        P8, neg8.tips, topo, pi8).lnf, w8, neg8.fpatt)[2].detach()
    hc = 86
    cases = (("M8", P8, cp.kernel_tips(neg8.tips), pi8, gz8, 4),
             (f"M2a, {hc} patterns",
              P, codeml._pattern_slice(cp.kernel_tips(neg.tips),
                                       slice(0, hc)),
              pi, gz[:, :hc].contiguous(), codeml.HESSIAN_ROWS))
    for tag, P_, tips, pi_, gz_, D in cases:
        C, n, H = P_.shape[1], P_.shape[-1], gz_.shape[1]
        (G1, Z1), (G, Z, TV), sms, npad = tan_grids(torch, topo, C, H, n, D)
        ntiles = cp.big_tiles(H)
        span = -(-ntiles // G)
        e1, e2, _, _, _, e_ta, (r1, r2) = tangent_checks(
            torch, f"{route} {tag}", P_, tips, topo, pi_, gz_, g, D, card)
        print(f"19 {route} {tag} ({C} classes x {H} patterns = {ntiles} "
              f"tiles, {D} directions) [{card}]: H1 grid {G1} x {C} x {Z1}"
              f", H2 grid G {G} x {C} x Z {Z}, visits of TV {TV} tiles, "
              f"{-(-span // TV)} visits a block; H1 max |diff| {e1:.3e} "
              f"({r1:.3e} of its largest value), H2 {e2:.3e} ({r2:.3e})"
              + ("" if e_ta is None else f", tip tables {e_ta:.3e}")
              + " against the plain versions", flush=True)
        reach = -(-span // TV) >= 2 if tag == "M8" else min(Z1, Z) >= 2
        if not reach:
            raise AssertionError(f"19 {route} {tag}: the grid ({G} x {C} x "
                                 f"{Z}, TV {TV}) does not reach the path "
                                 f"it is here to check")
        torch.cuda.empty_cache()


# M2a's Hessian (codeml.hessian on the card) as the first of a fresh process:
# argv[1] a pickle of (packed data, topology, x), argv[2] the .npy to write
FIRST_HESSIAN = r'''
import pickle, sys
import numpy as np
from paml_tpu_torch import _build
from paml_tpu_torch.apps import codeml
with open(sys.argv[1], "rb") as f:
    data, topo, x = pickle.load(f)
_build.lib()
neg = codeml.make_codon_objective(
    data, topo, codeml.CodemlSpec(NSsites=2, codonf="F3x4"),
    device="cuda")[0]
np.save(sys.argv[2], codeml.hessian(neg, x, device="cuda"))
'''


def first_hessian(data, topo, x) -> np.ndarray:
    """M2a's Hessian at x as a fresh process's first (`FIRST_HESSIAN`), on
    copies of the data and the topology without their cached device
    tables."""
    import os
    import pickle
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        pkl, npy = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "H.npy")
        with open(pkl, "wb") as f:
            pickle.dump((dataclasses.replace(data), dataclasses.replace(topo),
                         np.asarray(x, float)), f)
        r = subprocess.run([sys.executable, "-c", FIRST_HESSIAN, pkl, npy],
                           cwd=root, capture_output=True, text=True,
                           timeout=300)
        if r.returncode:
            raise AssertionError(f"19: the fresh process's Hessian exited "
                                 f"{r.returncode}:\n{r.stderr[-3000:]}")
        return np.load(npy)


def phase_hessian(torch, report, card, bench):
    """19. The Hessian's kernels: H1 and H2 (csrc/pruning_tangent.cuh) at
    the bench shape (32 taxa x 4096 codons, M2a's 3 classes at its fitted
    x, float64), on state codes (the B3/B4 walk) and on the gapped data
    (B1/B2's coded tips): each against its plain version (4 directions,
    1e-10 and 1e-8), timed at 4 and at `codeml.HESSIAN_ROWS` directions
    (medians of 5) beside its bound, with each grid's blocks, blocks per
    SM and waves; the gapped data's tip tables against their plain
    version; H1 and H2 against the plain versions where the grid takes
    other paths (`tangent_shapes`: M8's H2 blocks visit their tiles twice,
    a small chunk splits the directions); then M2a's Hessian by the kernels against the plain route
    (`codeml._hessian_twice`) on the card, twice, bit for bit, and bit for
    bit against a fresh process's first (`first_hessian`)."""
    from paml_tpu_torch.apps import codeml
    from paml_tpu_torch.core import cuda_pruning as cp, pruning

    t_phase = time.perf_counter()
    clean, gapped, topo, fitted = bench
    spec = codeml.CodemlSpec(NSsites=2, codonf="F3x4")
    g = np.random.default_rng(SEED + 19)
    for route, data in (("clean", clean), ("gapped", gapped)):
        neg = codeml.make_codon_objective(data, topo, spec,
                                          device="cuda")[0]
        x = fitted[route]["M2a"].x
        xt = torch.as_tensor(x, dtype=torch.float64, device="cuda")
        with torch.no_grad():
            P, piC, w = neg.model_at(xt)
        P, pi = P.contiguous(), piC.contiguous()
        route_k = cp.ClassSiteLnfKernelTwice(P, neg.tips, topo, pi)
        gz = codeml._mixture(route_k.lnf, w, neg.fpatt)[2].detach()
        del route_k
        tips = cp.kernel_tips(neg.tips)
        fused = isinstance(tips, cp.TipCodes)
        n_amb = n_amb_of(tips)
        C, n, H = P.shape[1], P.shape[-1], gz.shape[1]
        e1, e2, (Pd, pid, gd), S, Sd, e_ta, _ = tangent_checks(
            torch, route, P, tips, topo, pi, gz, g, 4, card)
        fwd, bwd = (cp.pruning_tan_fwd, cp.pruning_tan_bwd) if fused else \
            (cp.pruning_big_tan_fwd, cp.pruning_big_tan_bwd)
        rows = {}
        for D in (4, codeml.HESSIAN_ROWS):
            Pd_, pid_, gd_ = (t[:D] if D <= 4 else
                              t[torch.arange(D, device="cuda") % 4]
                              for t in (Pd, pid, gd))
            Sd_ = fwd(P, tips, topo, pi, Pd_, pid_, S)[1]
            ms_f = cuda_ms_median(lambda: fwd(P, tips, topo, pi, Pd_, pid_,
                                              S))
            ms_b = cuda_ms_median(lambda: bwd(P, tips, topo, pi, gz, Pd_,
                                              pid_, gd_, S, Sd_))
            grid_f, (G, Z, TV), sms, npad = tan_grids(torch, topo, C, H, n,
                                                      D)
            tb = cp.big_tree(topo)
            b_f = cp.tan_work("tan_fwd", tb, C, H, n, 8, D, n_amb)
            b_b = cp.tan_work("tan_bwd", tb, C, H, n, 8, D, n_amb, G)
            grids = [f"{g_ * C * z_} blocks ({g_} tile ranges x {C} classes "
                     f"x {z_} direction groups{tv}), "
                     f"{cp.tan_blocks_per_sm(npad)} a SM, "
                     f"{cp.tan_waves(g_, C, z_, sms, npad):.3f} waves"
                     for g_, z_, tv in ((*grid_f, ""),
                                        (G, Z, f", visits of {TV} tiles"))]
            rows[D] = dict(ms=(ms_f, ms_b), G=G, grids=grids, bound=tuple(
                (cp.bound_ms(*b), "operations" if b[0] / cp.PEAK_FLOPS
                 >= b[1] / cp.PEAK_BYTES else "bytes") for b in (b_f, b_b)))
            del Sd_
        plain_ms = (
            cuda_ms_median(lambda: pruning.class_site_lnf_tan_plain(
                P, tips, topo, pi, Pd, pid), reps=3),
            cuda_ms_median(lambda: pruning.class_site_lnf_bwd_tan_plain(
                P, tips, topo, pi, gz, Pd, pid, gd), reps=3))
        for i, name in enumerate(("tan_fwd", "tan_bwd")):
            rk = report[name]
            sfx = "" if route == "clean" else "_gapped"
            rk[f"max_abs_err_float64{sfx}"] = (e1, e2)[i]
            record(report, name, f"float64{sfx}", rows[4]["ms"][i],
                   plain_ms[i], rows[4]["bound"][i])
            rk[f"ms_float64_d{codeml.HESSIAN_ROWS}{sfx}"] = \
                rows[codeml.HESSIAN_ROWS]["ms"][i]
            rk[f"bound_ms_float64_d{codeml.HESSIAN_ROWS}{sfx}"] = \
                rows[codeml.HESSIAN_ROWS]["bound"][i][0]
        print(f"19 {route} ({'B1/B2' if fused else 'B3/B4'} walk; {topo.ns} "
              f"taxa x {H} patterns x {C} classes x {n} states, "
              f"{n_amb} ambiguity rows) [{card}]: H1 max |diff| {e1:.3e}, "
              f"H2 {e2:.3e}"
              + ("" if e_ta is None else f", tip tables {e_ta:.3e}")
              + " against the plain versions (4 directions); "
              + "; ".join(
                  f"{D} directions: H1 {r['ms'][0]:.3f} ms (bound "
                  f"{r['bound'][0][0]:.3f}, {r['bound'][0][1]}, share "
                  f"{r['bound'][0][0] / r['ms'][0]:.3f}; {r['grids'][0]}), "
                  f"H2 {r['ms'][1]:.3f} ms (G {r['G']}, bound "
                  f"{r['bound'][1][0]:.3f}, {r['bound'][1][1]}, share "
                  f"{r['bound'][1][0] / r['ms'][1]:.3f}; {r['grids'][1]})"
                  for D, r in rows.items())
              + f"; plain versions at 4 directions {plain_ms[0]:.1f} / "
              f"{plain_ms[1]:.1f} ms (medians of 3)", flush=True)
        del Pd, pid, gd, S, Sd
        torch.cuda.empty_cache()
        tangent_shapes(torch, route, data, topo, neg, P, pi, gz, g, card)
        # the Hessian of M2a at its MLE: the kernels against the plain
        # route, and the kernels twice
        reset_counts()
        t0 = time.perf_counter()
        Hk = codeml.hessian(neg, x, device="cuda")
        tk = time.perf_counter() - t0
        counts = read_counts()
        if counts["twice"] or counts["plain"] or not (
                counts["launches"]["tan_fwd"] and
                counts["launches"]["tan_bwd"]):
            raise AssertionError(f"19 {route}: the Hessian's route launched "
                                 f"{counts['launches']}, plain level passes "
                                 f"{counts['twice']}, plain calls "
                                 f"{counts['plain']}")
        Hk2 = codeml.hessian(neg, x, device="cuda")
        t0 = time.perf_counter()
        Ht = codeml._hessian_twice(neg, torch.tensor(
            x, dtype=torch.float64, device="cuda",
            requires_grad=True)).cpu().numpy()
        tt = time.perf_counter() - t0
        rel = float(np.abs(Hk - Ht).max() / np.abs(Ht).max())
        same = bool(np.array_equal(Hk, Hk2))
        t0 = time.perf_counter()
        H0 = first_hessian(data, topo, x)
        t0 = time.perf_counter() - t0
        first = bool(np.array_equal(H0, Hk))
        print(f"19 {route}: M2a's Hessian ({len(x)} parameters) by the "
              f"kernels {tk:.2f} s (launches {counts['launches']}), by the "
              f"plain route {tt:.2f} s; max |diff| / max |H| {rel:.3e} "
              f"(limit 1e-8); the kernels twice bit for bit {same}; a fresh "
              f"process's first Hessian ({t0:.1f} s with its start) bit for "
              f"bit {first} (max |diff| {np.abs(H0 - Hk).max():.3e})",
              flush=True)
        if not rel <= 1e-8 or not same or not first or \
                not np.isfinite(Hk).all():
            raise AssertionError(f"19 {route}: the Hessian by the kernels "
                                 f"differs from the plain route by {rel:.3e}"
                                 f" of its largest entry, or does not "
                                 f"repeat (bit for bit {same}; a fresh "
                                 f"process's first {first})")
        report["tan_fwd"][f"hessian_seconds_{route}"] = (tk, tt)
    print(f"19: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    t_start = time.perf_counter()
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
    # the float64 P(t)'s eigensolver, which replaces XLA's eigh (not a TPU
    # kernel) on the card
    report["eigh"] = {"name": "eigh", "route": "cuda",
                      "source": "paml_tpu_torch/csrc/eigh.cu",
                      "replaces": "paml_tpu/core/pmat.py:90"}
    # E2, the quantile code (the XLA-compiled incomplete beta / gamma
    # functions, their inverses, the mixtures' quantiles; not a TPU kernel)
    report["quantile"] = {"name": "quantile", "route": "cuda",
                          "source": "paml_tpu_torch/csrc/quantile.cu",
                          "replaces": "paml_tpu/core/dgamma.py:16"}
    # H1 / H2, the tangents of the walk that carry the Hessians (getSE):
    # jax.hessian differentiates the level pass's custom_vjp rules, forward
    # (its tangent H1) and adjoint (H2); not TPU kernels
    for name, line in (("tan_fwd", 205), ("tan_bwd", 215)):
        report[name] = {"name": name, "route": "cuda",
                        "source": "paml_tpu_torch/csrc/pruning_tangent.cuh",
                        "replaces": f"paml_tpu/core/pruning.py:{line}"}
    phase_kernels(torch, rng, report, smi[0])
    # 3b. the large-tree kernels against their plain versions
    phase_big_kernels(torch, rng, report, smi[0])
    # 4. the M0 / M2a path (B3/B4 on clean data, B1/B2 on gapped data)
    bench = phase_slice(torch, rng, report, smi[0])
    # 5. the branch-site path at 1024 taxa (B3/B4)
    big = phase_branch_site(torch, rng, report, smi[0])
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
    pw = phase_pairwise(torch, rng, report, smi[0])
    torch.cuda.empty_cache()
    # 10. mcmctree, in.BV, the MCMC utilities, clock 5 / 6 (B1-B4 on codons)
    dating = phase_dating(torch, rng, report, smi[0])
    torch.cuda.empty_cache()
    # 11. tree search (B1-B4 for codons, the level route for nucleotides)
    phase_search(torch, rng, report, smi[0])
    torch.cuda.empty_cache()
    # 12. the pattern axis over two shards, two ranks and a NCCL group
    phase_mesh(torch, rng, report, smi[0], big)
    torch.cuda.empty_cache()
    # 13. the float32 path: P(t), objectives, fits, the device L-BFGS
    phase_f32(torch, report, smi[0], bench, big)
    torch.cuda.empty_cache()
    # 14. the port's bench: the graph-captured primary step, 1024 taxa
    phase_bench(torch, report, smi[0])
    # 15. CUDA graphs: the eigensolver, value + gradient, fits, device L-BFGS
    phase_graphs(torch, report, smi[0], bench, big)
    del big
    torch.cuda.empty_cache()
    # 16. E2: the quantile code on the card, and the fits it lets graph
    phase_quantile(torch, report, smi[0], bench)
    torch.cuda.empty_cache()
    # 17. the rest of the compiled fits: clocks, FromCodon / REVaa, AdG,
    # nparK 4, UNREST, nhomo, mcmctree's exact likelihood
    phase_more_graphs(torch, report, smi[0], bench)
    torch.cuda.empty_cache()
    # 18. the pairwise programs' fits, one CUDA graph per program, and
    # clock 5 / 6's, one per fit
    phase_pair_graphs(torch, report, smi[0], pw, dating)
    torch.cuda.empty_cache()
    # 19. the Hessian's kernels H1 / H2 against their plain versions, timed,
    # and M2a's Hessian by them against the plain route
    phase_hessian(torch, report, smi[0], bench)
    print(f"chip_smoke: the build and phases 3-19 in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = []
    for r in report.values():
        # the main paths' launches, each path counted from 0 (M0/M2a fits
        # on clean and gapped data, the branch-site fits, the program on
        # clean and gapped data; phase 9's programs, which launch none;
        # phase 10's codon clock 5 fits; phase 11's codon tree searches;
        # phase 12's fit on the mesh; phase 13's float32 value + gradient,
        # fits and device fits, `launches_f32_*`, and the float64 device
        # fit; phase 14's bench, a CUDA graph's launches counted once;
        # phase 15's graphed paths, `launches_graph_*`: their host launches,
        # the warm-ups' and the captures' with the eager comparisons, and
        # so phases 17 and 18's; E2's from phase 6's programs and phase 16,
        # 17 and 18's fits; H1 / H2's from phase 6's programs' Hessians)
        r["launches"] = sum(v for k, v in r.items()
                            if k.startswith("launches_"))
        r["max_abs_err"] = r["max_abs_err_float64"]
        r["ms"] = r["ms_float64"]
        r["plain_ms"] = r["plain_ms_float64"]
        r["bound_ms"] = r["bound_ms_float64"]
        r["bound_by"] = r["bound_by_float64"]
        # no single PyTorch call computes a pruning pass or I_x(a, b);
        # torch.linalg.eigh computes the eigensolver's function
        r["library_ms"] = r.get("library_ms_float64")
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
