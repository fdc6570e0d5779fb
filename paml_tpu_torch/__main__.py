"""Command-line front end with reference-compatible control files.

Usage:
  python -m paml_tpu_torch codeml  [codeml.ctl] [--device cuda|cpu]
  python -m paml_tpu_torch baseml  [baseml.ctl] [--device cuda|cpu]
  python -m paml_tpu_torch basemlg [baseml.ctl] [--device cuda|cpu]
  python -m paml_tpu_torch yn00    [yn00.ctl]   [--device cuda|cpu]
  python -m paml_tpu_torch pamp    [pamp.ctl]   [--device cuda|cpu]
  python -m paml_tpu_torch chi2    [df stat]    # LRT p-values (scipy)
  python -m paml_tpu_torch evolver <mode> <args> [--device cuda|cpu]
                              # 1-4 trees, 5-7 simulate, 8 tree distances,
                              # 9 clade support, 11 label clades
  torchrun --nproc_per_node N -m paml_tpu_torch codeml|baseml|basemlg ...
  python -m paml_tpu_torch mcmctree [mcmctree.ctl] [--device cuda|cpu]
  python -m paml_tpu_torch mcmctree --combine <dir> | <out> <in1> <in2> ...
  python -m paml_tpu_torch infinitesites [mcmctree.ctl]  # infinite sites
  python -m paml_tpu_torch ds      <samplefile>     # descriptive statistics
  python -m paml_tpu_torch bfdriver <ctl> [nbeta]   # marginal likelihood
  python -m paml_tpu_torch multiruns <out> <rst1 files...>

Mirrors the reference programs' invocation (`codeml codeml.ctl`; the
default ctl names are the reference's).  The fits and every side
computation run on the CUDA card; `--device cpu` asks for the CPU instead.
Without a card and without `--device cpu` a program stops with an error:
it does not carry on on the CPU.  infinitesites, ds, bfdriver, multiruns,
chi2 and `mcmctree --combine` compute host scalars and files only (in
both packages): they need no card and take no `--device`.  codeml,
baseml and basemlg cut the site patterns over every card of the host, and
under torchrun over the ranks (`_run_on_mesh`).

Port of `run_codeml`, `run_baseml`, `run_basemlg`, `run_yn00`, `run_pamp`,
`run_chi2` and the evolver, mcmctree, infinitesites, ds, bfdriver and
multiruns dispatch of `paml_tpu/__main__.py`.  codeml at
runmode 0: for codon data NSsites lists, several trees, several data sets
(`ndata`), standard errors, NEB (with RateAncestor) and BEB into `rst`,
the marginal ancestral reconstruction (RateAncestor) into `rst`, `rst1`,
`lnf`, the optimizer trace `rub`, the tree-comparison table and dN & dS
per branch; amino-acid data (seqtype 2 and 3), aaDist and several genes
(Mgene) with `mlc`, `rst1` and `rub` alone, as the JAX program writes
them; codon data at runmode -2 (pairwise ML) and -3 (pairwise Bayesian)
into `mlc` and `2ML.t`, `2ML.dS`, `2ML.dN`, each pair fitted on the device
that was asked for; codon and amino-acid data at runmode 2-5 (tree
search: star decomposition, stepwise addition, NNI from the parsimony
tree; every candidate a full fit) into `mlc`, as the JAX program writes
it.  baseml: every model, rate and gene option of
`apps/baseml.py`, several trees, `rst` with the reconstruction and
`rates` (RateAncestor), `rst1`, `lnf`, the tree-comparison table, the
nhomo frequency sets, at clock = 5 / 6 the dating of heterogeneous
multi-locus data (`apps/clock56.py`), and tree search at runmode 2-5.
basemlg: the continuous-gamma fit and its rate-variance decomposition.  yn00: `yn`, `2YN.*` and `2NG.*`.  pamp:
`mp`.  evolver: `mc.paml` (or `mc.nex`), `siterates.txt`,
`ancestral.txt`, `evolver.out` (random, enumerated and labelled trees,
clade support).  mcmctree: `mcmc.txt`, `out.txt`,
`FigTree.tre` (or `out.BV` at usedata = 3), checkpoints; infinitesites,
ds, bfdriver and multiruns print and write as the JAX program does.
The one setting refused (codeml's pairwise runmodes on amino-acid data)
raises NotImplementedError naming ROADMAP C.
"""
from __future__ import annotations

import sys
import time


def _write_tree_with_blens(topo, blens_by_node, names=True):
    def build(i: int) -> str:
        kids = [c for c in topo.children[i] if c >= 0]
        if not kids:
            label = topo.node_names[i] if names else str(i + 1)
        else:
            label = "(" + ", ".join(build(c) for c in kids) + ")"
        if i in blens_by_node:
            label += f": {blens_by_node[i]:.6f}"
        return label

    return build(topo.root) + ";"


def _check_ported(extras, seqtype) -> None:
    """Raise NotImplementedError for a setting this package refuses,
    naming the ROADMAP item that says why.  As in the JAX program, a
    runmode other than -2 / -3 (pairwise) and 2-5 (tree search) fits the
    given trees, as runmode 0 does (runmode 1, which the reference reads
    as a search from the given tree, included: ROADMAP C)."""
    runmode = extras.get("runmode", 0)
    if runmode in (-2, -3) and seqtype != 1:
        raise NotImplementedError(
            f"paml_tpu_torch codeml runs runmode = {runmode} on codon data "
            f"(seqtype = 1) only, not on seqtype = {seqtype}: ROADMAP C")


def run_tree_search(data, fit, runmode: int, outfile: str,
                    program: str) -> dict:
    """Tree search (reference: runmode 2 star decomposition, 3 stepwise
    addition, 4 / 5 NNI from the parsimony stepwise-addition tree;
    src/treesub.c:4642-5170), as the JAX program runs it: every candidate
    is a full fit, `fit(topo, data) -> result` with `.lnL`.  Writes the
    best lnL and the tree to `outfile`.  Returns the tree, its lnL and
    every fit in order (topology, data, result, seconds)."""
    from .apps import treesearch
    from .io import treeio

    fits = []

    def fit_fn(topo_, sub):
        t0 = time.perf_counter()
        res = fit(topo_, sub)
        fits.append(dict(topo=topo_, data=sub, res=res,
                         seconds=time.perf_counter() - t0))
        return res.lnL

    t0 = time.perf_counter()
    if runmode == 3:
        tree, score = treesearch.stepwise_addition_ml(data, fit_fn,
                                                      progress=True)
    elif runmode == 2:
        tree, score = treesearch.star_decomposition(data, fit_fn,
                                                    progress=True)
    else:
        start, _ = treesearch.stepwise_addition_mp(data)
        tree, score = treesearch.nni_search_ml(
            data, start, lambda t_: fit_fn(t_, data))
    seconds = time.perf_counter() - t0
    with open(outfile, "w") as out:
        out.write(f"{program} (paml_tpu_torch) tree search runmode "
                  f"{runmode}\n")
        out.write(f"best lnL = {score:.6f}\n")
        out.write(treeio.write_newick(tree, branch_lengths=False) + "\n")
    print(f"tree search done: lnL {score:.6f} -> {outfile}")
    return {"tree": tree, "lnL": score, "fits": fits, "data": data,
            "seconds": seconds}


def run_codeml(ctl_path: str, device: str) -> dict:
    """Run a codeml control file on `device`, writing the reference's
    output files into the working directory.  Returns a summary: per
    (NSsites model, tree) the fit's result, evaluations and seconds."""
    import dataclasses

    import numpy as np
    import torch

    from .apps import beb as bebmod
    from .apps import codeml
    from .core import dgamma
    from .core.optim import set_rub
    from .core.topology import from_treenode
    from .io import ctl as ctlmod
    from .io import seqio, treeio
    from .io.outputs import write_lnf, write_rst1, write_rst_neb

    opts = ctlmod.read_ctl(ctl_path)
    spec, seqfile, treefile, outfile, extras = ctlmod.codeml_spec(opts,
                                                                  ctl_path)
    _check_ported(extras, spec.seqtype)
    open("rub", "w").close()
    set_rub("rub")
    rate_ancestor = extras.get("RateAncestor", 0)
    runs = []
    frst = None
    try:
        if extras.get("ndata", 1) > 1:
            _run_ndata(spec, seqfile, treefile, outfile, extras, device, runs)
            return {"runs": runs}
        aln = seqio.read_alignment(seqfile, codeml.SEQTYPES[spec.seqtype])
        data = seqio.pack(aln, cleandata=spec.cleandata, icode=spec.icode)
        if extras.get("runmode", 0) in (-2, -3):
            return _run_pairwise(data, spec, extras["runmode"], outfile,
                                 device)
        if extras.get("runmode", 0) in (2, 3, 4, 5):
            # tree search under the codon / amino-acid model (reference:
            # Forestry -> StepwiseAddition etc., src/codeml.c:606)
            return run_tree_search(
                data, lambda topo_, sub: codeml.fit_packed(
                    sub, topo_, spec, device=device),
                extras["runmode"], outfile, "CODEML")
        trees = treeio.read_trees(treefile, data.names)
        # amino acids, aaDist and several genes: the fit and mlc's lines
        # alone (the JAX program's side outputs need the codon objective)
        codon = (spec.seqtype == 1 and not spec.aaDist
                 and not (data.ngene > 1 and spec.Mgene != 1))
        ns_list = extras["NSsites_list"] or [spec.NSsites]
        site_lnf_trees = []          # per tree [npatt] (first NSsites model)
        frst = open("rst", "w")
        frst.write(f"Supplemental results for CODEML (paml_tpu_torch): "
                   f"{seqfile}\n")
        open("rst1", "w").close()                # truncate
        with open(outfile, "w") as out:
            out.write(f"CODEML (paml_tpu_torch) {seqfile}\n")
            out.write(f"ns = {data.ns}  ls = {data.ls}  npatt = "
                      f"{data.npatt}\n")
            for ins, ns_model in enumerate(ns_list):
                sp = dataclasses.replace(spec, NSsites=ns_model)
                for itree, tree in enumerate(trees):
                    topo = from_treenode(tree, data.names)
                    t0, q0 = time.perf_counter(), dgamma.SECONDS["host"]
                    # one objective for the fit and every side output
                    objective = codeml.make_codon_objective(
                        data, topo, sp, device=device) if codon else None
                    res = codeml.fit_packed(data, topo, sp, device=device,
                                            objective=objective)
                    # the host route's seconds in the quantile code; None
                    # on the card, where E2 runs it inside each evaluation
                    run = dict(NSsites=ns_model, tree=itree, res=res,
                               fit_seconds=time.perf_counter() - t0,
                               quantile_seconds=(
                                   None if torch.device(device).type ==
                                   "cuda" else dgamma.SECONDS["host"] - q0))
                    runs.append(run)
                    bl = dict(zip(res.branch_nodes.tolist(),
                                  res.blens.tolist()))
                    out.write(f"\nModel NSsites={ns_model}  TREE # "
                              f"{itree + 1}\n")
                    out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                              f"{res.lnL:.6f}\n")
                    out.write(_write_tree_with_blens(res.topo, bl) + "\n")
                    if res.kappa.size:
                        out.write("kappa = " + " ".join(
                            f"{k:.5f}" for k in res.kappa) + "\n")
                    write_rst1("rst1", [res.lnL] + [float(v) for v in res.x],
                               append=True)
                    if not codon:
                        print(f"NSsites={ns_model} tree {itree + 1}: "
                              f"lnL = {res.lnL:.6f}")
                        continue
                    neg = objective[0]
                    out.write("omega classes: " + np.array2string(
                        res.class_omegas, precision=5) + "\n")
                    out.write("class freqs:   " + np.array2string(
                        res.class_freqs, precision=5) + "\n")
                    if (ns_model == 0 and sp.clock == 0
                            and sp.fix_blength != 2):
                        _write_branch_dnds(out, data, sp, res, device)
                    # side outputs; lnf on the first NSsites model
                    # (reference layout: one lnf per run; rst accumulates
                    # per model)
                    xt = torch.as_tensor(res.x, device=device)
                    if ins == 0:
                        with torch.no_grad():
                            site_lnf_trees.append(
                                neg.site_loglik(xt).cpu().numpy())
                    if sp.getSE:
                        h0 = codeml.SECONDS["hessian"]
                        run["SEs"] = ses = codeml.standard_errors(
                            neg, res.x, device=device)
                        run["hessian_seconds"] = (codeml.SECONDS["hessian"]
                                                  - h0)
                        out.write("SEs for parameters:\n" + " ".join(
                            f"{v:.5f}" for v in ses) + "\n")
                    if rate_ancestor and ns_model and sp.model == 0 \
                            and itree == 0:
                        # NEB: class posteriors at the MLEs
                        with torch.no_grad():
                            run["neb"] = post = neg.class_posterior(
                                xt).cpu().numpy()
                        frst.write(f"\nModel NSsites={ns_model}\n")
                        write_rst_neb(frst, data.site_pattern, post,
                                      res.class_omegas.reshape(-1),
                                      data.fpatt)
                    if rate_ancestor and itree == 0:
                        a0 = time.perf_counter()
                        run["ancestral"] = _write_ancestral_rst(
                            frst, data, topo, sp, neg, xt)
                        run["ancestral_seconds"] = time.perf_counter() - a0
                    if sp.model == 2 and ns_model == 2 and itree == 0:
                        # branch-site model A BEB (reference:
                        # lfunNSsites_ACD, src/codeml.c:6827)
                        run["beb_A"] = acd = bebmod.beb_branchsite_A(
                            data, topo, sp, res, device=device, neg=neg)
                        _write_beb_A(out, frst, data, acd)
                    if sp.model == 0 and ns_model in (2, 8) and itree == 0:
                        b0 = bebmod.SECONDS["beb"]
                        run["beb"] = spbeb = bebmod.beb(
                            data, topo, sp, res, device=device, neg=neg)
                        run["beb_seconds"] = bebmod.SECONDS["beb"] - b0
                        _write_beb(out, frst, data, ns_model, spbeb)
                    print(f"NSsites={ns_model} tree {itree + 1}: "
                          f"lnL = {res.lnL:.6f}")
            # lnf + RELL/KH/SH tree comparison over trees (reference:
            # src/codeml.c:623-689 + rell, src/treesub.c:5844)
            if site_lnf_trees:
                write_lnf("lnf", data.ls, data.fpatt, site_lnf_trees)
            if len(site_lnf_trees) > 1:
                _write_tree_comparison(out, site_lnf_trees, data.fpatt)
        print(f"results written to {outfile}")
    finally:
        set_rub(None)
        if frst is not None:
            frst.close()
    return {"runs": runs, "data": data}


def _run_pairwise(data, spec, runmode, outfile, device) -> dict:
    """codeml's pairwise runmodes on codon data, without a tree: ML (-2)
    or Bayesian (-3) dN/dS per pair (reference: PairwiseCodon,
    src/codeml.c:4344, BayesPairwise :4612) into `mlc` and the 2ML.*
    matrices (written like src/yn00.c:141-167).  Under -3 the t and omega
    columns hold the posterior means E_t and E_w (the JAX program writes
    0 there: ROADMAP C).  Returns the pairs and the seconds of the fits."""
    from .apps import pairwise as pw
    from .io.outputs import write_pairwise_matrix

    fit = pw.pairwise_codon if runmode == -2 else pw.bayes_pairwise_codon
    kw = dict(fix_kappa=spec.fix_kappa) if runmode == -2 else {}
    t0 = time.perf_counter()
    res = fit(data, codonf=spec.codonf, icode=spec.icode, kappa0=spec.kappa,
              omega0=spec.omega, device=device, **kw)
    seconds = time.perf_counter() - t0
    t_field = "t" if runmode == -2 else "E_t"
    with open(outfile, "w") as out:
        out.write(f"CODEML (paml_tpu_torch) pairwise runmode {runmode}\n")
        out.write("seq1 seq2        t    kappa    omega       dN"
                  "       dS\n")
        for r in res:
            t = getattr(r, t_field)
            w = r.omega if runmode == -2 else r.E_w
            dN, dS = getattr(r, "dN", 0.0), getattr(r, "dS", 0.0)
            out.write(f"{r.i + 1:4d} {r.j + 1:4d} {t:8.4f} "
                      f"{r.kappa:8.4f} {w:8.4f} {dN:8.4f} {dS:8.4f}\n")
    for q in ("t", "dS", "dN"):
        write_pairwise_matrix(f"2ML.{q}", data.names, res,
                              t_field if q == "t" else q)
    print(f"pairwise results written to {outfile} + 2ML.*")
    return {"pairs": res, "data": data, "seconds": seconds}


def _run_ndata(spec, seqfile, treefile, outfile, extras, device, runs):
    """Several data sets stacked in one seqfile (reference: the ndata
    loop, src/codeml.c:372).  Tree handling per the reference's
    examples/ndata/README.txt: a shared tree block, per-dataset tree blocks
    ('separate_trees'), or subtrees pruned from a main tree ('maintree')."""
    import copy

    from .apps import codeml
    from .core.topology import from_treenode
    from .io import seqio, treeio
    from .io.outputs import write_rst1

    mode = extras.get("ndata_mode", "shared")
    alns = seqio.read_alignments(seqfile, codeml.SEQTYPES[spec.seqtype],
                                 extras["ndata"])
    tree_strs = treeio.read_tree_strings(treefile)
    main_tree = (treeio.parse_newick(tree_strs[0])
                 if mode == "maintree" else None)
    for i, a in enumerate(alns):
        print(f"\nData set {i + 1}")
        d = seqio.pack(a, cleandata=spec.cleandata, icode=spec.icode)
        if mode == "separate_trees":
            tree_i = treeio.parse_newick(tree_strs[i])
            treeio._resolve_names(tree_i, d.names)
        elif mode == "maintree":
            tree_i = treeio.prune_to(copy.deepcopy(main_tree), d.names)
            treeio._resolve_names(tree_i, d.names)
        else:
            tree_i = treeio.read_trees(treefile, d.names)[0]
        t0 = time.perf_counter()
        res = codeml.fit_packed(d, from_treenode(tree_i, d.names), spec,
                                device=device)
        runs.append(dict(NSsites=spec.NSsites, tree=0, dataset=i, res=res,
                         fit_seconds=time.perf_counter() - t0))
        with open(outfile, "a" if i else "w") as out:
            out.write(f"\nData set {i + 1}\n")
            out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                      f"{res.lnL:.6f}\n")
        write_rst1("rst1", [i + 1, res.lnL] + [float(v) for v in res.x],
                   append=bool(i))
        print(f"lnL = {res.lnL:.6f}")
    print(f"results written to {outfile}")


def _write_ancestral_rst(frst, data, topo, sp, neg, xt):
    """The marginal ancestral reconstruction of codons into rst
    (reference: AncestralMarginal, src/treesub.c:6288); returns (best,
    prob)."""
    import torch

    from .apps.ancestral import marginal_reconstruction
    from .constants import codon_string
    from .io.outputs import write_rst_ancestral
    from .models.codon import codon_graph

    with torch.no_grad():
        P, piC, freqs = neg.model_at(xt)
    best, prob, _ = marginal_reconstruction(P, neg.tips, topo, piC, freqs,
                                            neg.fpatt)
    codons = [codon_string(int(c)) for c in codon_graph(sp.icode).sense]
    write_rst_ancestral(frst, data.names,
                        [i + 1 for i in range(topo.ns, topo.nnode)],
                        [[codons[s] for s in row] for row in best], prob,
                        data.site_pattern)
    return best, prob


def run_baseml(ctl_path: str, device: str) -> dict:
    """Run a baseml control file on `device`, writing the reference's
    output files into the working directory.  Returns a summary: per tree
    the fit's result, seconds of the fit, the Hessian and the ancestral
    reconstruction, and the reconstruction itself."""
    import numpy as np
    import torch

    from .apps import baseml, codeml
    from .apps.ancestral import marginal_reconstruction
    from .core.topology import from_treenode
    from .io import ctl as ctlmod
    from .io import seqio, treeio
    from .io.outputs import (write_lnf, write_rates, write_rst1,
                             write_rst_ancestral)

    opts = ctlmod.read_ctl(ctl_path)
    spec, seqfile, treefile, outfile, extras = ctlmod.baseml_spec(opts,
                                                                  ctl_path)
    if extras["clock"] in (5, 6):
        return run_clock56(opts, spec, seqfile, treefile, outfile, extras,
                           device)
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata)
    if extras.get("runmode", 0) in (2, 3, 4, 5):
        return run_tree_search(
            data, lambda topo_, sub: baseml.fit_packed(sub, topo_, spec,
                                                       device=device),
            extras["runmode"], outfile, "BASEML")
    trees = treeio.read_trees(treefile, data.names)
    rate_ancestor = extras.get("RateAncestor", 0)
    site_lnf_trees = []
    runs = []
    open("rst1", "w").close()
    with open("rst", "w") as frst, open(outfile, "w") as out:
        frst.write(f"Supplemental results for BASEML (paml_tpu_torch): "
                   f"{seqfile}\n")
        out.write(f"BASEML (paml_tpu_torch) {seqfile}  model {spec.model}\n")
        out.write(f"ns = {data.ns}  ls = {data.ls}  npatt = {data.npatt}\n")
        for itree, tree in enumerate(trees):
            topo = from_treenode(tree, data.names)
            t0, h0 = time.perf_counter(), codeml.SECONDS["hessian"]
            # one objective for the fit and every side output
            objective = None if spec.nhomo else baseml.make_objective(
                data, topo, spec, device=device)
            res = baseml.fit_packed(data, topo, spec, device=device,
                                    objective=objective)
            hess = codeml.SECONDS["hessian"] - h0
            run = dict(tree=itree, res=res, spec=spec, hessian_seconds=hess,
                       fit_seconds=time.perf_counter() - t0 - hess)
            runs.append(run)
            bl = dict(zip(res.branch_nodes.tolist(), res.blens.tolist()))
            out.write(f"\nTREE # {itree + 1}\n")
            out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                      f"{res.lnL:.6f}\n")
            out.write(_write_tree_with_blens(res.topo, bl) + "\n")
            if res.rate_params.size:
                out.write("rate parameters: " + " ".join(
                    f"{v:.6f}" for v in np.ravel(res.rate_params)) + "\n")
            if res.alpha is not None and not spec.nparK:
                out.write("alpha = "
                          + " ".join(f"{a:.5f}" for a in res.alpha) + "\n")
            if not spec.fix_rho:
                # AdG autocorrelation (reference: rho output,
                # src/baseml.c:806)
                out.write(f"rho (auto-discrete-gamma) = "
                          f"{float(res.x[-1]):.5f}\n")
            if spec.nparK:
                K = spec.ncatG
                n_extra = {1: 0, 2: K - 1, 3: (K - 1) * (K - 1),
                           4: K * (K - 1)}[spec.nparK]
                rk = res.x[len(res.x) - (K - 1) - n_extra:][:K - 1]
                out.write(f"nparK = {spec.nparK} free rates 1..K-1 "
                          f"(K = {K}; mean rate constrained to 1): "
                          + " ".join(f"{v:.5f}" for v in rk) + "\n")
            if res.rgene.size > 1:
                out.write("rgene: "
                          + " ".join(f"{v:.5f}" for v in res.rgene) + "\n")
            if res.SEs is not None:
                out.write("SEs: " + " ".join(f"{v:.6f}" for v in res.SEs)
                          + "\n")
            write_rst1("rst1", [res.lnL] + [float(v) for v in res.x],
                       append=True)
            if spec.nhomo:
                # the frequency sets of a nonhomogeneous fit (reference:
                # DetailOutput nhomo block, src/baseml.c:786)
                out.write("base frequency parameter sets (TCAG):\n")
                for k, p4 in enumerate(np.atleast_2d(res.pi)):
                    out.write(f"  set {k + 1}: "
                              + " ".join(f"{v:.5f}" for v in p4) + "\n")
                print(f"tree {itree + 1}: lnL = {res.lnL:.6f}")
                continue
            neg = objective[0]
            xt = torch.as_tensor(res.x, device=device)
            with torch.no_grad():
                if hasattr(neg, "site_loglik"):
                    site_lnf_trees.append(neg.site_loglik(xt).cpu().numpy())
                if (rate_ancestor and hasattr(neg, "class_posterior")
                        and itree == 0):
                    a0 = time.perf_counter()
                    post, r, w = neg.class_posterior(xt)
                    if r.shape[0] > 1:
                        write_rates("rates", 0, r.cpu().numpy(),
                                    w.cpu().numpy(), data.site_pattern,
                                    post.cpu().numpy(), data.fpatt)
                    P, piC, w2, _ = neg.model_at(xt)
                    best, prob, _ = marginal_reconstruction(
                        P, neg.tips, topo, piC, w2, neg.fpatt)
                    write_rst_ancestral(
                        frst, data.names,
                        [i + 1 for i in range(topo.ns, topo.nnode)],
                        [["TCAG"[s] for s in row] for row in best], prob,
                        data.site_pattern)
                    run["ancestral"] = best, prob
                    run["ancestral_seconds"] = time.perf_counter() - a0
            print(f"tree {itree + 1}: lnL = {res.lnL:.6f}")
        if site_lnf_trees:
            write_lnf("lnf", data.ls, data.fpatt, site_lnf_trees)
        if len(site_lnf_trees) > 1:
            _write_tree_comparison(out, site_lnf_trees, data.fpatt)
    print(f"results written to {outfile}")
    return {"runs": runs, "data": data}


def run_clock56(opts, spec, seqfile, treefile, outfile, extras,
                device) -> dict:
    """baseml at clock = 5 / 6: dating heterogeneous multi-locus data
    (reference: DatingHeteroData, src/treesub.c:10100) into the outfile,
    as the JAX program writes it.  Returns the result and its seconds."""
    from .apps import clock56

    spec56 = clock56.Clock56Spec(
        model=spec.model, clock=extras["clock"],
        fix_kappa=spec.fix_kappa,
        kappa=[float(v) for v in str(opts.get("kappa", "2")).split()],
        fix_alpha=spec.fix_alpha,
        alpha=[float(v) for v in str(opts.get("alpha", "0")).split()],
        ncatG=spec.ncatG, cleandata=spec.cleandata, getSE=spec.getSE)
    t0 = time.perf_counter()
    res = clock56.fit(treefile, seqfile, extras["ndata"], spec56,
                      device=device)
    seconds = time.perf_counter() - t0
    with open(outfile, "w") as out:
        out.write(f"BASEML (paml_tpu_torch) clock = {extras['clock']} "
                  f"({extras['ndata']} loci)\n")
        out.write(f"lnL = {res.lnL:.6f}   np = {res.np}\n\nNode ages:\n")
        st = res.sp_topo
        for n in range(st.ns, st.nnode):
            out.write(f"  node {n + 1}: {res.ages[n]:.6f}\n")
        out.write("\nSubstitution rates for genes (per time unit)\n")
        for g, r in enumerate(res.rates):
            out.write(f"  Gene {g + 1}: "
                      + " ".join(f"{v:.5f}" for v in r) + "\n")
        if res.kappa is not None:
            out.write("\nkappa for genes\n  "
                      + " ".join(f"{v:.5f}" for v in res.kappa.ravel())
                      + "\n")
        if res.alpha is not None:
            out.write("\nalpha for genes\n  "
                      + " ".join(f"{v:.5f}" for v in res.alpha) + "\n")
        if res.SEs is not None:
            out.write("\nSEs:\n  "
                      + " ".join(f"{v:.5f}" for v in res.SEs) + "\n")
    print(f"lnL = {res.lnL:.6f}; results written to {outfile}")
    return {"result": res, "seconds": seconds}


def run_basemlg(ctl_path: str, device: str) -> dict:
    """basemlg: ML under continuous-gamma rates (reference:
    src/basemlg.c:82; the ctl format of baseml).  Returns the summary of
    `run_baseml`, with basemlg's rate-variance decomposition."""
    import dataclasses

    from .apps import baseml
    from .core.topology import from_treenode
    from .io import ctl as ctlmod
    from .io import seqio, treeio

    opts = ctlmod.read_ctl(ctl_path)
    spec, seqfile, treefile, outfile, extras = ctlmod.baseml_spec(opts,
                                                                  ctl_path)
    # continuous gamma always estimates alpha unless fixed at a positive
    # value (reference: basemlg's com.alpha handling, src/basemlg.c:141)
    spec = dataclasses.replace(
        spec, continuous_gamma=True,
        fix_alpha=bool(spec.fix_alpha) and spec.alpha > 0)
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata)
    if data.ns > 10:
        print(f"warning: basemlg is meant for small trees "
              f"(ns = {data.ns} > 10; reference limit src/basemlg.c:14)")
    trees = treeio.read_trees(treefile, data.names)
    runs = []
    with open(outfile, "w") as out:
        out.write(f"BASEMLG (paml_tpu_torch) {seqfile}  model {spec.model} "
                  f"(continuous gamma)\n")
        for itree, tree in enumerate(trees):
            topo = from_treenode(tree, data.names)
            t0 = time.perf_counter()
            res = baseml.fit_packed(data, topo, spec, device=device)
            run = dict(tree=itree, res=res, spec=spec,
                       fit_seconds=time.perf_counter() - t0)
            runs.append(run)
            bl = dict(zip(res.branch_nodes.tolist(), res.blens.tolist()))
            out.write(f"\nTREE # {itree + 1}\n")
            out.write(f"lnL(ntime: {len(res.blens)}  np: {res.np}): "
                      f"{res.lnL:.6f}\n")
            out.write(_write_tree_with_blens(res.topo, bl) + "\n")
            if res.rate_params.size:
                out.write("rate parameters: "
                          + " ".join(f"{v:.6f}" for v in res.rate_params)
                          + "\n")
            if res.alpha is not None:
                out.write(f"alpha (continuous gamma) = "
                          f"{float(res.alpha[0]):.6f}\n")
            if extras.get("RateAncestor") and itree == 0:
                run["rho_rate"] = rr = baseml.rho_rate(data, topo, spec,
                                                       res.x, device=device)
                out.write(f"rate-variance decomposition: Vr {rr['Vr']:.6f}"
                          f"  PEV {rr['PEV']:.6f}  RHO {rr['RHO']:.6f}\n")
                with open("rates", "w") as fr:
                    fr.write("site  rate (posterior mean, continuous "
                             "gamma)\n")
                    rh = rr["rates"]
                    for s, h in enumerate(data.site_pattern):
                        fr.write(f"{s + 1:6d}  {rh[h]:9.5f}\n")
            print(f"tree {itree + 1}: lnL = {res.lnL:.6f}")
    print(f"results written to {outfile}")
    return {"runs": runs, "data": data}


def run_yn00(ctl_path: str, device: str) -> dict:
    """yn00: NG86, YN00 and the LWL85 family for every pair into the
    ctl's outfile (`yn`) and the 2YN.* / 2NG.* matrices; with `ndata` the
    YN00 line of each pair per data set.  Returns the pairs (per data set
    under `ndata`) and the seconds of the analysis."""
    from .apps import yn00
    from .io import ctl as ctlmod
    from .io import seqio
    from .io.outputs import write_pairwise_matrix

    opts = ctlmod.yn00_opts(ctlmod.read_ctl(ctl_path), ctl_path)
    kw = dict(icode=opts["icode"], weighting=opts["weighting"],
              common_f3x4=opts["common_f3x4"], device=device)
    ndata = opts.get("ndata", 1)
    t0 = time.perf_counter()
    if ndata > 1:
        # multiple stacked data sets (reference: the yn00 ndata loop)
        alns = seqio.read_alignments(opts["seqfile"], seqio.CODON_SEQ, ndata)
        sets = []
        with open(opts["outfile"], "w") as out:
            out.write("YN00 (paml_tpu_torch)\n")
            for i, a in enumerate(alns):
                d = seqio.pack(a, cleandata=True, icode=opts["icode"])
                rs = yn00.run_packed(d, **kw)
                sets.append(rs)
                out.write(f"\nData set {i + 1}\n")
                for r in rs:
                    out.write(f"{r.i + 1:4d}{r.j + 1:4d} {r.t:8.4f}"
                              f"{r.kappa:8.4f}{r.omega:8.4f} "
                              f"{r.dN:7.4f} {r.dS:7.4f}\n")
        print(f"{ndata} data sets written to {opts['outfile']}")
        return {"datasets": sets, "seconds": time.perf_counter() - t0}
    results = yn00.run(opts["seqfile"], **kw)
    seconds = time.perf_counter() - t0
    # 2YN./2NG. lower-triangle matrices (reference: src/yn00.c:141-167)
    names = seqio.read_alignment(opts["seqfile"], seqio.CODON_SEQ).names
    for pre, field in (("2YN", "{}"), ("2NG", "ng_{}")):
        for q in ("dS", "dN", "t"):
            write_pairwise_matrix(f"{pre}.{q}", names, results,
                                  field.format(q))
    with open(opts["outfile"], "w") as out:
        out.write("YN00 (paml_tpu_torch)\n\n")
        out.write("Nei & Gojobori 1986. dN/dS (dN, dS)\n")
        for r in results:
            out.write(f"{r.i + 1:4d} vs {r.j + 1:4d}: "
                      f"{r.ng_dN / r.ng_dS if r.ng_dS > 0 else -1:.4f} "
                      f"({r.ng_dN:.4f} {r.ng_dS:.4f})\n")
        out.write("\nYang & Nielsen (2000)\n")
        out.write("seq seq      S       N      t    kappa   omega   "
                  "dN +- SE     dS +- SE\n")
        for r in results:
            out.write(f"{r.i + 1:4d}{r.j + 1:4d} {r.S:8.1f}{r.N:8.1f}"
                      f"{r.t:8.4f}{r.kappa:8.4f}{r.omega:8.4f} "
                      f"{r.dN:7.4f} +- {r.SEdN:6.4f} "
                      f"{r.dS:7.4f} +- {r.SEdS:6.4f}\n")
        out.write("\nLWL85 family\n")
        for r in results:
            l = r.lwl
            out.write(f"{r.i + 1:4d} vs {r.j + 1:4d}  "
                      f"LWL85 dS {l['LWL85']['dS']:.4f} dN "
                      f"{l['LWL85']['dN']:.4f}  "
                      f"LWL85m dS {l['LWL85m']['dS']:.4f} dN "
                      f"{l['LWL85m']['dN']:.4f}  "
                      f"LPB93 dS {l['LPB93']['dS']:.4f} dN "
                      f"{l['LPB93']['dN']:.4f}\n")
    print(f"results written to {opts['outfile']}")
    return {"pairs": results, "seconds": seconds}


def run_pamp(ctl_path: str, device: str) -> dict:
    """pamp: parsimony-based rate analysis into the ctl's outfile (`mp`)
    (reference: src/pamp.c:67; ctl template examples/pamp.ctl).  Returns
    the result and its seconds."""
    from .apps import pamp
    from .io import ctl as ctlmod

    opts = ctlmod.read_ctl(ctl_path)
    seqfile = ctlmod.resolve_path(ctl_path, opts.get("seqfile"))
    treefile = ctlmod.resolve_path(ctl_path, opts.get("treefile"))
    outfile = opts.get("outfile", "mp")
    ncatG = int(ctlmod._first_num(opts.get("ncatG", "8")))
    t0 = time.perf_counter()
    res = pamp.run(seqfile, treefile, ncatG=ncatG, device=device)
    seconds = time.perf_counter() - t0
    with open(outfile, "w") as out:
        out.write(f"PAMP (paml_tpu_torch) {seqfile}\n\n")
        out.write("# changes (parsimony) histogram: sites with k "
                  "changes\n")
        for k, c in enumerate(res.n_changes_hist):
            if c:
                out.write(f"  {k:3d}: {c:.0f}\n")
        out.write(f"\nmean changes {res.mean:.4f}  variance "
                  f"{res.var:.4f}\n")
        out.write(f"alpha (method of moments)    = {res.alpha_mm:.5f}\n")
        out.write(f"alpha (Sullivan et al. 1995) = "
                  f"{res.alpha_sullivan:.5f}\n")
        out.write(f"alpha (Yang & Kumar 1996)    = {res.alpha_yk96:.5f}\n")
        out.write("\nsubstitution pattern matrix (parsimony counts, "
                  "TCAG):\n")
        for row in res.pattern_matrix:
            out.write("  " + " ".join(f"{v:9.2f}" for v in row) + "\n")
    print(f"alpha estimates: MM {res.alpha_mm:.5f}  Sullivan "
          f"{res.alpha_sullivan:.5f}  YK96 {res.alpha_yk96:.5f}")
    print(f"results written to {outfile}")
    return {"result": res, "seconds": seconds}


def run_chi2(args: list[str]) -> None:
    """LRT chi-square p-values (reference: src/chi2.c); scipy only."""
    from scipy.stats import chi2 as chi2_dist
    if len(args) >= 2:
        df, stat = int(args[0]), float(args[1])
        p = chi2_dist.sf(stat, df)
        print(f"df = {df}  prob = {p:.9g} = {p:.6e}")
    else:
        # critical value table like the reference's interactive mode
        print("df      0.950    0.990    0.999")
        for df in list(range(1, 11)) + [20, 50, 100]:
            row = "  ".join(f"{chi2_dist.isf(a, df):8.4f}"
                            for a in (0.05, 0.01, 0.001))
            print(f"{df:3d}  {row}")


def run_evolver(args: list[str], device: str):
    from .apps.evolver import main as evolver_main
    return evolver_main(args, device)


def run_mcmctree(args: list[str], device: str):
    """mcmctree on a control file (its likelihoods on `device`); returns
    the posterior summaries (None at usedata = 3)."""
    from .apps.mcmctree import main as mcmctree_main
    return mcmctree_main(args, device)


def run_infinitesites(args: list[str]):
    """infinitesites on an mcmctree control file (host scalars); prints
    what the JAX program prints and returns the chain's output."""
    from .apps.infinitesites import run_ctl as is_run
    from .io.ctl import read_ctl

    ctl = args[0] if args else "mcmctree.ctl"
    out = is_run(read_ctl(ctl), ctl, progress=True)
    if isinstance(out, dict):            # clock 1
        lo, hi = out["t0_CI"]
        print(f"\nPosterior root age t0: mean {out['t0_mean']:.6f} "
              f"95% CI ({lo:.6f}, {hi:.6f})")
        for lab in ("mean", "low", "high"):
            ages = out["times"][lab]
            print(f"{lab:>5s} times: "
                  + " ".join(f"{a:.6f}" for a in ages))
    else:                                # clock 2/3 sample list
        from .apps.mcmctree import summarize
        summ = summarize(out)
        print(f"{'param':>12s} {'mean':>10s} {'2.5%':>10s} "
              f"{'97.5%':>10s}")
        for k, v in summ.items():
            print(f"{k:>12s} {v['mean']:10.5f} {v['eq_lo']:10.5f} "
                  f"{v['eq_hi']:10.5f}")
    return out


def run_ds(args: list[str]):
    """ds: descriptive statistics of a sample file (host)."""
    from .apps.mcmcutils import describe_file

    stats = describe_file(args[0])
    print(f"{'param':>12s} {'mean':>10s} {'sd':>10s} {'median':>10s} "
          f"{'2.5%':>10s} {'97.5%':>10s} {'ESS':>8s}")
    for k, v in stats.items():
        print(f"{k:>12s} {v['mean']:10.4f} {v['sd']:10.4f} "
              f"{v['median']:10.4f} {v['eq_lo']:10.4f} "
              f"{v['eq_hi']:10.4f} {v['ess']:8.1f}")
    return stats


def run_bfdriver(args: list[str]):
    """BFdriver: per-beta control files and their run script (host)."""
    from .apps.mcmcutils import bfdriver

    nb = int(args[1]) if len(args) > 1 else 8
    betas, ws = bfdriver(args[0], nbeta=nb)
    print(f"wrote {nb} per-beta configs under bf/ + runbf.sh")
    return betas, ws


def run_multiruns(args: list[str]):
    """multiruns: the best-lnL line per data set over replicate tables."""
    from .apps.mcmcutils import multiruns

    n = multiruns(args[1:], args[0])
    print(f"merged {len(args) - 1} runs, {n} datasets -> {args[0]}")
    return n


def _write_tree_comparison(out, site_lnf_trees, fpatt) -> None:
    """The RELL / KH / SH table over the trees (reference:
    src/codeml.c:623-689 + rell, src/treesub.c:5844)."""
    import numpy as np

    from .apps.bootstrap import tree_comparison

    stats = tree_comparison(np.stack(site_lnf_trees), fpatt)
    out.write("\nTree comparison (RELL / KH / SH)\n")
    out.write("tree    lnL-diff     pRELL      pKH      pSH\n")
    for i in range(len(site_lnf_trees)):
        out.write(f"{i + 1:4d} {stats['D'][i]:11.4f} "
                  f"{stats['pRELL'][i]:9.4f} {stats['pKH'][i]:8.4f}"
                  f" {stats['pSH'][i]:8.4f}\n")


def _write_beb_A(out, frst, data, acd) -> None:
    post = acd["postSite"]
    frst.write("\nBayes Empirical Bayes (BEB) probabilities for 4 classes "
               "(branch-site model A)\n")
    frst.write("site  class0   class1   class2a  class2b\n")
    for s_i, h in enumerate(data.site_pattern):
        frst.write(f"{s_i + 1:5d}  "
                   + "  ".join(f"{post[k, h]:.5f}" for k in range(4)) + "\n")
    out.write("\nBayes Empirical Bayes (BEB) analysis "
              "(Yang, Wong & Nielsen 2005)\n")
    out.write("Positive sites for foreground lineages Prob(w>1):\n")
    for s_i, h in enumerate(data.site_pattern):
        pp = acd["pos_prob"][h]
        if pp > 0.5:
            sig = "**" if pp > 0.99 else "*" if pp > 0.95 else ""
            out.write(f"{s_i + 1:6d} {pp:.3f}{sig}\n")


def _write_beb(out, frst, data, ns_model, spbeb) -> None:
    from .apps.beb import positive_sites

    out.write("BEB positively selected sites "
              "(P>0.5; * P>0.95, ** P>0.99):\n")
    frst.write(f"\nBayes Empirical Bayes (BEB) probabilities, "
               f"NSsites={ns_model}\n")
    for s, p, w in positive_sites(data, spbeb, 0.5):
        h = data.site_pattern[s - 1]
        star = "**" if p > 0.99 else "*" if p > 0.95 else ""
        line = (f"  {s:5d}  {p:.3f}{star:2s}  "
                f"{w:.3f} +- {spbeb.se_w[h]:.3f}\n")
        out.write(line)
        frst.write(line)


def _write_branch_dnds(out, data, sp, res, device) -> None:
    """'dN & dS for each branch' table (reference: DetailOutput via
    eigenQcodon mode=2, src/codeml.c:3357-3377)."""
    import torch

    from .apps.codeml import _codonf
    from .models import codon as codonmod

    codonf = _codonf(sp)
    graph = codonmod.codon_graph(sp.icode)
    G = codonmod.pair_tables(sp.icode, device)
    _, f3x4, f1x4 = codonmod.count_codon_freqs(
        data.tip_partials, data.fpatt, graph, data.pos_masks)
    kap = torch.as_tensor(res.kappa if res.kappa.size else [sp.kappa],
                          dtype=torch.float64, device=device)
    pi = torch.as_tensor(res.pi, dtype=torch.float64, device=device)
    if codonf in ("FMutSel", "FMutSel0"):
        pf = torch.as_tensor(res.params["pf_TCAG"], device=device)
        s = codonmod.mutation_part(G, kap, pf.expand(3, 4), sp.hkyREV)
        s = s * codonmod.fmutsel_multiplier(G, pf, pi, data.ls)
    else:
        s = codonmod.mutation_part(
            G, kap, codonmod.mg_pf3x4(codonf, f3x4, f1x4), sp.hkyREV)
    rs, ra = (float(v) for v in codonmod.flux(G, s, pi))
    W = res.class_omegas
    topo = res.topo
    out.write("\ndN & dS for each branch\n")
    out.write(f"{'branch':>10s} {'t':>8s} {'N':>9s} {'S':>9s} "
              f"{'dN/dS':>8s} {'dN':>8s} {'dS':>8s}\n")
    for bi, node in enumerate(res.branch_nodes):
        if W.shape[0] > 1:
            btype = bi if sp.model == 1 else int(topo.labels[node])
            w = float(W[min(btype, W.shape[0] - 1), 0])
        else:
            w = float(W[0, 0])
        st_ = codonmod.branch_dnds(rs, ra, w, float(res.blens[bi]), data.ls)
        par = int(topo.parent[node]) + 1
        out.write(f"{par:>5d}..{node + 1:<4d}{st_['t']:8.3f} "
                  f"{st_['N']:9.1f} {st_['S']:9.1f} {st_['w']:8.4f} "
                  f"{st_['dN']:8.4f} {st_['dS']:8.4f}\n")


def main(argv: list[str] | None = None):
    """Run a program of the package; returns what the program returns
    (its summary)."""
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv) or argv[i + 1] not in ("cuda", "cpu"):
            print("--device takes cuda or cpu", file=sys.stderr)
            sys.exit(2)
        device = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        print(__doc__)
        return None
    prog, *rest = argv
    # host programs: no card, no --device
    host = {"chi2": run_chi2, "infinitesites": run_infinitesites,
            "ds": run_ds, "bfdriver": run_bfdriver,
            "multiruns": run_multiruns}
    if prog in host:
        return host[prog](rest)
    if prog == "mcmctree" and rest[:1] == ["--combine"]:
        return run_mcmctree(rest, "cpu")
    programs = {"codeml": (run_codeml, "codeml.ctl"),
                "baseml": (run_baseml, "baseml.ctl"),
                "basemlg": (run_basemlg, "baseml.ctl"),
                "yn00": (run_yn00, "yn00.ctl"),
                "pamp": (run_pamp, "pamp.ctl"),
                "evolver": (run_evolver, None),
                "mcmctree": (run_mcmctree, None)}
    if prog not in programs:
        print(f"unknown program {prog!r}\n{__doc__}", file=sys.stderr)
        sys.exit(2)
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("paml_tpu_torch: no CUDA device; it runs on the card unless "
              "--device cpu asks for the CPU", file=sys.stderr)
        sys.exit(2)
    run, default_ctl = programs[prog]
    if default_ctl is None:
        return run(rest, device)
    ctl = rest[0] if rest else default_ctl
    if prog in ("codeml", "baseml", "basemlg"):
        return _run_on_mesh(run, ctl, device)
    return run(ctl, device)


def _run_on_mesh(run, ctl: str, device: str):
    """codeml, baseml and basemlg cut the pattern axis over every device
    they are given (`pruning.set_pattern_mesh`).  Under torchrun each rank
    joins the group (`distributed.initialize`: NCCL with a card per rank,
    gloo on the CPU or on a shared card), runs the program on its own
    device (`cuda:{LOCAL_RANK}`) with the pattern axis cut over the ranks,
    and only the primary rank writes into the working directory and
    prints: the others run in a temporary directory, removed at the end,
    with their standard output discarded.  In one process on a host with
    more than one card the axis is cut over all of them
    (`sharding.engage_auto_mesh`, as `paml_tpu/__main__.py:779-784`).  The
    mesh in force before is restored at the end, and a group joined here
    is left once the program has run (`distributed.shutdown`: every rank
    waits for the others; a rank that raises leaves torchrun to stop
    the rest)."""
    import contextlib
    import os
    import tempfile

    import torch

    from .core import pruning
    from .parallel import distributed, sharding

    before = pruning.pattern_mesh()
    joined = not torch.distributed.is_initialized() and \
        distributed.initialize(device=device)
    try:
        if not torch.distributed.is_initialized():
            if device == "cuda":
                sharding.engage_auto_mesh()
            return run(ctl, device)
        device = str(distributed.local_device(device))
        pruning.set_pattern_mesh(distributed.global_data_mesh(device))
        if distributed.is_primary():
            out = run(ctl, device)
        else:
            ctl = os.path.abspath(ctl)
            cwd = os.getcwd()
            with tempfile.TemporaryDirectory() as scratch, \
                    open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null):
                os.chdir(scratch)
                try:
                    out = run(ctl, device)
                finally:
                    os.chdir(cwd)
    finally:
        pruning.set_pattern_mesh(before)
    if joined:
        distributed.shutdown()
    return out

if __name__ == "__main__":
    main()
