"""Command-line front end with reference-compatible control files.

Usage:
  python -m paml_tpu_torch codeml  [codeml.ctl] [--device cuda|cpu]
  python -m paml_tpu_torch baseml  [baseml.ctl] [--device cuda|cpu]
  python -m paml_tpu_torch basemlg [baseml.ctl] [--device cuda|cpu]

Mirrors the reference programs' invocation (`codeml codeml.ctl`; the
default ctl names are the reference's).  The fits and every side
computation run on the CUDA card; `--device cpu` asks for the CPU instead.
Without a card and without `--device cpu` a program stops with an error:
it does not carry on on the CPU.

Port of `run_codeml`, `run_baseml` and `run_basemlg` of
`paml_tpu/__main__.py`.  codeml at runmode 0: for codon data NSsites
lists, several trees, several data sets (`ndata`), standard errors, NEB
(with RateAncestor) and BEB into `rst`, the marginal ancestral
reconstruction (RateAncestor) into `rst`, `rst1`, `lnf`, the optimizer
trace `rub`, the tree-comparison table and dN & dS per branch; amino-acid
data (seqtype 2 and 3), aaDist and several genes (Mgene) with `mlc`,
`rst1` and `rub` alone, as the JAX program writes them.  baseml:
every model, rate and gene option of `apps/baseml.py`, several trees,
`rst` with the reconstruction and `rates` (RateAncestor), `rst1`, `lnf`,
the tree-comparison table, the nhomo frequency sets.  basemlg: the
continuous-gamma fit and its rate-variance decomposition.  Settings whose
modules are not ported yet raise NotImplementedError naming their ROADMAP
item.
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


def _check_ported(extras) -> None:
    """Raise NotImplementedError for a runmode this package does not cover
    yet, naming the ROADMAP item that will."""
    runmode = extras.get("runmode", 0)
    if runmode in (-2, -3):
        raise NotImplementedError(
            f"paml_tpu_torch codeml does not cover runmode = {runmode} "
            "(pairwise dN/dS): ROADMAP A11")
    if runmode in (2, 3, 4, 5):
        raise NotImplementedError(
            f"paml_tpu_torch codeml does not cover runmode = {runmode} "
            "(tree search): ROADMAP A14")
    if runmode != 0:
        raise ValueError(f"runmode = {runmode} is not a codeml runmode")


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
    _check_ported(extras)
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
                    run = dict(NSsites=ns_model, tree=itree, res=res,
                               fit_seconds=time.perf_counter() - t0,
                               quantile_seconds=(dgamma.SECONDS["host"]
                                                 - q0))
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


def _check_baseml(extras) -> None:
    """Raise NotImplementedError for a baseml control file this package
    does not cover yet, naming the ROADMAP item that will."""
    if extras["clock"] in (5, 6):
        raise NotImplementedError(
            f"paml_tpu_torch baseml does not cover clock = {extras['clock']} "
            "(dating heterogeneous multi-locus data): ROADMAP A12")
    if extras.get("runmode", 0) in (2, 3, 4, 5):
        raise NotImplementedError(
            f"paml_tpu_torch baseml does not cover runmode = "
            f"{extras['runmode']} (tree search): ROADMAP A14")


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
    _check_baseml(extras)
    aln = seqio.read_alignment(seqfile, seqio.BASE_SEQ)
    data = seqio.pack(aln, cleandata=spec.cleandata)
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
    programs = {"codeml": (run_codeml, "codeml.ctl"),
                "baseml": (run_baseml, "baseml.ctl"),
                "basemlg": (run_basemlg, "baseml.ctl")}
    if prog not in programs:
        print(f"unknown program {prog!r}: paml_tpu_torch runs codeml, "
              f"baseml and basemlg so far (the other programs: ROADMAP "
              f"A11-A14)\n{__doc__}", file=sys.stderr)
        sys.exit(2)
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("paml_tpu_torch: no CUDA device; it runs on the card unless "
              "--device cpu asks for the CPU", file=sys.stderr)
        sys.exit(2)
    run, default_ctl = programs[prog]
    return run(rest[0] if rest else default_ctl, device)


if __name__ == "__main__":
    main()
