"""MCMC operational utilities.

Port of `paml_tpu/apps/mcmcutils.py` (host files and numpy only; no
device):
- checkpoint/resume for MCMCTree chains (reference: SaveMCMCstate /
  ReadMCMCstate, src/mcmctree.c:807,846 — improved here by also saving the
  RNG state, a reproducibility gap the reference leaves open)
- chain combining (reference: mcmctree --combine,
  CombineMCMCFiles_CommandLine, src/mcmctree.c:397)
- `ds`: descriptive statistics of a sample file (reference: src/ds.c ->
  DescriptiveStatistics, src/tools.c:5779)
- BFdriver: per-beta control files for stepping-stones / thermodynamic-
  integration marginal likelihoods (reference: src/BFdriver.c)
- multiruns: merge replicate rst1 tables keeping the best lnL
  (reference: Technical/Simulation/multiruns.c)
"""
from __future__ import annotations

import os
import pickle

import numpy as np


# --- checkpointing ---------------------------------------------------------

def save_state(mc, path: str, it: int = 0) -> None:
    state = dict(ages=mc.ages, mu=mc.mu, sigma2=mc.sigma2, rates=mc.rates,
                 kappa=mc.kappa, alpha_g=mc.alpha_g, it=it,
                 rng_state=mc.rng.bit_generator.state,
                 # adapted proposal step lengths (reference saves them,
                 # SaveMCMCstate mcmctree.c:807) so a resume mid-burn-in
                 # does not restart Pjump adaptation from scratch
                 steps=getattr(mc, "steps", None))
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_state(mc, path: str) -> int:
    with open(path, "rb") as f:
        state = pickle.load(f)
    mc.ages = state["ages"]
    mc.mu = state["mu"]
    mc.sigma2 = state["sigma2"]
    mc.rates = state["rates"]
    mc.kappa = state["kappa"]
    mc.alpha_g = state["alpha_g"]
    mc.rng.bit_generator.state = state["rng_state"]
    if state.get("steps") is not None:
        mc._resume_steps = state["steps"]
    return int(state["it"])


# --- sample files ----------------------------------------------------------

def write_mcmc_txt(samples: list[dict], path: str) -> None:
    keys = list(samples[0].keys())
    with open(path, "w") as f:
        f.write("Gen\t" + "\t".join(keys) + "\n")
        for i, s in enumerate(samples):
            f.write(str(i + 1) + "\t"
                    + "\t".join(f"{s[k]:.6f}" for k in keys) + "\n")


def read_mcmc_txt(path: str, skip_malformed: bool = False):
    """Parse an mcmc.txt sample table.  skip_malformed=True applies the
    reference --combine semantics (mcmctree.c CombineMCMCFiles): blank
    lines and incomplete rows (e.g. a truncated last line after a crash)
    are skipped, not fatal; returns (header, rows, n_empty, n_bad)."""
    n_empty = n_bad = 0
    with open(path) as f:
        header = f.readline().split()
        rows = []
        for ln, line in enumerate(f):
            vals = line.split()
            if not vals:
                n_empty += 1
                continue
            ok = len(vals) == len(header)
            if ok:
                try:
                    rows.append([float(v) for v in vals])
                    continue
                except ValueError:
                    ok = False
            if skip_malformed:
                n_bad += 1
                continue
            raise ValueError(f"{path}: malformed line {ln + 2} "
                             f"({len(vals)} fields, expected "
                             f"{len(header)})")
    if skip_malformed:
        return header, np.array(rows), n_empty, n_bad
    return header, np.array(rows)


def combine_mcmc(paths: list[str], out: str, verbose: bool = False) -> int:
    """Concatenate compatible mcmc.txt sample files (chain merging after
    independent runs; reference: CombineMCMCFiles, src/mcmctree.c:397).
    Blank and incomplete lines are skipped with a count; a header
    mismatch aborts (the reference's 'Header mismatch detected!')."""
    header0 = None
    all_rows = []
    for i, p in enumerate(paths):
        header, rows, n_empty, n_bad = read_mcmc_txt(p, skip_malformed=True)
        if header0 is None:
            header0 = header
        elif header != header0:
            raise ValueError(
                f"Header mismatch detected!\nFile 1 has {len(header0)} "
                f"columns\nFile {i + 1} has {len(header)} columns\n"
                f"File {i + 1}: {p}\nAll files must have the same header "
                f"structure.")
        if verbose:
            print(f"Processing file {i + 1}/{len(paths)}: {p}")
            print(f"  Lines kept = {len(rows)} | Empty lines skipped = "
                  f"{n_empty} | Incomplete lines skipped = {n_bad}")
        all_rows.append(rows)
    merged = np.concatenate(all_rows, axis=0)
    with open(out, "w") as f:
        f.write("\t".join(header0) + "\n")
        for i, r in enumerate(merged):
            r = r.tolist()
            r[0] = i + 1
            f.write("\t".join(f"{v:.6f}" if k else str(int(v))
                              for k, v in enumerate(r)) + "\n")
    return merged.shape[0]


def _natural_key(name: str):
    """Reference --combine filename ordering: digit runs compare
    numerically ('mcmc_3.txt' before 'mcmc_21.txt')."""
    import re
    return [int(t) if t.isdigit() else t
            for t in re.split(r"(\d+)", name)]


def combine_mcmc_dir(directory: str,
                     out: str = "mcmc_combined.txt") -> int:
    """`mcmctree --combine <dir>`: combine every *.txt sample file in a
    directory, sorted alphanumerically with numeric-aware digit runs
    (reference: CombineMCMCFiles_CommandLine, src/mcmctree.c:397)."""
    import os
    files = sorted((f for f in os.listdir(directory)
                    if f.endswith(".txt")), key=_natural_key)
    if not files:
        raise ValueError(f"no .txt MCMC files found in {directory!r}")
    paths = [os.path.join(directory, f) for f in files]
    print(f"Scanning directory: {directory}")
    print(f"Found {len(paths)} files to combine:")
    for i, p in enumerate(paths):
        print(f"  {i + 1}. {p}")
    n = combine_mcmc(paths, out, verbose=True)
    print(f"\nSuccessfully combined {n} lines from {len(paths)} files")
    print(f"Output written to: {out}")
    return n


# --- ds: descriptive statistics -------------------------------------------

def describe_file(path: str, burnin_frac: float = 0.0):
    """(per-column stats dict) for a whitespace table with a header row."""
    from .mcmctree import ess, hpd_interval
    header, rows = read_mcmc_txt(path)
    nburn = int(burnin_frac * rows.shape[0])
    rows = rows[nburn:]
    out = {}
    for j, name in enumerate(header):
        x = rows[:, j]
        lo, hi = np.quantile(x, [0.025, 0.975])
        h = hpd_interval(x)
        out[name] = dict(mean=float(x.mean()), sd=float(x.std(ddof=1)),
                         median=float(np.median(x)), eq_lo=float(lo),
                         eq_hi=float(hi), hpd_lo=h[0], hpd_hi=h[1],
                         ess=ess(x))
    return out


# --- BFdriver --------------------------------------------------------------

def bfdriver(ctl_template: str, nbeta: int = 8, outdir: str = "bf",
             scriptname: str = "runbf.sh"):
    """Generate per-beta control files and a run script for Gauss-Legendre
    thermodynamic integration of the marginal likelihood (reference:
    src/BFdriver.c writes qsub scripts; here a plain shell script)."""
    nodes, weights = np.polynomial.legendre.leggauss(nbeta)
    betas = (nodes + 1) / 2
    ws = weights / 2
    os.makedirs(outdir, exist_ok=True)
    with open(ctl_template) as f:
        base = f.read()
    lines = ["#!/bin/sh"]
    for i, b in enumerate(betas):
        sub = os.path.join(outdir, f"b{i + 1}")
        os.makedirs(sub, exist_ok=True)
        ctl = base + f"\nBayesFactorBeta = {b:.8f}\n"
        with open(os.path.join(sub, "mcmctree.ctl"), "w") as f:
            f.write(ctl)
        lines.append(f"(cd {sub} && python -m paml_tpu_torch mcmctree "
                     f"mcmctree.ctl > log.txt 2>&1)")
    script = os.path.join(outdir, scriptname)
    with open(script, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.chmod(script, 0o755)
    np.savetxt(os.path.join(outdir, "beta_weights.txt"),
               np.column_stack([betas, ws]))
    return betas, ws


def gauss_legendre_logml(mean_lnls: np.ndarray, weights: np.ndarray) -> float:
    """log marginal likelihood from per-beta posterior mean lnL values
    (thermodynamic integration with GL weights)."""
    return float(np.sum(np.asarray(weights) * np.asarray(mean_lnls)))


# --- multiruns -------------------------------------------------------------

def multiruns(paths: list[str], out: str, lnl_col: int = -1) -> int:
    """Merge replicate summary tables (rst1-style: one line per dataset),
    keeping the line with the best lnL for each dataset (reference:
    Technical/Simulation/multiruns.c)."""
    tables = []
    for p in paths:
        with open(p) as f:
            tables.append([line.rstrip("\n") for line in f
                           if line.strip()])
    n = min(len(t) for t in tables)
    best_lines = []
    for i in range(n):
        cand = []
        for t in tables:
            fields = t[i].split()
            try:
                lnl = float(fields[lnl_col])
            except (ValueError, IndexError):
                lnl = -np.inf
            cand.append((lnl, t[i]))
        best_lines.append(max(cand)[1])
    with open(out, "w") as f:
        f.write("\n".join(best_lines) + "\n")
    return n
