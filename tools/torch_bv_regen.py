"""Regenerate chip_smoke.py 10b's in.BV data set as a given phase-7 size
makes it, on the card, and stop after 10b.

    python3 tools/torch_bv_regen.py SITES OUTDIR

The script's phases draw their data from one generator in turn, so 10b's
alignment (60 species x 8 loci x 5000 sites, HKY85 + G5) depends on how
many sites phase 7 simulated before it.  This runs chip_smoke.py's main
with phase 7 simulating and running SITES sites (50000 gives the data on
which 10b's gradient check once failed), writes 10b's `seq.txt` and
`tree.nwk` to OUTDIR, lets 10b print its per-locus gradients, and exits
0 after 10b whatever its check says.  Needs one CUDA card; the phases
before 10b take about 8 minutes."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import chip_smoke as cs

    sites, out = int(sys.argv[1]), sys.argv[2]
    os.makedirs(out, exist_ok=True)
    cs.NUC_SIM_SITES = cs.NUC_SITES = sites
    real_sim, real_nwk, real_bv = (cs.simulate_dated, cs.annotated_newick,
                                   cs.date_bv)

    def simulate_dated(torch, rng, names, joined, rates, ls, *a, **kw):
        res = real_sim(torch, rng, names, joined, rates, ls, *a, **kw)
        if len(names) == cs.BV_TAXA and len(ls) == cs.BV_LOCI:
            with open(os.path.join(out, "seq.txt"), "w") as f:
                f.write(cs.stacked_phylip([(names, r) for r in res[0]]))
        return res

    def annotated_newick(names, joined, cals):
        s = real_nwk(names, joined, cals)
        if len(names) == cs.BV_TAXA:
            with open(os.path.join(out, "tree.nwk"), "w") as f:
                f.write(f"{cs.BV_TAXA} 1\n\n{s}\n")
        return s

    def date_bv(*a, **kw):
        try:
            return real_bv(*a, **kw)
        finally:
            print(f"10b's data in {out}; stopping after 10b", flush=True)
            os._exit(0)

    cs.simulate_dated, cs.annotated_newick, cs.date_bv = (
        simulate_dated, annotated_newick, date_bv)
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
