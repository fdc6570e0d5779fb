"""`python -m paml_tpu_torch codeml <ctl> --device cpu` against `python -m
paml_tpu codeml` for the settings of ROADMAP A9: amino-acid data
(seqtype 2, with gaps and X), codons translated (seqtype 3, JTT),
aaDist = 7 with an OmegaAA.dat beside the control file, and Mgene = 2 over
two genes (option G).  Each program runs in a directory of its own;
compared: `mlc`'s lnL (2e-4) and np, and `rst1`'s length.  The JAX
program stops in its dN/dS table after writing `mlc`'s lnL line under
Mgene (ROADMAP C); the port writes `mlc` and `rst1` alone there, as for
amino acids and aaDist."""
import os
import re

import numpy as np
import pytest
import torch

from paml_tpu import __main__ as jax_cli
from paml_tpu.io import seqio as jax_seqio
from paml_tpu_torch import __main__ as cli

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")

CTL = """      seqfile = seq.txt
     treefile = tree.txt
      outfile = mlc
        noisy = 0
      runmode = 0
      seqtype = {seqtype}
    CodonFreq = 2
        model = {model}
   aaRatefile = {ratefile}
      NSsites = 0
        icode = 0
        Mgene = {mgene}
       aaDist = {aadist}
    fix_kappa = {fix_kappa}
        kappa = 2
    fix_omega = 0
        omega = .4
    fix_alpha = {fix_alpha}
        alpha = 0.5
        ncatG = 4
    cleandata = 0
"""

OMEGA_AA = "2\n1: AG AS AT VI IL LM FY DE KR\n0: all others\n"


def clock56_rows(seqtype):
    aln = jax_seqio.read_alignment(os.path.join(DATA, "clock56.codon"),
                                   jax_seqio.CODON_SEQ)
    rows = list(aln.rows)
    if seqtype == 2:
        rows = jax_seqio.translate_codon_rows(rows)
        rows[0] = "XX" + rows[0][2:]
        rows[3] = rows[3][:40] + "-" * 12 + rows[3][52:]
    return aln.names, rows


def write(d, seqtype, genes=None, **kw):
    os.makedirs(d)
    names, rows = clock56_rows(seqtype)
    with open(os.path.join(d, "seq.txt"), "w") as f:
        f.write(f"{len(rows)} {len(rows[0])}" + (" G" if genes else "")
                + "\n")
        if genes:
            f.write(f"G {len(genes)} " + " ".join(map(str, genes)) + "\n")
        for nm, row in zip(names, rows):
            f.write(f"{nm}  {row}\n")
    with open(os.path.join(d, "tree.txt"), "w") as f:
        f.write(open(os.path.join(DATA, "clock56.trees")).read())
    opts = dict(seqtype=seqtype, model=0, ratefile="jones", mgene=0,
                aadist=0, fix_alpha=1, fix_kappa=0)
    opts.update(kw)
    if opts["aadist"] == 7:
        with open(os.path.join(d, "OmegaAA.dat"), "w") as f:
            f.write(OMEGA_AA)
    with open(os.path.join(d, "codeml.ctl"), "w") as f:
        f.write(CTL.format(**opts))


def mlc_fits(d):
    text = open(os.path.join(d, "mlc")).read()
    return [(int(m[0]), float(m[1])) for m in re.findall(
        r"lnL\(ntime: *\d+ +np: *(\d+)\): *(-?[0-9.]+)", text)]


CASES = {
    "aa_lg_gamma": (2, None, dict(model=3, ratefile="lg", fix_alpha=0)),
    "codon2aa_jones": (3, None, dict(model=2)),
    # kappa fixed: three starts instead of nine (`aadist_starts`)
    "aadist7": (1, None, dict(aadist=7, fix_kappa=1)),
    "mgene2": (1, [150, 150], dict(mgene=2)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cli_matches_jax(name, tmp_path, monkeypatch):
    seqtype, genes, kw = CASES[name]
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    write(dj, seqtype, genes, **kw)
    write(dt, seqtype, genes, **kw)
    monkeypatch.chdir(dj)
    if name == "mgene2":
        # the JAX program's dN/dS table reads the class omegas that its
        # Mgene fit does not have (ROADMAP C)
        with pytest.raises(AttributeError, match="shape"):
            jax_cli.run_codeml("codeml.ctl")
    else:
        jax_cli.run_codeml("codeml.ctl")
    monkeypatch.chdir(dt)
    out = cli.main(["codeml", "codeml.ctl", "--device", "cpu"])
    fj, ft = mlc_fits(dj), mlc_fits(dt)
    assert len(ft) == len(fj) == 1
    assert ft[0][0] == fj[0][0]
    assert abs(ft[0][1] - fj[0][1]) <= 2e-4
    rst1 = open(os.path.join(dt, "rst1")).read().split()
    assert len(rst1) == 1 + ft[0][0]
    assert len(open(os.path.join(dj, "rst1")).read().split()) == len(rst1)
    res = out["runs"][0]["res"]
    assert abs(res.lnL - ft[0][1]) <= 1e-6
    # amino acids, aaDist and Mgene write no lnf (the JAX program neither)
    assert not os.path.exists(os.path.join(dt, "lnf"))
    assert not os.path.exists(os.path.join(dj, "lnf"))
    np.testing.assert_equal(out["data"].ngene, 2 if genes else 1)
