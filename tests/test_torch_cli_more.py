"""More of `python -m paml_tpu_torch codeml --device cpu` against
`python -m paml_tpu codeml` on the 6-taxon problem of
`tests/test_torch_cli.py`: `getSE = 1` (the SEs to 1e-4 relative, and the
dN & dS table), FASTA input with two trees (the tree-comparison table and
a two-tree `lnf`), and two data sets in one file (`ndata`)."""
import os

import numpy as np
import torch

from paml_tpu import __main__ as jax_cli
from paml_tpu_torch import __main__ as cli
from paml_tpu_torch.io import outputs
from test_torch_cli import (lnl_lines, problem, rst1_rows,  # noqa: F401
                            run_both, write_problem)

torch.set_num_threads(1)


def test_standard_errors_match_jax_cli(problem, tmp_path, monkeypatch):
    names, rows, nwk, cls = problem
    dj, dt, out = run_both(tmp_path, monkeypatch, names, rows, [nwk],
                           nssites="0", getSE=1)

    def ses(d):
        text = open(os.path.join(d, "mlc")).read()
        line = text.split("SEs for parameters:\n")[1].splitlines()[0]
        return np.array([float(v) for v in line.split()])
    sj, st = ses(dj), ses(dt)
    assert len(st) == out["runs"][0]["res"].np and (st > 0).all()
    # five decimals in the file
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(lnl_lines(dt), lnl_lines(dj), rtol=1e-6)
    # the dN & dS table of M0
    def dnds(d):
        text = open(os.path.join(d, "mlc")).read()
        block = text.split("dN & dS for each branch\n")[1].split("SEs")[0]
        return [line.split() for line in block.splitlines()[1:] if line]
    tj, tt = dnds(dj), dnds(dt)
    assert [r[0] for r in tt] == [r[0] for r in tj]
    np.testing.assert_allclose(
        np.array([[float(v) for v in r[1:]] for r in tt]),
        np.array([[float(v) for v in r[1:]] for r in tj]), atol=2e-3)


def test_fasta_and_two_trees(problem, tmp_path, monkeypatch):
    names, rows, nwk, cls = problem
    other = "((t0,t2),(t1,(t3,t4)),t5);"
    dj, dt, out = run_both(tmp_path, monkeypatch, names, rows, [nwk, other],
                           fasta=True, nssites="0")
    np.testing.assert_allclose(lnl_lines(dt), lnl_lines(dj), rtol=1e-6)

    def table(d):
        text = open(os.path.join(d, "mlc")).read()
        block = text.split("Tree comparison (RELL / KH / SH)\n")[1]
        return np.array([[float(v) for v in line.split()]
                         for line in block.splitlines()[1:3]])
    tj, tt = table(dj), table(dt)
    assert tt.shape == (2, 5)
    # the RELL draws are seeded alike; the lnf values differ in the last
    # digits, which may move a draw
    np.testing.assert_allclose(tt, tj, atol=2e-3)
    _, _, lnf_t = outputs.read_lnf(os.path.join(dt, "lnf"))
    assert lnf_t.shape == (2, out["data"].npatt)


def test_ndata(problem, tmp_path, monkeypatch):
    names, rows, nwk, cls = problem
    half = 3 * 75
    d = str(tmp_path / "torch")
    ctl = write_problem(d, names, rows, [nwk], ndata=2)
    with open(os.path.join(d, "seq.txt"), "w") as f:
        for part in ([r[:half] for r in rows], [r[half:] for r in rows]):
            f.write(f"{len(names)} {len(part[0])}\n")
            for nm, row in zip(names, part):
                f.write(f"{nm}  {row}\n")
            f.write("\n")
    dj = str(tmp_path / "jax")
    os.makedirs(dj)
    monkeypatch.chdir(dj)
    jax_cli.run_codeml(ctl)
    monkeypatch.chdir(d)
    out = cli.main(["codeml", ctl, "--device", "cpu"])
    assert len(out["runs"]) == 2
    for a, b in zip(rst1_rows(d), rst1_rows(dj)):
        assert a[0] == b[0] and abs(a[1] - b[1]) <= 1e-6 * abs(b[1])
