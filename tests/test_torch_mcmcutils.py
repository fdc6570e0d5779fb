"""paml_tpu_torch's MCMC utilities against paml_tpu's on the same files:
mcmc.txt writing and reading, chain combining (files and a directory,
with blank and incomplete lines, the header check), ds's statistics,
BFdriver's files, the Gauss-Legendre log marginal likelihood, multiruns,
and checkpoints (the numpy generator's state included)."""
import os

import numpy as np
import pytest

from paml_tpu.apps import mcmcutils as JU
from paml_tpu_torch.apps import mcmcutils as TU


def sample_files(d, rng, k=3, n=60):
    paths = []
    for i in range(k):
        rows = [dict(lnL=-1000 + rng.normal(), t_n7=rng.normal(0.5, 0.05),
                     mu1=rng.normal(0.2, 0.02)) for _ in range(n)]
        p = os.path.join(d, f"mcmc_{(1, 3, 21)[i]}.txt")
        JU.write_mcmc_txt(rows, p)
        paths.append(p)
    return paths


def test_write_and_read_match(tmp_path):
    rng = np.random.default_rng(0)
    rows = [dict(lnL=-rng.random(), t=rng.random()) for _ in range(20)]
    JU.write_mcmc_txt(rows, str(tmp_path / "j.txt"))
    TU.write_mcmc_txt(rows, str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "t.txt").read_bytes()
    hj, rj = JU.read_mcmc_txt(str(tmp_path / "j.txt"))
    ht, rt = TU.read_mcmc_txt(str(tmp_path / "j.txt"))
    assert ht == hj
    np.testing.assert_array_equal(rt, rj)


def test_combine_matches(tmp_path):
    d = tmp_path / "to_combine"
    d.mkdir()
    paths = sample_files(str(d), np.random.default_rng(1))
    with open(paths[1], "a") as f:
        f.write("61\t-1000.1\n")               # a truncated last line
    with open(paths[2], "a") as f:
        f.write("\n")                          # a blank line
    for mod, tag in ((JU, "j"), (TU, "t")):
        assert mod.combine_mcmc(paths, str(tmp_path / f"{tag}.txt")) == 180
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    cwd = os.getcwd()
    for mod, tag in ((JU, "j"), (TU, "t")):
        os.chdir(tmp_path)
        try:
            mod.combine_mcmc_dir(str(d), out=f"dir_{tag}.txt")
        finally:
            os.chdir(cwd)
    assert (tmp_path / "dir_t.txt").read_bytes() == \
        (tmp_path / "dir_j.txt").read_bytes()
    assert TU._natural_key("mcmc_21.txt") == JU._natural_key("mcmc_21.txt")
    other = tmp_path / "other.txt"
    other.write_text("Gen\tx\n1\t0.1\n")
    with pytest.raises(ValueError, match="Header mismatch"):
        TU.combine_mcmc([paths[0], str(other)], str(tmp_path / "x.txt"))


def test_describe_file_matches(tmp_path):
    p = sample_files(str(tmp_path), np.random.default_rng(2), k=1)[0]
    for frac in (0.0, 0.2):
        assert TU.describe_file(p, frac) == JU.describe_file(p, frac)


def test_bfdriver_and_logml_match(tmp_path):
    ctl = tmp_path / "m.ctl"
    ctl.write_text("seqfile = x\nusedata = 2\n")
    bj = JU.bfdriver(str(ctl), nbeta=6, outdir=str(tmp_path / "bfj"))
    bt = TU.bfdriver(str(ctl), nbeta=6, outdir=str(tmp_path / "bft"))
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a, b)
    for k in range(1, 7):
        assert (tmp_path / "bft" / f"b{k}" / "mcmctree.ctl").read_text() == \
            (tmp_path / "bfj" / f"b{k}" / "mcmctree.ctl").read_text()
    assert (tmp_path / "bft" / "beta_weights.txt").read_text() == \
        (tmp_path / "bfj" / "beta_weights.txt").read_text()
    # the run script names this package's module
    sj = (tmp_path / "bfj" / "runbf.sh").read_text()
    st = (tmp_path / "bft" / "runbf.sh").read_text()
    assert st == sj.replace("-m paml_tpu ", "-m paml_tpu_torch ").replace(
        "bfj", "bft")
    m = np.linspace(-130, -120, 6)
    assert TU.gauss_legendre_logml(m, bt[1]) == \
        JU.gauss_legendre_logml(m, bj[1])


def test_multiruns_matches(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for k in range(3):
        p = tmp_path / f"r{k}.txt"
        p.write_text("".join(f"{i + 1} {rng.random():.4f} "
                             f"{-100 - rng.random() * 5:.6f}\n"
                             for i in range(12 + k)) + "\n")
        paths.append(str(p))
    assert TU.multiruns(paths, str(tmp_path / "t.txt")) == \
        JU.multiruns(paths, str(tmp_path / "j.txt")) == 12
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_checkpoints_cross_packages(tmp_path):
    class Chain:
        pass
    rng = np.random.default_rng(42)
    mc = Chain()
    mc.ages, mc.mu, mc.sigma2 = rng.random(5), rng.random(3), rng.random(3)
    mc.rates, mc.kappa, mc.alpha_g = (rng.random((5, 3)), rng.random(3),
                                      rng.random(3))
    mc.rng = rng
    mc.steps = {"t": np.full(2, 0.3)}
    TU.save_state(mc, str(tmp_path / "t.ckpt"), it=7)
    JU.save_state(mc, str(tmp_path / "j.ckpt"), it=7)
    nxt = mc.rng.random()
    for mod, path in ((JU, "t.ckpt"), (TU, "j.ckpt"), (TU, "t.ckpt")):
        m2 = Chain()
        m2.rng = np.random.default_rng(0)
        assert mod.load_state(m2, str(tmp_path / path)) == 7
        np.testing.assert_array_equal(m2.rates, mc.rates)
        np.testing.assert_array_equal(m2._resume_steps["t"], mc.steps["t"])
        assert m2.rng.random() == nxt
