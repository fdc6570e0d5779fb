"""paml_tpu_torch's entry points (`entry.py`) against `__graft_entry__.py`
on the CPU: `entry()`'s value and gradient of the synthetic M2a problem
equal the JAX package's on the same problem in float64 (1e-12), and
`dryrun_multichip` runs its four checks on a CPU mesh of two shards."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as jax_entry
from paml_tpu_torch import entry

torch.set_num_threads(1)


def test_entry_matches_jax():
    fn, (x,) = entry.entry(device="cpu")
    neg, x0, tips, fpatt = jax_entry._synthetic_codon_problem(
        dtype=jnp.float64)
    vj, gj = jax.jit(jax.value_and_grad(neg))(jnp.asarray(x0, jnp.float64))
    np.testing.assert_allclose(x.numpy(), np.asarray(x0, np.float64),
                               rtol=1e-6)
    # the JAX entry hands x0 over in float32: evaluate both at that x.
    # The gradients' P(t) routes differ (the port's Daleckii-Krein backward
    # of the spectral P, JAX's autodiff of eigh): 1.8e-11 of the largest
    # component on this problem of unrelated random codons
    xj = torch.as_tensor(np.asarray(x0, np.float64))
    v, g = fn(xj)
    assert abs(float(v) - float(vj)) <= 1e-12 * abs(float(vj))
    assert float(np.abs(g.numpy() - np.asarray(gj)).max()) <= \
        1e-10 * float(np.abs(np.asarray(gj)).max())
    assert x.dtype == torch.float64 and v.device.type == "cpu"


def test_synthetic_problem_draws_match_jax():
    _, x0, tips, fpatt = entry._synthetic_codon_problem(device="cpu")
    _, x0j, tipsj, fpattj = jax_entry._synthetic_codon_problem(
        dtype=jnp.float64)
    np.testing.assert_array_equal(tips, tipsj)
    np.testing.assert_array_equal(fpatt, fpattj)
    np.testing.assert_allclose(x0, x0j, rtol=1e-6)
    P, ktips, topo, pi = entry._random_kernel_problem(16, 64, 2, seed=1,
                                                      device="cpu")
    Pj, kj, topoj, pij = jax_entry._random_kernel_problem(16, 64, 2, seed=1)
    np.testing.assert_array_equal(ktips.numpy(), np.asarray(kj))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=1e-6)
    np.testing.assert_array_equal(topo.children, topoj.children)


def test_dryrun_multichip_on_two_cpu_shards(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = entry.dryrun_multichip(2, ["cpu", "cpu"])
    assert set(out) == {"step1", "step2", "step3", "step4"}
    assert np.isfinite(out["step1"]["lnL"]) and out["step4"] < 0
