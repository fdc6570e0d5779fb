"""paml_tpu_torch nucleotide models against paml_tpu: P(t) of all eleven
models (`nuc.pmats_for_model`: the TN93 closed forms, the spectral P(t)
of REV and REVu, matrix_exp for UNREST and UNRESTu, with the root
frequencies each implies) at random rates, frequencies and branch x class
lengths, value to 1e-12 and the gradient of a random linear functional in
the rates, frequencies and lengths to 1e-10 of its largest component; the
same through the route that is differentiable twice, whose second
derivative is held against `jax.hessian` for HKY85 and UNREST."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.io import ctl as jax_ctl
from paml_tpu.models import nuc as jax_nuc
from paml_tpu_torch.io import ctl
from paml_tpu_torch.models import nuc

torch.set_num_threads(1)

N_RATES = {"JC69": 1, "K80": 1, "F81": 1, "F84": 1, "HKY85": 1, "T92": 1,
           "TN93": 2, "REV": 5, "UNREST": 11, "REVu": 2, "UNRESTu": 3}
STEPS = {"REVu": "[2 (TC) (AG)]", "UNRESTu": "[3 (TC CT) (AG) (GA TA)]"}


def problem(model, seed=3):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.3, 4.0, N_RATES[model])
    pi = rng.dirichlet(np.full(4, 5.0))
    ts = rng.uniform(0.001, 1.5, (7, 3))
    W = rng.normal(size=(7, 3, 4, 4))
    step = None
    if model in STEPS:
        step, nrate = ctl.parse_step_matrix(STEPS[model], model == "REVu")
        step_j, _ = jax_ctl.parse_step_matrix(STEPS[model], model == "REVu")
        np.testing.assert_array_equal(step, step_j)
        assert nrate == N_RATES[model]
    return rates, pi, ts, W, step


def jax_functional(model, step, W):
    def f(rates, pi, ts):
        P, pi_root = jax_nuc.pmats_for_model(model, rates, pi, ts, step)
        return jnp.sum(P * W) + jnp.sum(pi_root * jnp.arange(1.0, 5.0))
    return f


def torch_functional(model, step, W, twice=False):
    Wt = torch.as_tensor(W)

    def f(rates, pi, ts):
        P, pi_root = nuc.pmats_for_model(model, rates, pi, ts, step, twice)
        return (P * Wt).sum() + (pi_root * torch.arange(
            1.0, 5.0, dtype=torch.float64)).sum()
    return f


@pytest.mark.parametrize("twice", [False, True], ids=["fit", "twice"])
@pytest.mark.parametrize("model", nuc.NUC_MODELS)
def test_pmats_match_jax(model, twice):
    rates, pi, ts, W, step = problem(model)
    P_j, pi_j = jax_nuc.pmats_for_model(model, jnp.asarray(rates),
                                        jnp.asarray(pi), jnp.asarray(ts),
                                        step)
    args = [torch.tensor(v, requires_grad=True) for v in (rates, pi, ts)]
    P, pi_r = nuc.pmats_for_model(model, *args, step=step, twice=twice)
    assert P.shape == (7, 3, 4, 4)
    np.testing.assert_allclose(P.detach().numpy(), np.asarray(P_j),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(pi_r.detach().numpy(), np.asarray(pi_j),
                               rtol=1e-12)
    np.testing.assert_allclose(P.detach().sum(-1).numpy(), 1.0, atol=1e-12)
    g_j = jax.grad(jax_functional(model, step, W), argnums=(0, 1, 2))(
        jnp.asarray(rates), jnp.asarray(pi), jnp.asarray(ts))
    # JC69 and F81 do not read the rates, UNREST(u) not the frequencies
    g = torch.autograd.grad(torch_functional(model, step, W, twice)(*args),
                            args, allow_unused=True)
    for a, b, v in zip(g, g_j, args):
        b = np.asarray(b)
        a = torch.zeros_like(v) if a is None else a
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-10 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("model", ["HKY85", "UNREST"])
def test_second_derivative_matches_jax(model):
    rates, pi, ts, W, step = problem(model, seed=4)
    f_j = jax_functional(model, step, W)
    H_j = np.asarray(jax.hessian(lambda r: f_j(r, jnp.asarray(pi),
                                               jnp.asarray(ts)))(
        jnp.asarray(rates)))
    f = torch_functional(model, step, W, twice=True)
    H = torch.autograd.functional.hessian(
        lambda r: f(r, torch.as_tensor(pi), torch.as_tensor(ts)),
        torch.as_tensor(rates)).numpy()
    np.testing.assert_allclose(H, H_j, rtol=0,
                               atol=1e-9 * np.abs(H_j).max())


def test_model_pi_matches_jax():
    obs = np.array([0.1, 0.35, 0.25, 0.3])
    for model in nuc.NUC_MODELS:
        np.testing.assert_array_equal(nuc.model_pi(model, obs),
                                      jax_nuc.model_pi(model, obs))
