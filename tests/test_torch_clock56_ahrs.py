"""paml_tpu_torch's clock 6 (the AHRS local clock: no-clock fits with
their branch-length curvatures, the rate smoothing, the grouped refit)
against paml_tpu's on tests/data/clock56.nuc (lnL to 1e-6, the same rate
groups; marked slow for the JAX side's minute) and against
tests/golden_clock56.json as tests/test_clock56.py holds it; and with
getSE the SEs from the twice-differentiable route."""
import json
import os

import numpy as np
import pytest
import torch

from paml_tpu.apps import clock56 as J
from paml_tpu_torch.apps import clock56 as T

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
GOLD = json.load(open(os.path.join(HERE, "golden_clock56.json")))
ARGS = (os.path.join(HERE, "data", "clock56.trees"),
        os.path.join(HERE, "data", "clock56.nuc"), 2)


@pytest.mark.slow
def test_clock6_matches_jax_and_golden():
    """Slow: the JAX package's clock 6 takes about a minute on one CPU
    (its step 1 curvatures in eager mode); test_clock6_matches_golden
    keeps clock 6 in the quick pass."""
    spec = dict(clock=6, model="HKY85", ncatG=1)
    rj = J.fit_clock6(J.read_tree_seqs(*ARGS), J.Clock56Spec(**spec))
    rt = T.fit_clock6(T.read_tree_seqs(*ARGS), T.Clock56Spec(**spec),
                      device="cpu")
    assert rt.lnL == pytest.approx(rj.lnL, abs=1e-6)
    for a, b in zip(rt.labels, rj.labels):
        np.testing.assert_array_equal(a, b)
    assert rt.step2["objective"] == pytest.approx(rj.step2["objective"],
                                                  rel=1e-8)
    np.testing.assert_allclose(rt.step2["ages"], rj.step2["ages"],
                               rtol=1e-5, atol=1e-7)
    ref = GOLD["clock6"]
    assert rt.lnL == pytest.approx(ref["lnL"], abs=5e-3)
    np.testing.assert_allclose(rt.kappa.ravel(), ref["kappa"], atol=5e-3)


def test_clock6_matches_golden():
    """The port's clock 6 against the reference's values, to the bounds
    tests/test_clock56.py holds the JAX package to (the JAX package's own
    clock 6 lies within them)."""
    res = T.fit_clock6(T.read_tree_seqs(*ARGS),
                       T.Clock56Spec(clock=6, model="HKY85", ncatG=1),
                       device="cpu")
    ref = GOLD["clock6"]
    assert res.lnL == pytest.approx(ref["lnL"], abs=5e-3)
    np.testing.assert_allclose(res.kappa.ravel(), ref["kappa"], atol=5e-3)
    assert res.step2 is not None and "nu" in res.step2


def test_clock5_standard_errors():
    """getSE: the port's SEs by `codeml.hessian` on the objective's
    twice-differentiable route, against central differences of its
    gradient."""
    hd = T.read_tree_seqs(*ARGS)
    spec = T.Clock56Spec(clock=5, model="HKY85", ncatG=1, getSE=True)
    res = T.fit_clock5(hd, spec, device="cpu")
    assert res.SEs is not None and np.isfinite(res.SEs).all()
    neg = T.make_step3_objective(hd, spec, res.labels, [1, 1],
                                 device="cpu")[0]

    def grad(x):
        xt = torch.tensor(x, requires_grad=True)
        return torch.autograd.grad(neg(xt), xt)[0].numpy()
    x = res.fit.x
    h = 1e-5 * np.maximum(np.abs(x), 1e-3)
    H = np.stack([(grad(x + h[i] * np.eye(len(x))[i])
                   - grad(x - h[i] * np.eye(len(x))[i])) / (2 * h[i])
                  for i in range(len(x))])
    se = np.sqrt(np.maximum(np.diag(np.linalg.pinv((H + H.T) / 2)), 0))
    np.testing.assert_allclose(res.SEs, se, rtol=1e-3)
