"""The NSsites battery of paml_tpu_torch.apps.codeml against
paml_tpu.apps.codeml: class omegas and weights of M1a-M13 and M2a_rel
(22) from the same parameter vectors to 1e-9; starting points, bounds,
parameter counts and extra starts; the quantile helpers; and the
objective's value (1e-8 relative) and gradient (1e-6, against `jax.grad`)
on `tests/data/clock56.codon` for the models whose omegas are quantiles
(M5-M13), and M11 at ncatG = 10 on the kink at omega = 1."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paml_tpu.apps import codeml as jax_codeml
from paml_tpu_torch import interop
from paml_tpu_torch.apps import codeml
from test_torch_codeml import _clock56, _random_x

torch.set_num_threads(1)

def t64(v):
    return torch.tensor(v, dtype=torch.float64)


MODELS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 22]


def _ncat(ns):
    return 5 if ns == 4 else 4


def _thetas(ns, fix_omega):
    """The model's starting theta, its extra starts, and two random
    in-bounds thetas."""
    ncatG = _ncat(ns)
    x0, bounds = codeml.nssites_x0_bounds(ns, ncatG, fix_omega, 0.4)
    out = [x0] + [th for th in codeml.nssites_extra_starts(
        ns, ncatG, fix_omega) if len(th) == len(x0)]
    rng = np.random.default_rng(ns)
    for _ in range(2):
        out.append([rng.uniform(max(lo, -2.0), min(hi, 3.0))
                    for lo, hi in bounds])
    return out


@pytest.mark.parametrize("fix_omega", [False, True])
@pytest.mark.parametrize("ns", MODELS)
def test_classes_match_jax(ns, fix_omega):
    ncatG = _ncat(ns)
    assert codeml.nssites_nparams(ns, ncatG, fix_omega) == \
        jax_codeml.nssites_nparams(ns, ncatG, fix_omega)
    assert codeml.nssites_x0_bounds(ns, ncatG, fix_omega, 0.4) == \
        jax_codeml.nssites_x0_bounds(ns, ncatG, fix_omega, 0.4)
    assert codeml.nssites_extra_starts(ns, ncatG, fix_omega) == \
        jax_codeml.nssites_extra_starts(ns, ncatG, fix_omega)
    for theta in _thetas(ns, fix_omega):
        wj, fj = jax_codeml.nssites_classes(ns, jnp.asarray(theta), ncatG,
                                            fix_omega, 1.7)
        w, f = codeml.nssites_classes(ns, t64(theta), ncatG,
                                      fix_omega, 1.7)
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-9)


def test_class_gradients_match_jax():
    # d omegas / d theta through the quantile code, M8 and M9
    for ns, theta in ((8, [0.8, 0.3, 1.4, 2.5]),
                      (9, [0.7, 0.6, 1.5, 1.3, 0.9])):
        w8 = np.arange(1.0, 6.0)[:5 if ns == 8 else 4]
        gj = jax.grad(lambda th: (jax_codeml.nssites_classes(
            ns, th, 4, False, 1.0)[0] * w8).sum())(jnp.asarray(theta))
        th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
        w, _ = codeml.nssites_classes(ns, th, 4, False, 1.0)
        (g,) = torch.autograd.grad((w * torch.tensor(w8)).sum(), th)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-7,
                                   atol=1e-10)


def test_cdf_quantiles_match_jax():
    theta = [0.6, 0.8, 1.6, 1.2, 0.7]
    wj = jax_codeml.cdf_quantiles(
        jax_codeml.nssites_mixture_cdf(10, jnp.asarray(theta)), 6)
    w = codeml._mixture_quantiles(10, t64(theta), 6)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-10)
    np.testing.assert_allclose(
        codeml.beta_median_quantiles(t64(0.05), t64(0.05),
                                     5).numpy(),
        np.asarray(jax_codeml.beta_median_quantiles(0.05, 0.05, 5)),
        rtol=1e-10)
    np.testing.assert_allclose(
        codeml.gamma_median_quantiles(t64(0.6), t64(1.1),
                                      5).numpy(),
        np.asarray(jax_codeml.gamma_median_quantiles(0.6, 1.1, 5)),
        rtol=1e-10)


# M10's gradient in the distribution parameters is NaN in the JAX package
# (its incomplete gamma's derivatives at 0, where every omega below 1
# evaluates the gamma part, times the zero of a `where`); the port's is
# finite.  The two are held together on the entries JAX can give.
OBJECTIVES = [5, 6, 7, 8, 9, 10, 11, 12, 13]


@pytest.mark.parametrize("ns", OBJECTIVES)
def test_quantile_model_objective_matches_jax(ns):
    data_j, topo_j = _clock56(False)
    kw = dict(NSsites=ns, ncatG=4)
    neg_j, _, _, x0_j, b_j, _ = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float64)
    neg, _, _, x0, b, _ = codeml.make_codon_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        codeml.CodemlSpec(**kw), device="cpu")
    np.testing.assert_array_equal(x0, x0_j)
    assert b == b_j
    vg_j = jax.jit(jax.value_and_grad(neg_j))
    nb = len(topo_j.branch_nodes())
    for x in (x0, _random_x(b, nb, np.random.default_rng(5))):
        vj, gj = vg_j(jnp.asarray(x))
        gj = np.asarray(gj)
        xt = interop.params_from(x, device="cpu").requires_grad_(True)
        v = neg(xt)
        (g,) = torch.autograd.grad(v, xt)
        assert abs(v.item() - float(vj)) <= 1e-8 * abs(float(vj))
        assert torch.isfinite(g).all()
        ok = np.isfinite(gj)
        assert ok.all() or ns == 10
        np.testing.assert_allclose(g.numpy()[ok], gj[ok], rtol=1e-6,
                                   atol=1e-6 * np.abs(gj[ok]).max())
        if ns == 10:
            # where JAX gives no number: central differences of the port
            for i in np.nonzero(~ok)[0]:
                e = np.zeros_like(x)
                e[i] = 1e-6
                with torch.no_grad():
                    fd = (neg(interop.params_from(x + e, device="cpu"))
                          - neg(interop.params_from(x - e, device="cpu"))
                          ) / 2e-6
                assert abs(float(fd) - float(g[i])) <= 1e-5 * max(
                    1.0, abs(float(g[i])))


def _central(neg, x, i, h):
    e = np.zeros_like(x)
    e[i] = h
    with torch.no_grad():
        return float((neg(interop.params_from(x + e, device="cpu"))
                      - neg(interop.params_from(x - e, device="cpu")))
                     / (2 * h))


def test_m11_gradient_at_its_kink():
    # M11 at ncatG = 10 and its start point: p0 = 0.95 puts the tenth
    # median target on omega = 1, where the beta part's density is 0 and
    # the normal part's starts.  The bracket ends there, the first Newton
    # step leaves it with a pdf clamped at 1e-12, and the second starts
    # 1.3e-3 past the root.  The value within 1e-8 of the JAX package's;
    # the gradient within the other models' tolerance but for p0 (x[-5],
    # the kink: the root moves at one rate above p0 and another below).
    # mu and sigma (x[-2], x[-1]) move the value only through the tenth
    # omega's landing 7e-8 above 1: their components (-2.2e-5, 4.0e-6)
    # are far below that tolerance, and are held to 1e-3 of their own size
    # against the port's own central differences, at a step h = 1e-3 where
    # those have settled (h from 1e-5 to 1e-2 agree within 2e-4; at 1e-6
    # the value's rounding moves x[-1]'s by 4 %).
    data_j, topo_j = _clock56(False)
    kw = dict(NSsites=11, ncatG=10)
    neg_j, _, _, x0_j, _, _ = jax_codeml.make_codon_objective(
        data_j, topo_j, jax_codeml.CodemlSpec(**kw), jnp.float64)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(
        interop.packed_from(data_j), interop.topology_from(topo_j),
        codeml.CodemlSpec(**kw), device="cpu")
    x = np.asarray(x0, float)
    np.testing.assert_array_equal(x, x0_j)
    vj, gj = jax.jit(jax.value_and_grad(neg_j))(jnp.asarray(x))
    gj = np.asarray(gj)
    xt = interop.params_from(x, device="cpu").requires_grad_(True)
    v = neg(xt)
    (g,) = torch.autograd.grad(v, xt)
    g = g.numpy()
    assert abs(v.item() - float(vj)) <= 1e-8 * abs(float(vj))
    assert np.isfinite(g).all()
    keep = np.arange(len(x)) != len(x) - 5
    np.testing.assert_allclose(g[keep], gj[keep], rtol=1e-6,
                               atol=1e-6 * np.abs(gj).max())
    for i in (len(x) - 2, len(x) - 1):
        fd = _central(neg, x, i, 1e-3)
        assert abs(fd - g[i]) <= 1e-3 * abs(fd), (i, fd, g[i])
