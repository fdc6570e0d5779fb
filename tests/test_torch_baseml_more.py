"""paml_tpu_torch baseml objective against paml_tpu, continued (the
helpers and tolerances of tests/test_torch_baseml.py): clocks 1 / 2 / 3
(with the tree's `@0.45` fossil) and TipDate, the free-rate models nparK
1-4 and the auto-discrete-gamma rate HMM, and the multi-starts of the
nparK fits.  The nonhomogeneous models: tests/test_torch_baseml_nhomo.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from paml_tpu.apps import baseml as jax_baseml
from paml_tpu_torch import interop
from paml_tpu_torch.apps import baseml

from test_torch_baseml import check_objective, clock56

CASES = {
    "clock1_HKY85": (dict(model="HKY85", clock=1), ""),
    "clock1_HKY85_G4": (dict(model="HKY85", clock=1, ncatG=4,
                             fix_alpha=False), ""),
    "clock2_K80": (dict(model="K80", clock=2), "labelled"),
    "clock3_HKY85": (dict(model="HKY85", clock=3), "labelled genes"),
    "tipdate_clock1_HKY85": (dict(model="HKY85", clock=1, tipdate=True,
                                  tipdate_timeunit=10.0), "tipdate"),
    "nparK1": (dict(model="HKY85", ncatG=3, nparK=1), ""),
    "nparK2": (dict(model="HKY85", ncatG=3, nparK=2), ""),
    "nparK3": (dict(model="HKY85", ncatG=3, nparK=3), ""),
    "nparK4": (dict(model="K80", ncatG=3, nparK=4), ""),
    "AdG_HKY85": (dict(model="HKY85", ncatG=4, fix_alpha=False,
                       fix_rho=False), ""),
    "AdG_rho_fixed": (dict(model="JC69", ncatG=3, alpha=0.8, rho=0.4), ""),
}


@pytest.mark.parametrize("name", list(CASES))
def test_objective_matches_jax(name):
    kw, variant = CASES[name]
    # clock parameters are ages and proportions: any in-bounds value does
    check_objective(kw, variant, nb=0 if kw.get("clock") else None)


def check_multi_starts(kw, monkeypatch):
    """x0 and the extra starts of a fit, against those the JAX package's
    `fit_packed` hands its optimizer."""
    data_j, topo_j = clock56()

    class Starts(Exception):
        pass

    def capture(_make, _neg, x0, bounds, multi_start=None, **_):
        raise Starts(x0, multi_start)
    monkeypatch.setattr(jax_baseml, "maximize_auto", capture)
    with pytest.raises(Starts) as got:
        jax_baseml.fit_packed(data_j, topo_j, jax_baseml.BasemlSpec(**kw),
                              dtype=jnp.float64)
    x0_j, multi_j = got.value.args
    data, topo = interop.packed_from(data_j), interop.topology_from(topo_j)
    spec = baseml.BasemlSpec(**kw)
    if kw.get("nhomo"):
        x0 = baseml.make_nhomo_objective(data, topo, spec, device="cpu")[2]
        multi = baseml.nhomo_starts(data, topo, x0)
    else:
        x0 = baseml.make_objective(data, topo, spec, device="cpu")[2]
        multi = baseml.npark_starts(spec, x0)
    np.testing.assert_array_equal(x0, x0_j)
    assert len(multi) == len(multi_j)
    for a, b in zip(multi, multi_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(model="HKY85", ncatG=3, nparK=2), dict(model="HKY85", ncatG=3,
                                                nparK=4)],
    ids=["nparK2", "nparK4"])
def test_multi_starts_match_jax(kw, monkeypatch):
    check_multi_starts(kw, monkeypatch)
