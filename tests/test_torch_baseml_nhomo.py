"""paml_tpu_torch baseml's nonhomogeneous models against paml_tpu (the
helpers and tolerances of tests/test_torch_baseml.py): the objective of
nhomo 1-5, value and gradient at x0 and at a random in-bounds x (nhomo 5
by branch label, nhomo 3 with label-defined rate sets on gapped tips), and
the multi-starts of the nhomo fits."""
import pytest

from test_torch_baseml import check_objective
from test_torch_baseml_more import check_multi_starts

CASES = {
    "nhomo1_HKY85": (dict(model="HKY85", nhomo=1), ""),
    "nhomo1_REV": (dict(model="REV", nhomo=1), ""),
    "nhomo2_K80": (dict(model="K80", nhomo=2), ""),
    "nhomo3_HKY85": (dict(model="HKY85", nhomo=3), ""),
    "nhomo4_TN93": (dict(model="TN93", nhomo=4), ""),
    "nhomo5_HKY85": (dict(model="HKY85", nhomo=5), "labelled"),
    "nhomo3_fixkappa2_gapped": (dict(model="HKY85", nhomo=3, fix_kappa=2),
                                "labelled gapped"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_objective_matches_jax(name):
    check_objective(*CASES[name])


@pytest.mark.parametrize("kw", [dict(model="HKY85", nhomo=1),
                                dict(model="K80", nhomo=2)],
                         ids=["nhomo1", "nhomo2"])
def test_multi_starts_match_jax(kw, monkeypatch):
    check_multi_starts(kw, monkeypatch)
