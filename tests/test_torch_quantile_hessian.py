"""The Hessian behind codeml's standard errors through the quantile code's
card route (`dgamma._e2` sent to E2's plain versions, whose second
partials the card's kernel returns) against the host route, on the CPU:
M8 (the beta quantiles' second partials, in the batched rows of
`codeml.hessian`) and M10 (the mixture quantiles' Newton steps, their pdf
on its graph, third partials taken as 0) on tests/data/clock56.codon,
within 1e-10 of the largest entry: the host route's second derivatives of
lgamma are torch's trigamma, which truncates its series (4.9e-10 relative
off scipy's), the card's its own (7e-16); with torch's trigamma in both
the two agree to 2e-15."""
import os

import numpy as np
import pytest
import torch

from paml_tpu_torch.apps import codeml
from paml_tpu_torch.core import cuda_quantile, dgamma
from paml_tpu_torch.core.topology import from_treenode
from paml_tpu_torch.io import seqio, treeio

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.parametrize("NSsites", [8, 10])
def test_hessian_through_the_card_route(NSsites, monkeypatch):
    data = seqio.pack(seqio.read_alignment(
        os.path.join(DATA, "clock56.codon"), seqio.CODON_SEQ))
    topo = from_treenode(treeio.read_trees(
        os.path.join(DATA, "clock56.trees"), data.names)[0], data.names)
    neg, _, _, x0, _, _ = codeml.make_codon_objective(
        data, topo, codeml.CodemlSpec(NSsites=NSsites, ncatG=3),
        device="cpu")
    host = codeml.hessian(neg, x0, device="cpu")
    monkeypatch.setattr(dgamma, "_e2", lambda t: cuda_quantile.PLAIN)
    card = codeml.hessian(neg, x0, device="cpu")
    assert np.isfinite(card).all()
    assert np.abs(card - host).max() <= 1e-10 * np.abs(host).max()
