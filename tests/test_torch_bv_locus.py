"""An in.BV locus whose fit stops with a gradient component above 1e-2
(tests/data/bv10b_locus4.phy: 60 species x 5000 sites, HKY85 + G5, the
fifth locus of chip_smoke.py 10b's data when phase 7 simulates 50,000
sites, `tools/torch_bv_regen.py`; on the card the port's fit stopped at
0.0137 there).  The JAX package's `generate_BV` and the port's, on the
CPU: the branch lengths agree, and each fit's largest gradient component
off the lower bound is of order 1e-2, the reference's no smaller than
the port's (scipy's L-BFGS-B stops on the relative change of lnL, not on
the gradient).  About 10 minutes at 4 threads: marked slow."""
import os
import tempfile

import numpy as np
import pytest
import torch

from paml_tpu.apps import mcmctree as jax_mcmctree
from paml_tpu.io import seqio as jax_seqio
from paml_tpu.io import treeio as jax_treeio
from paml_tpu_torch.apps import mcmctree
from paml_tpu_torch.io import seqio, treeio

DATA = os.path.join(os.path.dirname(__file__), "data")


def _off_bound_grad(res):
    bl, g = np.asarray(res[2]), np.asarray(res[3])
    return float(np.abs(g[bl > 1e-5]).max()), bl


@pytest.mark.slow
def test_bv_locus_stops_where_the_reference_does():
    seq = os.path.join(DATA, "bv10b_locus4.phy")
    nwk = os.path.join(DATA, "bv10b.trees")
    aln = seqio.read_alignment(seq, seqio.BASE_SEQ)
    aln_j = jax_seqio.read_alignment(seq, jax_seqio.BASE_SEQ)
    names = aln.names
    kw = dict(model="HKY85", ncatG=5, alpha0=0.5)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            port = mcmctree.generate_BV(
                [aln], treeio.read_trees(nwk, names)[0], names, **kw,
                outfile=os.path.join(tmp, "p.BV"), device="cpu")[0]
            ref = jax_mcmctree.generate_BV(
                [aln_j], jax_treeio.read_trees(nwk, names)[0], names, **kw,
                outfile=os.path.join(tmp, "j.BV"))[0]
    finally:
        torch.set_num_threads(threads)
    g_port, bl_port = _off_bound_grad(port)
    g_ref, bl_ref = _off_bound_grad(ref)
    print(f"largest |dlnL/db| off the bound: port {g_port:.6f}, paml_tpu "
          f"{g_ref:.6f}; branch lengths within "
          f"{np.abs(bl_port - bl_ref).max():.3e}")
    np.testing.assert_allclose(bl_port, bl_ref, atol=1e-5)
    assert g_port <= g_ref < 0.05
