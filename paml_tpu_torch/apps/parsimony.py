"""Fitch parsimony change counts (reference: MPScore / UpPass,
src/treesub.c:5417-5642).

Port of the part of `paml_tpu/apps/parsimony.py` that pamp calls
(`_tip_bitmasks`, `site_change_counts`; numpy on the host).  State sets
are bitmasks and the up-pass is vectorized over all site patterns at once.
`mp_score`, `informative_sites` and `pathway_mp` go with tree search
(ROADMAP A14).
"""
from __future__ import annotations

import numpy as np

from ..core.topology import Topology
from ..io import seqio


def _tip_bitmasks(data: seqio.PackedData) -> np.ndarray:
    """[ns, H] uint32 bitmask of compatible states per tip/pattern."""
    bits = (data.tip_partials > 0).astype(np.uint32)
    weights = (1 << np.arange(data.nstates, dtype=np.uint32))
    return (bits * weights[None, None, :]).sum(-1).astype(np.uint32)


def site_change_counts(topo: Topology, data: seqio.PackedData) -> np.ndarray:
    """Minimum change count per pattern (Fitch)."""
    masks = _tip_bitmasks(data)
    H = data.npatt
    buf = np.zeros((topo.nnode, H), dtype=np.uint32)
    buf[:topo.ns] = masks
    changes = np.zeros(H, dtype=np.int64)
    for node in topo.postorder:
        kids = [c for c in topo.children[node] if c >= 0]
        acc = buf[kids[0]]
        for c in kids[1:]:
            inter = acc & buf[c]
            nz = inter != 0
            changes += (~nz).astype(np.int64)
            acc = np.where(nz, inter, acc | buf[c])
        buf[node] = acc
    return changes
