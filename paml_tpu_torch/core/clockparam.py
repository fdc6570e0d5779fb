"""Clock branch-length parameterization shared by the ML programs.

Port of `paml_tpu/core/clockparam.py`.  Reference semantics (SetBranch,
src/treesub.c:3770; SetAge/GetAgeLow :3713-3766; GetBranchRate :3682):
with clock >= 1 the tree is rooted and the time parameters are the root
age plus one proportion per free internal node (age = parent_age * p, or
AgeLow + (parent - AgeLow) * p when ages are absolute).  '@' fossil point
calibrations fix node ages and introduce an absolute mutation-rate
parameter; TipDate does the same with dated tips.  Local clocks (clock =
2/3) attach per-branch rate multipliers via #i branch labels (class 0 is
the reference rate 1).

The ages follow the tree in preorder, a chain of scalar operations: they
are computed on the host from a copy of the time parameters, and the
branch lengths return to the parameters' device (autograd crosses both
copies).
"""
from __future__ import annotations

import numpy as np
import torch

from .topology import Topology


def make_clock_times(topo: Topology, clock: int, tip_ages=None):
    """Build the time parameterization for a rooted tree.

    Returns (branch_lengths, n_time, x0, bounds, info):
      branch_lengths(x) -> tfull [nnode] branch length above each node,
      using x[:n_time]; local-clock rate multipliers are applied from
      x[n_time - n_rate_cls:] when clock == 2.
      info: dict with 'absrate', 'n_rate_cls', 'ages_of(x)' accessor.
    """
    assert clock >= 1
    int_nonroot = [n for n in range(topo.ns, topo.nnode)
                   if n != topo.root]
    fossil: dict[int, float] = {}
    if topo.ages0 is not None:
        for n in range(topo.ns, topo.nnode):
            a = topo.ages0[n]
            if a == a and a > 0:
                fossil[int(n)] = float(a)
    absrate = (tip_ages is not None) or bool(fossil)
    preorder = []
    stack = [topo.root]
    while stack:
        n = stack.pop()
        preorder.append(n)
        for c in topo.children[n]:
            if c >= topo.ns:
                stack.append(int(c))
    agelow = np.zeros(topo.nnode)
    if tip_ages is not None:
        agelow[:topo.ns] = np.asarray(tip_ages)
    if absrate:
        for n in topo.postorder:
            agelow[n] = max(fossil.get(int(c), agelow[int(c)])
                            for c in topo.children[n] if c >= 0)
    free_int = [n for n in int_nonroot if n not in fossil]
    root_fossil = int(topo.root) in fossil
    labels = topo.labels
    n_rate_cls = int(labels.max()) if clock == 2 else 0
    nroot_free = 0 if root_fossil else 1
    n_time = nroot_free + len(free_int) + (1 if absrate else 0) + n_rate_cls
    prop_idx = {n: nroot_free + i for i, n in enumerate(free_int)}

    def ages_of(x):
        """node -> age (0-d tensors on x's device) for the internal
        nodes."""
        ages = {topo.root: (x.new_tensor(fossil[int(topo.root)])
                            if root_fossil else x[0])}
        for n in preorder:
            if n == topo.root:
                continue
            if n in fossil:
                ages[n] = x.new_tensor(fossil[n])
            elif absrate:
                ages[n] = agelow[n] + ((ages[int(topo.parent[n])]
                                        - agelow[n]) * x[prop_idx[n]])
            else:
                ages[n] = ages[int(topo.parent[n])] * x[prop_idx[n]]
        return ages

    def branch_lengths(x):
        dev = x.device
        x = x.to("cpu")
        ages = ages_of(x)
        mu = (x[nroot_free + len(free_int)] if absrate
              else x.new_ones(()))
        k = nroot_free + len(free_int) + (1 if absrate else 0)
        if n_rate_cls:
            rate_cls = torch.cat([x.new_ones(1), x[k:k + n_rate_cls]])
        tf = [x.new_zeros(())] * topo.nnode
        for n in range(topo.nnode):
            if n == topo.root:
                continue
            a_par = ages[int(topo.parent[n])]
            a_n = ages[n] if n in ages else x.new_tensor(agelow[n])
            b = (a_par - a_n) * mu
            if n_rate_cls:
                b = b * rate_cls[int(labels[n])]
            tf[n] = b
        return torch.stack(tf).to(dev)

    # initial values: root age then proportions (reference GetInitialsTimes
    # uses rough preorder-shrinking proportions)
    if absrate:
        root0 = agelow[topo.root] * 1.5 + 0.2
        x0 = ([] if root_fossil else [root0]) \
            + [0.5 + 0.2 * (i % 3) * 0.2 for i in range(len(free_int))] \
            + [0.1]
        bounds = ([] if root_fossil else
                  [(agelow[topo.root] + 1e-6,
                    max(50.0, agelow[topo.root] * 10))]) \
            + [(1e-6, 1 - 1e-6)] * len(free_int) + [(1e-5, 99.0)]
    else:
        x0 = [0.3] + [0.6 + 0.1 * (i % 3) for i in range(len(free_int))]
        bounds = [(1e-5, 50.0)] + [(1e-6, 1 - 1e-6)] * len(free_int)
    if n_rate_cls:
        x0 += [1.0] * n_rate_cls
        bounds += [(1e-4, 999.0)] * n_rate_cls    # rateb, SetxBound
    info = dict(absrate=absrate, n_rate_cls=n_rate_cls, ages_of=ages_of,
                fossil=fossil, agelow=agelow, free_int=free_int,
                root_fossil=root_fossil)
    return branch_lengths, n_time, x0, bounds, info
