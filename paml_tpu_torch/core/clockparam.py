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

The ages are computed on the parameters' own device from tables made
once per device: no copy to or from the host, so that a fit may replay
the evaluation from a CUDA graph.  A node's age is an affine function of
its parent's, a_n = low_n + (a_par - low_n) x_n (low_n = 0 without
absolute ages), so its excess over its lower bound, e_n = a_n - low_n,
is e_n = A_n e_par + B_n with A_n = x_n and B_n = x_n (low_par - low_n)
for a free node, and A_n = 0 for the root and the fossils (a fossil's
age is its own base, with excess 0; the root's excess is a parameter
when it is not a fossil).  A level-by-level walk down the tree would cost
a launch or three per level, and a ladder of 1024 taxa has about 1023
levels; instead the maps are composed along ancestor paths by pointer
jumping: each round composes every node's map with that of the ancestor
its path has reached and doubles the path, so ceil(log2(depth + 1))
rounds of a gather, two products and a sum reach the root from every
node (10 rounds at depth 1023).  The products come in another order than
the JAX package's chain of scalar products, within a few units of the
last place.
"""
from __future__ import annotations

import numpy as np
import torch

from .topology import Topology


def make_clock_times(topo: Topology, clock: int, tip_ages=None, *,
                     device=None, dtype=torch.float64):
    """Build the time parameterization for a rooted tree (its device
    tables made now on `device` in `dtype` when one is given, else at the
    first evaluation on each device).

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

    # the node tables (internal nodes ns.., the root its own parent): the
    # parameter of each free node's proportion; each node's base, its
    # lower bound (a fossil's base is its age, and its excess 0); a free
    # node's parent's base less its own; the ancestor each pointer
    # jumping round composes with
    ns, nint = topo.ns, topo.nnode - topo.ns
    par = np.where(np.arange(topo.nnode) == topo.root, topo.root,
                   topo.parent).astype(np.int64)
    free = np.zeros(nint, bool)
    pidx = np.zeros(nint, np.int64)
    for n, i in prop_idx.items():
        free[n - ns], pidx[n - ns] = True, i
    base = agelow.copy()
    for n, a in fossil.items():
        base[n] = a
    d = np.where(free, base[par[ns:]] - base[ns:], 0.0)
    depth = np.zeros(nint, np.int64)
    for n in preorder:
        if n != topo.root:
            depth[n - ns] = depth[par[n] - ns] + 1
    anc, ancs = par[ns:] - ns, []
    for _ in range(int(np.ceil(np.log2(depth.max() + 1)))):
        ancs.append(anc)
        anc = anc[anc]
    k_mu = nroot_free + len(free_int)
    k_rate = k_mu + (1 if absrate else 0)
    cache: dict = {}

    def tables(x):
        key = (str(x.device), x.dtype)
        if key not in cache:
            def f(a):
                return torch.as_tensor(a, dtype=x.dtype, device=x.device)

            def i(a):
                return torch.as_tensor(a, dtype=torch.int64, device=x.device)
            root = np.zeros(nint)
            root[topo.root - ns] = 1.0
            cache[key] = dict(
                free=f(free), pidx=i(pidx), d=f(d), root=f(root),
                base_tip=f(base[:ns]), base_int=f(base[ns:]),
                ancs=[i(a) for a in ancs], par=i(par),
                labels=i(labels.astype(np.int64)))
        return cache[key]

    if device is not None:
        tables(torch.empty(0, dtype=dtype, device=device))

    def ages(x):
        """[nnode]: every node's age (the tips' their dates or 0), on x's
        device."""
        T = tables(x)
        A = x[T["pidx"]] * T["free"]
        B = A * T["d"]
        if not root_fossil:
            B = B + T["root"] * (x[0] - T["base_int"][topo.root - ns])
        for anc in T["ancs"]:
            B = A * B[anc] + B
            A = A * A[anc]
        return torch.cat([T["base_tip"], T["base_int"] + B])

    def ages_of(x):
        """node -> age (0-d tensors on x's device) for the internal
        nodes."""
        a = ages(x)
        return {n: a[n] for n in preorder}

    def branch_lengths(x):
        T = tables(x)
        a = ages(x)
        b = a[T["par"]] - a
        if absrate:
            b = b * x[k_mu]
        if n_rate_cls:
            rate_cls = torch.cat([x.new_ones(1), x[k_rate:k_rate + n_rate_cls]])
            b = b * rate_cls[T["labels"]]
        return b

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
