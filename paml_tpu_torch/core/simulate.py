"""Sequence simulation down a tree (the evolver core).

Port of `paml_tpu/core/simulate.py`.  The reference's recursive `Evolve`
(src/evolver.c:753) becomes categorical sampling over sites and
replicates at once: states propagate root-to-tips in preorder, and each
branch draws its child states from the parent-conditional rows of P(t),
with per-site rate/omega classes selecting the class axis (reference:
Rates4Sites / MultiNomialAlias sampling, src/tools.c:695,1972).

The JAX package vmaps `jax.random.categorical` over replicate keys.  Here
each draw is an inverse CDF: a uniform from `torch.rand` with an explicit
`torch.Generator`, and `torch.searchsorted` on the row's cumulative sum
(the sums taken once per (node, class), on the device).  Every replicate has
a generator of its own, seeded from one seed, so a replicate's sequences
do not depend on how the replicates are chunked: the same seed on the same
device gives the same bits.  Nothing here reduces in parallel or uses
atomics.  JAX's threefry streams are not reproduced; the tests hold the
sampler by distribution and by refit.
"""
from __future__ import annotations

import numpy as np
import torch

from .topology import Topology

# the share of the card's free memory a replicate chunk may take
FREE_SHARE = 0.25
HOST_BYTES = 1 << 30       # the chunk budget on the CPU


def _cdf(p: torch.Tensor) -> torch.Tensor:
    """Row-normalized cumulative sums with the last entry exactly 1."""
    c = p.clamp_min(0.0).cumsum(-1)
    c = c / c[..., -1:]
    c[..., -1] = 1.0
    return c


def preorder(topo: Topology) -> list[int]:
    order = [topo.root]
    for i in order:
        for c in topo.children[i]:
            if c >= 0:
                order.append(int(c))
    return order


def replicate_seeds(seed: int, nrepl: int) -> list[int]:
    """One generator seed per replicate, the same on every device."""
    g = torch.Generator("cpu").manual_seed(int(seed))
    return torch.randint(0, 2 ** 62, (nrepl,), generator=g).tolist()


def chunk_replicates(nnode: int, nsites: int, n: int, nrepl: int,
                     device) -> int:
    """Replicates per chunk: the uniforms [nnode + 1, ls] f64, the states
    [nnode, ls] int16 and one node's gathered rows [ls, n] f64 (twice, for
    the temporaries) per replicate, within a share of the card's free
    memory (a fixed budget on the CPU)."""
    per = nsites * ((nnode + 1) * 8 + nnode * 2 + 2 * n * 8 + 16)
    dev = torch.device(device)
    if dev.type == "cuda":
        budget = FREE_SHARE * torch.cuda.mem_get_info(dev)[0]
    else:
        budget = HOST_BYTES
    return int(max(1, min(nrepl, budget // per)))


def simulate_chunks(topo: Topology, P, root_pi, nsites: int, nrepl: int,
                    class_probs=None, *, seed: int, device,
                    chunk: int | None = None):
    """Simulate `nrepl` replicates in chunks.

    P: [nnode, C, n, n] (rows: the parent's state); root_pi: [n];
    class_probs: [C] or None.  Yields (r0, states [Rc, nnode, nsites]
    int16, site_class [Rc, nsites] int16), tensors on `device`, for the
    replicates r0 .. r0 + Rc - 1."""
    dev = torch.device(device)

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float64).detach().to(dev)

    P = on_dev(P)
    nnode, C, n = P.shape[0], P.shape[1], P.shape[-1]
    cdf = _cdf(P).reshape(nnode, C * n, n)
    cdf_root = _cdf(on_dev(root_pi))
    with_classes = class_probs is not None and C > 1
    if with_classes:
        cdf_cls = _cdf(on_dev(class_probs))
    order = preorder(topo)
    seeds = replicate_seeds(seed, nrepl)
    chunk = chunk or chunk_replicates(nnode, nsites, n, nrepl, dev)
    for r0 in range(0, nrepl, chunk):
        # uniforms: row 0 the site classes, row 1 the root, then each
        # node below the root in preorder
        U = torch.stack([
            torch.rand((nnode + 1, nsites), dtype=torch.float64,
                       device=dev,
                       generator=torch.Generator(dev).manual_seed(s))
            for s in seeds[r0:r0 + chunk]])
        Rc = U.shape[0]
        if with_classes:
            cls = torch.searchsorted(cdf_cls, U[:, 0].contiguous(),
                                     right=True).clamp_max_(C - 1)
        else:
            cls = torch.zeros((Rc, nsites), dtype=torch.int64, device=dev)
        states = torch.empty((Rc, nnode, nsites), dtype=torch.int16,
                             device=dev)
        states[:, topo.root] = torch.searchsorted(
            cdf_root, U[:, 1].contiguous(), right=True).clamp_max_(n - 1)
        base = cls * n
        for k, node in enumerate(order[1:]):
            parent = int(topo.parent[node])
            rows = cdf[node][base + states[:, parent].long()]  # [Rc, ls, n]
            new = torch.searchsorted(
                rows, U[:, k + 2, :, None].contiguous(), right=True)[..., 0]
            states[:, node] = new.clamp_max_(n - 1)
        yield r0, states, cls.to(torch.int16)


def simulate_states(topo: Topology, P, root_pi, nsites: int, nrepl: int = 1,
                    class_probs=None, *, seed: int, device):
    """All replicates at once: (states [R, nnode, nsites] int16,
    site_class [R, nsites] int16) on `device`."""
    parts = list(simulate_chunks(topo, P, root_pi, nsites, nrepl,
                                 class_probs, seed=seed, device=device))
    return (torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]))


def states_to_rows(states_tips: np.ndarray, alphabet: str | list[str]):
    """Integer states -> character strings per taxon (every symbol of the
    alphabet has one width: a base, an amino acid or a codon)."""
    table = np.array([a.encode() for a in alphabet])
    return [row.tobytes().decode() for row in table[np.asarray(states_tips)]]


def write_paml_seqs(path_or_f, names, rows, append=False):
    """Write a PAML/PHYLIP sequential alignment."""
    close = False
    if isinstance(path_or_f, str):
        f = open(path_or_f, "a" if append else "w")
        close = True
    else:
        f = path_or_f
    f.write(f" {len(names)} {len(rows[0])}\n")
    for nm, r in zip(names, rows):
        f.write(f"{nm:<20s}  {r}\n")
    f.write("\n")
    if close:
        f.close()
