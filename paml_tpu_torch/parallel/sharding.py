"""Data parallelism over the site-pattern axis, on several devices and ranks.

Port of `paml_tpu/parallel/sharding.py`.  The pattern axis is pure data
parallelism: per-pattern likelihoods are independent, and the only
cross-pattern operation is the fpatt-weighted reduction that follows
pruning.  A `Mesh` lists the devices of this process (repeats allowed, so
that one card can hold two shards) and, under `torch.distributed`, this
process's rank in its group; `pruning.set_pattern_mesh(mesh)` makes
`pruning.class_site_lnf` run each device's contiguous slice of the
patterns on that device and return lnf [C, H] in pattern order (see
there).

The JAX package's `shard_map` wants equal shards, so it pads the pattern
axis with all-ones partials and weight 0 (`pad_patterns`).  The port
splits unevenly instead (shard k of K takes patterns [k H // K, (k + 1) H
// K)): no code or table changes (padding clean state codes with all-ones
cells would turn them into coded tips with a gap row and move the fit
from B3/B4 to B1/B2), and no padded pattern can reach a site-wise output
(`rst`, BEB, `lnf`).  `pad_patterns`, `pad_packed` and `maybe_pad_packed`
are kept, equal to the JAX package's as arrays, for callers that want the
padded layout; the port's fits do not call them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of this process that share the pattern axis, and under
    a process group (`group` not None) this process's `rank` of `world`:
    the axis is cut into world x len(devices) shards, rank r holding
    shards r * len(devices) ... (r + 1) * len(devices) - 1."""
    devices: tuple[torch.device, ...]
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def n_shards(self) -> int:
        return self.world * len(self.devices)

    def bounds(self, H: int) -> list[int]:
        """Pattern offsets of every shard of the job: shard k holds
        [bounds[k], bounds[k + 1])."""
        n = self.n_shards
        return [k * H // n for k in range(n + 1)]

    def local_bounds(self, H: int, rank: int | None = None) -> list[int]:
        """Pattern offsets of the shards of `rank` (default this
        process's): its device d holds [b[d], b[d + 1])."""
        r = self.rank if rank is None else rank
        nd = len(self.devices)
        return self.bounds(H)[r * nd:(r + 1) * nd + 1]

    def rank_range(self, H: int, rank: int | None = None) -> tuple[int, int]:
        """The patterns [lo, hi) of `rank` (default this process's)."""
        b = self.local_bounds(H, rank)
        return b[0], b[-1]


def data_mesh(devices=None) -> Mesh:
    """A one-process mesh over `devices` (default: every visible card)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("data_mesh needs at least one device")
    return Mesh(devices)


def pad_patterns(tip_partials: np.ndarray, fpatt: np.ndarray, n_shards: int):
    """Pad the pattern axis to a multiple of the mesh size.  Padding
    patterns get all-ones tip partials (positive site likelihood) and zero
    weight, so they contribute exactly nothing to lnL."""
    H = tip_partials.shape[1]
    Hpad = (-H) % n_shards
    if Hpad == 0:
        return tip_partials, fpatt
    ns, _, n = tip_partials.shape
    tp = np.concatenate(
        [tip_partials, np.ones((ns, Hpad, n), tip_partials.dtype)], axis=1)
    fp = np.concatenate([fpatt, np.zeros(Hpad, fpatt.dtype)])
    return tp, fp


def _split(x, bounds: list[int], dim: int):
    return [x.narrow(dim, lo, hi - lo) for lo, hi in zip(bounds, bounds[1:])]


def shard_data(mesh: Mesh, tip_partials, fpatt):
    """(tips, fpatt) of this process's shards: one contiguous pattern
    slice of tips [ns, H(, n)] and fpatt [H] per mesh device, each on its
    device.  Unpadded; see the module docstring."""
    tips = torch.as_tensor(tip_partials)
    fp = torch.as_tensor(fpatt)
    b = mesh.local_bounds(tips.shape[1])
    return ([t.to(d) for t, d in zip(_split(tips, b, 1), mesh.devices)],
            [f.to(d) for f, d in zip(_split(fp, b, 0), mesh.devices)])


def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """x on every device of the mesh."""
    return [x.to(d) for d in mesh.devices]


def shard_data_multihost(mesh: Mesh, tip_partials, fpatt):
    """This rank's slice of the pattern axis: every process holds the full
    arrays (each reads the same alignment) and keeps patterns
    `mesh.rank_range(H)` (the JAX package builds a global array from the
    processes' slices instead).  Returns (tips [ns, hi - lo(, n)], fpatt
    [hi - lo]) as given, on the host or the device they lie on."""
    H = np.shape(tip_partials)[1]
    lo, hi = mesh.rank_range(H)
    return tip_partials[:, lo:hi], fpatt[lo:hi]


# --- production auto-sharding ------------------------------------------------

def engage_auto_mesh(min_devices: int = 2):
    """Engage the pattern mesh over every visible card when there are at
    least `min_devices` (the programs codeml, baseml and basemlg call
    this).  Returns the Mesh or None.  `pruning.set_pattern_mesh(None)`
    disengages it."""
    if torch.cuda.device_count() < min_devices:
        return None
    from ..core import pruning
    mesh = data_mesh()
    pruning.set_pattern_mesh(mesh)
    return mesh


def pad_packed(data, n_shards: int):
    """Return a copy of a PackedData with the pattern axis padded to a
    multiple of n_shards (all-ones partials, zero weight — contributes
    exactly nothing to lnL)."""
    H = data.tip_partials.shape[1]
    Hpad = (-H) % n_shards
    if Hpad == 0:
        return data
    tp, fp = pad_patterns(data.tip_partials, data.fpatt, n_shards)
    kw = dict(tip_partials=tp, fpatt=fp)
    if data.pos_masks is not None:
        ns = data.pos_masks.shape[0]
        pm = np.concatenate(
            [data.pos_masks,
             np.ones((ns, Hpad) + data.pos_masks.shape[2:],
                     data.pos_masks.dtype)], axis=1)
        kw["pos_masks"] = pm
    if data.pattern_site is not None:
        kw["pattern_site"] = np.concatenate(
            [data.pattern_site, np.zeros(Hpad, data.pattern_site.dtype)])
    return dataclasses.replace(data, **kw)


def maybe_pad_packed(data):
    """Pad a PackedData for the engaged pattern mesh (no-op when no mesh
    is engaged, the pattern count already divides the mesh, or the data
    is multi-gene — gene blocks are contiguous pattern ranges that
    padding at the tail would corrupt)."""
    from ..core import pruning
    mesh = pruning.pattern_mesh()
    if mesh is None or data.ngene > 1:
        return data
    return pad_packed(data, mesh.n_shards)
