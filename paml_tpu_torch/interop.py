"""Carry state across from the JAX package (`paml_tpu`).

The functions take the JAX package's objects by duck typing, read their
fields as plain numpy arrays and attributes, and return this package's
objects, tensors on the given device.  Neither JAX nor `paml_tpu` is
imported: `np.asarray` reads a JAX array through the array protocol.

The parameter vector keeps the JAX package's layout (`codeml.unpack`), so
a vector fitted by one package is a valid point of the other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.topology import Topology
from .io.seqio import PackedData


def _copy(v):
    return np.array(v) if isinstance(v, np.ndarray) or hasattr(
        v, "__array__") else v


def _fields_from(cls, obj, **override):
    kw = {f.name: _copy(getattr(obj, f.name)) for f in dataclasses.fields(cls)}
    kw.update(override)
    return cls(**kw)


def topology_from(topo) -> Topology:
    """The port's Topology from a `paml_tpu.core.topology.Topology`."""
    return _fields_from(Topology, topo)


def packed_from(data) -> PackedData:
    """The port's PackedData from a `paml_tpu.io.seqio.PackedData`."""
    return _fields_from(PackedData, data)


def baseml_spec_from(spec):
    """The port's BasemlSpec from a `paml_tpu.apps.baseml.BasemlSpec`."""
    from .apps.baseml import BasemlSpec
    return _fields_from(BasemlSpec, spec)


def params_from(x, *, device) -> torch.Tensor:
    """A parameter vector x (JAX layout) as a float64 tensor on device."""
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device)


def kernel_inputs_from(P, tips, pi, *, device, dtype=None):
    """(P, tips, pi) of a `class_site_lnf` call as tensors on device:
    integer tips become int32 state codes, partials take P's dtype."""
    P = np.asarray(P)
    dtype = dtype or (torch.float64 if P.dtype == np.float64
                      else torch.float32)
    tips = np.asarray(tips)
    if np.issubdtype(tips.dtype, np.integer):
        tips_t = torch.tensor(tips.astype(np.int32), device=device)
    else:
        tips_t = torch.tensor(tips, dtype=dtype, device=device)
    return (torch.tensor(P, dtype=dtype, device=device), tips_t,
            torch.tensor(np.asarray(pi), dtype=dtype, device=device))


def mcmc_spec_from(spec):
    """The port's McmcSpec from a `paml_tpu.apps.mcmctree.McmcSpec`."""
    from .apps.mcmctree import McmcSpec
    return _fields_from(McmcSpec, spec)


def clock56_spec_from(spec):
    """The port's Clock56Spec from a `paml_tpu.apps.clock56.Clock56Spec`."""
    from .apps.clock56 import Clock56Spec
    return _fields_from(Clock56Spec, spec)


def species_tree_from(st):
    """The port's SpeciesTree from a `paml_tpu.apps.mcmctree.SpeciesTree`
    (its calibrations, priors, mirrors and fossil-error settings copied;
    the Monte Carlo cache of the fossil-error constants is not)."""
    import copy

    from .apps.mcmctree import SpeciesTree
    return SpeciesTree(
        topo=topology_from(st.topo),
        calibrations=copy.deepcopy(st.calibrations),
        root_age_prior=copy.deepcopy(st.root_age_prior),
        bds=tuple(st.bds), multiplicative=st.multiplicative, psi=st.psi,
        tip_ages=_copy(st.tip_ages), mirror_of=dict(st.mirror_of),
        pfossilerror=st.pfossilerror)


def approx_locus_from(locus):
    """The port's ApproxLocus from a `paml_tpu.apps.mcmctree.ApproxLocus`
    (already transformed or not: the fields are copied as they are)."""
    from .apps.mcmctree import ApproxLocus
    return _fields_from(ApproxLocus, locus, topo=topology_from(locus.topo))


def hetero_data_from(hd):
    """The port's HeteroData from a `paml_tpu.apps.clock56.HeteroData`."""
    from .apps.clock56 import GeneTree, HeteroData
    return HeteroData(
        sp_topo=topology_from(hd.sp_topo), fixed_ages=dict(hd.fixed_ages),
        loci=[GeneTree(topo=topology_from(g.topo), ipop=_copy(g.ipop),
                       data=packed_from(g.data)) for g in hd.loci])
