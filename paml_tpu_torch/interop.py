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


def topology_from(topo) -> Topology:
    """The port's Topology from a `paml_tpu.core.topology.Topology`."""
    return Topology(**{f.name: _copy(getattr(topo, f.name))
                       for f in dataclasses.fields(Topology)})


def packed_from(data) -> PackedData:
    """The port's PackedData from a `paml_tpu.io.seqio.PackedData`."""
    return PackedData(**{f.name: _copy(getattr(data, f.name))
                         for f in dataclasses.fields(PackedData)})


def baseml_spec_from(spec):
    """The port's BasemlSpec from a `paml_tpu.apps.baseml.BasemlSpec`."""
    from .apps.baseml import BasemlSpec
    return BasemlSpec(**{f.name: _copy(getattr(spec, f.name))
                         for f in dataclasses.fields(BasemlSpec)})


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
