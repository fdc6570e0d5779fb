"""Several processes on one pattern axis (`torch.distributed`).

Port of `paml_tpu/parallel/distributed.py`.  The JAX package joins hosts
with `jax.distributed.initialize` and lets XLA insert the collectives; here
each process (a rank, as `torchrun` starts them) holds the whole alignment
and computes the likelihood of its own contiguous slice of the patterns
(`sharding.Mesh.rank_range`), on its own device.  Two collectives carry
the rest, both in the pruning layer (`pruning._class_site_lnf_sharded`):

- `gather_patterns`: every rank's lnf slice is all-gathered, so that every
  rank holds lnf [C, H] and computes the same downstream (mixing, lnL,
  the optimizer's steps, the output), bit for bit; its backward hands
  each rank the cotangent of its own slice;
- `sum_grad`: the identity on P and pi, whose backward sums the ranks'
  shares of dP and dpi (an all-reduce), so that every rank's gradient is
  the whole axis's.

NCCL serves CUDA tensors when every rank has a card of its own; gloo
serves CPU tensors, and CUDA tensors when ranks share a card (NCCL refuses
two ranks on one device).  gloo has no all-gather of CUDA tensors, so
`gather_patterns` stages that one through the host under gloo.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharding import Mesh


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    """This process's rank on its host (`LOCAL_RANK`, set by torchrun)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(device: str = "cuda") -> torch.device:
    """The device of this process: `cuda:{LOCAL_RANK}` (modulo the cards
    visible, so that several ranks may share one card), or the CPU when
    `device` says so."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def default_backend(device: str = "cuda") -> str:
    """NCCL when every rank of this host has a card of its own, else
    gloo."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", _env_world()))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device: str = "cuda") -> bool:
    """Join the process group (idempotent); True when this process is in
    one.

    With no arguments the group is the one `torchrun` describes (the
    `env://` variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); a
    single process without them (or with WORLD_SIZE 1) joins nothing.
    Given `world_size`, `rank` and `init_method` (`tcp://localhost:<port>`)
    it joins that group whatever the environment says.  `backend` defaults
    to `default_backend(device)`."""
    if dist.is_initialized():
        return True
    if world_size is None:
        if _env_world() <= 1:
            return False
        world_size = _env_world()
    if rank is None:
        rank = int(os.environ["RANK"])
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def shutdown() -> None:
    """Leave the process group (nothing outside one): every rank waits for
    the others first, so that none exits, taking the group's store with
    it, while a peer still talks to it."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def global_data_mesh(device: str = "cuda") -> Mesh:
    """The pattern mesh of the job: one device per rank (this process's
    `local_device`), every rank of the default group."""
    if not dist.is_initialized():
        return Mesh((local_device(device),))
    return Mesh((local_device(device),), group=dist.group.WORLD,
                rank=dist.get_rank(), world=dist.get_world_size())


def is_primary() -> bool:
    """True on the process that writes output files and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _staged(t: torch.Tensor, group) -> bool:
    """gloo's all-gather takes no CUDA tensor: stage it through the host."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _GatherPatterns(torch.autograd.Function):

    @staticmethod
    def forward(ctx, lnf, mesh, H):
        b = [mesh.rank_range(H, r) for r in range(mesh.world)]
        ctx.lo, ctx.hi = b[mesh.rank]
        width = max(hi - lo for lo, hi in b)
        x = lnf.new_zeros((lnf.shape[0], width))
        x[:, :lnf.shape[1]] = lnf
        staged = _staged(x, mesh.group)
        if staged:
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x, group=mesh.group)
        out = torch.cat([p[:, :hi - lo] for p, (lo, hi) in zip(parts, b)], 1)
        return out.to(lnf.device) if staged else out

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo:ctx.hi].contiguous(), None, None


class _SumGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_patterns(lnf: torch.Tensor, mesh: Mesh, H: int) -> torch.Tensor:
    """This rank's lnf slice [C, hi - lo] -> lnf [C, H] on every rank
    (slices of unequal width padded for the collective and cut after)."""
    return _GatherPatterns.apply(lnf, mesh, H)


def sum_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x itself; its gradient is summed over the ranks of `mesh`."""
    return _SumGrad.apply(x, mesh.group)
