"""The 1-D mesh of graph shards the distributed layers run over.

``sgracex1_tpu.parallel`` runs a per-shard body under ``shard_map`` over a
1-D device mesh, with ``jax.lax.all_to_all`` / ``all_gather`` between the
shards. Here a ``Mesh`` runs the same body, written once, in one of two
ways:

- in-process (``make_mesh``): every shard lives in this process on one
  device and the bodies run in turn. A row-sharded tensor is the whole
  ``[n_pad, F]``, viewed as ``[S, n_local, F]`` (JAX's ``P("graph")``);
  ``all_to_all`` is the index move ``halo[r] = send[:, r]`` and
  ``all_gather`` a concatenation, plain torch ops that autograd transposes
  as JAX transposes the collectives;
- across processes (``init_multihost`` then ``global_mesh``): one shard a
  rank, the row-sharded tensor is the rank's ``[n_local, F]`` block, and
  the collectives are ``torch.autograd.Function``s around
  ``torch.distributed`` (``all_to_all_single``, whose transpose is itself,
  and ``all_gather_into_tensor``, whose transpose is a reduce-scatter).
  gloo on the CPU, nccl on CUDA with one rank a GPU: nccl takes no two
  ranks on one GPU, so one card runs the in-process mesh only.

A layer's replicated parameters go through ``replicated``: on a process
group their gradient is summed over the ranks (the ``psum`` JAX inserts
for an unsharded input of ``shard_map``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from sgracex1_tpu_torch._device import resolve_device


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of a [S, L, F] buffer: block r goes to rank r,
    block t of the result came from rank t. Its transpose is the same
    exchange."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """Tiled ``all_gather`` on axis 0; backward: the reduce-scatter of the
    cotangent (nccl), or ``all_reduce`` and this rank's rows (gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, part, group):
        ctx.group, ctx.n = group, part.shape[0]
        world = dist.get_world_size(group)
        out = part.new_empty((world * part.shape[0], *part.shape[1:]))
        dist.all_gather_into_tensor(out, part.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if dist.get_backend(ctx.group) == "nccl":
            out = g.new_empty((ctx.n, *g.shape[1:]))
            dist.reduce_scatter_tensor(out, g, group=ctx.group)
            return out, None
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n : (r + 1) * ctx.n].contiguous(), None


class _ReplicatedGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class Mesh:
    """``n_shards`` graph shards on ``device``: in-process (``group`` None)
    or one shard on each rank of the process group ``group``."""

    def __init__(self, n_shards: int, device: torch.device, axis_name: str = "graph", group=None):
        if n_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())  # as tensors report it
        self.n_shards = n_shards
        self.device = device
        self.axis_name = axis_name
        self.group = group

    @property
    def in_process(self) -> bool:
        return self.group is None

    @property
    def local_shards(self) -> List[int]:
        """The shard ids whose bodies this process runs."""
        if self.in_process:
            return list(range(self.n_shards))
        return [dist.get_rank(self.group)]

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A row-sharded tensor as this process's shard blocks (views)."""
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, mesh on {self.device}")
        if not self.in_process:
            return [x]
        if x.shape[0] % self.n_shards:
            raise ValueError(f"{x.shape[0]} rows do not split into {self.n_shards} shards")
        return list(torch.chunk(x, self.n_shards, dim=0))

    def concat(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The shard blocks as one row-sharded tensor."""
        return torch.cat(parts) if self.in_process else parts[0]

    def all_to_all(self, sends: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each shard's [S, L, F] send buffer (block r for reader r) to each
        shard's [S, L, F] received buffer (block t from owner t)."""
        if not self.in_process:
            return [_AllToAll.apply(sends[0], self.group)]
        return list(torch.stack(sends).transpose(0, 1).unbind(0))

    def all_gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each shard's rows gathered in shard order, for every shard."""
        if not self.in_process:
            return [_AllGather.apply(parts[0], self.group)]
        full = torch.cat(parts)
        return [full] * len(parts)

    def replicated(self, w: torch.Tensor) -> torch.Tensor:
        """A parameter every shard reads whole: on a process group its
        gradient becomes the sum over the ranks."""
        if self.in_process:
            return w
        return _ReplicatedGrad.apply(w, self.group)


def make_mesh(n_shards: Optional[int] = None, axis_name: str = "graph", *, device=None) -> Mesh:
    """In-process mesh of ``n_shards`` shards (None: one) on ``device``:
    the CUDA card by default (a ``RuntimeError`` where there is none), the
    CPU only with ``device="cpu"``."""
    return Mesh(1 if n_shards is None else n_shards, resolve_device(device), axis_name)


def init_multihost(
    coordinator_address: str, num_processes: int, process_id: int, *, device=None,
) -> None:
    """Join a job of ``num_processes`` processes, one shard each, through
    ``torch.distributed`` at ``tcp://coordinator_address`` (host:port; no
    discovery): nccl on the CUDA card of this rank (``process_id`` modulo
    the visible cards), gloo with ``device="cpu"``. A no-op when this
    process already belongs to a group."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
    )


def global_mesh(axis_name: str = "graph") -> Mesh:
    """The mesh of every rank of the job ``init_multihost`` joined, on this
    rank's device (its card under nccl, the CPU under gloo). Raises where
    no process group exists: it never becomes an in-process mesh."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh needs a process group: call init_multihost first")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(dist.get_world_size(), device, axis_name, group=dist.group.WORLD)
