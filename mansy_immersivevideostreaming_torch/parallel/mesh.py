"""Process groups for data and env-lane parallelism.

Port of the JAX package's ``parallel/mesh.py``.  JAX runs a data-parallel
step as one SPMD program over a ``data`` mesh axis: parameters replicate,
batches and env lanes shard over the axis, XLA inserts the collectives.
Here each device runs a process of its own (a rank) on ``torch.distributed``:

* :func:`init_distributed` is ``jax.distributed.initialize``: it joins the
  process group and returns the rank's :class:`Mesh`; :func:`make_mesh`
  gives the mesh of the group already joined (a one-process mesh without
  one);
* :func:`replicate` broadcasts a module's parameters and buffers from rank
  0, the ``P()`` placement;
* :func:`shard_batch` keeps the rank's contiguous ``1/world`` of each
  leaf's leading axis, the ``P("data")`` placement; the steps that need the
  whole batch (the MTIO slot trick's permutations, the PPO update's
  minibatches) take every rank's copy of it and :meth:`Mesh.rows`;
* the collectives the steps meet at: :func:`all_reduce_sum` (differentiable:
  its backward sums the incoming gradients too, which is how a batch
  statistic's gradient reaches every rank), :func:`sum_tensors`,
  :func:`all_gather_cat`, :func:`broadcast_object` and :func:`barrier`.

Backend: NCCL where each rank has a card of its own; Gloo on the CPU and
where ranks share a card (NCCL refuses two ranks on one device), its
collectives on CUDA tensors going through host copies.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from mansy_immersivevideostreaming_torch.utils.device import resolve_device

TIMEOUT_S = 600   # a collective's longest wait before the group raises


class Mesh(NamedTuple):
    """One rank's view of the data axis: its rank, the world size, its
    device and the group's backend (None: one process, no group)."""
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def sharded(self) -> bool:
        """More than one rank: the steps split their leading axes."""
        return self.world > 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """The rank's contiguous share of a leading axis of ``n``, which must
        divide by the world size (as JAX's ``data`` axis requires)."""
        if n % self.world:
            raise ValueError(f"a leading axis of {n} does not split over {self.world} ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The card of a rank (``cuda:<local_rank mod cards>``), or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(dev: torch.device, local_world: int) -> str:
    """NCCL when every rank on this host has a card of its own, else Gloo."""
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_method(coordinator_address: Optional[str]) -> str:
    """JAX's ``host:port`` as ``tcp://host:port``; a URL (``file://...``,
    ``tcp://...``) as it is; None as ``env://`` (torchrun's MASTER_ADDR and
    MASTER_PORT)."""
    if coordinator_address is None:
        return "env://"
    return coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str | torch.device = "cuda",
                     local_rank: Optional[int] = None, local_world: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join the process group (``jax.distributed.initialize``): rank
    ``process_id`` of ``num_processes`` (default: torchrun's RANK and
    WORLD_SIZE), on its device (``local_rank``, default LOCAL_RANK or the
    rank; ``local_world``, default LOCAL_WORLD_SIZE or the world, the ranks
    on this host), with an explicit ``timeout_s``.  Prints the backend
    chosen, then returns the rank's :class:`Mesh`."""
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    print(f"[mesh] rank {rank} of {world} on {dev}: backend {backend}", flush=True)
    dist.init_process_group(backend, init_method=init_method(coordinator_address),
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(rank, world, dev, backend)


def make_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The mesh of the process group this process joined, or a one-process
    mesh on ``device`` when it joined none."""
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
        return Mesh(rank, dist.get_world_size(), dev, dist.get_backend())
    return Mesh(0, 1, resolve_device(device))


def shutdown(mesh: Mesh) -> None:
    """Leave the group (after a last barrier), if there is one."""
    if mesh.backend is not None and dist.is_initialized():
        barrier(mesh)
        dist.destroy_process_group()


def _via_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def sum_tensors(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's ``tensors`` summed, in one collective (flattened into
    one f32 buffer); the same bits on every rank."""
    if mesh.backend is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    host = _via_host(mesh, flat)
    buf = flat.cpu() if host else flat
    dist.all_reduce(buf)
    flat = buf.to(flat.device) if host else buf
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradients over the
    ranks too (d L / d x_r = sum over r' of d L_r' / d S)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return sum_tensors(mesh, [x])[0]

    @staticmethod
    def backward(ctx, g):
        return sum_tensors(ctx.mesh, [g])[0], None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x, mesh)


def all_gather_cat(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: the whole
    axis of which each rank held its :meth:`Mesh.rows`."""
    if mesh.backend is None:
        return x
    src = x.contiguous()
    if src.dtype == torch.bool:
        return all_gather_cat(mesh, src.to(torch.uint8), dim).bool()
    host = _via_host(mesh, src)
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    out = torch.cat(parts, dim)
    return out.to(x.device) if host else out


def gather_tree(mesh: Mesh, tree, dim: int):
    """:func:`all_gather_cat` over every tensor of a NamedTuple."""
    return type(tree)(*(all_gather_cat(mesh, t, dim) for t in tree))


def broadcast_object(mesh: Mesh, obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (pickled; rank 0's own objects only)."""
    if mesh.backend is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.backend is not None:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    if mesh.backend is None:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        host = _via_host(mesh, t)
        buf = t.detach().cpu() if host else t.data
        dist.broadcast(buf, src=0)
        if host:
            t.copy_(buf)
    return module


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """The rank's rows of every tensor in ``batch`` (a dict, a tuple, a
    NamedTuple, a list or one tensor): the leading axis split as
    :meth:`Mesh.rows` splits it."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        parts = [shard_batch(mesh, v) for v in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else type(batch)(parts)
    return batch[mesh.rows(batch.shape[0])]


def mean_gradients(mesh: Mesh, params: Sequence[torch.Tensor]) -> None:
    """Replace every parameter's ``.grad`` by its mean over the ranks."""
    grads = [p.grad for p in params]
    for g, s in zip(grads, sum_tensors(mesh, grads)):
        g.copy_(s / mesh.world)
