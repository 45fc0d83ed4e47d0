"""Data-parallel process groups (port of ``arflow_tpu/parallel/mesh.py``).

JAX runs one process per host, each driving all of its local devices, and
shards a batch over a device mesh under ``jit``. The port runs one process
per card, PyTorch's idiom: ``--num_processes`` counts cards, and rank ``i``
runs on ``cuda:{LOCAL_RANK}`` where a launcher sets it, else on
``cuda:{i % device_count}`` (``local_device``). A mesh here is that rank's
view of the run: its device and the ``torch.distributed`` process group
the data-parallel reductions run over.

Each rank holds its own rows of every global batch (``shard_batch``, the
loader's ``num_replicas`` / ``rank``), and what the JAX mesh computes on
the global batch under GSPMD the port computes with explicit reductions:

- ``all_sum``: a sum over the group with autograd; its backward sums the
  gradient over the group too, so a loss that every rank computes from
  global sums back-propagates ``world`` times its gradient, and the
  average of the ranks' gradients (``average_grads``, one all-reduce) is
  the one-process gradient;
- ``data_parallel(group)``: the context in which the losses' batch
  reductions (``batch_sum``, ``batch_mean``, ``group_sums``) and the
  BatchNorm statistics reduce over ``group``; outside it, and without a
  group, each is the plain local reduction it replaces, so a one-process
  run computes as before;
- ``local_rows`` / ``gather_rows``: random draws of the global batch's
  shape, taken from a generator that every rank seeds and advances alike,
  of which each rank keeps its rows; and a small tensor's global rows.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

_BATCH_GROUP = None  # the group of the enclosing data_parallel(), if any
INIT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass
class Mesh:
    """A rank's view of a data-parallel run: its ``device``, the ``group``
    its reductions run over (None: one process, nothing to reduce), the
    mesh's ``shape`` and ``axis_names``, and for a hybrid mesh this rank's
    sub-group along each axis (``groups``)."""

    device: torch.device
    group: object = None
    shape: tuple = (1,)
    axis_names: tuple = ("data",)
    groups: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)


def local_device(process_id: int = 0, device="cuda") -> torch.device:
    """The device of rank ``process_id``: the CPU where ``device`` is the
    CPU, else ``cuda:{LOCAL_RANK}`` where a launcher sets it, else
    ``cuda:{process_id % device_count}``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", int(process_id or 0)
                        % max(1, torch.cuda.device_count()))


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, backend=None, device=None) -> bool:
    """Join a data-parallel run of ``num_processes`` ranks, one per card:
    ``torch.distributed.init_process_group`` with TCP initialization at
    ``coordinator_address`` (``host:port``), as rank ``process_id``.

    ``backend`` is NCCL where the rank's ``device`` is a card and gloo where
    it is the CPU unless given (two ranks on one card need gloo: NCCL
    refuses them). ``device`` defaults to the card where one is present.
    A no-op that returns False with no coordinator and at most one
    process, as the JAX function is; True where the group exists already.

        arflow-torch-train -c cfg.json --coordinator host0:8476 \\
            --num_processes N --process_id i      # one per card
    """
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        raise ValueError("num_processes > 1 needs a coordinator host:port")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = local_device(process_id or 0, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = str(coordinator_address)
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(
        backend, init_method=addr, world_size=int(num_processes or 1),
        rank=int(process_id or 0), timeout=INIT_TIMEOUT)
    return True


def make_mesh(device=None, axis_name: str = "data") -> Mesh:
    """A 1-D data-parallel mesh over every rank of the run (one rank, no
    group, where ``torch.distributed`` is not initialized), on ``device``
    (default: ``local_device`` of this rank)."""
    group = dist.group.WORLD if dist.is_initialized() else None
    rank = dist.get_rank() if group is not None else 0
    dev = local_device(rank) if device is None else torch.device(device)
    size = 1 if group is None else dist.get_world_size()
    return Mesh(dev, group, (size,), (axis_name,))


def make_hybrid_mesh(device=None, n_hosts=None, dcn_axis: str = "dcn",
                     ici_axis: str = "data") -> Mesh:
    """A 2-D (hosts x cards) mesh: rank ``h * per_host + j`` is card ``j`` of
    host ``h``. ``groups[ici_axis]`` holds this rank's host, and
    ``groups[dcn_axis]`` the ranks of its card index on every host; a batch
    is sharded over both, so ``group`` is the whole run.
    ``n_hosts`` defaults to the world size over ``LOCAL_WORLD_SIZE`` (a
    launcher's cards per host; 1 where unset)."""
    mesh = make_mesh(device)
    n = mesh.size
    if n_hosts is None:
        n_hosts = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    if n_hosts <= 0 or n % n_hosts:
        raise ValueError(f"{n} ranks do not split over {n_hosts} hosts evenly")
    per_host = n // n_hosts
    groups = {}
    if mesh.group is not None:
        host, card = divmod(mesh.rank, per_host)
        # every rank creates every group, in the same order
        for h in range(n_hosts):
            g = dist.new_group(list(range(h * per_host, (h + 1) * per_host)))
            if h == host:
                groups[ici_axis] = g
        for j in range(per_host):
            g = dist.new_group(list(range(j, n, per_host)))
            if j == card:
                groups[dcn_axis] = g
    return Mesh(mesh.device, mesh.group, (n_hosts, per_host),
                (dcn_axis, ici_axis), groups)


def dp_axes(mesh: Mesh) -> tuple:
    """The mesh axes a data-parallel batch is sharded over: all of them."""
    return tuple(mesh.axis_names)


def batch_rows(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size`` rows, which the
    mesh's size must divide (the counterpart of the JAX ``batch_sharding``,
    whose GSPMD layout has no PyTorch meaning)."""
    n = mesh.size
    if batch_size % n:
        raise ValueError(f"a batch of {batch_size} rows does not divide over "
                         f"{n} ranks; trim it first")
    b = batch_size // n
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch: a dict, list or tuple of arrays
    or tensors (a 0-d leaf is kept whole), on the host as they came. The
    global batch is the ranks' rows concatenated in rank order."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    if getattr(batch, "ndim", 0) == 0:
        return batch
    return batch[batch_rows(mesh, batch.shape[0])]


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Broadcast a module's parameters and buffers (or a list of tensors)
    from rank 0 to every rank, in place; returns ``tree`` (a no-op without
    a mesh or a group)."""
    if mesh is None or mesh.group is None:
        return tree
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else list(tree))
    for t in tensors:
        dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group=None, force: bool = False) -> torch.Tensor:
    """``x`` summed over ``group``, with autograd (the backward sums the
    gradient over the group) where ``x`` requires grad or ``force`` is set:
    every rank then issues the backward's all-reduce, also where its ``x``
    is cut from the graph (an empty band); ``x`` itself without a group."""
    if group is None:
        return x
    if force or x.requires_grad:
        return _AllSum.apply(x if x.requires_grad
                             else x.detach().requires_grad_(), group)
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def average_grads(params, group=None) -> None:
    """Each parameter's ``.grad`` averaged over ``group`` in one all-reduce
    of their concatenation, with a flag per parameter: a rank whose graph
    never reaches a parameter (an empty band at a coarse level) sends
    zeros, and a parameter that no rank's graph reaches keeps no gradient,
    as in one process. Nothing happens without a group."""
    if group is None:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params]
                     + [torch.tensor([p.grad is not None for p in params],
                                     dtype=params[0].dtype,
                                     device=params[0].device)])
    dist.all_reduce(flat, group=group)
    n = len(params)
    flat[:-n] /= dist.get_world_size(group)
    offset = 0
    for p, has in zip(params, flat[-n:].tolist()):
        g = flat[offset:offset + p.numel()].view_as(p)
        p.grad = g if has > 0 else None
        offset += p.numel()


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, the losses' batch reductions and the BatchNorm
    statistics run over ``group`` (nothing changes with None). The trainer
    wraps a step's forward, loss and backward in it: a rematerialized
    region's recomputation in the backward reduces again."""
    global _BATCH_GROUP
    prev, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield
    finally:
        _BATCH_GROUP = prev


def batch_group():
    """The group of the enclosing ``data_parallel``, or None."""
    return _BATCH_GROUP


def world_size() -> int:
    g = _BATCH_GROUP
    return 1 if g is None else dist.get_world_size(g)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum()`` over the global batch."""
    return all_sum(x.sum(), _BATCH_GROUP)


def batch_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x.mean()`` (``dim=0``: ``x.mean(0)``, the batch axis) over the
    global batch, every rank's ``x`` of one shape; exactly ``x.mean()``
    without a group."""
    g = _BATCH_GROUP
    if g is None:
        return x.mean() if dim is None else x.mean(dim)
    if dim is None:
        return all_sum(x.sum(), g) / (x.numel() * dist.get_world_size(g))
    if dim != 0:
        raise ValueError("batch_mean reduces over every axis or the batch's")
    return all_sum(x.sum(0), g) / (x.shape[0] * dist.get_world_size(g))


def group_sums(x: torch.Tensor) -> torch.Tensor:
    """A vector of per-group local sums (``(G,)``), summed over the global
    batch."""
    return all_sum(x, _BATCH_GROUP)


def local_rows(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """This rank's rows of a global-batch tensor laid out as ``groups``
    consecutive blocks of the global batch (sample-major Monte-Carlo draws:
    ``groups`` = samples): ``(groups * B, ...)`` -> ``(groups * B / N,
    ...)``; ``x`` itself without a group."""
    g = _BATCH_GROUP
    if g is None:
        return x
    n, r = dist.get_world_size(g), dist.get_rank(g)
    xs = x.reshape((groups, n, x.shape[0] // (groups * n)) + x.shape[1:])
    return xs[:, r].reshape((-1,) + x.shape[1:])


@torch.no_grad()
def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """A small tensor's global batch (rank order), without gradient, through
    one all-reduce (gloo has no all-gather of CUDA tensors)."""
    g = _BATCH_GROUP
    if g is None:
        return x.detach()
    n, r = dist.get_world_size(g), dist.get_rank(g)
    out = x.new_zeros((n * x.shape[0],) + x.shape[1:])
    out[r * x.shape[0]:(r + 1) * x.shape[0]] = x.detach()
    dist.all_reduce(out, group=g)
    return out
