"""Device mesh, process bootstrap and the collectives of the port.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX's mesh is
single-controller: one process sees every device and GSPMD inserts the
collectives. Here the layout is SPMD, as ``torch.distributed`` has it: one
process per device, every rank runs the same program on the same global
inputs, keeps its own rows of each batch, and calls the collectives itself.
JAX's multi-host mode (``initialize_multihost``) has the same shape.

The mesh is 2-D, ``(data, model)``, laid over the world's ranks as JAX's
``reshape(dp, mp)`` lays devices: world rank ``r`` has data coordinate
``r // mp`` and model coordinate ``r % mp``. The data axis splits the
batch; the model axis splits wide output channels (``parallel/tp.py``,
``parallel/sharding.py``). Each rank's collectives on the data axis run
over its data sub-group (the ranks of its model coordinate), those on the
model axis over its model sub-group; parameter replication, the barrier,
the host stop flag and the writer (world rank 0) are the world's.

A single process with no process group gets a 1×1 mesh that needs no
collectives, so the same code serves one device and many. Where a process
group exists, a mesh calls its collectives even at one rank (a one-rank
all-reduce into a zero buffer is exact), so every path runs on the
backend at any world size.

Collectives. Only ``broadcast`` and ``all_reduce`` are used, because they
are what gloo supports on CUDA tensors as well as on the CPU, and NCCL
supports everywhere: a row gather is an all-reduce into a zero-filled
global buffer in which each rank has written its own rows (``x + 0`` is
exact, so the gather is bitwise). Every call is counted in
:data:`COLLECTIVES` under its path, operation and backend.

Training on a data axis (:func:`sharded_rows`): inside a train step's
forward and backward passes, the loss denominators, the BatchNorm
statistics and the random draws are those of the global batch. Masked
means divide a local numerator by the global mask sum, plain means are
scaled by the local over the global row count, BatchNorm averages its
per-rank means with a differentiable all-reduce, and a rank draws the global batch's
dropout mask or noise from the shared generator and keeps its rows. The
gradients summed over the ranks are then the single-device gradients.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from iris_tts_tpu_torch.config import MeshConfig
from iris_tts_tpu_torch.runtime import DeviceLike

DEFAULT_TIMEOUT_S = 300.0

# The collective timeout given to initialize_multihost, for the groups the
# port makes besides the world group (None: torch's default, where the
# process group was made elsewhere).
_TIMEOUT: Optional[datetime.timedelta] = None

# (path, operation, backend) → calls, for the record of which collective
# each path took on each backend.
COLLECTIVES: collections.Counter = collections.Counter()


@dataclass(eq=False)
class Mesh:
    """The port's ``(data, model)`` mesh as one rank sees it.

    ``shape`` maps the axis names to their sizes, as ``jax.sharding.Mesh``
    does. ``rank`` is this process's coordinate on the data axis, ``device``
    the device it computes on, and ``group`` the data axis' process group
    over the ranks of this rank's model coordinate (None without a process
    group: that mesh makes no collective call). ``model_rank`` and
    ``model_group`` are the same for the model axis (no group where the
    model axis has one rank), and ``world_group`` is the group of every
    rank."""

    shape: Dict[str, int]
    axis_names: Tuple[str, str]
    rank: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None
    model_rank: int = 0
    model_group: Any = None
    world_group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def data_size(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def model_size(self) -> int:
        return self.shape[self.axis_names[1]]

    @property
    def world_rank(self) -> int:
        """This rank's index in the world (``rank · model_size +
        model_rank``)."""
        return self.rank * self.model_size + self.model_rank


def local_only(mesh: Optional[Mesh]) -> bool:
    """True where no collective is called: no mesh, or no process group."""
    return mesh is None or mesh.group is None


def process_group_info() -> Tuple[int, int, Optional[str]]:
    """(rank, world size, backend) of this process (0, 1, None without a
    process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    return 0, 1, None


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return process_group_info()[1]


def _default_device() -> torch.device:
    """``cuda:{LOCAL_RANK}``; raises without CUDA (pass ``devices`` to run
    elsewhere)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices= "
                           "(e.g. ['cpu'] * world_size) to run elsewhere")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def build_mesh(cfg: MeshConfig = MeshConfig(),
               devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build the ``(data, model)`` mesh of the running processes.

    ``devices`` lists one device per rank (this rank computes on
    ``devices[rank]``); by default each rank takes ``cuda:{LOCAL_RANK}``.
    ``cfg.data_parallel == 0`` means every rank the model axis leaves on the
    data axis. The world is laid out as ``reshape(dp, mp)``; a layout that
    does not cover the world raises. Every rank makes every sub-group, in
    the same order (``new_group``)."""
    rank, world, backend = process_group_info()
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel or world // mp
    if dp < 1 or dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} does not cover {world} "
                         "process(es); adjust data_parallel/model_parallel")
    if devices is None:
        device = _default_device()
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} "
                             "process(es): give one device per rank")
        device = torch.device(devices[rank])
    shape = {cfg.data_axis: dp, cfg.model_axis: mp}
    names = (cfg.data_axis, cfg.model_axis)
    if backend is None:
        return Mesh(shape, names, 0, device)
    world_group = dist.group.WORLD
    if mp == 1:
        return Mesh(shape, names, rank, device, world_group, backend, 0,
                    None, world_group)
    data_groups = [new_group([d * mp + m for d in range(dp)])
                   for m in range(mp)]
    model_groups = [new_group([d * mp + m for m in range(mp)])
                    for d in range(dp)]
    return Mesh(shape, names, rank // mp, device, data_groups[rank % mp],
                backend, rank % mp, model_groups[rank // mp], world_group)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group: one call per process before any collective.

    With no arguments it reads torchrun's ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR``/``MASTER_PORT``, and is a no-op when they are not set
    (a single process, as JAX's is with no coordinator). A
    ``coordinator_address`` is ``host:port`` or an ``init_method`` URL
    (``tcp://…``, ``file://…``). ``backend`` defaults to ``nccl`` for the
    card and to ``gloo`` when ``device`` is the CPU; the port never switches
    backend on its own. Every group of the port waits at most
    ``timeout_s`` in a collective. A no-op when the process group exists
    already."""
    global _TIMEOUT
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        if coordinator_address is None or num_processes is None:
            raise ValueError("give both coordinator_address and "
                             "num_processes, or neither")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank = int(process_id if process_id is not None
                   else env.get("RANK", 0))
        world = int(num_processes)
    if backend is None:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if on_cpu else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    _TIMEOUT = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=_TIMEOUT)


def new_group(ranks: Sequence[int], backend: Optional[str] = None):
    """A process group over ``ranks`` with the world group's timeout (as
    given to :func:`initialize_multihost`). Every rank of the world makes
    every group, in the same order."""
    return dist.new_group(list(ranks), timeout=_TIMEOUT, backend=backend)


# A gloo group over the world's ranks for flags the hosts agree on, where
# the world group is not gloo (made at its first use).
_HOST_GROUP: Dict[Any, Any] = {}


def host_group(mesh: Mesh):
    """A gloo group over the world's ranks, for what the hosts agree on:
    the world group where it is gloo, else a gloo group made at the first
    call (which every rank makes at the same point)."""
    if mesh.backend == "gloo":
        return mesh.world_group
    key = mesh.world_group
    if key not in _HOST_GROUP:
        _HOST_GROUP.clear()  # a group of an earlier world is gone
        _HOST_GROUP[key] = new_group(range(world_size()), "gloo")
    return _HOST_GROUP[key]


def any_rank(flag: bool, mesh: Optional[Mesh], path: str) -> bool:
    """Whether ``flag`` is set on any rank of the world, agreed on the
    host: a CPU tensor's all-reduce over :func:`host_group`, so it waits
    for no device work the rank has queued."""
    if local_only(mesh):
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    COLLECTIVES[(path, "all_reduce", "gloo")] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group(mesh))
    return bool(t[0])


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: its ``axis`` split over the data axis
    (each rank keeps its own block of rows), or, with ``axis=None``,
    whole on every rank (broadcast from world rank 0)."""

    mesh: Mesh
    axis: Optional[int] = 0

    def place(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if self.axis is None:
            t = t.to(self.mesh.device)
            broadcast_(t, self.mesh, "replicate")
            return t
        return local_rows(t, self.mesh, self.axis).to(self.mesh.device)


def data_sharding(mesh: Mesh, cfg: MeshConfig = MeshConfig()) -> Sharding:
    """Split the leading (batch) axis over the data axis; the rest is
    whole."""
    del cfg  # one data axis: the mesh's first
    return Sharding(mesh, 0)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh, cfg: MeshConfig = MeshConfig(),
                axis: int = 0):
    """This rank's rows of every array in a (nested dict/list/tuple) batch,
    on the mesh's device. Every rank passes the same global batch, whose
    ``axis`` must divide by the data-axis size (``axis=1`` for batches
    stacked as ``[accum, B, ...]`` microbatches)."""
    del cfg
    sharding = Sharding(mesh, axis)
    return _tree_map(sharding.place, batch)


def replicate_params(params, mesh: Mesh):
    """Put a module's parameters and buffers (or a tree of tensors) on the
    mesh's device, each equal to world rank 0's."""
    if isinstance(params, nn.Module):
        params.to(mesh.device)
        if not local_only(mesh):
            tensors = list(params.parameters()) + list(params.buffers())
            broadcast_flat_([t.data for t in tensors], mesh.world_group,
                            mesh.backend, "replicate")
        return params
    return _tree_map(replicated(mesh).place, params)


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------


def pad_rows(x, multiple: int):
    """Pad the leading axis up to a multiple of ``multiple`` with copies of
    the last row (numpy or tensor)."""
    pad = -x.shape[0] % multiple
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])


def local_rows(x, mesh: Mesh, axis: int = 0):
    """This rank's block of ``axis`` (which must divide by the data-axis
    size)."""
    dp = mesh.data_size
    n = x.shape[axis]
    if n % dp:
        raise ValueError(f"a batch of {n} rows does not divide over the "
                         f"{dp} ranks of the data axis")
    k = n // dp
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, mesh.rank * k, k)
    return np.take(x, np.arange(mesh.rank * k, (mesh.rank + 1) * k), axis)


# Transport dtypes: NCCL has no int16 or bool type, so those cross as int32
# (exact: one rank contributes each element of a gather).
_WIDEN = {torch.int16: torch.int32, torch.bool: torch.int32}


def reduce_rows(local: Optional[torch.Tensor], shape: Sequence[int],
                dtype: torch.dtype, device, offset: int, group,
                backend: Optional[str], path: str, async_op: bool = False):
    """A buffer of ``shape`` and ``dtype``, zero but for ``local`` written at
    row ``offset`` (None: this rank contributes nothing), summed over
    ``group``. Returns (buffer, work): with ``async_op`` the caller waits on
    ``work`` before reading, and :func:`unwiden` gives ``dtype`` back."""
    buf = torch.zeros(tuple(shape), dtype=_WIDEN.get(dtype, dtype),
                      device=device)
    if local is not None:
        buf[offset:offset + local.shape[0]] = local
    COLLECTIVES[(path, "all_reduce", backend)] += 1
    work = dist.all_reduce(buf, group=group, async_op=async_op)
    return buf, work


def unwiden(buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return buf if buf.dtype == dtype else buf.to(dtype)


def gather_rows(local: torch.Tensor, mesh: Optional[Mesh],
                n: Optional[int] = None, path: str = "gather_rows"
                ) -> torch.Tensor:
    """Every rank's block of rows, in rank order, on every rank (the first
    ``n`` rows). Identity without a process group."""
    if local_only(mesh):
        return local if n is None else local[:n]
    k = local.shape[0]
    buf, _ = reduce_rows(local, (k * mesh.data_size, *local.shape[1:]),
                         local.dtype, local.device, mesh.rank * k,
                         mesh.group, mesh.backend, path)
    buf = unwiden(buf, local.dtype)
    return buf if n is None else buf[:n]


def all_reduce_(t: torch.Tensor, mesh: Optional[Mesh], path: str,
                op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` over the data axis (``op`` "sum" or
    "max"); identity without a process group."""
    if local_only(mesh):
        return t
    COLLECTIVES[(path, "all_reduce", mesh.backend)] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group)
    return t


def broadcast_(t: torch.Tensor, mesh: Optional[Mesh], path: str,
               src: int = 0) -> torch.Tensor:
    """In-place broadcast of ``t`` from world rank ``src`` to every rank;
    identity without a process group."""
    if local_only(mesh):
        return t
    COLLECTIVES[(path, "broadcast", mesh.backend)] += 1
    dist.broadcast(t, src=src, group=mesh.world_group)
    return t


def broadcast_flat_(tensors, group, backend: Optional[str], path: str,
                    src: int = 0) -> None:
    """Broadcast ``tensors`` in place from global rank ``src`` over
    ``group``, one flat buffer per dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        wide = _WIDEN.get(dtype, dtype)
        flat = torch.cat([t.reshape(-1).to(wide) for t in ts])
        COLLECTIVES[(path, "broadcast", backend)] += 1
        dist.broadcast(flat, src=src, group=group)
        i = 0
        for t in ts:
            t.copy_(flat[i:i + t.numel()].view(t.shape).to(dtype))
            i += t.numel()


def all_reduce_flat_(tensors, mesh: Optional[Mesh], path: str) -> int:
    """Sum ``tensors`` in place over the data axis as one flat buffer (all
    one dtype); returns the bytes reduced (0 without a process group)."""
    if local_only(mesh) or not tensors:
        return 0
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, mesh, path)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return flat.numel() * flat.element_size()


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank of the mesh is here (a file one rank wrote is
    then there for the others)."""
    if local_only(mesh):
        return
    COLLECTIVES[("barrier", "all_reduce", mesh.backend)] += 1
    dist.all_reduce(torch.zeros(1, device=mesh.device),
                    group=mesh.world_group)


def is_primary(mesh: Optional[Mesh] = None) -> bool:
    """True on the rank that writes files (world rank 0, or a lone
    process)."""
    return (process_group_info()[0] if mesh is None
            else mesh.world_rank) == 0


# ---------------------------------------------------------------------------
# Rows of a train step
# ---------------------------------------------------------------------------

# The mesh whose data axis the running train step's rows are split over
# (None: the whole batch is here); see sharded_rows.
_ROWS: Optional[Mesh] = None


@contextlib.contextmanager
def sharded_rows(mesh: Optional[Mesh]) -> Iterator[None]:
    """Within the block, losses, BatchNorm statistics and random draws are
    those of the global batch split over ``mesh``'s data axis (a no-op for
    None or a mesh without a process group).

    The block's mesh is one process-wide global, not scoped to a thread:
    the backward pass, and remat's recompute in it, run on autograd's own
    threads and must see it. It is read by ``ops/losses.py`` (masked-mean
    denominators, ``row_mean``), ``train/gan.py`` (the mel loss),
    ``models/layers.dropout`` and ``models/vae.py`` (the global batch's
    draws) and ``models/postnet.BatchNorm`` (global statistics). So
    nothing else may compute a loss, a dropout or a BatchNorm in training
    mode while a step runs in the block, on any thread of the process:
    it would take the sharded meaning."""
    global _ROWS
    prev = _ROWS
    _ROWS = None if local_only(mesh) else mesh
    try:
        yield
    finally:
        _ROWS = prev


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """A loss denominator summed over the ranks, out of the gradient."""
    if _ROWS is None:
        return t
    return all_reduce_(t.detach().clone(), _ROWS, "loss_denominator")


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` as this rank's share of the global batch's mean (every
    rank holds as many rows)."""
    m = x.mean()
    return m if _ROWS is None else m / _ROWS.data_size


class _SumOverRanks(torch.autograd.Function):
    """A sum over the ranks whose backward pass sums the gradients over
    the ranks too: each rank's loss reads the sum, so the gradient of the
    global loss with respect to the sum is the sum of the ranks' own."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def mean_over_rows(t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of ``t``, a mean over this rank's rows (every
    rank holds as many), with a differentiable all-reduce (its backward
    sums the gradients): BatchNorm's statistics. At one rank it is ``t``,
    bitwise."""
    if _ROWS is None:
        return t
    COLLECTIVES[("batch_norm_stats", "all_reduce", _ROWS.backend)] += 1
    return _SumOverRanks.apply(t, _ROWS.group) / _ROWS.data_size


def draw_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device, normal: bool = False) -> torch.Tensor:
    """A uniform (or standard normal) f32 draw of ``shape`` whose leading
    axis is this rank's rows: the global batch's draw is made from the
    shared generator and this rank keeps its rows, so a mesh step draws
    what the single-device step does."""
    fn = torch.randn if normal else torch.rand
    if _ROWS is None:
        return fn(tuple(shape), generator=generator, device=device)
    full = fn((shape[0] * _ROWS.data_size, *shape[1:]), generator=generator,
              device=device)
    return full.narrow(0, _ROWS.rank * shape[0], shape[0])
