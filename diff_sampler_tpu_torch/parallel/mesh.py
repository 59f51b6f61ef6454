"""Processes, devices and the (data, seq) layout of a multi-process run.

Counterpart of ``diff_sampler_tpu/parallel/mesh.py``, on
``torch.distributed`` where the JAX package has its device mesh:

  * seed-sharded sampling: each batch of seeds splits over the data ranks
    (``sampling.generate_batches``) and the results are all-gathered, so
    image i stays a pure function of seed i at any world size;
  * training: the predictor or the student is replicated, each microbatch
    splits over the data ranks, and the gradients are averaged over them
    before the optimizer's step (``average_gradients``), in place of the
    reference's DDP;
  * sequence parallelism: the ranks of one seq group hold the same rows and
    split each attention's tokens among them (``ops/ring_attention.py``);
  * tensor parallelism: the ranks of one model group hold the same rows and
    each holds its shard of the U-Net's weights (``parallel/tp.py``).

The processes form a (data, seq) or a (data, model) grid laid out as the
JAX package's ``parallel/tp.py::get_mesh_2d`` lays out its devices, the
inner index varying fastest: ``rank = d * sp + s`` or ``rank = d * tp + m``
(``--sp`` and ``--tp`` exclude each other, as in the JAX CLIs).

A CLI calls ``maybe_initialize_distributed`` before any device work.  It
starts a process group when the environment describes one: the JAX
package's surface (``DST_COORDINATOR``, ``DST_NUM_PROCESSES``,
``DST_PROCESS_ID``, ``DST_LOCAL_DEVICE_IDS``) or torchrun's (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).  The
backend is NCCL for a CUDA device and gloo for the CPU; ``DST_BACKEND``
overrides it (NCCL refuses two ranks on one card, gloo takes them).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["ParallelLayout", "ShardSpec", "all_gather_cat", "average_gradients",
           "broadcast_object", "check_degrees", "cut", "data_rows", "local_device_id",
           "make_layout", "maybe_initialize_distributed", "pad_to_multiple", "print0",
           "process_count", "process_index", "rank_device", "shard_spec", "whole"]


def local_device_id() -> int:
    """The card this process runs on: ``DST_LOCAL_DEVICE_IDS`` (one id: the
    port runs one device a process), else torchrun's ``LOCAL_RANK``, else 0."""
    ids = os.environ.get("DST_LOCAL_DEVICE_IDS")
    if ids:
        ids = [int(i) for i in ids.split(",")]
        if len(ids) != 1:
            raise ValueError(f"DST_LOCAL_DEVICE_IDS={ids}: the port runs one device a process")
        return ids[0]
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device) -> torch.device:
    """The device of this process: ``cuda`` becomes ``cuda:<local device
    id>``; any other device (``cpu``, an explicit ``cuda:i``) stays."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_device_id())
    return device


def maybe_initialize_distributed(device="cuda", timeout_s: float = 600.0) -> bool:
    """Start the process group of a multi-process run, if the environment
    describes one; else, and when a group already exists, do nothing.

    ``DST_COORDINATOR`` (``host:port``, or an init-method URL such as
    ``tcp://...`` or ``file://...``) with ``DST_NUM_PROCESSES`` and
    ``DST_PROCESS_ID``; or torchrun's ``MASTER_ADDR`` / ``WORLD_SIZE`` /
    ``RANK``.  The backend is ``DST_BACKEND`` where set (``gloo`` for
    several ranks on one card, which NCCL refuses), else NCCL on a CUDA
    ``device`` and gloo on the CPU.  ``timeout_s`` bounds the rendezvous
    and every collective.  Returns True only when this call started the
    group."""
    if dist.is_initialized():
        return False
    env = os.environ
    if env.get("DST_COORDINATOR"):
        coord = env["DST_COORDINATOR"]
        init_method = coord if "://" in coord else f"tcp://{coord}"
        missing = [k for k in ("DST_NUM_PROCESSES", "DST_PROCESS_ID") if k not in env]
        if missing:
            raise ValueError(f"DST_COORDINATOR is set but {missing} is not")
        world, rank = int(env["DST_NUM_PROCESSES"]), int(env["DST_PROCESS_ID"])
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        init_method, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    device = rank_device(device)
    backend = env.get("DST_BACKEND") or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def print0(*args, **kwargs) -> None:
    """Print on process 0 only (the reference's ``dist.print0``)."""
    if process_index() == 0:
        print(*args, **kwargs)


def pad_to_multiple(n: int, m: int) -> int:
    """The smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ParallelLayout:
    """The (data, seq) or (data, model) grid of the processes, ``rank =
    data_index * inner + inner_index`` with ``inner`` = sp or tp (one of
    them is 1), and this rank's groups: ``data_group`` holds the ranks of
    its inner index (one per data row), ``seq_group`` / ``model_group``
    those of its data row.  A group of one rank is None: nothing is
    communicated over it."""

    sp: int = 1
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None
    data_group: Optional[object] = None
    seq_group: Optional[object] = None
    tp: int = 1
    model_group: Optional[object] = None

    @property
    def inner(self) -> int:
        return self.sp * self.tp

    @property
    def dp(self) -> int:
        return self.world // self.inner

    @property
    def data_index(self) -> int:
        return self.rank // self.inner

    @property
    def seq_index(self) -> int:
        return self.rank % self.sp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def seq_ranks(self) -> list:
        """The global ranks of this rank's seq group, in ring order."""
        d = self.data_index
        return [d * self.sp + s for s in range(self.sp)]


def check_degrees(sp: int, tp: int) -> None:
    """The refusals of a (data, seq) or (data, model) layout's degrees, as
    the JAX CLIs make them: ``--tp`` and ``--sp`` exclusive, each at least 1."""
    if sp > 1 and tp > 1:
        raise ValueError("--tp and --sp are mutually exclusive (one attention sharding at a "
                         "time)")
    for flag, value in (("--tp", tp), ("--sp", sp)):
        if value < 1:
            raise ValueError(f"{flag}={value} is out of range")


def make_layout(sp: int = 1, tp: int = 1) -> ParallelLayout:
    """The layout of the running processes with seq groups of ``sp`` ranks
    or model groups of ``tp`` ranks (one process: the trivial layout).  With
    ``sp`` or ``tp`` > 1 every process must call it, in the same order
    (``dist.new_group`` is collective)."""
    world, rank = process_count(), process_index()
    check_degrees(sp, tp)
    inner = sp * tp
    if world % inner:
        what = f"model groups of --tp={tp}" if tp > 1 else f"seq groups of --sp={sp}"
        raise ValueError(f"{world} processes do not split into {what}")
    backend = dist.get_backend() if dist.is_initialized() else None
    if world == 1:
        return ParallelLayout(backend=backend)
    dp = world // inner
    if inner == 1:
        return ParallelLayout(1, rank, world, backend, dist.group.WORLD, None)
    data_group = inner_group = None
    for s in range(inner):
        g = dist.new_group([d * inner + s for d in range(dp)])
        if rank % inner == s and dp > 1:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * inner + s for s in range(inner)])
        if rank // inner == d:
            inner_group = g
    if tp > 1:
        return ParallelLayout(1, rank, world, backend, data_group, None, tp, inner_group)
    return ParallelLayout(sp, rank, world, backend, data_group, inner_group)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (one shape) joined along ``dim`` in group-rank order;
    ``x`` itself for a group of one."""
    n = _size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def average_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks of
    ``group``, in one all-reduce of the flattened gradients.  Parameters
    without a gradient are left out, and so are FSDP shards
    (``parallel/fsdp.py``), whose backward averaged their gradients already;
    every rank runs the same graph, so the set is the same on every rank."""
    if _size(group) == 1:
        return
    params = [p for p in params if p.grad is not None and not getattr(p, "fsdp_averaged", False)]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= _size(group)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
        offset += p.numel()


def data_rows(x: torch.Tensor, mb: int, layout: "ParallelLayout") -> list:
    """This data rank's rows of each microbatch of ``mb`` rows of ``x``: each
    microbatch splits contiguously over the dp data ranks, as the JAX
    trainers' ``data_sharding`` splits it.  Raises where dp does not divide
    ``mb``."""
    dp = layout.dp
    if mb % dp:
        raise ValueError(f"the microbatch of {mb} rows does not split over {dp} data ranks")
    lm = mb // dp
    lo = layout.data_index * lm
    return [c[lo:lo + lm] for c in x.split(mb)]


def broadcast_object(obj):
    """Process 0's ``obj`` on every process (a picklable value)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a parameter is cut over a group of ranks (``parallel/tp.py``'s
    tensor-parallel shards over the model group, ``parallel/fsdp.py``'s
    shards over the data group): this rank holds the entries
    ``index[rank]`` of dimension ``dim`` (of ``full`` entries) of the whole
    tensor; every rank of ``group`` holds as many."""

    dim: int
    full: int
    index: tuple
    rank: int
    group: object

    @property
    def size(self) -> int:
        return len(self.index)


def shard_spec(p: torch.Tensor) -> Optional[ShardSpec]:
    """The ``ShardSpec`` of a parameter that a sharding cut, else None."""
    return getattr(p, "dst_shard", None)


def cut(full: torch.Tensor, spec: ShardSpec) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` (a copy)."""
    return full.index_select(spec.dim, spec.index[spec.rank].to(full.device)).contiguous()


def whole(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t`` (the parameter ``p`` itself, or a tensor shaped as it: its
    gradient, an Adam moment) whole: where ``p`` is a shard, gathered from
    every rank's part (a collective over the spec's group), else ``t``."""
    spec = shard_spec(p)
    if spec is None:
        return t.detach()
    parts = [torch.empty_like(t) for _ in range(spec.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=spec.group)
    shape = list(t.shape)
    shape[spec.dim] = spec.full
    out = t.new_empty(shape)
    for part, idx in zip(parts, spec.index):
        out.index_copy_(spec.dim, idx.to(t.device), part)
    return out
