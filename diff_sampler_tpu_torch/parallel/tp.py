"""Tensor parallelism (Megatron-style) of the U-Nets over the model group.

Counterpart of ``diff_sampler_tpu/parallel/tp.py``.  The JAX package
annotates ``PartitionSpec``s and lets GSPMD insert every collective; PyTorch
propagates no shardings, so the port writes the Megatron plan out block by
block.  Every rank builds the same full net (from one seed or one file),
then ``shard_tensor_parallel`` cuts it in place to this rank's shard.

The plan (``tp_plan``) is the JAX package's ``_role`` table applied to the
port's module names (a module path with '.' -> '_' is the JAX name):

  column-parallel (output channels split)   conv0, in_layers_2, qkv, to_q,
                                            to_k, to_v, net_0_proj
  row-parallel (input channels split,       conv1, out_layers_3, to_out_0,
  partial results summed)                   net_2; proj / proj_out with a
                                            qkv sibling and no proj_in one
  replicated                                everything else

and a weight whose split dimension does not divide by tp stays replicated.

How a sharded block runs: a column layer's input is replicated, so its
backward sums the input gradient over the model group (``_CopyToModel``);
a row layer all-reduces its partial output in the forward
(``_ReduceFromModel``) and adds its (replicated) bias once, after the sum.
Between the two the activations hold this rank's channels only.  Where the
port stores a slice of what the JAX plan replicates, it says so: the norm
between the pair (``UNetBlock.norm1``, a ResBlock's ``out_layers.0``), run
on the rank's channels with ``groups / tp`` groups, and the embedding rows
that modulate them (``affine``, ``affine_step``, ``emb_layers.1``: the
rank's rows of the scale and of the shift).  A whole copy would take a
gradient on its slice only; so every parameter is either a shard, complete
on its rank, or replicated with the same gradient on every rank of the
model group.  A column layer's bias is cut with its weight.

Attention runs on the rank's heads with no collective (K1 / K2 on the card)
where tp divides the heads.  A block whose heads do not divide (EDM's
SongUNet has one head; the LSUN LDM's 224-channel level has 7) keeps the
JAX placement of its weights (a contiguous cut of the projection), gathers
the projection over the model group, attends on every head and hands the
row-parallel ``proj`` this rank's channels (``_GatherFromModel``, whose
backward sums and cuts the gradient).

Departures from the JAX placement, each the same bytes with no reshard:
GEGLU's ``net.0.proj`` gives each rank its slice of each half ([a | gate]),
where JAX's contiguous cut puts all of a on one rank and GSPMD reshards at
the gate; the new-order (3, head, ch) qkv gives each rank its heads of each
of q, k and v; the stored slices above.  A block whose paired column and
row layers do not both divide stays replicated whole.  GroupNorm across a
column shard needs tp to divide the norm's groups: ``shard_tensor_parallel``
refuses a tp that does not, naming the norm (JAX lets GSPMD gather there).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import ParallelLayout, ShardSpec, shard_spec, whole

__all__ = ["HeadSplit", "attend", "count_sharded", "gather_state_dict", "shard_tensor_parallel",
           "tp_bytes_per_rank", "tp_input", "tp_output", "tp_plan"]

# module-name suffixes -> role (diff_sampler_tpu/parallel/tp.py:68-70)
_COL_SUFFIXES = ("in_layers_2", "conv0", "qkv", "to_q", "to_k", "to_v", "net_0_proj")
_ROW_SUFFIXES = ("out_layers_3", "conv1", "to_out_0", "net_2")


def _role(module_name: str, all_names: frozenset) -> Optional[str]:
    """The JAX package's ``_role`` (tp.py:86-110): "col", "row" or None."""
    if module_name == "proj" or module_name.endswith("_proj"):
        prefix = module_name[: -len("proj")].rstrip("_")
        sib = f"{prefix}_qkv" if prefix else "qkv"
        if sib in all_names:
            return "row"
    elif module_name == "proj_out" or module_name.endswith("_proj_out"):
        prefix = module_name[: -len("proj_out")].rstrip("_")
        pin = f"{prefix}_proj_in" if prefix else "proj_in"
        qkv = f"{prefix}_qkv" if prefix else "qkv"
        if pin in all_names:
            return None  # SpatialTransformer boundary: keep replicated
        if qkv in all_names:
            return "row"  # guided-diffusion pixel attention
        return None
    for s in _COL_SUFFIXES:
        if module_name == s or module_name.endswith("_" + s):
            return "col"
    for s in _ROW_SUFFIXES:
        if module_name == s or module_name.endswith("_" + s):
            return "row"
    return None


def tp_plan(module: nn.Module, tp: int) -> Dict[str, Tuple[str, int]]:
    """{parameter name: (role, dimension cut)} of the weights that the JAX
    plan shards at ``tp``: a column layer's weight on its output dimension
    (0 of OIHW and of (out, in)), a row layer's on its input dimension (1).
    Only 2-D and 4-D ``weight``s take a role, as only JAX ``kernel``s do."""
    names = frozenset(path.replace(".", "_") for path, m in module.named_modules()
                      if path and any(True for _ in m.parameters(recurse=False)))
    plan = {}
    for name, p in module.named_parameters():
        path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        if leaf != "weight" or p.dim() not in (2, 4) or not path:
            continue
        role = _role(path.replace(".", "_"), names)
        dim = {"col": 0, "row": 1}.get(role)
        if dim is not None and p.shape[dim] % tp == 0:
            plan[name] = (role, dim)
    return plan


# ---------------------------------------------------------------------------
# Megatron's conjugate pair, and the gather of a projection whose heads do
# not divide


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives move it: f32 for a half-precision tensor
    (the partial sums are summed in f32; gloo, which two ranks on one card
    use, takes f32 on CUDA tensors), else a contiguous copy."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float().contiguous()
    return x.contiguous().clone()


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group
    (the input of a column layer is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = _wire(g)
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group in the forward (a row layer's partial
    outputs); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        total = _wire(x)
        dist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' column shards joined along the last dimension; the
    backward sums the gradient over the model group and keeps this rank's
    part (every rank computed the whole attention from the gathered
    projection, and handed on only its own channels)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.size = group, rank, size
        mine = _wire(x)
        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine, group=group)
        return torch.cat(parts, dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        total = _wire(g)
        dist.all_reduce(total, group=ctx.group)
        return (total.chunk(ctx.size, dim=-1)[ctx.rank].to(g.dtype).contiguous(), None, None,
                None)


def tp_input(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A layer's input: through ``_CopyToModel`` for a column layer (its
    input is replicated), else as it is."""
    if getattr(layer, "tp_role", None) == "col":
        return _CopyToModel.apply(x, layer.tp_group)
    return x


def tp_output(layer: nn.Module, fn: Callable, bias: Optional[torch.Tensor]):
    """``fn(bias)``, the layer's op with its bias; a row layer runs it with
    no bias, sums the partial results over the model group and adds the
    bias once, after the sum.  ``bias`` is broadcast on the last
    dimension."""
    if getattr(layer, "tp_role", None) != "row":
        return fn(bias)
    y = _ReduceFromModel.apply(fn(None), layer.tp_group)
    return y if bias is None else y + bias


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """How a sharded attention block runs its heads: on this rank's
    ``heads / size`` of them, or (``gather``: the heads do not divide) on
    every head of the projections gathered over the model group."""

    group: object
    rank: int
    size: int
    gather: bool


def attend(split: Optional[HeadSplit], fn: Callable, heads: int, *projs):
    """``fn(*projs, heads)``, an attention over column-parallel projections
    whose outputs' last dimension is (heads, per-head channels), as the
    block's ``split`` runs it; returns this rank's channels of the result."""
    if split is None:
        return fn(*projs, heads)
    if not split.gather:
        return fn(*projs, heads // split.size)
    full = [_GatherFromModel.apply(p, split.group, split.rank, split.size) for p in projs]
    return fn(*full, heads).chunk(split.size, dim=-1)[split.rank]


# ---------------------------------------------------------------------------
# cutting a full module


def _block(n: int, parts: int, rank: int, tp: int) -> torch.Tensor:
    """The entries of rank ``rank`` in each of ``parts`` equal parts of n:
    its contiguous 1/tp of every part."""
    step, share = n // parts, n // parts // tp
    return torch.cat([torch.arange(j * step + rank * share, j * step + (rank + 1) * share)
                      for j in range(parts)])


class _Cutter:
    def __init__(self, layout: ParallelLayout):
        self.group, self.rank, self.tp = layout.model_group, layout.model_index, layout.tp

    def param(self, p: nn.Parameter, dim: int, parts: int = 1) -> None:
        n = p.shape[dim]
        index = tuple(_block(n, parts, r, self.tp) for r in range(self.tp))
        spec = ShardSpec(dim, n, index, self.rank, self.group)
        with torch.no_grad():
            p.data = p.data.index_select(dim, index[self.rank].to(p.device)).contiguous()
        p.dst_shard = spec

    def col(self, layer: nn.Module, parts: int = 1) -> None:
        """A column layer (or the stored rows of an embedding): weight and
        bias cut on the output dimension."""
        self.param(layer.weight, 0, parts)
        if getattr(layer, "bias", None) is not None:
            self.param(layer.bias, 0, parts)
        layer.tp_role, layer.tp_group = "col", self.group

    def row(self, layer: nn.Module) -> None:
        self.param(layer.weight, 1)
        layer.tp_role, layer.tp_group = "row", self.group

    def norm(self, norm: nn.Module, name: str, attr: str) -> None:
        """A GroupNorm between a column and a row layer: its channel slice,
        with groups / tp groups."""
        groups = getattr(norm, attr)
        if groups % self.tp:
            raise ValueError(f"--tp={self.tp} does not divide the {groups} groups of the "
                             f"GroupNorm {name}: its channels would split inside a group")
        self.param(norm.weight, 0)
        self.param(norm.bias, 0)
        setattr(norm, attr, groups // self.tp)

    def heads(self, heads: int) -> HeadSplit:
        return HeadSplit(self.group, self.rank, self.tp, heads % self.tp != 0)


def shard_tensor_parallel(module: nn.Module, layout: ParallelLayout) -> nn.Module:
    """Cut the full ``module`` in place to this rank's tensor-parallel shard
    over ``layout``'s model group: every submodule with a ``tp_cut(cut,
    planned, name)`` method (the U-Nets' blocks) cuts its layers by the
    plan; ``layout.tp`` 1 leaves it whole.  Every rank must call it on the
    same full module.  Returns the module."""
    if layout.tp == 1:
        return module
    plan = tp_plan(module, layout.tp)
    cut = _Cutter(layout)
    named = {m: name for name, m in module.named_modules()}

    def planned(layer: nn.Module, role: str) -> bool:
        return plan.get(f"{named[layer]}.weight", (None,))[0] == role

    for name, m in list(module.named_modules()):
        if hasattr(m, "tp_cut"):
            m.tp_cut(cut, planned, name)
    return module


def gather_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state_dict of a module that ``shard_tensor_parallel`` (or
    ``parallel/fsdp.py::shard_fsdp``) cut: every shard gathered whole (a
    collective: every rank of the groups must call it), every other tensor
    as it is.  A snapshot of a sharded run writes these."""
    params = dict(module.named_parameters())
    return {name: whole(t, params[name]) if name in params else t
            for name, t in module.state_dict().items()}


def count_sharded(module: nn.Module) -> int:
    """Parameters of ``module`` that a sharding cut."""
    return sum(shard_spec(p) is not None for p in module.parameters())


def tp_bytes_per_rank(module: nn.Module) -> int:
    """The bytes of ``module``'s parameters that this rank holds."""
    return sum(p.numel() * p.element_size() for p in module.parameters())
