"""Fully-sharded data parallelism (ZeRO-3 style) of a module's weights.

Counterpart of ``diff_sampler_tpu/parallel/fsdp.py``: every parameter of at
least 2^14 elements is split over the data group (replicated over a seq
group) along its largest dimension that divides by the group's size, ties
to the last (``fsdp_dim``, the JAX ``fsdp_param_specs`` rule); smaller
ones, and those with no divisible dimension, stay whole.  The optimizer
built on the module afterwards keeps its moments on the shards.

The JAX package lets GSPMD insert the collectives.  The port gathers each
sharded parameter just before the module that owns it runs (a forward
pre-hook swaps the whole tensor in, a forward hook puts the shard back), so
that one layer's whole weights live at a time in a forward without
autograd.  The gather is differentiable: its backward sums the whole
gradient over the data group into this rank's part, divided by the
group's size, so the shard's ``.grad`` is already the data-parallel mean
(``fsdp_averaged``: ``mesh.average_gradients`` leaves such parameters out).
A remat recompute gathers again, in the same order on every rank.  What a
backward needs of the gathered weights stays resident from the forward to
the backward (nothing gathers again in the backward).

The collectives are ``all_gather`` and ``reduce_scatter_tensor``, which
gloo runs on CUDA tensors, so two ranks may share one card; FSDP2's
``fully_shard`` crashed there under gloo (two ranks on one H100, torch
2.11).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import ParallelLayout, ShardSpec, shard_spec

__all__ = ["count_sharded_fsdp", "fsdp_bytes_per_device", "fsdp_dim", "fsdp_specs",
           "shard_fsdp"]

# Leaves smaller than this stay replicated (fsdp.py:45)
_MIN_SHARD_ELEMS = 2 ** 14


def fsdp_dim(shape: Tuple[int, ...], n_shard: int):
    """The dimension the JAX rule shards a tensor of ``shape`` on over
    ``n_shard`` ranks: its largest that divides, ties to the last; None for
    a tensor under ``_MIN_SHARD_ELEMS`` elements or with none that divides."""
    if not shape or int(torch.tensor(shape).prod()) < _MIN_SHARD_ELEMS:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % n_shard == 0 and (best is None or d >= shape[best]):
            best = i
    return best


class _GatherShard(torch.autograd.Function):
    """A parameter whole from its shards (all_gather over the data group);
    the backward's gradient reduce-scattered over the group (this rank's
    part of the sum), divided by the group's size."""

    @staticmethod
    def forward(ctx, shard, spec):
        ctx.spec = spec
        parts = [torch.empty_like(shard) for _ in range(spec.size)]
        dist.all_gather(parts, shard.contiguous(), group=spec.group)
        return torch.cat(parts, dim=spec.dim)

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        rows = g.movedim(spec.dim, 0).contiguous()  # the shards along dimension 0
        mine = rows.new_empty((rows.shape[0] // spec.size,) + rows.shape[1:])
        dist.reduce_scatter_tensor(mine, rows, group=spec.group)
        return mine.div_(spec.size).movedim(0, spec.dim).contiguous(), None


def fsdp_specs(module: nn.Module, n_shard: int) -> Dict[str, int]:
    """{parameter name: dimension} of the parameters that the JAX rule
    shards over ``n_shard`` ranks (``fsdp_dim``)."""
    return {name: d for name, p in module.named_parameters()
            if (d := fsdp_dim(tuple(p.shape), n_shard)) is not None}


def shard_fsdp(module: nn.Module, layout: ParallelLayout) -> Dict[str, int]:
    """Cut ``module``'s parameters in place over ``layout``'s data group (of
    ``layout.dp`` ranks) and hook the gathers into its forward.  Every rank
    must call it on the same full module.  A module that holds a parameter
    but has no ``forward`` of its own (an embedding table read by its
    parent) is gathered by its parent.  Returns {parameter name: dimension
    cut} (what the JAX specs shard; nothing is cut at dp 1)."""
    n = layout.dp
    specs = fsdp_specs(module, n)
    if n == 1:
        return specs
    group, rank = layout.data_group, layout.data_index
    owners = {}
    for path, m in module.named_modules():
        owner = m
        if type(m).forward is nn.Module.forward and path:
            owner = module.get_submodule(path.rsplit(".", 1)[0]) if "." in path else module
        for leaf, p in m.named_parameters(recurse=False):
            name = f"{path}.{leaf}" if path else leaf
            if name not in specs:
                continue
            d = specs[name]
            size = p.shape[d] // n
            index = tuple(torch.arange(r * size, (r + 1) * size) for r in range(n))
            with torch.no_grad():
                p.data = p.data.narrow(d, rank * size, size).contiguous()
            p.dst_shard = ShardSpec(d, size * n, index, rank, group)
            p.fsdp_averaged = True
            owners.setdefault(owner, []).append((m, leaf, p))
    for owner, held in owners.items():
        def gather(mod, args, held=held):
            for m, leaf, p in held:
                m._parameters[leaf] = _GatherShard.apply(p, p.dst_shard)

        def release(mod, args, out, held=held):
            for m, leaf, p in held:
                m._parameters[leaf] = p

        owner.register_forward_pre_hook(gather)
        owner.register_forward_hook(release, always_call=True)
    return specs


def count_sharded_fsdp(specs: Dict[str, int]) -> int:
    """Parameters that the specs shard (diagnostics, as the JAX function)."""
    return len(specs)


def fsdp_bytes_per_device(module: nn.Module, specs: Dict[str, int], n_shard: int) -> int:
    """Per-device resident bytes of ``module``'s parameters under ``specs``
    over ``n_shard`` ranks (the JAX function's count): a sharded tensor's
    whole bytes over n_shard, every other tensor's whole bytes.  On a module
    that ``shard_fsdp`` cut this is what the rank holds."""
    total = 0
    for name, p in module.named_parameters():
        spec = shard_spec(p)
        nbytes = p.numel() * p.element_size() * (spec.size if spec is not None else 1)
        total += nbytes // n_shard if name in specs else nbytes
    return total
