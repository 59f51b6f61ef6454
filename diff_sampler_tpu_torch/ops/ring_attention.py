"""Sequence-parallel (ring) attention over the ranks of a seq group.

Counterpart of ``diff_sampler_tpu/ops/ring_attention.py``.  Each rank of a
seq group of n holds its T/n slice of q, k and v; the k / v blocks travel
round the ring (rank i sends to i+1 and receives from i-1, n-1 times) while
each rank merges the partial attention of every visiting block into its
own by log-sum-exp (the RingAttention construction of Liu et al. 2023,
arXiv:2310.01889, for the bidirectional attention of these U-Nets).  Per
rank that is T/n queries against T keys in tiles of [T/n, T/n], and never
the [T, T] logits.

The partial of one block runs kernel K1 (``attention.flash_attention_mh``,
which returns out and lse) and differentiates through K2
(``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv``).  The combine
differentiates through lse, so the partial's VJP carries an lse cotangent
g_lse: with S = scale q k^T, P = exp(S - lse) and delta = rowsum(dO * O),

  dS = P * (dO V^T - delta + g_lse),  dQ = scale dS K,  dK = scale dS^T Q,
  dV = P^T dO,

which is K2's math run on delta - g_lse (dV does not read delta).  The JAX
package recomputes that VJP by einsum; the port runs K2 on it, and on a CPU
tensor both directions take the plain versions.  A second-order gradient
through the ring is exact on the CPU (the plain partial's own VJP,
recorded) and refused on the card, as ``ops/attention.py`` refuses it.

The rotation is an autograd Function over ``dist.batch_isend_irecv``: its
backward sends the gradients the other way round the ring.  Under NCCL the
blocks go from card to card; gloo reads raw host memory for its sends, so
under gloo a CUDA block is staged through pinned host memory.

``sp_sdpa`` (called first by ``ops/attention.py::sdpa`` once
``set_sp_context`` has installed a layout) slices the replicated q, k, v of
each rank of a seq group, runs the ring and all-gathers the outputs.  The
slice and the gather are conjugate autograd Functions: the gather's backward
takes the rank's own slice of the (replicated) output gradient, the slice's
backward all-gathers the dq / dk / dv slices, so every rank ends with the
whole gradient, as one process computes it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from . import attention as A

__all__ = ["log_sp_dispatch", "reset_sp_dispatch", "ring_sdpa", "set_sp_context",
           "sp_dispatch_counts", "sp_gate", "sp_sdpa"]


def _partial_reference(q, k, v, scale):
    """The local tile -> (o [B, Tq, H, d] f32, lse [B, H, Tq] f32), in plain
    PyTorch (the JAX ``_partial_einsum``): f32 logits, the row-max-shifted
    exp, the weights cast to v's dtype; differentiable by autograd."""
    logits = scale * torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = logits.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(s))[..., 0]
    w = (e / s).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
    return o, lse


class _KernelPartial(torch.autograd.Function):
    """The partial of one block: K1 forward (out, lse), K2 backward with the
    lse cotangent folded into delta (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = A.flash_attention_mh(q, k, v, scale)
        o = out.float()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if torch.is_grad_enabled():
            return _recorded_partial_backward(ctx, q, k, v, g_o, g_lse)
        if g_o is None:
            g_o = torch.zeros_like(o)
        delta = A._delta(o, g_o)
        if g_lse is not None:
            delta = (delta - g_lse).contiguous()
        do = g_o.to(q.dtype)
        dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def _recorded_partial_backward(ctx, q, k, v, g_o, g_lse):
    """The partial's backward recorded for a second differentiation: on a
    CPU tensor the plain partial's own VJP, differentiable in every input;
    on the card it raises, as the attention kernels' backward does."""
    if q.device.type != "cpu":
        raise RuntimeError(
            "a second-order gradient through ring attention: its partials' backward is kernel "
            "K2 (flash_attention_bwd_dq / flash_attention_bwd_dkv), which is not "
            "differentiable, so the result would silently lack the second-order term")
    with torch.enable_grad():
        o, lse = _partial_reference(q, k, v, ctx.scale)
        outs, cots = zip(*[(t, g) for t, g in ((o, g_o), (lse, g_lse)) if g is not None])
        grads = torch.autograd.grad(outs, (q, k, v), cots, create_graph=True,
                                    allow_unused=True)
    return (*grads, None)


def _combine(o_a, lse_a, o_b, lse_b):
    """Two partial results merged by their log-sum-exps.  o: [B, T, H, d] f32
    (each softmax-normalised over its own keys), lse: [B, H, T] f32."""
    lse = torch.logaddexp(lse_a, lse_b)
    wa = torch.exp(lse_a - lse).transpose(1, 2)[..., None]
    wb = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return wa * o_a + wb * o_b, lse


def _exchange(tensors, send_to: int, recv_from: int, group, staged: bool):
    """Send each tensor to global rank ``send_to`` and receive one of its
    shape from ``recv_from``; ``staged`` copies CUDA tensors through pinned
    host memory (gloo's sends read host memory)."""
    device = tensors[0].device
    stage = staged and device.type == "cuda"
    sends = [t.contiguous() for t in tensors]
    if stage:
        sends = [t.to("cpu", non_blocking=False).pin_memory() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, send_to, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, recv_from, group) for t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if stage:
        recvs = [t.to(device) for t in recvs]
    return recvs


class _Rotate(torch.autograd.Function):
    """k and v one step round the ring: rank i of ``ranks`` (the group's
    global ranks) sends to i + step and receives from i - step.  The
    backward rotates the gradients by -step, as ``ppermute`` transposes."""

    @staticmethod
    def forward(ctx, k, v, ranks, index, group, staged, step):
        ctx.args = (ranks, index, group, staged, step)
        ctx.like = [(x.shape, x.dtype, x.device) for x in (k, v)]
        n = len(ranks)
        return tuple(_exchange((k, v), ranks[(index + step) % n], ranks[(index - step) % n],
                               group, staged))

    @staticmethod
    def backward(ctx, g_k, g_v):
        ranks, index, group, staged, step = ctx.args
        g_k, g_v = (torch.zeros(shape, dtype=dtype, device=device) if g is None else g
                    for g, (shape, dtype, device) in zip((g_k, g_v), ctx.like))
        g_k, g_v = _Rotate.apply(g_k, g_v, ranks, index, group, staged, -step)
        return g_k, g_v, None, None, None, None, None


def ring_sdpa(q, k, v, scale=None, *, group=None, ranks=None, staged: bool = False,
              impl: str = "auto"):
    """Ring attention of this rank's slices q, k, v [B, T/n, H, d] over the
    n ranks of ``group`` (global ranks ``ranks``, in ring order; None: one
    rank); returns this rank's [B, T/n, H, d] in q's dtype.  The local block's
    partial, then n-1 rotations of k and v, each followed by the visiting
    block's partial and the combine.  ``impl``: "auto" (the kernel partial:
    K1 / K2, which raise on a head dim they do not take, as the local path
    does; their plain versions on the CPU) or "reference" (the plain partial
    under autograd, for tests).  ``staged``: send CUDA blocks through host
    memory (gloo)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scale = float(scale)
    if impl not in ("auto", "reference"):
        raise ValueError(f"impl {impl!r}: 'auto' or 'reference'")
    partial = _partial_reference if impl == "reference" else _KernelPartial.apply
    ranks = list(ranks) if ranks is not None else [0]
    n = len(ranks)
    index = ranks.index(dist.get_rank()) if n > 1 else 0
    o, lse = partial(q, k, v, scale)
    kc, vc = k, v
    for _ in range(n - 1):
        kc, vc = _Rotate.apply(kc, vc, ranks, index, group, staged, 1)
        o_p, lse_p = partial(q, kc, vc, scale)
        o, lse = _combine(o, lse, o_p, lse_p)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# sdpa integration: the layout that ``ops/attention.py::sdpa`` reads first

_SP_LAYOUT = None

# Do not ring the small levels: below this T the [T, T] logits are small and
# the slicing, rotations and gather cost more (the JAX package's gate; tests
# patch it down).
_SP_MIN_TOKENS = 256

# The dispatch ledger, keyed by the [B, T, H, d] call shape (B this rank's
# rows): "rang" counts the ring calls, "skipped" maps a shape to the reason.
_SP_DISPATCH = {"rang": {}, "skipped": {}}


def reset_sp_dispatch():
    for v in _SP_DISPATCH.values():
        v.clear()


def sp_dispatch_counts():
    """{'rang': {shape: n}, 'skipped': {shape: reason}} since the last reset."""
    return {k: dict(v) for k, v in _SP_DISPATCH.items()}


def log_sp_dispatch(print_fn=print):
    """One line: which attention shapes rode the ring, which did not and why."""
    c = _SP_DISPATCH
    rang = ", ".join(f"{s}x{n}" for s, n in sorted(c["rang"].items())) or "none"
    skip = ", ".join(f"{s}: {r}" for s, r in sorted(c["skipped"].items())) or "none"
    print_fn(f"SP ring dispatch -- rang: {rang} | skipped: {skip}")


def set_sp_context(layout):
    """Install (or clear, ``layout=None``) the ``parallel.mesh.ParallelLayout``
    whose seq groups ``sdpa`` rings its attention over."""
    global _SP_LAYOUT
    _SP_LAYOUT = layout


def sp_gate(b: int, t: int, n: int) -> Optional[str]:
    """Why a [b, t, ...] attention does not ride a ring of n ranks, or None
    when it does: the JAX ``sp_sdpa``'s gates and ledger strings.  The JAX
    gate also splits B over the mesh's data axis; here each rank's batch is
    already its data row's (``sampling.generate`` and the trainers split
    it), so the ring splits B no further: the strings read ``data=1``."""
    if t < _SP_MIN_TOKENS:
        return f"T={t} < min_tokens {_SP_MIN_TOKENS}"
    if n <= 1 or t % n or (t // n) % 8:
        return (f"indivisible: T={t} over seq={n} (local {t // max(n, 1)}), "
                f"B={b} over data=1")
    return None


class _SeqSlice(torch.autograd.Function):
    """This rank's T slice of a replicated [B, T, H, d] tensor (contiguous);
    the backward all-gathers the slices' gradients into the whole one
    (``_SeqGather``, so that a recorded backward stays differentiable)."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.args = (group, n, index)
        tl = x.shape[1] // n
        return x[:, index * tl:(index + 1) * tl].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _SeqGather.apply(g, *ctx.args), None, None, None


class _SeqGather(torch.autograd.Function):
    """The ranks' T slices joined into the replicated [B, T, H, d] tensor;
    the backward keeps this rank's slice of the (replicated) gradient
    (``_SeqSlice``)."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        from ..parallel.mesh import all_gather_cat

        ctx.args = (group, n, index)
        return all_gather_cat(x, group, dim=1)

    @staticmethod
    def backward(ctx, g):
        return _SeqSlice.apply(g, *ctx.args), None, None, None


def sp_sdpa(q, k, v, scale, *, impl: str = "auto"):
    """The ring over the installed layout's seq group, or None where the
    gates say no (``sdpa`` then takes its local paths) or no layout is
    installed.  q, k, v: the [B, T, H, d] self-attention that every rank of
    the seq group holds whole.  Every decision lands in the ledger."""
    layout = _SP_LAYOUT
    if layout is None:
        return None
    n = layout.sp
    b, t, h, d = q.shape
    shape = (b, t, h, d)
    reason = sp_gate(b, t, n)
    if reason is not None:
        _SP_DISPATCH["skipped"][shape] = reason
        return None
    _SP_DISPATCH["rang"][shape] = _SP_DISPATCH["rang"].get(shape, 0) + 1
    group, index = layout.seq_group, layout.seq_index
    ql, kl, vl = (_SeqSlice.apply(x, group, n, index) for x in (q, k, v))
    out = ring_sdpa(ql, kl, vl, scale, group=group, ranks=layout.seq_ranks,
                    staged=layout.backend == "gloo", impl=impl)
    return _SeqGather.apply(out, group, n, index)
