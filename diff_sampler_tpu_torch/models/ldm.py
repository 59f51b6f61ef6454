"""The latent-diffusion tiers on NHWC activations: the unconditional LDMs
(LSUN-Bedroom / FFHQ, VQ first stage) and Stable Diffusion v1.5 (``ms_coco``:
a cross-attention U-Net conditioned on a text context, the KL first stage).

Counterpart of ``diff_sampler_tpu/models/ldm.py``: ``LDMUNet`` on both of
its attention branches (the legacy AttentionBlock, and the SpatialTransformer
with ``_LN``, self- and cross-attention and GEGLU) with the AMED bottleneck
tap (the middle block's output), the ``_VAEBase`` resnet and mid-attention,
``VAEDecoder``, ``VAEEncoder`` (with ``_ConvDownAsym``, the stride-2 conv
after (0, 1, 0, 1) padding), ``VQModel`` (nearest-codebook quantisation,
then decode), ``AutoencoderKL`` (decode, and with its encoder ``encode``:
``quant_conv``, then the ``DiagonalGaussianDistribution`` posterior),
``LatentDiffusion`` (``scale_factor``, ``conditioning_key``, the text
encoder and ``get_learned_conditioning``), ``LDM_CONFIGS``, and the loading
of a reference checkpoint (``load_ldm_checkpoint``, the split of
``ldm_state_dict_to_params``).  Every GroupNorm of the first stage runs
through ``ops/groupnorm.py`` (K3 on the card).

Module paths are the reference's torch state_dict names
(``input_blocks.1.0.in_layers.0.weight``,
``input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight``,
``mid.block_1.norm1.weight``, ``up.2.upsample.conv.weight``), so the JAX
package's flat param names are those paths with '.' -> '_'
(``models.convert.load_ldm_jax_params``).  The VQ codebook is the parameter
``codebook`` (the reference's ``quantize.embedding.weight``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.tp import attend, tp_input, tp_output
from . import adm
from .adm import (_GN, AttentionBlock, Downsample, ResBlock, Upsample, _Conv, _Linear,
                  _lecun_normal, timestep_embedding)

__all__ = ["LDMUNet", "SpatialTransformer", "VAEDecoder", "VAEEncoder", "VQModel",
           "AutoencoderKL", "DiagonalGaussianDistribution", "LatentDiffusion", "LDM_CONFIGS",
           "build_latent_diffusion", "linear_alphas_cumprod", "load_ldm_checkpoint",
           "reference_state_dict", "checkpoint_ignores"]


def linear_alphas_cumprod(linear_start: float, linear_end: float,
                          timesteps: int = 1000) -> np.ndarray:
    """ddpm.py register_schedule, 'linear': betas = linspace(sqrt(s), sqrt(e))^2."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def _standard_normal(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) noise of ``like``'s shape, dtype and device, from ``generator``."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


class DiagonalGaussianDistribution:
    """distributions.py: moments [..., 2 z] -> the (mean, logvar) halves of the
    last axis, logvar clipped to [-30, 20], std = exp(logvar / 2)."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.mean, self.logvar = torch.chunk(parameters, 2, dim=-1)
        self.logvar = torch.clamp(self.logvar, -30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * N(0, 1) drawn from ``generator`` (the mean where
        ``deterministic``)."""
        if self.deterministic:
            return self.mean
        return self.mean + self.std * _standard_normal(self.mean, generator)

    def mode(self) -> torch.Tensor:
        return self.mean


def _GN6(channels: int, device=None) -> _GN:
    """The LDM modules' GroupNorm: 32 groups, eps 1e-6."""
    return _GN(channels, eps=1e-6, device=device)


# ---------------------------------------------------------------------------
# SpatialTransformer stack (attention.py:47-260)
# ---------------------------------------------------------------------------


class _LN(nn.Module):
    """LayerNorm over the last axis: f32 statistics, eps 1e-5, cast back to
    the input's dtype."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        return ((xf - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias).to(x.dtype)


class _LinearNoBias(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.copy_(_lecun_normal(self.weight.shape, self.weight.shape[1], generator))

    def forward(self, x):
        x = tp_input(self, x)
        w = self.weight.to(x.dtype)
        return tp_output(self, lambda b: F.linear(x, w), None)


class CrossAttention(nn.Module):
    """Multi-head attention of x over a context (or over x itself).  Self-
    attention goes through ``sdpa`` (the kernels on the card); attention over
    the 77 context tokens is the JAX package's plain einsum with f32 logits,
    outside any Pallas kernel there too."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.to_q = _LinearNoBias(query_dim, inner, device=device)
        self.to_k = _LinearNoBias(context_dim, inner, device=device)
        self.to_v = _LinearNoBias(context_dim, inner, device=device)
        self.to_out = nn.ModuleList([_Linear(inner, query_dim, device=device)])

    tp_heads = None  # a parallel.tp.HeadSplit once the block is tensor parallel

    def tp_cut(self, cut, planned, name: str) -> None:
        """Cut to this rank's shard (``parallel.tp.shard_tensor_parallel``):
        to_q / to_k / to_v column by heads (k and v over the replicated
        context), to_out.0 row."""
        projs = (self.to_q, self.to_k, self.to_v)
        if all(planned(p, "col") for p in projs) and planned(self.to_out[0], "row"):
            for p in projs:
                cut.col(p)
            cut.row(self.to_out[0])
            self.tp_heads = cut.heads(self.heads)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = attend(self.tp_heads, lambda q, k, v, heads: self._attention(
            q, k, v, heads, context is None), self.heads, self.to_q(x), self.to_k(ctx),
            self.to_v(ctx))
        return self.to_out[0](out)

    def _attention(self, q, k, v, heads: int, self_attention: bool):
        """q [b, n, heads * d], k and v [b, m, heads * d] -> [b, n, heads * d]."""
        (b, n), m, d = q.shape[:2], k.shape[1], self.dim_head
        q, k, v = q.reshape(b, n, heads, d), k.reshape(b, m, heads, d), v.reshape(b, m, heads, d)
        if self_attention:  # ``adm.sdpa``: the name the all-plain comparisons swap
            out = adm.sdpa(q, k, v, scale=self.scale)
        else:
            logits = torch.einsum("bihd,bjhd->bhij", (q * self.scale).float(), k.float())
            w = torch.softmax(logits, dim=-1).to(q.dtype)
            out = torch.einsum("bhij,bjhd->bihd", w, v)
        return out.reshape(b, n, heads * d)


class GEGLU(nn.Module):
    """proj to 2 * inner, then h * gelu(gate).  The JAX package calls
    ``jax.nn.gelu`` bare, which is its tanh approximation, so the port takes
    ``approximate="tanh"`` (the reference's torch GEGLU takes the exact one)."""

    def __init__(self, dim: int, inner: int, device=None):
        super().__init__()
        self.proj = _Linear(dim, 2 * inner, device=device)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, device=None):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleDict({"0": GEGLU(dim, inner, device=device),
                                  "2": _Linear(inner, dim, device=device)})

    def tp_cut(self, cut, planned, name: str) -> None:
        """Cut to this rank's shard: net.0.proj column, each rank its slice of
        each half ([a | gate]), net.2 row."""
        if planned(self.net["0"].proj, "col") and planned(self.net["2"], "row"):
            cut.col(self.net["0"].proj, 2)
            cut.row(self.net["2"])

    def forward(self, x):
        return self.net["2"](self.net["0"](x))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention over the context, GEGLU feed-forward,
    each after a LayerNorm and with a residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int, device=None):
        super().__init__()
        dev = dict(device=device)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, **dev)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, **dev)
        self.ff = FeedForward(dim, **dev)
        self.norm1, self.norm2, self.norm3 = (_LN(dim, **dev) for _ in range(3))

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6), 1x1 proj_in, ``depth`` transformer blocks over
    the h * w tokens, 1x1 proj_out, residual."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, device=None):
        super().__init__()
        self.inner = n_heads * d_head
        self.norm = _GN6(in_channels, device=device)
        self.proj_in = _Conv(in_channels, self.inner, 1, device=device)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(self.inner, n_heads, d_head, context_dim or self.inner,
                                  device=device) for _ in range(depth)])
        self.proj_out = _Conv(self.inner, in_channels, 1, device=device)

    def forward(self, x, context=None):
        b, h, w, _ = x.shape
        t = self.proj_in(self.norm(x)).reshape(b, h * w, self.inner)
        for block in self.transformer_blocks:
            t = block(t, context)
        return self.proj_out(t.reshape(b, h, w, self.inner)) + x


# ---------------------------------------------------------------------------
# Latent U-Net (openaimodel.py UNetModel): its ResBlock, AttentionBlock,
# Downsample and Upsample are the ADM family's (models.adm)
# ---------------------------------------------------------------------------


def _run(block: nn.ModuleList, h, emb, context, remat: bool = False):
    """One U-Net block's layers; with ``remat`` while autograd records, each
    res block and attention layer recomputes its activations in the backward
    (the JAX package's ``nn.remat`` of ``_res_step`` / ``_attn_step``)."""
    remat = remat and torch.is_grad_enabled()
    for layer in block:
        if isinstance(layer, ResBlock):
            args = (h, emb)
        elif isinstance(layer, SpatialTransformer):
            args = (h, context)
        else:
            args = (h,)
        if remat and isinstance(layer, (ResBlock, SpatialTransformer, AttentionBlock)):
            h = checkpoint(layer, *args, use_reentrant=False)
        else:
            h = layer(*args)
    return h


class LDMUNet(nn.Module):
    """The latent U-Net: guided-diffusion skeleton with attention at the
    downsample rates ``attention_resolutions``: legacy attention blocks, or
    with ``use_spatial_transformer`` spatial transformers that attend to a
    ``context`` (Stable Diffusion).

    ``dtype`` is the compute dtype of the blocks and of the context
    (parameters stay f32 and are cast per layer); the time embedding runs in
    f32, and the output norm and conv in the input's dtype, as in the JAX
    module.  ``remat``: recompute each res block and attention layer in the
    backward instead of storing its activations (SFD's training memory)."""

    def __init__(self, image_size: int, in_channels: int, out_channels: int,
                 model_channels: int, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads: int = -1,
                 num_head_channels: int = -1, use_spatial_transformer: bool = False,
                 transformer_depth: int = 1, context_dim: Optional[int] = None,
                 legacy: bool = True, dtype: torch.dtype = torch.float32, remat: bool = False,
                 device=None):
        super().__init__()
        self.remat = remat
        self.image_size, self.in_channels, self.out_channels = image_size, in_channels, out_channels
        self.model_channels = model_channels
        self.context_dim = context_dim
        self.dtype = dtype
        cm = tuple(channel_mult)
        emb_dim = model_channels * 4
        dev = dict(device=device)

        def attention(ch):  # openaimodel.py:542-556 head / dim bookkeeping
            if num_head_channels == -1:
                heads, dim_head = num_heads, ch // num_heads
            else:
                heads, dim_head = ch // num_head_channels, num_head_channels
            if legacy:
                dim_head = ch // heads if use_spatial_transformer else num_head_channels
            if use_spatial_transformer:
                return SpatialTransformer(ch, heads, dim_head, transformer_depth, context_dim,
                                          **dev)
            return AttentionBlock(ch, ch // dim_head if dim_head != -1 else heads, **dev)

        self.time_embed = nn.ModuleDict({"0": _Linear(model_channels, emb_dim, **dev),
                                         "2": _Linear(emb_dim, emb_dim, **dev)})
        ch = model_channels * cm[0]
        blocks = [nn.ModuleList([_Conv(in_channels, ch, 3, **dev)])]
        input_chans, ds = [ch], 1
        for level, mult in enumerate(cm):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, model_channels * mult, emb_dim, **dev)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(attention(ch))
                blocks.append(nn.ModuleList(layers))
                input_chans.append(ch)
            if level != len(cm) - 1:
                blocks.append(nn.ModuleList([Downsample(ch, **dev)]))
                input_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb_dim, **dev), attention(ch),
                                           ResBlock(ch, ch, emb_dim, **dev)])
        blocks = []
        for level, mult in list(enumerate(cm))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + input_chans.pop(), model_channels * mult, emb_dim, **dev)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(attention(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, **dev))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.ModuleDict({"0": _GN(ch, **dev), "2": _Conv(ch, out_channels, 3, **dev)})

    def forward(self, x, timesteps, context=None, *, return_bottleneck: bool = False):
        """x: [N, H, W, C]; timesteps: [N]; context: [N, tokens,
        context_dim] for the spatial transformers' cross-attention.  Returns
        the output, or with ``return_bottleneck`` (output, the middle block's
        output): the AMED predictor's tap, which the reference takes with a
        forward hook."""
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed["2"](F.silu(self.time_embed["0"](emb))).to(self.dtype)
        h = x.to(self.dtype)
        if context is not None:
            context = context.to(self.dtype)
        hs = []
        for block in self.input_blocks:
            h = _run(block, h, emb, context, self.remat)
            hs.append(h)
        h = _run(self.middle_block, h, emb, context, self.remat)
        bottleneck = h
        for block in self.output_blocks:
            h = _run(block, torch.cat([h, hs.pop()], dim=-1), emb, context, self.remat)
        out = self.out["2"](self.out["0"](h.to(x.dtype), apply_silu=True))
        if return_bottleneck:
            return out, bottleneck
        return out


# ---------------------------------------------------------------------------
# VAE first stages (modules/diffusionmodules/model.py, autoencoder.py)
# ---------------------------------------------------------------------------


class _VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm1 = _GN6(cin, device=device)
        self.conv1 = _Conv(cin, cout, 3, device=device)
        self.norm2 = _GN6(cout, device=device)
        self.conv2 = _Conv(cout, cout, 3, device=device)
        self.nin_shortcut = _Conv(cin, cout, 1, device=device) if cin != cout else None

    def forward(self, x):
        h = self.conv1(self.norm1(x, apply_silu=True))
        h = self.conv2(self.norm2(h, apply_silu=True))
        return (self.nin_shortcut(x) if self.nin_shortcut is not None else x) + h


class _VAEAttn(nn.Module):
    """Single-head attention over all positions (T = 4096, C = 512 in the
    decoder's middle): outside any Pallas kernel in the JAX package, so plain
    matmuls and an f32 softmax here."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.norm = _GN6(c, device=device)
        self.q = _Conv(c, c, 1, device=device)
        self.k = _Conv(c, c, 1, device=device)
        self.v = _Conv(c, c, 1, device=device)
        self.proj_out = _Conv(c, c, 1, device=device)

    def forward(self, x):
        n, h, w, c = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(n, h * w, c) for m in (self.q, self.k, self.v))
        logits = torch.bmm(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
        wgt = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.bmm(wgt, v).reshape(n, h, w, c)
        return x + self.proj_out(a)


class VAEDecoder(nn.Module):
    """model.py Decoder: conv_in, mid (resnet, attention, resnet), ``up``
    levels from the lowest resolution, norm_out + SiLU, conv_out."""

    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, z_channels: int = 3, device=None):
        super().__init__()
        dev = dict(device=device)
        n_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (n_res - 1)
        self.conv_in = _Conv(z_channels, block_in, 3, **dev)
        self.mid = nn.ModuleDict({"block_1": _VAEResnet(block_in, block_in, **dev),
                                  "attn_1": _VAEAttn(block_in, **dev),
                                  "block_2": _VAEResnet(block_in, block_in, **dev)})
        up = [None] * n_res
        for i_level in reversed(range(n_res)):
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(_VAEResnet(block_in, block_out, **dev))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(_VAEAttn(block_in, **dev))
            level = nn.ModuleDict({"block": nn.ModuleList(blocks), "attn": nn.ModuleList(attns)})
            if i_level != 0:
                level["upsample"] = Upsample(block_in, **dev)
                curr_res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.norm_out = _GN6(block_in, **dev)
        self.conv_out = _Conv(block_in, out_ch, 3, **dev)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid["block_2"](self.mid["attn_1"](self.mid["block_1"](h)))
        for level in reversed(self.up):
            for i, block in enumerate(level["block"]):
                h = block(h)
                if len(level["attn"]):
                    h = level["attn"][i](h)
            if "upsample" in level:
                h = level["upsample"](h)
        return self.conv_out(self.norm_out(h, apply_silu=True))


class _ConvDownAsym(nn.Module):
    """The encoder's Downsample (model.py:72-77, with_conv): zero padding
    (0, 1, 0, 1) on H and W, then a stride-2 3x3 conv without padding.  The
    conv is ``conv`` (the reference's ``down.{i}.downsample.conv``)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = _Conv(channels, channels, 3, stride=2, device=device)

    def forward(self, x):
        x = F.pad(x, (0, 0, 0, 1, 0, 1))  # NHWC: one zero column right, one row below
        w = self.conv.weight.to(x.dtype)
        return F.conv2d(x.permute(0, 3, 1, 2), w, self.conv.bias.to(x.dtype),
                        stride=2).permute(0, 2, 3, 1)


class VAEEncoder(nn.Module):
    """model.py Encoder: conv_in, ``down`` levels from the highest resolution
    (resnets, attention at ``attn_resolutions``, a ``_ConvDownAsym`` below
    every level but the last), mid (resnet, attention, resnet), norm_out +
    SiLU, conv_out to 2 * z_channels moments with ``double_z``."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, in_channels: int = 3, z_channels: int = 3,
                 double_z: bool = False, device=None):
        super().__init__()
        dev = dict(device=device)
        curr_res = resolution
        self.conv_in = _Conv(in_channels, ch, 3, **dev)
        block_in = ch
        down = []
        for i_level, mult in enumerate(ch_mult):
            block_out = ch * mult
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(_VAEResnet(block_in, block_out, **dev))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(_VAEAttn(block_in, **dev))
            level = nn.ModuleDict({"block": nn.ModuleList(blocks), "attn": nn.ModuleList(attns)})
            if i_level != len(ch_mult) - 1:
                level["downsample"] = _ConvDownAsym(block_in, **dev)
                curr_res //= 2
            down.append(level)
        self.down = nn.ModuleList(down)
        self.mid = nn.ModuleDict({"block_1": _VAEResnet(block_in, block_in, **dev),
                                  "attn_1": _VAEAttn(block_in, **dev),
                                  "block_2": _VAEResnet(block_in, block_in, **dev)})
        self.norm_out = _GN6(block_in, **dev)
        self.conv_out = _Conv(block_in, 2 * z_channels if double_z else z_channels, 3, **dev)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, block in enumerate(level["block"]):
                h = block(h)
                if len(level["attn"]):
                    h = level["attn"][i](h)
            if "downsample" in level:
                h = level["downsample"](h)
        h = self.mid["block_2"](self.mid["attn_1"](self.mid["block_1"](h)))
        return self.conv_out(self.norm_out(h, apply_silu=True))


class VQModel(nn.Module):
    """The VQ autoencoder's decode path: nearest-codebook quantisation
    (VectorQuantizer2), post_quant_conv, decoder (VQModelInterface.decode
    with force_not_quantize=False, as the JAX package's default)."""

    def __init__(self, decoder: VAEDecoder, n_embed: int, embed_dim: int, device=None):
        super().__init__()
        self.decoder = decoder
        self.post_quant_conv = _Conv(embed_dim, embed_dim, 1, device=device)
        self.codebook = nn.Parameter(torch.empty(n_embed, embed_dim, device=device))

    def quantize(self, z):
        """The nearest codebook entry at every position of z [..., D], in f32."""
        e = self.codebook.float()
        zf = z.float().reshape(-1, z.shape[-1])
        d = zf.square().sum(1, keepdim=True) - 2.0 * zf @ e.T + e.square().sum(1)[None]
        return e[torch.argmin(d, dim=1)].reshape(z.shape)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(self.quantize(z)))


class AutoencoderKL(nn.Module):
    """The KL autoencoder (autoencoder.py AutoencoderKL): ``decode`` is
    post_quant_conv (1x1, embed_dim -> z_channels), then the decoder; built
    with an ``encoder`` (a ``double_z`` ``VAEEncoder``), ``encode`` is the
    encoder, ``quant_conv`` (1x1, 2 z_channels -> 2 embed_dim) and the
    ``DiagonalGaussianDistribution`` over those moments."""

    def __init__(self, decoder: VAEDecoder, embed_dim: int, z_channels: int,
                 encoder: Optional[VAEEncoder] = None, device=None):
        super().__init__()
        self.decoder = decoder
        self.post_quant_conv = _Conv(embed_dim, z_channels, 1, device=device)
        self.encoder = encoder
        self.quant_conv = (_Conv(2 * z_channels, 2 * embed_dim, 1, device=device)
                           if encoder is not None else None)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def encode(self, x) -> DiagonalGaussianDistribution:
        """Images [N, H, W, 3] -> the posterior over latents [N, H/f, W/f,
        embed_dim]."""
        if self.encoder is None:
            raise RuntimeError("this first stage was built without its encoder: "
                               "build_latent_diffusion(..., encoder=True)")
        return DiagonalGaussianDistribution(self.quant_conv(self.encoder(x)))


class LatentDiffusion(nn.Module):
    """The pieces of a LatentDiffusion (ddpm.py) that sampling uses: the
    eps-predicting U-Net (``apply_model``, with the text context as ``cond``
    under ``conditioning_key="crossattn"``), the first stage
    (``decode_first_stage``: a KL stage's latents are divided by
    ``scale_factor`` first, a VQ stage's decode as they are), the
    linear-beta ``alphas_cumprod`` table and, where a checkpoint carries
    one, the text encoder ``cond_stage_model`` (prompts -> contexts;
    ``get_learned_conditioning``)."""

    def __init__(self, unet: LDMUNet, first_stage: nn.Module, alphas_cumprod: np.ndarray,
                 scale_factor: float = 1.0, conditioning_key: Optional[str] = None,
                 cond_stage_model: Optional[nn.Module] = None):
        super().__init__()
        self.unet = unet
        self.first_stage = first_stage
        self.alphas_cumprod = np.asarray(alphas_cumprod, np.float64)
        self.scale_factor = scale_factor
        self.conditioning_key = conditioning_key
        self.cond_stage_model = cond_stage_model

    def apply_model(self, x, t, cond=None):
        if self.conditioning_key is None or cond is None:
            return self.unet(x, t)
        return self.unet(x, t, cond)

    def decode_first_stage(self, z):
        if isinstance(self.first_stage, AutoencoderKL):
            z = z / self.scale_factor
        return self.first_stage.decode(z)

    def get_learned_conditioning(self, prompts) -> torch.Tensor:
        """Prompts -> the text encoder's contexts [B, 77, context_dim] (f32,
        on the encoder's device)."""
        if self.cond_stage_model is None:
            raise RuntimeError("no text encoder bound: the encoder comes with a checkpoint "
                               "(its cond_stage_model.* weights); random weights have none")
        return self.cond_stage_model(prompts)

    @torch.no_grad()
    def encode_in_chunks(self, prompts, chunk: int = 64) -> torch.Tensor:
        """The contexts of ``prompts``, ``chunk`` at a time, gathered on the
        host in f32 [N, 77, context_dim] (a context per seed of a long seed
        list would crowd the card)."""
        return torch.cat([self.get_learned_conditioning(prompts[i:i + chunk]).float().cpu()
                          for i in range(0, len(prompts), chunk)])

    @torch.no_grad()
    def decode_in_chunks(self, latents: np.ndarray, chunk: int = 16) -> np.ndarray:
        """Decode latents [N, h, w, c] (numpy) ``chunk`` at a time in f32 on
        the first stage's device; returns images [N, H, W, 3] f32 numpy."""
        device = next(self.first_stage.parameters()).device
        return np.concatenate([
            self.decode_first_stage(torch.from_numpy(np.asarray(latents[i:i + chunk],
                                                                np.float32)).to(device))
            .float().cpu().numpy() for i in range(0, len(latents), chunk)])


# models/ldm/configs/**.yaml: the unconditional LDM-4 (VQ-f4) nets and Stable
# Diffusion v1.5 (v1-inference.yaml)
LDM_CONFIGS = {
    "lsun_bedroom_ldm": dict(
        linear_start=0.0015, linear_end=0.0195, timesteps=1000,
        scale_factor=1.0, conditioning_key=None, first_stage="vq",
        unet=dict(image_size=64, in_channels=3, out_channels=3,
                  model_channels=224, attention_resolutions=(8, 4, 2),
                  num_res_blocks=2, channel_mult=(1, 2, 3, 4),
                  num_head_channels=32),
        vae=dict(z_channels=3, resolution=256, ch=128, ch_mult=(1, 2, 4),
                 num_res_blocks=2, attn_resolutions=()),
        n_embed=8192, embed_dim=3,
    ),
    "ffhq_ldm": dict(
        linear_start=0.0015, linear_end=0.0195, timesteps=1000,
        scale_factor=1.0, conditioning_key=None, first_stage="vq",
        unet=dict(image_size=64, in_channels=3, out_channels=3,
                  model_channels=224, attention_resolutions=(8, 4, 2),
                  num_res_blocks=2, channel_mult=(1, 2, 3, 4),
                  num_head_channels=32),
        vae=dict(z_channels=3, resolution=256, ch=128, ch_mult=(1, 2, 4),
                 num_res_blocks=2, attn_resolutions=()),
        n_embed=8192, embed_dim=3,
    ),
    "ms_coco": dict(  # Stable Diffusion v1.5 (v1-inference.yaml)
        linear_start=0.00085, linear_end=0.0120, timesteps=1000,
        scale_factor=0.18215, conditioning_key="crossattn", first_stage="kl",
        unet=dict(image_size=64, in_channels=4, out_channels=4,
                  model_channels=320, attention_resolutions=(4, 2, 1),
                  num_res_blocks=2, channel_mult=(1, 2, 4, 4), num_heads=8,
                  use_spatial_transformer=True, transformer_depth=1,
                  context_dim=768, legacy=False),
        vae=dict(z_channels=4, resolution=256, ch=128, ch_mult=(1, 2, 4, 4),
                 num_res_blocks=2, attn_resolutions=(), double_z=True),
        embed_dim=4,
    ),
}


# The reference checkpoint's name prefixes -> the port's module paths
# (diff_sampler_tpu/models/ldm.py::ldm_state_dict_to_params splits a
# checkpoint along the same lines)
_CHECKPOINT_NAMES = (
    ("model.diffusion_model.", "unet."),
    ("first_stage_model.decoder.", "first_stage.decoder."),
    ("first_stage_model.post_quant_conv.", "first_stage.post_quant_conv."),
    ("first_stage_model.quantize.embedding.weight", "first_stage.codebook"),
    ("first_stage_model.encoder.", "first_stage.encoder."),
    ("first_stage_model.quant_conv.", "first_stage.quant_conv."),
    ("cond_stage_model.", "cond_stage_model."),
)
# The first stage's encoder and quant_conv: loaded into a stack built with
# its encoder (``build_latent_diffusion(..., encoder=True)``), else left out
ENCODER_PREFIXES = ("first_stage_model.encoder.", "first_stage_model.quant_conv.")
# Parts of a reference LDM / SD checkpoint that the port does not load: the
# encoder's (above) where the stack has none, the EMA copy, the text
# tower's position_ids (a constant arange), and the top-level DDPM buffers
# (the port recomputes alphas_cumprod from the config)
CHECKPOINT_IGNORED_PREFIXES = ENCODER_PREFIXES + ("model_ema.",)
CHECKPOINT_IGNORED_KEYS = (
    "cond_stage_model.transformer.text_model.embeddings.position_ids",
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "scale_factor")


def checkpoint_ignores(key: str, encoder: bool = False) -> bool:
    """Whether a reference checkpoint key is one the port leaves out from a
    stack without (``encoder=False``) or with its first stage's encoder."""
    if encoder and key.startswith(ENCODER_PREFIXES):
        return False
    return key in CHECKPOINT_IGNORED_KEYS or key.startswith(CHECKPOINT_IGNORED_PREFIXES)


def _port_name(key: str, encoder: bool) -> Optional[str]:
    for ref, port in _CHECKPOINT_NAMES:
        if key.startswith(ref) and not checkpoint_ignores(key, encoder):
            return port + key[len(ref):]
    return None


def load_ldm_checkpoint(ld: LatentDiffusion, state_dict) -> LatentDiffusion:
    """Load a reference LDM / SD checkpoint state_dict into ``ld`` in place.
    Every key of ``ld`` must be in the checkpoint and every checkpoint key
    must load, apart from the ones ``checkpoint_ignores`` names (the
    encoder's and quant_conv's load where ``ld``'s first stage has an
    encoder).  The legacy attention's Conv1d weights [O, I, 1] load into
    the port's 1x1 convs."""
    own = ld.state_dict()
    encoder = getattr(ld.first_stage, "encoder", None) is not None
    sd, unmatched = {}, []
    for key, val in state_dict.items():
        name = _port_name(key, encoder)
        if name not in own:
            if not checkpoint_ignores(key, encoder):
                unmatched.append(key)
            continue
        if val.dim() == 3 and own[name].dim() == 4:
            val = val[..., None]
        sd[name] = val
    missing = sorted(set(own) - set(sd))
    if unmatched or missing:
        raise KeyError(f"the checkpoint does not match the {type(ld.unet).__name__} stack: "
                       f"checkpoint keys it has no place for {unmatched[:20]} "
                       f"({len(unmatched)}), module keys the checkpoint lacks {missing[:20]} "
                       f"({len(missing)})")
    ld.load_state_dict(sd)
    return ld


def reference_state_dict(ld: LatentDiffusion) -> dict:
    """``ld``'s weights under the reference checkpoint's names (the inverse
    of ``load_ldm_checkpoint``; the legacy attention's 1x1 convs as Conv1d
    weights [O, I, 1]), e.g. to write a checkpoint in the reference's
    layout."""
    out = {}
    legacy = {f"unet.{name}.{p}" for name, m in ld.unet.named_modules()
              if isinstance(m, AttentionBlock) for p in ("qkv.weight", "proj_out.weight")}
    for key, val in ld.state_dict().items():
        ref, port = next((r, p) for r, p in _CHECKPOINT_NAMES if key.startswith(p))
        out[ref + key[len(port):]] = val[..., 0] if key in legacy else val
    return out


def build_latent_diffusion(dataset_name: str, *, state_dict=None,
                           dtype: torch.dtype = torch.float32, seed: int = 0,
                           remat: bool = False, encoder: bool = False,
                           device="cuda") -> LatentDiffusion:
    """The LatentDiffusion stack of a config, in eval mode.

    With ``state_dict`` (a reference checkpoint's, ``models.torch_import``)
    its weights load through ``load_ldm_checkpoint``, and a crossattn
    config whose checkpoint carries ``cond_stage_model.*`` gets the CLIP
    text encoder (``models.text.FrozenCLIPEmbedder``), as the JAX package's
    ``build_ldm_model`` binds it.  Without, random weights: the U-Net and
    decoder drawn from one generator seeded with ``seed``
    (``factory.init_params``), the post-quant conv the identity and a VQ
    stage's codebook ``RandomState(0).randn(n_embed, z_channels)``, as the
    JAX package's random init makes them, and no text encoder.
    ``encoder``: a KL first stage gets its ``VAEEncoder`` (``double_z``) and
    ``quant_conv``, loaded from the checkpoint's ``first_stage_model.encoder.*``
    and ``quant_conv.*`` (random weights: drawn with the rest, quant_conv the
    identity), so that ``first_stage.encode`` runs; without it (the
    default) the stage decodes only and a checkpoint's encoder weights are
    not loaded.  A VQ stage has no encode, as in the JAX package.
    ``remat``: the U-Net's (``LDMUNet``)."""
    from .factory import init_params

    cfg = LDM_CONFIGS[dataset_name]
    if cfg["first_stage"] not in ("vq", "kl"):
        raise NotImplementedError(f"first stage {cfg['first_stage']!r}: only 'vq' and 'kl' "
                                  f"are ported")
    if cfg["conditioning_key"] not in (None, "crossattn"):
        raise NotImplementedError(f"conditioning key {cfg['conditioning_key']!r}: only "
                                  f"'crossattn' (a context for the U-Net) is ported")
    if encoder and cfg["first_stage"] != "kl":
        raise ValueError(f"{dataset_name}: only a KL first stage encodes (the JAX package's "
                         f"VQModel has no encode)")
    vae = {k: v for k, v in cfg["vae"].items() if k != "double_z"}
    zc = vae["z_channels"]
    unet = LDMUNet(dtype=dtype, remat=remat, device=device, **cfg["unet"])
    decoder = VAEDecoder(out_ch=3, device=device, **vae)
    if cfg["first_stage"] == "vq":
        first = VQModel(decoder, cfg.get("n_embed", 16), zc, device=device)
    else:
        enc = (VAEEncoder(in_channels=3, double_z=cfg["vae"].get("double_z", False),
                          device=device, **vae) if encoder else None)
        first = AutoencoderKL(decoder, cfg["embed_dim"], zc, encoder=enc, device=device)
    text = None
    if (state_dict is not None and cfg["conditioning_key"] == "crossattn"
            and any(k.startswith("cond_stage_model.") for k in state_dict)):
        from .text import FrozenCLIPEmbedder

        text = FrozenCLIPEmbedder(device=device).requires_grad_(False)
    ld = LatentDiffusion(unet, first, linear_alphas_cumprod(
        cfg["linear_start"], cfg["linear_end"], cfg["timesteps"]),
        scale_factor=cfg["scale_factor"], conditioning_key=cfg["conditioning_key"],
        cond_stage_model=text)
    if state_dict is not None:
        return load_ldm_checkpoint(ld, state_dict).eval()
    init_params(ld, seed=seed)
    with torch.no_grad():
        first.post_quant_conv.weight.copy_(torch.eye(zc)[:, :, None, None])
        first.post_quant_conv.bias.zero_()
        if encoder:
            first.quant_conv.weight.copy_(torch.eye(*first.quant_conv.weight.shape[:2])[
                :, :, None, None])
            first.quant_conv.bias.zero_()
        if cfg["first_stage"] == "vq":
            first.codebook.copy_(torch.from_numpy(
                np.random.RandomState(0).randn(cfg.get("n_embed", 16), zc).astype(np.float32)))
    return ld.eval()
