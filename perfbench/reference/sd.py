"""Plain reference of Stable Diffusion v1.5: the latent U-Net with its spatial
transformers, the KL decoder, classifier-free guidance and the discrete
noise schedule's sigma maps.

Written from the published LDM code (``ldm/modules/diffusionmodules/
openaimodel.py``, ``ldm/modules/attention.py``, ``ldm/modules/
diffusionmodules/model.py``) and ``v1-inference.yaml``, in NCHW, with the
checkpoint's names (``model.diffusion_model.input_blocks.1.1.
transformer_blocks.0.attn1.to_q.weight``, ``first_stage_model.decoder.
mid.attn_1.q.weight``, ...).  Plain PyTorch through ``reference/ops.py``.
GEGLU's gate takes the exact (erf) GELU, as the published code does.  The
sigma maps interpolate the ``alphas_cumprod`` table in float64, where the
system computes them in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ops


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.weight.shape[-1] // 2)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return ops.group_norm(x, 32, self.weight, self.bias, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)


class _Seq(nn.Module):
    """Layers under the checkpoint's indices (None: a layer without weights,
    such as a SiLU, whose index the checkpoint skips)."""

    def __init__(self, *layers):
        super().__init__()
        for i, layer in enumerate(layers):
            if layer is not None:
                self.add_module(str(i), layer)

    def __getitem__(self, i: int):
        return getattr(self, str(i))


_seq = _Seq


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int):
        super().__init__()
        self.in_layers = _seq(GroupNorm(cin, 1e-5), None, Conv(cin, cout, 3))
        self.emb_layers = _seq(None, Linear(emb, cout))
        self.out_layers = _seq(GroupNorm(cout, 1e-5), None, None, Conv(cout, cout, 3))
        self.skip_connection = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb, context=None):
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None]
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        return (self.skip_connection(x) if self.skip_connection is not None else x) + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = _seq(Linear(inner, dim))

    def forward(self, x, context=None):
        self_attention = context is None
        ctx = x if self_attention else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, n, _ = q.shape
        h, d = self.heads, self.dim_head

        def split(t):  # [b, m, h*d] -> [b*h, m, d]
            return t.reshape(b, t.shape[1], h, d).permute(0, 2, 1, 3).reshape(b * h, -1, d)

        out = ops.softmax_attention(split(q), split(k), split(v), d ** -0.5,
                                    cls="attention" if self_attention else "conv_gemm")
        return self.to_out[0](out.reshape(b, h, n, d).permute(0, 2, 1, 3).reshape(b, n, h * d))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = nn.Module()
        self.ff.net = _seq(GEGLU(dim, dim * 4), None, Linear(dim * 4, dim))
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff.net[2](self.ff.net[0](self.norm3(x))) + x


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(c, 1e-6)
        self.proj_in = Conv(c, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim)])
        self.proj_out = Conv(inner, c, 1)

    def forward(self, x, emb=None, context=None):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x))
        inner = t.shape[1]
        t = t.permute(0, 2, 3, 1).reshape(b, h * w, inner)
        for block in self.transformer_blocks:
            t = block(t, context)
        return self.proj_out(t.reshape(b, h, w, inner).permute(0, 3, 1, 2)) + x


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = Conv(c, c, 3, stride=2)

    def forward(self, x, emb=None, context=None):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3)

    def forward(self, x, emb=None, context=None):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _blocks(*layers) -> nn.ModuleList:
    return nn.ModuleList(layers)


class UNetModel(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, model_channels: int,
                 num_res_blocks: int, attention_resolutions, channel_mult, num_heads: int,
                 context_dim: int):
        super().__init__()
        self.model_channels = model_channels
        emb = model_channels * 4
        self.time_embed = _seq(Linear(model_channels, emb), None, Linear(emb, emb))

        def attn(ch):
            return SpatialTransformer(ch, num_heads, ch // num_heads, context_dim)

        self.input_blocks = nn.ModuleList([_blocks(Conv(in_channels, model_channels, 3))])
        chans, ch, ds = [model_channels], model_channels, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * model_channels, emb)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(_blocks(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(_blocks(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = _blocks(ResBlock(ch, ch, emb), attn(ch), ResBlock(ch, ch, emb))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), model_channels * mult, emb)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(_blocks(*layers))
        self.out = _seq(GroupNorm(ch, 1e-5), None, Conv(ch, out_channels, 3))

    @staticmethod
    def _run(block, h, emb, context):
        for layer in block:
            h = layer(h) if isinstance(layer, Conv) else layer(h, emb, context)
        return h

    def forward(self, x, t, context):
        emb = ops.timestep_embedding(t, self.model_channels)
        emb = self.time_embed[2](F.silu(self.time_embed[0](emb)))
        hs, h = [], x
        for block in self.input_blocks:
            h = self._run(block, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out[2](F.silu(self.out[0](h)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, 1e-6)
        self.conv1 = Conv(cin, cout, 3)
        self.norm2 = GroupNorm(cout, 1e-6)
        self.conv2 = Conv(cout, cout, 3)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if self.nin_shortcut is not None else x) + h


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c, 1e-6)
        self.q, self.k, self.v, self.proj_out = Conv(c, c, 1), Conv(c, c, 1), Conv(c, c, 1), \
            Conv(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)

        def tokens(m):
            return m(hn).reshape(b, c, h * w).transpose(1, 2)

        a = ops.softmax_attention(tokens(self.q), tokens(self.k), tokens(self.v), c ** -0.5,
                                  cls="conv_gemm", rows=1)
        return x + self.proj_out(a.transpose(1, 2).reshape(b, c, h, w))


class Decoder(nn.Module):
    def __init__(self, ch: int, out_ch: int, ch_mult, num_res_blocks: int, z_channels: int):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv(z_channels, block_in, 3)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        up = []
        for i_level in reversed(range(len(ch_mult))):
            level = nn.Module()
            block_out = ch * ch_mult[i_level]
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            level.block = nn.ModuleList(blocks)
            if i_level != 0:
                level.upsample = Upsample(block_in)
            up.insert(0, level)
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in, 1e-6)
        self.conv_out = Conv(block_in, out_ch, 3)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class StableDiffusion(nn.Module):
    """The U-Net as ``model.diffusion_model`` and the decoder with its
    post-quant conv as ``first_stage_model``, the checkpoint's names."""

    def __init__(self, m: dict):
        super().__init__()
        u, v = m["unet"], m["vae"]
        self.model = nn.Module()
        self.model.diffusion_model = UNetModel(
            u["in_channels"], u["out_channels"], u["model_channels"], u["num_res_blocks"],
            tuple(u["attention_resolutions"]), tuple(u["channel_mult"]), u["num_heads"],
            u["context_dim"])
        self.first_stage_model = nn.Module()
        self.first_stage_model.decoder = Decoder(v["ch"], 3, tuple(v["ch_mult"]),
                                                 v["num_res_blocks"], v["z_channels"])
        self.first_stage_model.post_quant_conv = Conv(m["embed_dim"], v["z_channels"], 1)
        self.scale_factor = m["scale_factor"]
        betas = np.linspace(m["linear_start"] ** 0.5, m["linear_end"] ** 0.5, m["timesteps"],
                            dtype=np.float64) ** 2
        self.log_alpha = 0.5 * np.log(np.cumprod(1.0 - betas))
        self.t_array = np.linspace(0.0, 1.0, m["timesteps"] + 1)[1:]
        self.M = m["timesteps"]
        self.sigma_min = float(m["sigma_min"])
        self.sigma_max = float(self.sigma(1.0))

    # the discrete schedule's maps (DPM-Solver's NoiseScheduleVP('discrete'))
    def sigma(self, t):
        log_a = np.interp(np.asarray(t, np.float64), self.t_array, self.log_alpha)
        return np.sqrt(1.0 - np.exp(2.0 * log_a)) / np.exp(log_a)

    def sigma_inv(self, sigma):
        lamb = -np.log(np.asarray(sigma, np.float64))
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
        return np.interp(log_alpha, self.log_alpha[::-1], self.t_array[::-1])

    def denoise(self, x, sigma: float, context, uncond, guidance_rate: float):
        """Guided D(x, sigma) on NCHW latents: x - sigma * (eps_u + g (eps_c -
        eps_u)), eps of the U-Net at x / sqrt(sigma^2 + 1), time M t - 1."""
        b = x.shape[0]
        c_in = 1.0 / math.sqrt(sigma ** 2 + 1.0)
        t_in = torch.full((2 * b,), self.M * float(self.sigma_inv(sigma)) - 1.0,
                          dtype=torch.float32, device=x.device)
        eps = self.model.diffusion_model(torch.cat([c_in * x] * 2), t_in,
                                         torch.cat([uncond, context]))
        eps_u, eps_c = eps.chunk(2)
        return x - sigma * (eps_u + guidance_rate * (eps_c - eps_u))

    def decode(self, z):
        fs = self.first_stage_model
        return fs.decoder(fs.post_quant_conv(z / self.scale_factor))


def build(config: dict, device="cpu") -> StableDiffusion:
    with torch.device(device):
        return StableDiffusion(config["model"]).eval()


def checkpoint_names(ref: StableDiffusion) -> dict:
    return dict(ref.named_parameters())


def denoiser(ref: StableDiffusion, config: dict, traffic: dict):
    """``D(x, sigma, (context, empty prompt's context))`` on NHWC latents,
    guided at the job's rate."""
    rate = float(traffic["guidance_rate"])

    def fn(x, sigma, cond):
        ctx, uc = cond
        out = ref.denoise(x.permute(0, 3, 1, 2), float(sigma), ctx,
                          uc.expand(ctx.shape[0], -1, -1), rate)
        return out.permute(0, 2, 3, 1)

    return fn


def decode(ref: StableDiffusion, z_nhwc):
    return ref.decode(z_nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def sigma_range(config: dict, ref: StableDiffusion):
    return ref.sigma_min, ref.sigma_max


def discrete_schedule(ref: StableDiffusion, num_steps: int, rho: float) -> np.ndarray:
    """The LDM / SD ``discrete`` schedule: uniform in t**(1/rho) between the
    times of sigma_max and sigma_min (``solver_utils.py``'s spacing)."""
    t_min, t_max = ref.sigma_inv(ref.sigma_min), ref.sigma_inv(ref.sigma_max)
    i = np.arange(num_steps, dtype=np.float64)
    t = (t_max + i / (num_steps - 1) * (t_min ** (1.0 / rho) - t_max)) ** rho
    return ref.sigma(t)


def latents_shape(config: dict):
    u = config["model"]["unet"]
    return (u["image_size"], u["image_size"], u["in_channels"])
