"""The guided-diffusion (ADM) U-Net family on NHWC activations: the layers
that the latent U-Net shares, ``ADMUNet`` and its noisy classifier
``ADMClassifier``.

Counterpart of ``diff_sampler_tpu/models/adm.py``: ``timestep_embedding``,
GroupNorm32 (``_GN``), ``_Conv``, ``_Linear``, ``legacy_attention`` and
``new_order_attention``, the ResBlock (``use_scale_shift_norm``, ``up`` /
``down``), the attention block, ``ADMUNet`` (guided_diffusion's UNetModel,
also the consistency-models LSUN net) with ``label_emb`` and the AMED
bottleneck tap, ``ADMClassifier`` (EncoderUNetModel, ``pool="attention"``
through ``AttentionPool2d`` or ``"adaptive"``) and the settings of the three
256 px checkpoints.

Module paths are the reference's state_dict names
(``input_blocks.10.1.qkv.weight``, ``out.2.qkv_proj.weight``,
``out.2.positional_embedding``, ``label_emb.weight``).  Parameters use the
reference's layouts: conv weights OIHW (1x1 convs too, where the
reference's attention uses Conv1d [O, I, 1]: ``load_adm_checkpoint`` and
``reference_state_dict`` convert), linear weights (out, in), norm
``weight``/``bias``, the attention pool's ``positional_embedding`` [C, T].
They are allocated uninitialised; ``factory.init_params`` draws them (LeCun
normal, zero biases, unit norms, the label table N(0, 1) and the positional
embedding N(0, 1/C), as the JAX modules' initialisers).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.groupnorm import groupnorm_silu

__all__ = ["ADMClassifier", "ADMUNet", "AttentionBlock", "AttentionPool2d", "CM_LSUN_SETTING",
           "IMAGENET256_CLASSIFIER_SETTING", "IMAGENET256_SETTING", "ResBlock",
           "channel_mult_for", "legacy_attention", "load_adm_checkpoint",
           "new_order_attention", "reference_state_dict", "timestep_embedding"]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """guided-diffusion's [cos | sin] embedding with exp-spaced frequencies,
    in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) / math.sqrt(fan_in)


class _GN(nn.Module):
    """GroupNorm32: 32 groups, f32 statistics, through ``groupnorm_silu``
    (kernel K3 on the card).  ``apply_silu`` fuses the SiLU that the JAX
    code applies to the norm's output."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, apply_silu: bool = False):
        return groupnorm_silu(x, self.weight, self.bias, groups=32, eps=self.eps,
                              apply_silu=apply_silu)


class _Conv(nn.Module):
    """kernel x kernel conv with symmetric padding kernel // 2, NHWC in and
    out (a channels-last NCHW view for cuDNN), in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        self.weight.copy_(_lecun_normal(self.weight.shape, fan_in, generator))
        self.bias.zero_()

    def forward(self, x):
        w = self.weight.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias.to(x.dtype), stride=self.stride,
                     padding=w.shape[-1] // 2)
        return y.permute(0, 2, 3, 1)


class _Linear(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.copy_(_lecun_normal(self.weight.shape, self.weight.shape[1], generator))
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def legacy_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """QKVAttentionLegacy: channels laid out as (head, 3 * ch), the scale
    1/sqrt(ch), an f32 softmax.  q, k and v are strided views of the [N, T,
    heads, 3 * ch] projection, handed to ``sdpa`` (kernels K1 / K2 on the card)
    as they are.  qkv: [N, T, 3C]; returns [N, T, C]."""
    n, t, w = qkv.shape
    ch = w // (3 * num_heads)
    parts = qkv.reshape(n, t, num_heads, 3 * ch)
    q, k, v = parts[..., :ch], parts[..., ch:2 * ch], parts[..., 2 * ch:]
    out = sdpa(q, k, v, scale=1.0 / math.sqrt(ch))
    return out.reshape(n, t, num_heads * ch)


def new_order_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """QKVAttention: channels laid out as (3, head, ch), the scale
    1/sqrt(ch).  q, k and v are strided views of the [N, T, 3, heads, ch]
    projection, handed to ``sdpa`` as they are.  qkv: [N, T, 3C]; returns
    [N, T, C]."""
    n, t, w = qkv.shape
    ch = w // (3 * num_heads)
    q, k, v = qkv.reshape(n, t, 3, num_heads, ch).unbind(2)
    out = sdpa(q, k, v, scale=1.0 / math.sqrt(ch))
    return out.reshape(n, t, num_heads * ch)


def _upsample_nearest(x):
    """2x nearest-neighbour upsampling of NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _avgpool2(x):
    """2x2 average pooling of NHWC: the four pixels summed in x's dtype, then
    divided by 4, as the JAX ``reduce_window`` sum does."""
    n, h, w, c = x.shape
    p = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return (p[:, :, 0, :, 0] + p[:, :, 0, :, 1] + p[:, :, 1, :, 0] + p[:, :, 1, :, 1]) / 4.0


def channel_mult_for(image_size: int) -> Tuple[float, ...]:
    """guided-diffusion's channel_mult for ``channel_mult=''``."""
    return {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
            128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4), 32: (1, 2, 2, 2)}[image_size]


class ResBlock(nn.Module):
    """in_layers (GN, SiLU, conv), emb_layers (SiLU, linear), out_layers (GN,
    SiLU, dropout, conv), skip_connection: the reference's indices name the
    layers that hold parameters.  ``up`` / ``down`` resample h and x after
    the first norm (nearest / 2x2 average).  With ``use_scale_shift_norm``
    the embedding gives a per-sample scale and shift applied between the
    second norm and its SiLU, so K3 runs without its fused SiLU there and the
    SiLU follows in the activations' dtype, as in the JAX code."""

    def __init__(self, cin: int, cout: int, emb_dim: int, use_scale_shift_norm: bool = False,
                 up: bool = False, down: bool = False, device=None):
        super().__init__()
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.in_layers = nn.ModuleDict({"0": _GN(cin, device=device),
                                        "2": _Conv(cin, cout, 3, device=device)})
        self.emb_layers = nn.ModuleDict({"1": _Linear(
            emb_dim, 2 * cout if use_scale_shift_norm else cout, device=device)})
        self.out_layers = nn.ModuleDict({"0": _GN(cout, device=device),
                                         "3": _Conv(cout, cout, 3, device=device)})
        self.skip_connection = _Conv(cin, cout, 1, device=device) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_layers["0"](x, apply_silu=True)
        if self.up:
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.down:
            h, x = _avgpool2(h), _avgpool2(x)
        h = self.in_layers["2"](h)
        emb_out = self.emb_layers["1"](F.silu(emb))[:, None, None, :].to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = self.out_layers["3"](F.silu(self.out_layers["0"](h) * (1.0 + scale) + shift))
        else:
            h = self.out_layers["3"](self.out_layers["0"](h + emb_out, apply_silu=True))
        return (self.skip_connection(x) if self.skip_connection is not None else x) + h


class AttentionBlock(nn.Module):
    """GroupNorm, 1x1 qkv conv, multi-head attention (legacy channel order,
    or with ``new_order`` the (3, head, ch) one), 1x1 proj_out, residual."""

    def __init__(self, ch: int, num_heads: int, new_order: bool = False, device=None):
        super().__init__()
        self.num_heads, self.new_order = num_heads, new_order
        self.norm = _GN(ch, device=device)
        self.qkv = _Conv(ch, 3 * ch, 1, device=device)
        self.proj_out = _Conv(ch, ch, 1, device=device)

    def forward(self, x):
        n, h, w, c = x.shape
        a = self.qkv(self.norm(x)).reshape(n, h * w, 3 * c)
        a = (new_order_attention if self.new_order else legacy_attention)(a, self.num_heads)
        return x + self.proj_out(a.reshape(n, h, w, c))


class Downsample(nn.Module):
    """Stride-2 3x3 conv (``op``), or without ``use_conv`` 2x2 average pooling."""

    def __init__(self, ch: int, use_conv: bool = True, device=None):
        super().__init__()
        self.op = _Conv(ch, ch, 3, stride=2, device=device) if use_conv else None

    def forward(self, x):
        return self.op(x) if self.op is not None else _avgpool2(x)


class Upsample(nn.Module):
    """2x nearest upsampling, then (with ``use_conv``) a 3x3 conv."""

    def __init__(self, ch: int, use_conv: bool = True, device=None):
        super().__init__()
        self.conv = _Conv(ch, ch, 3, device=device) if use_conv else None

    def forward(self, x):
        x = _upsample_nearest(x)
        return self.conv(x) if self.conv is not None else x


class _Embedding(nn.Module):
    """The class-label table ``label_emb`` [classes, emb_dim]."""

    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator))


class AttentionPool2d(nn.Module):
    """The classifier's attention pool: the mean token prepended to the h * w
    tokens, a positional embedding [C, h * w + 1] added, new-order attention
    in heads of ``num_head_channels`` through the 1x1 ``qkv_proj``, the 1x1
    ``c_proj`` to the class logits, token 0 kept."""

    def __init__(self, spatial: int, embed_dim: int, num_head_channels: int, output_dim: int,
                 device=None):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.empty(embed_dim, spatial ** 2 + 1, device=device))
        self.qkv_proj = _Conv(embed_dim, 3 * embed_dim, 1, device=device)
        self.c_proj = _Conv(embed_dim, output_dim, 1, device=device)
        self.num_heads = embed_dim // num_head_channels

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        c = self.positional_embedding.shape[0]
        self.positional_embedding.copy_(
            torch.randn(self.positional_embedding.shape, generator=generator) / math.sqrt(c))

    def forward(self, x):
        n, h, w, c = x.shape
        t = x.reshape(n, h * w, c)
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        t = t + self.positional_embedding.t()[None].to(t.dtype)
        a = self.qkv_proj(t[:, None])[:, 0]  # the 1x1 conv over [N, 1, T, C]
        a = new_order_attention(a, self.num_heads)[:, None]
        return self.c_proj(a)[:, 0, 0]


def _run(block: nn.ModuleList, h, emb):
    for layer in block:
        h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
    return h


class _ADMBase(nn.Module):
    """The time embedding, the grouped encoder (one ModuleList per
    TimestepEmbedSequential of the reference, a skip state after each) and
    the middle block that ``ADMUNet`` and ``ADMClassifier`` share."""

    def _build_trunk(self, in_channels, model_channels, num_res_blocks, attention_resolutions,
                     channel_mult, conv_resample, num_heads, num_head_channels,
                     use_scale_shift_norm, resblock_updown, use_new_attention_order, device):
        emb_dim = model_channels * 4
        self.model_channels = model_channels
        self.time_embed = nn.ModuleDict({"0": _Linear(model_channels, emb_dim, device=device),
                                         "2": _Linear(emb_dim, emb_dim, device=device)})

        def res(cin, cout, up=False, down=False):
            return ResBlock(cin, cout, emb_dim, use_scale_shift_norm, up, down, device=device)

        def attn(c):
            heads = num_heads if num_head_channels == -1 else c // num_head_channels
            return AttentionBlock(c, heads, use_new_attention_order, device=device)

        ch = int(channel_mult[0] * model_channels)
        blocks = [nn.ModuleList([_Conv(in_channels, ch, 3, device=device)])]
        input_chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out_ch = int(mult * model_channels)
                layers = [res(ch, out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                blocks.append(nn.ModuleList(layers))
                input_chans.append(ch)
            if level != len(channel_mult) - 1:
                blocks.append(nn.ModuleList([res(ch, ch, down=True) if resblock_updown
                                             else Downsample(ch, conv_resample, device=device)]))
                input_chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        return res, attn, input_chans, ch, ds

    def _time_emb(self, timesteps):
        """The f32 embedding of the timesteps (before the label's, if any)."""
        emb = timestep_embedding(timesteps, self.model_channels)
        return self.time_embed["2"](F.silu(self.time_embed["0"](emb)))


class ADMUNet(_ADMBase):
    """guided-diffusion's UNetModel on NHWC, also the consistency-models LSUN
    net.  ``attention_resolutions`` are downsample rates ((32, 16, 8) at 256
    px: attention at the 8x8, 16x16 and 32x32 levels).

    ``dtype`` is the compute dtype of the blocks (parameters stay f32 and are
    cast per layer); the time and label embeddings run in f32, and the output
    norm and conv in the input's dtype, as in the JAX module.  ``dropout`` is
    accepted for the settings' sake and not applied: the port runs the nets
    frozen, as the JAX module runs them deterministic."""

    def __init__(self, image_size: int, in_channels: int = 3, model_channels: int = 256,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8), dropout: float = 0.0,
                 channel_mult: Optional[Sequence[float]] = None, conv_resample: bool = True,
                 num_classes: Optional[int] = None, num_heads: int = 4,
                 num_head_channels: int = 64, use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, use_new_attention_order: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cm = tuple(channel_mult or channel_mult_for(image_size))
        self.image_size, self.in_channels, self.out_channels = image_size, in_channels, out_channels
        self.num_classes, self.dtype = num_classes, dtype
        res, attn, input_chans, ch, ds = self._build_trunk(
            in_channels, model_channels, num_res_blocks, tuple(attention_resolutions), cm,
            conv_resample, num_heads, num_head_channels, use_scale_shift_norm, resblock_updown,
            use_new_attention_order, device)
        self.label_emb = (_Embedding(num_classes, model_channels * 4, device=device)
                          if num_classes is not None else None)
        blocks = []
        for level, mult in list(enumerate(cm))[::-1]:
            for i in range(num_res_blocks + 1):
                out_ch = int(model_channels * mult)
                layers = [res(ch + input_chans.pop(), out_ch)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True) if resblock_updown
                                  else Upsample(ch, conv_resample, device=device))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.ModuleDict({"0": _GN(ch, device=device),
                                  "2": _Conv(ch, out_channels, 3, device=device)})

    def forward(self, x, timesteps, y=None, *, return_bottleneck: bool = False):
        """x: [N, H, W, C]; timesteps: [N]; y: integer class labels [N] for a
        class-conditional net.  Returns the output, or with
        ``return_bottleneck`` (output, the middle block's output): the AMED
        predictor's tap, which the reference takes with a forward hook."""
        emb = self._time_emb(timesteps)
        if self.label_emb is not None:
            if y is None:
                raise ValueError("a class-conditional ADMUNet needs integer labels y")
            emb = emb + self.label_emb.weight[y.long()]
        emb = emb.to(self.dtype)
        h = x.to(self.dtype)
        hs = []
        for block in self.input_blocks:
            h = _run(block, h, emb)
            hs.append(h)
        h = _run(self.middle_block, h, emb)
        bottleneck = h
        for block in self.output_blocks:
            h = _run(block, torch.cat([h, hs.pop()], dim=-1), emb)
        out = self.out["2"](self.out["0"](h.to(x.dtype), apply_silu=True))
        if return_bottleneck:
            return out, bottleneck
        return out


class ADMClassifier(_ADMBase):
    """guided-diffusion's EncoderUNetModel, the noisy classifier of
    classifier guidance: the ADM encoder and middle block, then GroupNorm +
    SiLU and ``pool="attention"`` (``AttentionPool2d``) or ``"adaptive"``
    (the spatial mean, a 1x1 conv).  Returns logits [N, out_channels] in
    ``dtype``."""

    def __init__(self, image_size: int, in_channels: int = 3, model_channels: int = 128,
                 out_channels: int = 1000, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8), dropout: float = 0.0,
                 channel_mult: Optional[Sequence[float]] = None, conv_resample: bool = True,
                 num_heads: int = 1, num_head_channels: int = 64,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = True,
                 use_new_attention_order: bool = False, pool: str = "attention",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cm = tuple(channel_mult or channel_mult_for(image_size))
        self.image_size, self.in_channels, self.out_channels = image_size, in_channels, out_channels
        self.pool, self.dtype = pool, dtype
        _, _, _, ch, ds = self._build_trunk(
            in_channels, model_channels, num_res_blocks, tuple(attention_resolutions), cm,
            conv_resample, num_heads, num_head_channels, use_scale_shift_norm, resblock_updown,
            use_new_attention_order, device)
        if pool == "attention":
            head = {"2": AttentionPool2d(image_size // ds, ch, num_head_channels, out_channels,
                                         device=device)}
        elif pool == "adaptive":
            head = {"3": _Conv(ch, out_channels, 1, device=device)}
        else:
            raise NotImplementedError(f"pool {pool!r}: 'attention' and 'adaptive' are ported")
        self.out = nn.ModuleDict({"0": _GN(ch, device=device), **head})

    def forward(self, x, timesteps):
        emb = self._time_emb(timesteps).to(self.dtype)
        h = x.to(self.dtype)
        for block in self.input_blocks:
            h = _run(block, h, emb)
        h = self.out["0"](_run(self.middle_block, h, emb), apply_silu=True)
        if self.pool == "adaptive":
            return self.out["3"](h.mean(dim=(1, 2), keepdim=True)).reshape(h.shape[0], -1)
        return self.out["2"](h)


def _conv1d_weights(module: nn.Module, prefix: str = "") -> set:
    """The keys of the 1x1 conv weights that the reference holds as Conv1d
    [O, I, 1]: the attention blocks' qkv / proj_out and the attention pool's
    qkv_proj / c_proj."""
    keys = set()
    for name, m in module.named_modules():
        convs = {AttentionBlock: ("qkv", "proj_out"),
                 AttentionPool2d: ("qkv_proj", "c_proj")}.get(type(m), ())
        keys.update(f"{prefix}{name}.{c}.weight" for c in convs)
    return keys


def load_adm_checkpoint(module: nn.Module, state_dict) -> nn.Module:
    """Load a reference ADM / CM checkpoint state_dict (guided-diffusion's or
    consistency-models' names) into an ``ADMUNet`` or ``ADMClassifier`` in
    place, strictly: every module key must be in the checkpoint and every
    checkpoint key must load.  Conv1d weights [O, I, 1] load into the 1x1
    convs."""
    own = module.state_dict()
    sd, unmatched = {}, []
    for key, val in state_dict.items():
        if key not in own:
            unmatched.append(key)
            continue
        if val.dim() == 3 and own[key].dim() == 4:
            val = val[..., None]
        sd[key] = val
    missing = sorted(set(own) - set(sd))
    if unmatched or missing:
        raise KeyError(f"the checkpoint does not match the {type(module).__name__}: "
                       f"checkpoint keys it has no place for {unmatched[:20]} "
                       f"({len(unmatched)}), module keys the checkpoint lacks {missing[:20]} "
                       f"({len(missing)})")
    module.load_state_dict(sd)
    return module


def reference_state_dict(module: nn.Module) -> dict:
    """``module``'s weights in the reference checkpoint's layout (the inverse
    of ``load_adm_checkpoint``: the attention's 1x1 convs as Conv1d [O, I,
    1]), e.g. to write a checkpoint file."""
    conv1d = _conv1d_weights(module)
    return {key: val[..., 0] if key in conv1d else val for key, val in module.state_dict().items()}


# The settings of the reference's 256 px checkpoints (cg_model_loader.py,
# cm_model_loader.py, as the JAX package's adm.py holds them)
IMAGENET256_SETTING = dict(
    image_size=256, in_channels=3, model_channels=256, out_channels=6,
    num_res_blocks=2, attention_resolutions=(32, 16, 8), dropout=0.0,
    num_classes=1000, num_heads=4, num_head_channels=64,
    use_scale_shift_norm=True, resblock_updown=True,
    use_new_attention_order=False)

CM_LSUN_SETTING = dict(
    image_size=256, in_channels=3, model_channels=256, out_channels=3,
    num_res_blocks=2, attention_resolutions=(32, 16, 8), dropout=0.1,
    num_classes=None, num_heads=4, num_head_channels=64,
    use_scale_shift_norm=False, resblock_updown=True,
    use_new_attention_order=False)

IMAGENET256_CLASSIFIER_SETTING = dict(
    image_size=256, in_channels=3, model_channels=128, out_channels=1000,
    num_res_blocks=2, attention_resolutions=(32, 16, 8),
    num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True,
    pool="attention")
