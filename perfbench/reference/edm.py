"""Plain reference of EDM's DDPM++ U-Net (``SongUNet``) under ``EDMPrecond``.

Written from EDM's published ``training/networks.py`` (Karras et al. 2022),
in NCHW as there, with its module names, so that a state_dict of an EDM
checkpoint (keys ``model.enc.32x32_block0.conv0.weight``, ...) loads into it.
Plain PyTorch through ``reference/ops.py``: attention as softmax of products,
``F.group_norm``.  Only what the configuration uses is here: the positional
noise embedding, the ``standard`` encoder and decoder, eval mode (no
dropout), no class labels; ``map_augment`` exists (its weights are drawn and
loaded) and sampling passes no augment labels.  The ``resample_filter`` is a
buffer computed from the configuration, not a weight.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import ops


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, up: bool = False, down: bool = False,
                 resample_filter=(1, 1)):
        super().__init__()
        self.cin, self.cout, self.up, self.down = cin, cout, up, down
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel)) if kernel else None
        self.bias = nn.Parameter(torch.empty(cout)) if kernel else None
        # made on the host and moved: the first ops on the meta device cost
        # seconds of host time
        f = torch.as_tensor(resample_filter, dtype=torch.float32, device="cpu")
        f = (torch.outer(f, f)[None, None] / f.sum() ** 2).to(torch.get_default_device())
        self.register_buffer("resample_filter", f if up or down else None, persistent=False)

    def forward(self, x):
        w, b, f = self.weight, self.bias, self.resample_filter
        w_pad = w.shape[-1] // 2 if w is not None else 0
        f_pad = (f.shape[-1] - 1) // 2 if f is not None else 0
        f = f.to(x.dtype) if f is not None else None
        if self.up:
            x = ops.conv_transpose2d(x, f.mul(4).tile([self.cin, 1, 1, 1]), stride=2,
                                     padding=f_pad, groups=self.cin)
        if self.down:
            x = ops.conv2d(x, f.tile([self.cin, 1, 1, 1]), stride=2, padding=f_pad,
                           groups=self.cin)
        if w is not None:
            x = ops.conv2d(x, w, b, padding=w_pad)
        return x


class GroupNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5, num_groups: int = 32, min_per_group: int = 4):
        super().__init__()
        self.groups = min(num_groups, c // min_per_group)
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return ops.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class UNetBlock(nn.Module):
    """EDM's UNetBlock with DDPM++'s settings: adaptive_scale off,
    resample_proj on, skip_scale sqrt(0.5), eps 1e-6, one attention head."""

    def __init__(self, cin: int, cout: int, emb: int, up=False, down=False, attention=False,
                 resample_filter=(1, 1), eps=1e-6):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.num_heads = 1 if attention else 0
        self.skip_scale = math.sqrt(0.5)
        self.norm0 = GroupNorm(cin, eps=eps)
        self.conv0 = Conv2d(cin, cout, 3, up=up, down=down, resample_filter=resample_filter)
        self.affine = Linear(emb, cout)
        self.norm1 = GroupNorm(cout, eps=eps)
        self.conv1 = Conv2d(cout, cout, 3)
        self.skip = None
        if cout != cin or up or down:
            self.skip = Conv2d(cin, cout, 1, up=up, down=down, resample_filter=resample_filter)
        if self.num_heads:
            self.norm2 = GroupNorm(cout, eps=eps)
            self.qkv = Conv2d(cout, cout * 3, 1)
            self.proj = Conv2d(cout, cout, 1)

    def forward(self, x, emb):
        orig = x
        x = self.conv0(torch.nn.functional.silu(self.norm0(x)))
        params = self.affine(emb.to(x.dtype)).unsqueeze(2).unsqueeze(3)
        x = torch.nn.functional.silu(self.norm1(x + params))
        x = self.conv1(x)
        x = (x + (self.skip(orig) if self.skip is not None else orig)) * self.skip_scale
        if self.num_heads:
            n, c, h, w = x.shape
            q, k, v = self.qkv(self.norm2(x)).reshape(
                n * self.num_heads, c // self.num_heads, 3, -1).unbind(2)  # [n, c, hw]
            ch = q.shape[1]
            a = ops.softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      1.0 / math.sqrt(ch))  # [n, hw, c]
            x = (self.proj(a.transpose(1, 2).reshape(n, c, h, w)) + x) * self.skip_scale
        return x


class SongUNet(nn.Module):
    def __init__(self, img_resolution: int, in_channels: int, out_channels: int,
                 augment_dim: int = 0, model_channels: int = 128, channel_mult=(1, 2, 2, 2),
                 channel_mult_emb: int = 4, num_blocks: int = 4, attn_resolutions=(16,),
                 channel_mult_noise: int = 1, resample_filter=(1, 1)):
        super().__init__()
        emb_ch = model_channels * channel_mult_emb
        self.noise_ch = model_channels * channel_mult_noise
        self.map_augment = Linear(augment_dim, self.noise_ch, bias=False) if augment_dim else None
        self.map_layer0 = Linear(self.noise_ch, emb_ch)
        self.map_layer1 = Linear(emb_ch, emb_ch)
        kw = dict(emb=emb_ch, resample_filter=resample_filter)
        self.enc = nn.ModuleDict()
        cout = in_channels
        for level, mult in enumerate(channel_mult):
            res = img_resolution >> level
            if level == 0:
                cin, cout = cout, model_channels
                self.enc[f"{res}x{res}_conv"] = Conv2d(cin, cout, 3)
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **kw)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=res in attn_resolutions, **kw)
        skips = [b.cout for b in self.enc.values()]
        self.dec = nn.ModuleDict()
        for level, mult in reversed(list(enumerate(channel_mult))):
            res = img_resolution >> level
            if level == len(channel_mult) - 1:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True, **kw)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **kw)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **kw)
            for idx in range(num_blocks + 1):
                cin = cout + skips.pop()
                cout = model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=idx == num_blocks and res in attn_resolutions, **kw)
            if level == 0:
                self.dec[f"{res}x{res}_aux_norm"] = GroupNorm(cout, eps=1e-6)
                self.dec[f"{res}x{res}_aux_conv"] = Conv2d(cout, out_channels, 3)

    def forward(self, x, noise_labels, tap=None):
        """The output, or with ``tap`` (an encoder layer's name, e.g.
        ``8x8_block3``) (output, that layer's output activation)."""
        n = self.noise_ch // 2
        freqs = (1 / 10000) ** (torch.arange(n, dtype=torch.float32, device=x.device) / (n - 1))
        emb = noise_labels.float()[:, None] * freqs[None]
        emb = torch.cat([emb.sin(), emb.cos()], dim=1).to(x.dtype)  # [cos | sin] swapped
        emb = torch.nn.functional.silu(self.map_layer0(emb))
        emb = torch.nn.functional.silu(self.map_layer1(emb))
        skips, act = [], None
        for name, block in self.enc.items():
            x = block(x, emb) if isinstance(block, UNetBlock) else block(x)
            skips.append(x)
            if name == tap:
                act = x
        aux = tmp = None
        for name, block in self.dec.items():
            if "aux_norm" in name:
                tmp = block(x)
            elif "aux_conv" in name:
                aux = block(torch.nn.functional.silu(tmp))
            else:
                if x.shape[1] != block.cin:
                    x = torch.cat([x, skips.pop()], dim=1)
                x = block(x, emb)
        return aux if tap is None else (aux, act)


class EDMPrecond(nn.Module):
    """D(x, sigma) = c_skip x + c_out F(c_in x, log(sigma) / 4), f32."""

    def __init__(self, img_resolution: int, img_channels: int, sigma_data: float = 0.5,
                 dtype=torch.float32, **unet):
        super().__init__()
        self.sigma_data = sigma_data
        self.dtype = dtype  # the inner net's compute dtype (the control's bf16)
        self.model = SongUNet(img_resolution, img_channels, img_channels, **unet)

    def forward(self, x, sigma, tap=None):
        sigma = sigma.float().reshape(-1, 1, 1, 1)
        sd = self.sigma_data
        c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
        c_out = sigma * sd / (sigma ** 2 + sd ** 2).sqrt()
        c_in = 1 / (sd ** 2 + sigma ** 2).sqrt()
        out = self.model((c_in * x).to(self.dtype), (sigma.log() / 4).flatten().expand(x.shape[0]),
                         tap)
        if tap is None:
            return c_skip * x + c_out * out.float()
        return c_skip * x + c_out * out[0].float(), out[1].float()


def build(config: dict, device="cpu", dtype=torch.float32) -> EDMPrecond:
    """The reference denoiser of a configuration file's ``model`` section
    (``dtype``: its inner net's compute dtype)."""
    m = config["model"]
    with torch.device(device):
        return EDMPrecond(
            m["img_resolution"], m["img_channels"], sigma_data=m["sigma_data"], dtype=dtype,
            augment_dim=m["augment_dim"], model_channels=m["model_channels"],
            channel_mult=tuple(m["channel_mult"]), channel_mult_emb=m["channel_mult_emb"],
            num_blocks=m["num_blocks"], attn_resolutions=tuple(m["attn_resolutions"]),
            channel_mult_noise=m["channel_mult_noise"],
            resample_filter=tuple(m["resample_filter"])).eval()


def checkpoint_names(ref: EDMPrecond) -> dict:
    """{checkpoint key: parameter} of the reference, under EDM's names."""
    return dict(ref.named_parameters())


def denoiser(ref: EDMPrecond, config: dict, traffic: dict):
    """``D(x, sigma, cond)`` on NHWC images (no conditioning)."""
    def fn(x, sigma, cond=None):
        out = ref(x.permute(0, 3, 1, 2), torch.as_tensor(sigma, device=x.device))
        return out.permute(0, 2, 3, 1)

    return fn


def sigma_range(config: dict, ref=None):
    m = config["model"]
    return float(m["sigma_min"]), float(m["sigma_max"])


def latents_shape(config: dict):
    m = config["model"]
    return (m["img_resolution"], m["img_resolution"], m["img_channels"])

