"""EDM-family U-Nets on NHWC activations: ``UNetBlock``, ``SongUNet``
(DDPM++ / NCSN++) and ``DhariwalUNet`` (ADM).

Counterpart of ``diff_sampler_tpu/models/unets.py``.  Module names are the
reference state_dict's: ``enc.16x16_block0.conv0.weight``,
``map_layer0.weight``, ``map_label.weight``, ... so a reference checkpoint
loads with no rewrite.  The SFD extensions are the JAX package's: with
``use_step_condition`` each block has a second embedding modulation
``affine_step``, fed by a ``map_step`` tower (the noise embedding of the
step count, ``map_step_layer0`` / ``map_step_layer1``) when the call passes
``step_condition``; ``skip_tuning`` scales each skip tensor the decoder
concatenates by 0.75 + 0.25 * i / n_skips; ``remat`` recomputes each block
in the backward (``torch.utils.checkpoint``) instead of storing its
activations.

Train mode (``.train()``, the counterpart of the JAX package's
``deterministic=False``) turns on ``UNetBlock``'s dropout (at the configs'
rates: 0.13 on CIFAR-10) and the label dropout of a class-conditional net
(``class_labels`` times a Bernoulli keep mask [N, 1]), drawn from the
``generator`` a forward is given (the torch default generator of the
device where it is None), as Flax draws them (``models.layers.dropout``,
``drop_labels``).  Every sampling and distillation path runs the nets in
eval mode (``factory.build_edm_model``), as the JAX package runs them
deterministic, and ``bind``, the AMED step and the SFD train steps refuse
a net in train mode.  ``augment_labels`` (the augment pipe's,
``ops/augment.py``) enter the embedding through ``map_augment`` where the
net has one.  Tensor parallel (``parallel/tp.py``):
a block runs on this rank's channels between conv0 and conv1 and on its
heads (or on every head of the gathered qkv, where tp does not divide
them) between qkv and proj.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.tp import attend
from .layers import (Conv2d, FourierEmbedding, GroupNorm, Linear, attention, drop_labels, dropout,
                     positional_embedding)

__all__ = ["UNetBlock", "SongUNet", "DhariwalUNet"]


class UNetBlock(nn.Module):
    """DDPM++ / NCSN++ / ADM residual block, with optional self-attention."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 up: bool = False, down: bool = False, attention: bool = False,
                 num_heads: Optional[int] = None, channels_per_head: int = 64,
                 dropout: float = 0.0, skip_scale: float = 1.0, eps: float = 1e-5,
                 resample_filter: Sequence[float] = (1, 1), resample_proj: bool = False,
                 adaptive_scale: bool = True, init: Optional[Dict] = None,
                 init_zero: Optional[Dict] = None, init_attn: Optional[Dict] = None,
                 use_step_condition: bool = False, device=None):
        super().__init__()
        init = dict(init or {})
        init_zero = dict(init_zero) if init_zero is not None else dict(init_weight=0)
        init_attn = dict(init_attn) if init_attn is not None else init
        self.num_heads = (0 if not attention else num_heads if num_heads is not None
                          else out_channels // channels_per_head)
        self.in_channels = in_channels
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale

        self.norm0 = GroupNorm(in_channels, eps=eps, device=device)
        self.conv0 = Conv2d(in_channels, out_channels, kernel=3, up=up, down=down,
                            resample_filter=resample_filter, device=device, **init)
        n_aff = out_channels * (2 if adaptive_scale else 1)
        self.affine = Linear(emb_channels, n_aff, device=device, **init)
        # SFD's second modulation, by the step-condition embedding
        self.affine_step = (Linear(emb_channels, n_aff, device=device, **init)
                            if use_step_condition else None)
        self.norm1 = GroupNorm(out_channels, eps=eps, device=device)
        self.dropout_rate = dropout
        self.conv1 = Conv2d(out_channels, out_channels, kernel=3, device=device, **init_zero)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if resample_proj or out_channels != in_channels else 0
            self.skip = Conv2d(in_channels, out_channels, kernel=kernel, up=up, down=down,
                               resample_filter=resample_filter, device=device, **init)
        if self.num_heads:
            self.norm2 = GroupNorm(out_channels, eps=eps, device=device)
            self.qkv = Conv2d(out_channels, out_channels * 3, kernel=1, device=device,
                              **init_attn)
            self.proj = Conv2d(out_channels, out_channels, kernel=1, device=device,
                               **init_zero)

    tp_heads = None  # a parallel.tp.HeadSplit once the block is tensor parallel

    def tp_cut(self, cut, planned, name: str) -> None:
        """Cut to this rank's shard (``parallel.tp.shard_tensor_parallel``):
        conv0 column, conv1 row, norm1 and the rows of affine / affine_step
        on the rank's channels; qkv column, proj row."""
        if planned(self.conv0, "col") and planned(self.conv1, "row"):
            cut.norm(self.norm1, f"{name}.norm1", "num_groups")
            cut.col(self.conv0)
            for aff in (self.affine, self.affine_step):
                if aff is not None:
                    cut.col(aff, 2 if self.adaptive_scale else 1)  # [scale | shift]
            cut.row(self.conv1)
        if self.num_heads and planned(self.qkv, "col") and planned(self.proj, "row"):
            cut.col(self.qkv)
            cut.row(self.proj)
            self.tp_heads = cut.heads(self.num_heads)

    def forward(self, x, emb, emb_step=None, generator=None):
        """``emb_step``: the step-condition embedding (a block built with
        ``use_step_condition``), or None for no second modulation;
        ``generator``: the dropout's draws in train mode."""
        orig = x
        x = self.conv0(F.silu(self.norm0(x)))
        params = self.affine(emb)[:, None, None, :].to(x.dtype)
        params_step = None
        if emb_step is not None:
            params_step = self.affine_step(emb_step)[:, None, None, :].to(x.dtype)
        if self.adaptive_scale:
            scale, shift = params.chunk(2, dim=-1)
            x = shift + self.norm1(x) * (scale + 1)
            if params_step is not None:
                scale_s, shift_s = params_step.chunk(2, dim=-1)
                x = shift_s + x * (scale_s + 1)
            x = F.silu(x)
        else:
            # the embedding is added before the norm
            add = params if params_step is None else params + params_step
            x = F.silu(self.norm1(x + add))
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        x = self.conv1(x)
        x = (x + (self.skip(orig) if self.skip is not None else orig)) * self.skip_scale
        if self.num_heads:
            a = attend(self.tp_heads, attention, self.num_heads, self.qkv(self.norm2(x)))
            x = (x + self.proj(a)) * self.skip_scale
        return x


def _block(layer: UNetBlock, remat: bool, x, emb, emb_step, generator=None):
    """One block; with ``remat`` while autograd records, its activations are
    recomputed in the backward instead of stored (the JAX package's
    ``nn.remat`` per block).  A block in train mode draws its dropout mask
    again in the recompute from the default generator, whose state
    ``checkpoint`` keeps; an explicit ``generator`` is refused there."""
    if not (remat and torch.is_grad_enabled()):
        return layer(x, emb, emb_step, generator)
    if generator is not None and layer.training:
        raise ValueError("remat in train mode draws dropout from the default generator: "
                         "pass generator=None or build the net with remat=False")
    return checkpoint(layer, x, emb, emb_step, generator, use_reentrant=False)


def _tuned_skip(s, skip_tuning: bool, count: int, n_skips: int):
    """SFD's skip tuning: the decoder's ``count``-th skip tensor scaled by
    0.75 + 0.25 * count / n_skips."""
    return (0.75 + (1.0 - 0.75) / n_skips * count) * s if skip_tuning else s


def _song_layout(img_resolution, in_channels, out_channels, model_channels,
                 channel_mult, num_blocks, attn_resolutions, encoder_type, decoder_type):
    """Static layer layout of SongUNet: ordered (name, kind, kwargs) lists for
    the encoder and decoder.  Names are the reference's module keys under
    ``enc`` / ``dec``; kind is one of conv, block, aux_down, aux_skip,
    aux_residual, aux_up, aux_norm, aux_conv.  Mirrors the JAX package's
    ``_song_layout``, including the attention forced on at ``in0`` of the
    lowest resolution."""
    enc: List[Tuple[str, str, dict]] = []
    cout = in_channels
    caux = in_channels
    for level, mult in enumerate(channel_mult):
        res = img_resolution >> level
        if level == 0:
            cin, cout = cout, model_channels
            enc.append((f"{res}x{res}_conv", "conv", dict(cin=cin, cout=cout)))
        else:
            enc.append((f"{res}x{res}_down", "block",
                        dict(cin=cout, cout=cout, up=False, down=True, attn=False)))
            if encoder_type == "skip":
                enc.append((f"{res}x{res}_aux_down", "aux_down", dict(cin=caux, cout=caux)))
                enc.append((f"{res}x{res}_aux_skip", "aux_skip", dict(cin=caux, cout=cout)))
            if encoder_type == "residual":
                enc.append((f"{res}x{res}_aux_residual", "aux_residual",
                            dict(cin=caux, cout=cout)))
                caux = cout
        for idx in range(num_blocks):
            cin, cout = cout, model_channels * mult
            enc.append((f"{res}x{res}_block{idx}", "block",
                        dict(cin=cin, cout=cout, up=False, down=False,
                             attn=res in attn_resolutions)))
    skips = [kw["cout"] for name, _, kw in enc if "aux" not in name]

    dec: List[Tuple[str, str, dict]] = []
    for level, mult in reversed(list(enumerate(channel_mult))):
        res = img_resolution >> level
        if level == len(channel_mult) - 1:
            dec.append((f"{res}x{res}_in0", "block",
                        dict(cin=cout, cout=cout, up=False, down=False, attn=True)))
            dec.append((f"{res}x{res}_in1", "block",
                        dict(cin=cout, cout=cout, up=False, down=False, attn=False)))
        else:
            dec.append((f"{res}x{res}_up", "block",
                        dict(cin=cout, cout=cout, up=True, down=False, attn=False)))
        for idx in range(num_blocks + 1):
            cin = cout + skips.pop()
            cout = model_channels * mult
            attn = idx == num_blocks and res in attn_resolutions
            dec.append((f"{res}x{res}_block{idx}", "block",
                        dict(cin=cin, cout=cout, up=False, down=False, attn=attn)))
        if decoder_type == "skip" or level == 0:
            if decoder_type == "skip" and level < len(channel_mult) - 1:
                dec.append((f"{res}x{res}_aux_up", "aux_up",
                            dict(cin=out_channels, cout=out_channels)))
            dec.append((f"{res}x{res}_aux_norm", "aux_norm", dict(c=cout)))
            dec.append((f"{res}x{res}_aux_conv", "aux_conv", dict(cin=cout, cout=out_channels)))
    return enc, dec


class SongUNet(nn.Module):
    """DDPM++ / NCSN++ U-Net, class-conditional through ``map_label`` (on
    the labels times sqrt(label_dim)) when ``label_dim > 0``.
    ``augment_dim`` creates ``map_augment``, which the augment labels go
    through (sampling passes none)."""

    def __init__(self, img_resolution: int, in_channels: int, out_channels: int,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2), channel_mult_emb: int = 4,
                 num_blocks: int = 4, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.10, label_dropout: float = 0.0,
                 embedding_type: str = "positional", channel_mult_noise: int = 1,
                 encoder_type: str = "standard", decoder_type: str = "standard",
                 resample_filter: Sequence[float] = (1, 1), use_step_condition: bool = False,
                 remat: bool = False, device=None):
        if embedding_type not in ("positional", "fourier"):
            raise ValueError(f"unknown embedding_type {embedding_type!r}")
        super().__init__()
        emb_channels = model_channels * channel_mult_emb
        noise_channels = model_channels * channel_mult_noise
        init = dict(init_mode="xavier_uniform")
        init_zero = dict(init_mode="xavier_uniform", init_weight=1e-5)
        init_attn = dict(init_mode="xavier_uniform", init_weight=math.sqrt(0.2))
        block_kwargs = dict(emb_channels=emb_channels, num_heads=1, dropout=dropout,
                            skip_scale=math.sqrt(0.5), eps=1e-6,
                            resample_filter=resample_filter, resample_proj=True,
                            adaptive_scale=False, init=init, init_zero=init_zero,
                            init_attn=init_attn, use_step_condition=use_step_condition,
                            device=device)
        self.noise_channels = noise_channels
        self.label_dropout = label_dropout
        self.remat = remat

        # Mapping tower.
        self.map_noise = (FourierEmbedding(noise_channels, device=device)
                          if embedding_type == "fourier" else None)
        self.map_label = (Linear(label_dim, noise_channels, device=device, **init)
                          if label_dim else None)
        self.map_augment = (Linear(augment_dim, noise_channels, bias=False, device=device,
                                   **init) if augment_dim else None)
        self.map_layer0 = Linear(noise_channels, emb_channels, device=device, **init)
        self.map_layer1 = Linear(emb_channels, emb_channels, device=device, **init)
        # SFD-v's step-condition tower: the noise embedding of the step count
        self.map_step = self.map_step_layer0 = self.map_step_layer1 = None
        if use_step_condition:
            if embedding_type == "fourier":
                self.map_step = FourierEmbedding(noise_channels, device=device)
            self.map_step_layer0 = Linear(noise_channels, emb_channels, device=device, **init)
            self.map_step_layer1 = Linear(emb_channels, emb_channels, device=device, **init)

        enc_layout, dec_layout = _song_layout(
            img_resolution, in_channels, out_channels, model_channels, tuple(channel_mult),
            num_blocks, tuple(attn_resolutions), encoder_type, decoder_type)
        self.enc_layout = [(name, kind) for name, kind, _ in enc_layout]
        self.dec_layout = [(name, kind) for name, kind, _ in dec_layout]
        self.enc = nn.ModuleDict()
        for name, kind, kw in enc_layout:
            if kind == "conv":
                self.enc[name] = Conv2d(kw["cin"], kw["cout"], kernel=3, device=device, **init)
            elif kind == "aux_down":
                self.enc[name] = Conv2d(kw["cin"], kw["cout"], kernel=0, down=True,
                                        resample_filter=resample_filter, device=device)
            elif kind == "aux_skip":
                self.enc[name] = Conv2d(kw["cin"], kw["cout"], kernel=1, device=device, **init)
            elif kind == "aux_residual":
                self.enc[name] = Conv2d(kw["cin"], kw["cout"], kernel=3, down=True,
                                        resample_filter=resample_filter, fused_resample=True,
                                        device=device, **init)
            else:
                self.enc[name] = UNetBlock(kw["cin"], kw["cout"], down=kw["down"],
                                           attention=kw["attn"], **block_kwargs)
        self.dec = nn.ModuleDict()
        for name, kind, kw in dec_layout:
            if kind == "aux_up":
                self.dec[name] = Conv2d(kw["cin"], kw["cout"], kernel=0, up=True,
                                        resample_filter=resample_filter, device=device)
            elif kind == "aux_norm":
                self.dec[name] = GroupNorm(kw["c"], eps=1e-6, device=device)
            elif kind == "aux_conv":
                self.dec[name] = Conv2d(kw["cin"], kw["cout"], kernel=3, device=device,
                                        **init_zero)
            else:
                self.dec[name] = UNetBlock(kw["cin"], kw["cout"], up=kw["up"],
                                           attention=kw["attn"], **block_kwargs)

    def _noise_embed(self, fourier, v):
        emb = fourier(v) if fourier is not None else positional_embedding(
            v, self.noise_channels, endpoint=True)
        return emb.reshape(emb.shape[0], 2, -1).flip(1).reshape(emb.shape)  # swap sin/cos

    def forward(self, x, noise_labels, class_labels=None, bottleneck: Optional[str] = None, *,
                augment_labels=None, step_condition=None, skip_tuning: bool = False,
                generator=None):
        """x: [N, H, W, C] in the compute dtype; noise_labels: [N] or [1];
        class_labels: [N or 1, label_dim] (a conditional net) or None.

        ``bottleneck`` names an encoder layer by its JAX module name (e.g.
        ``enc_8x8_block3``, the AMED tap); the call then returns
        (output, that layer's output activation) -- the explicit counterpart
        of the JAX package's ``capture_intermediates``.
        ``augment_labels``: [N, augment_dim] (a net with ``map_augment``) or
        None; ``step_condition``: SFD-v's step count, [N] or [1] f32 (a net
        built with ``use_step_condition``), else None; ``skip_tuning``:
        scale the decoder's skip tensors (SFD); ``generator``: the dropout
        and label-dropout draws in train mode."""
        emb = self._noise_embed(self.map_noise, noise_labels)
        if self.map_label is not None:
            if class_labels is None:
                raise ValueError("a class-conditional SongUNet needs class_labels")
            tmp = class_labels.to(emb.dtype)
            if self.training:
                tmp = drop_labels(tmp, self.label_dropout, x.shape[0], generator)
            emb = emb + self.map_label(tmp * math.sqrt(self.map_label.in_features))
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels.to(emb.dtype))
        emb = F.silu(self.map_layer0(emb))
        emb = F.silu(self.map_layer1(emb))
        emb_step = None
        if step_condition is not None:
            if self.map_step_layer0 is None:
                raise ValueError("step_condition needs a net built with use_step_condition")
            es = self._noise_embed(self.map_step, step_condition)
            emb_step = F.silu(self.map_step_layer1(F.silu(self.map_step_layer0(es))))

        skips = []
        aux = x
        tap = None
        for name, kind in self.enc_layout:
            layer = self.enc[name]
            if kind == "aux_down":
                aux = layer(aux)
            elif kind == "aux_skip":
                x = skips[-1] = x + layer(aux)
            elif kind == "aux_residual":
                x = skips[-1] = aux = (x + layer(aux)) / math.sqrt(2)
            else:
                x = (_block(layer, self.remat, x, emb, emb_step, generator) if kind == "block"
                     else layer(x))
                skips.append(x)
            if bottleneck == f"enc_{name}":
                tap = x

        n_skips, count = len(skips), 0
        aux = tmp = None
        for name, kind in self.dec_layout:
            layer = self.dec[name]
            if kind == "aux_up":
                aux = layer(aux)
            elif kind == "aux_norm":
                tmp = layer(x)
            elif kind == "aux_conv":
                tmp = layer(F.silu(tmp))
                aux = tmp if aux is None else tmp + aux
            else:
                if x.shape[-1] != layer.in_channels:
                    x = torch.cat([x, _tuned_skip(skips.pop(), skip_tuning, count, n_skips)],
                                  dim=-1)
                    count += 1
                x = _block(layer, self.remat, x, emb, emb_step, generator)
        if bottleneck is None:
            return aux
        if tap is None:
            raise ValueError(f"no encoder layer {bottleneck!r}")
        return aux, tap


def _dhariwal_layout(img_resolution, in_channels, model_channels, channel_mult, num_blocks,
                     attn_resolutions):
    """Static layer layout of DhariwalUNet: ordered (name, kind, kwargs) lists
    for the encoder and decoder, as the JAX package's ``DhariwalUNet`` builds
    them (``networks_edm.py:395-409``).  kind is conv or block; every
    decoder block at an attention resolution has attention."""
    enc: List[Tuple[str, str, dict]] = []
    cout = in_channels
    for level, mult in enumerate(channel_mult):
        res = img_resolution >> level
        if level == 0:
            cin, cout = cout, model_channels * mult
            enc.append((f"{res}x{res}_conv", "conv", dict(cin=cin, cout=cout)))
        else:
            enc.append((f"{res}x{res}_down", "block",
                        dict(cin=cout, cout=cout, up=False, down=True, attn=False)))
        for idx in range(num_blocks):
            cin, cout = cout, model_channels * mult
            enc.append((f"{res}x{res}_block{idx}", "block",
                        dict(cin=cin, cout=cout, up=False, down=False,
                             attn=res in attn_resolutions)))
    skips = [kw["cout"] for _, _, kw in enc]

    dec: List[Tuple[str, str, dict]] = []
    for level, mult in reversed(list(enumerate(channel_mult))):
        res = img_resolution >> level
        if level == len(channel_mult) - 1:
            dec.append((f"{res}x{res}_in0", "block",
                        dict(cin=cout, cout=cout, up=False, down=False, attn=True)))
            dec.append((f"{res}x{res}_in1", "block",
                        dict(cin=cout, cout=cout, up=False, down=False, attn=False)))
        else:
            dec.append((f"{res}x{res}_up", "block",
                        dict(cin=cout, cout=cout, up=True, down=False, attn=False)))
        for idx in range(num_blocks + 1):
            cin = cout + skips.pop()
            cout = model_channels * mult
            dec.append((f"{res}x{res}_block{idx}", "block",
                        dict(cin=cin, cout=cout, up=False, down=False,
                             attn=res in attn_resolutions)))
    return enc, dec


class DhariwalUNet(nn.Module):
    """ADM U-Net (the reference's re-implementation), class-conditional
    through ``map_label`` when ``label_dim > 0``.

    It differs from SongUNet in more than its layout: the noise embedding
    keeps its [cos | sin] order and spaces its frequencies without the
    endpoint; ``map_layer1`` has no SiLU until the label embedding (a
    bias-free Linear, kaiming-normal at scale sqrt(label_dim)) is added;
    blocks use adaptive scale, eps 1e-5, skip scale 1 and 64 channels per
    attention head; the zero-init layers (``conv1``, ``proj``, ``out_conv``)
    are exactly zero at init; and the net ends with ``out_norm`` -> SiLU ->
    ``out_conv``.  ``augment_dim`` creates ``map_augment`` (zero at init),
    which the augment labels go through (sampling passes none)."""

    def __init__(self, img_resolution: int, in_channels: int, out_channels: int,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 192,
                 channel_mult: Sequence[int] = (1, 2, 3, 4), channel_mult_emb: int = 4,
                 num_blocks: int = 3, attn_resolutions: Sequence[int] = (32, 16, 8),
                 dropout: float = 0.10, label_dropout: float = 0.0,
                 use_step_condition: bool = False, remat: bool = False, device=None):
        super().__init__()
        emb_channels = model_channels * channel_mult_emb
        init = dict(init_mode="kaiming_uniform", init_weight=math.sqrt(1 / 3),
                    init_bias=math.sqrt(1 / 3))
        init_zero = dict(init_mode="kaiming_uniform", init_weight=0.0, init_bias=0.0)
        block_kwargs = dict(emb_channels=emb_channels, channels_per_head=64, dropout=dropout,
                            init=init, init_zero=init_zero,
                            use_step_condition=use_step_condition, device=device)
        self.model_channels = model_channels
        self.label_dropout = label_dropout
        self.remat = remat

        # Mapping tower.
        self.map_augment = (Linear(augment_dim, model_channels, bias=False, device=device,
                                   **init_zero) if augment_dim else None)
        self.map_layer0 = Linear(model_channels, emb_channels, device=device, **init)
        self.map_layer1 = Linear(emb_channels, emb_channels, device=device, **init)
        self.map_label = (Linear(label_dim, emb_channels, bias=False, init_mode="kaiming_normal",
                                 init_weight=math.sqrt(label_dim), device=device)
                          if label_dim else None)
        # SFD-v's step-condition tower
        self.map_step_layer0 = self.map_step_layer1 = None
        if use_step_condition:
            self.map_step_layer0 = Linear(model_channels, emb_channels, device=device, **init)
            self.map_step_layer1 = Linear(emb_channels, emb_channels, device=device, **init)

        enc_layout, dec_layout = _dhariwal_layout(
            img_resolution, in_channels, model_channels, tuple(channel_mult), num_blocks,
            tuple(attn_resolutions))
        self.enc_layout = [(name, kind) for name, kind, _ in enc_layout]
        self.dec_layout = [name for name, _, _ in dec_layout]
        self.enc = nn.ModuleDict()
        for name, kind, kw in enc_layout:
            if kind == "conv":
                self.enc[name] = Conv2d(kw["cin"], kw["cout"], kernel=3, device=device, **init)
            else:
                self.enc[name] = UNetBlock(kw["cin"], kw["cout"], down=kw["down"],
                                           attention=kw["attn"], **block_kwargs)
        self.dec = nn.ModuleDict()
        for name, _, kw in dec_layout:
            self.dec[name] = UNetBlock(kw["cin"], kw["cout"], up=kw["up"], attention=kw["attn"],
                                       **block_kwargs)
        cout = dec_layout[-1][2]["cout"]
        self.out_norm = GroupNorm(cout, device=device)
        self.out_conv = Conv2d(cout, out_channels, kernel=3, device=device, **init_zero)

    def forward(self, x, noise_labels, class_labels=None, bottleneck: Optional[str] = None, *,
                augment_labels=None, step_condition=None, skip_tuning: bool = False,
                generator=None):
        """x: [N, H, W, C] in the compute dtype; noise_labels: [N] or [1];
        class_labels: [N, label_dim] or [1, label_dim] (one-hot rows; a
        conditional net needs them, ``EDMPrecond`` supplies zeros).

        ``bottleneck`` names an encoder layer by its JAX module name (the
        AMED tap of a conditional net is ``enc_8x8_block2``); the call then
        returns (output, that layer's output activation).
        ``augment_labels``, ``step_condition``, ``skip_tuning`` and
        ``generator`` as in ``SongUNet``."""
        emb = positional_embedding(noise_labels, self.model_channels)
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels.to(emb.dtype))
        emb = F.silu(self.map_layer0(emb))
        emb = self.map_layer1(emb)
        if self.map_label is not None:
            if class_labels is None:
                raise ValueError("a class-conditional DhariwalUNet needs class_labels")
            tmp = class_labels.to(emb.dtype)
            if self.training:
                tmp = drop_labels(tmp, self.label_dropout, x.shape[0], generator)
            emb = emb + self.map_label(tmp)
        emb = F.silu(emb)
        emb_step = None
        if step_condition is not None:
            if self.map_step_layer0 is None:
                raise ValueError("step_condition needs a net built with use_step_condition")
            es = positional_embedding(step_condition, self.model_channels)
            emb_step = F.silu(self.map_step_layer1(F.silu(self.map_step_layer0(es))))

        skips = []
        tap = None
        for name, kind in self.enc_layout:
            layer = self.enc[name]
            x = (_block(layer, self.remat, x, emb, emb_step, generator) if kind == "block"
                 else layer(x))
            skips.append(x)
            if bottleneck == f"enc_{name}":
                tap = x
        n_skips, count = len(skips), 0
        for name in self.dec_layout:
            layer = self.dec[name]
            if x.shape[-1] != layer.in_channels:
                x = torch.cat([x, _tuned_skip(skips.pop(), skip_tuning, count, n_skips)], dim=-1)
                count += 1
            x = _block(layer, self.remat, x, emb, emb_step, generator)
        x = self.out_conv(F.silu(self.out_norm(x)))
        if bottleneck is None:
            return x
        if tap is None:
            raise ValueError(f"no encoder layer {bottleneck!r}")
        return x, tap
