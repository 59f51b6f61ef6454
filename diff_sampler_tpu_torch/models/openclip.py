"""The OpenCLIP image and text towers, offline, in plain PyTorch.

Counterpart of ``diff_sampler_tpu/models/openclip.py``: the CLIP-score
detector of the reference is OpenCLIP ViT-g-14 (``open_clip.create_model_and_transforms(
'ViT-g-14', pretrained='laion2b_s34b_b88k')``), which open_clip downloads.
Here a local checkpoint file is all that is needed.  The module carries
open_clip's state_dict names (``visual.conv1.weight``,
``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``transformer.resblocks.{i}.mlp.c_fc.weight``, ``text_projection``,
``logit_scale``, ...), so a checkpoint loads by ``load_state_dict`` once a
``module.`` prefix is stripped (``openclip_from_state_dict``).

The math is the JAX package's: LayerNorm with eps 1e-5, packed-qkv
attention with the 1/sqrt(d) scale on q before the product, the exact GELU
(SD's GEGLU is the tanh one), a causal mask on the text tower only, a
bias-free patch conv of stride = patch, the class token then the positional
embedding then ``ln_pre``, and the text pooled at ``argmax(ids)``.
Attention is plain matmul and softmax in the module's dtype: no Pallas
kernel serves these towers in the JAX package either.

Everything but the attention heads is read from the state_dict's shapes;
the vision tower's head width comes from open_clip's config table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["OpenCLIPConfig", "OpenCLIP", "infer_openclip_config", "openclip_from_state_dict",
           "attention"]

# vision width -> attention head width (open_clip model_configs: ViT-B/L use
# 64; ViT-H-14 80; ViT-g-14 88; ViT-bigG-14 104)
_VISION_HEAD_WIDTH = {768: 64, 1024: 64, 1280: 80, 1408: 88, 1664: 104}

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class OpenCLIPConfig:
    embed_dim: int
    image_size: int
    patch_size: int
    vision_width: int
    vision_layers: int
    vision_heads: int
    vision_mlp_dim: int
    text_width: int
    text_layers: int
    text_heads: int
    text_mlp_dim: int
    vocab_size: int
    context_length: int


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention of [B, T, width] projections: q scaled by
    1/sqrt(d) before the product, ``mask`` added to the logits, softmax in
    the inputs' dtype."""
    b, t, w = q.shape
    dh = w // heads
    q, k, v = (a.reshape(b, t, heads, dh) for a in (q, k, v))
    logits = torch.einsum("bihd,bjhd->bhij", q * dh ** -0.5, k)
    if mask is not None:
        logits = logits + mask
    return torch.einsum("bhij,bjhd->bihd", torch.softmax(logits, dim=-1), v).reshape(b, t, w)


class _Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameters: ``in_proj_weight`` [3w, w]
    (q, k, v stacked), ``in_proj_bias`` and ``out_proj``."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def forward(self, x, mask=None):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, self.heads, mask))


class _MLP(nn.Module):
    def __init__(self, width: int, mlp_dim: int, device=None):
        super().__init__()
        self.c_fc = nn.Linear(width, mlp_dim, device=device)
        self.c_proj = nn.Linear(mlp_dim, width, device=device)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="none"))


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int, device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS, device=device)
        self.attn = _Attention(width, heads, device=device)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS, device=device)
        self.mlp = _MLP(width, mlp_dim, device=device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, mlp_dim: int, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList([_ResidualAttentionBlock(width, heads, mlp_dim, device)
                                        for _ in range(layers)])

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: OpenCLIPConfig, device=None):
        super().__init__()
        w, p = cfg.vision_width, cfg.patch_size
        grid = cfg.image_size // p
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(w, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, w, device=device))
        self.ln_pre = nn.LayerNorm(w, eps=LN_EPS, device=device)
        self.transformer = _Transformer(w, cfg.vision_layers, cfg.vision_heads,
                                        cfg.vision_mlp_dim, device)
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS, device=device)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim, device=device))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.conv1(pixels.permute(0, 3, 1, 2))  # NHWC -> NCHW, as the JAX conv's HWIO
        b, w = x.shape[:2]
        x = x.reshape(b, w, -1).transpose(1, 2)  # [B, grid * grid, w], row-major patches
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


class OpenCLIP(nn.Module):
    """Two-tower CLIP (open_clip's ``CLIP`` with its ``VisionTransformer``
    and text transformer).  ``encode_image(pixels)``: [B, H, W, 3]
    CLIP-normalised pixels -> [B, embed_dim]; ``encode_text(ids)``: [B,
    context_length] ints -> [B, embed_dim], pooled at the largest id (EOT).
    ``logit_scale`` is carried for the checkpoint's sake; the CLIP score
    does not use it."""

    def __init__(self, cfg: OpenCLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.visual = _VisionTransformer(cfg, device)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.text_width, device=device))
        self.transformer = _Transformer(cfg.text_width, cfg.text_layers, cfg.text_heads,
                                        cfg.text_mlp_dim, device)
        self.ln_final = nn.LayerNorm(cfg.text_width, eps=LN_EPS, device=device)
        self.text_projection = nn.Parameter(
            torch.zeros(cfg.text_width, cfg.embed_dim, device=device))
        self.logit_scale = nn.Parameter(torch.full((), math.log(1 / 0.07), device=device))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual(pixels.to(self.text_projection.dtype))

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        x = self.token_embedding(ids) + self.positional_embedding
        t = x.shape[1]
        causal = torch.full((t, t), float("-inf"), dtype=x.dtype, device=x.device).triu(1)
        x = self.ln_final(self.transformer(x, causal))
        x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return x @ self.text_projection


def infer_openclip_config(sd: Mapping[str, torch.Tensor], vision_heads: Optional[int] = None,
                          text_heads: Optional[int] = None) -> OpenCLIPConfig:
    """The architecture read from an open_clip state_dict's shapes (the
    trick of open_clip's ``build_model_from_openai_state_dict``); heads from
    ``_VISION_HEAD_WIDTH`` (vision) and a head width of 64 (text) unless
    given."""
    vw = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vl = 1 + max(int(k.split(".")[3]) for k in sd
                 if k.startswith("visual.transformer.resblocks."))
    tw = sd["token_embedding.weight"].shape[1]
    tl = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks."))
    return OpenCLIPConfig(
        embed_dim=sd["text_projection"].shape[1], image_size=grid * patch, patch_size=patch,
        vision_width=vw, vision_layers=vl,
        vision_heads=vision_heads or vw // _VISION_HEAD_WIDTH.get(vw, 64),
        vision_mlp_dim=sd["visual.transformer.resblocks.0.mlp.c_fc.weight"].shape[0],
        text_width=tw, text_layers=tl, text_heads=text_heads or tw // 64,
        text_mlp_dim=sd["transformer.resblocks.0.mlp.c_fc.weight"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0])


def openclip_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                             vision_heads: Optional[int] = None, device="cuda") -> OpenCLIP:
    """An ``OpenCLIP`` in f32 on ``device`` holding an open_clip state_dict
    (``open_clip_pytorch_model.bin``; keys may carry a ``module.`` prefix).
    The load is strict but for ``logit_scale``, which may be absent; any
    other missing or unknown key raises and is named."""
    sd: Dict[str, torch.Tensor] = {
        (k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v).float()
        for k, v in state_dict.items()}
    cfg = infer_openclip_config(sd, vision_heads)
    model = OpenCLIP(cfg, device="meta")
    missing, unexpected = model.load_state_dict(sd, strict=False, assign=True)
    missing = [k for k in missing if k != "logit_scale"]
    if missing or unexpected:
        raise KeyError(f"not an open_clip state_dict of this architecture: missing {missing}, "
                       f"unknown {unexpected}")
    if model.logit_scale.is_meta:
        model.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
    return model.to(device).eval().requires_grad_(False)
