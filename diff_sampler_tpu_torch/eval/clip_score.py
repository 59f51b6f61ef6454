"""CLIP score: 100 x the cosine of image and text embeddings, averaged.

Counterpart of ``diff_sampler_tpu/eval/clip_score.py`` (the reference's
``diff-solvers-main/clip_score.py:34-96``, OpenCLIP ViT-g-14).  The encoder
pair is pluggable:

  * ``make_openclip_encoders(checkpoint_path)``: a local open_clip
    checkpoint (ViT-g-14 ``laion2b_s34b_b88k``, the reference's detector)
    through ``models/openclip.py``, tokenised by the in-repo BPE;
  * ``make_hf_clip_encoders(model_name)``: transformers' torch ``CLIPModel``
    from a local directory or the local cache;
  * any (image_embed_fn, text_embed_fn) pair: tests use stubs.

Nothing is downloaded: a missing checkpoint, vocab file or HF model raises
and says what was looked for.  The towers run in f32 with TF32 off inside
every call (``eval.inception.exact_f32``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .inception import exact_f32, resize_nhwc

__all__ = ["clip_score", "clip_preprocess", "make_openclip_encoders", "make_hf_clip_encoders",
           "OpenCLIPEncoders"]

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _numpy(e) -> np.ndarray:
    return e.detach().cpu().numpy() if torch.is_tensor(e) else np.asarray(e)


def clip_score(image_embed_fn: Callable, text_embed_fn: Callable,
               batches: Iterable[Tuple[np.ndarray, Sequence[str]]]) -> float:
    """Mean of 100 * cosine(image embedding, text embedding) over the pairs
    of every (images, prompts) batch (clip_score.py:74-94); each batch's
    embeddings are L2-normalised on the host, as in the JAX package."""
    total, count = 0.0, 0
    for images, prompts in batches:
        img_e = _numpy(image_embed_fn(images))
        txt_e = _numpy(text_embed_fn(prompts if isinstance(prompts, np.ndarray)
                                     else list(prompts)))
        img_e = img_e / np.linalg.norm(img_e, axis=-1, keepdims=True)
        txt_e = txt_e / np.linalg.norm(txt_e, axis=-1, keepdims=True)
        sims = 100.0 * np.sum(img_e * txt_e, axis=-1)
        total += float(sims.sum())
        count += len(sims)
    return total / max(count, 1)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(_CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def clip_preprocess(images_uint8, size: int, device="cuda") -> torch.Tensor:
    """uint8 NHWC -> CLIP-normalised f32 NHWC on ``device``: the shorter side
    resized to ``size`` by ``jax.image.resize``'s bicubic (Keys' a = -0.5,
    antialiased where it shrinks), a centre crop, CLIP's mean and std (the
    torchvision Compose open_clip returns as ``preprocess``)."""
    x = torch.as_tensor(np.asarray(images_uint8), device=device).float() / 255.0
    _b, h, w, _c = x.shape
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = resize_nhwc(x, nh, nw, "bicubic")
    top, left = (nh - size) // 2, (nw - size) // 2
    return _normalize(x[:, top:top + size, left:left + size, :])


class OpenCLIPEncoders:
    """The two encoders of ``make_openclip_encoders`` over one ``OpenCLIP``
    (``model``) on ``device``."""

    def __init__(self, model, tokenizer: Optional[Callable] = None, device="cuda"):
        self.model = model
        self.tokenizer = tokenizer
        self.device = device

    @torch.no_grad()
    def encode_images(self, images_uint8) -> torch.Tensor:
        """uint8 NHWC images -> [B, embed_dim] f32."""
        with exact_f32():
            return self.model.encode_image(
                clip_preprocess(images_uint8, self.model.cfg.image_size, self.device))

    @torch.no_grad()
    def encode_texts(self, prompts) -> torch.Tensor:
        """A list of prompts, or pre-tokenised [B, context_length] ids ->
        [B, embed_dim] f32.  Without a tokenizer, the first call of prompts
        loads the in-repo BPE over the local vocab file (open_clip's zero
        padding), and raises naming the places searched where there is
        none."""
        if isinstance(prompts, np.ndarray) or torch.is_tensor(prompts):
            ids = torch.as_tensor(prompts)
        else:
            if self.tokenizer is None:
                from ..utils.bpe import SimpleBPETokenizer

                self.tokenizer = SimpleBPETokenizer.from_default_paths(
                    context_length=self.model.cfg.context_length)
            ids = torch.as_tensor(np.asarray(self.tokenizer(list(prompts))))
        with exact_f32():
            return self.model.encode_text(ids.to(self.device))


def make_openclip_encoders(checkpoint_path: str, tokenizer: Optional[Callable] = None,
                           vision_heads: Optional[int] = None, device="cuda"):
    """(image_embed_fn(uint8 NHWC), text_embed_fn(prompts or ids)) of a local
    open_clip checkpoint (ViT-g-14: ``open_clip_pytorch_model.bin``), loaded
    by the port's restricted reader (``models/torch_import.py``).
    ``tokenizer``: any callable prompts -> [B, context_length] ids; by
    default the in-repo BPE.  There is no ``CLIPTokenizer.from_pretrained``
    fallback: it downloads.  Both functions are bound methods of one
    ``OpenCLIPEncoders``."""
    from ..models.openclip import openclip_from_state_dict
    from ..models.torch_import import load_torch_file, torch_state_dict

    sd = torch_state_dict(load_torch_file(checkpoint_path))
    model = openclip_from_state_dict(sd, vision_heads=vision_heads, device=device)
    enc = OpenCLIPEncoders(model, tokenizer, device)
    return enc.encode_images, enc.encode_texts


def make_hf_clip_encoders(model_name: str = "laion/CLIP-ViT-g-14-laion2B-s12B-b42K",
                          device="cuda"):
    """(image_embed_fn(uint8 NHWC), text_embed_fn(list[str])) of transformers'
    torch ``CLIPModel`` and ``AutoTokenizer`` from a local directory or the
    local cache (``local_files_only``): images resized to the model's size
    by ``jax.image.resize``'s bicubic and CLIP-normalised, as the JAX
    package does; prompts padded to the tokenizer's length.  A model that
    is not local raises and names it."""
    from transformers import AutoTokenizer, CLIPModel

    try:
        model = CLIPModel.from_pretrained(model_name, local_files_only=True)
        tokenizer = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
    except OSError as e:
        raise RuntimeError(
            f"CLIP model '{model_name}' is not available locally (a directory or the "
            f"transformers cache); nothing is downloaded: {e}") from e
    model = model.to(device=device, dtype=torch.float32).eval().requires_grad_(False)
    size = model.config.vision_config.image_size

    @torch.no_grad()
    def image_embed(images_uint8):
        x = torch.as_tensor(np.asarray(images_uint8), device=device).float() / 255.0
        x = _normalize(resize_nhwc(x, size, size, "bicubic"))
        with exact_f32():
            return model.get_image_features(pixel_values=x.permute(0, 3, 1, 2))

    @torch.no_grad()
    def text_embed(prompts):
        toks = tokenizer(list(prompts), padding="max_length", truncation=True,
                         return_tensors="pt")
        with exact_f32():
            return model.get_text_features(input_ids=toks["input_ids"].to(device),
                                           attention_mask=toks["attention_mask"].to(device))

    return image_embed, text_embed
