"""Caption / context conditioning for the Stable Diffusion tier's AMED
training (``ms_coco``).

Counterpart of ``diff_sampler_tpu/training/conditioning.py``.  The reference
draws random captions from the MS-COCO 30k CSV each iteration and encodes
them with the checkpoint's CLIP text tower
(``amed-solver-main/training/training_loop.py:118-126,173-180``); the CFG
unconditional context is the empty-string encoding (:175-177).  Without a
text encoder, as with the random-weight models, the JAX package falls back to
seeded random contexts of the right shape, and so does the port, whose CLIP
text tower comes with a later slice: every context here is that fallback,
drawn with numpy exactly as the JAX package draws it.  A captions file that
is named is still read, so a wrong path fails as it does there.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Optional

import numpy as np

__all__ = ["CLIP_SEQ_LEN", "load_captions", "make_caption_context_fn", "make_uncond_context"]

CLIP_SEQ_LEN = 77  # CLIP text tower context length


def load_captions(prompts_path: Optional[str]) -> Optional[list]:
    """MS-COCO captions CSV with a 'text' column -> list[str]; None for no
    path.  A path that names no file raises: a mistyped --prompt_path must
    not train on random contexts unnoticed."""
    if not prompts_path:
        return None
    if not os.path.isfile(prompts_path):
        raise FileNotFoundError(
            f"captions CSV not found: {prompts_path!r} (omit --prompt_path "
            f"entirely for the seeded-random contexts)")
    with open(prompts_path) as f:
        return [row["text"] for row in csv.DictReader(f)]


def _ctx_dim(ld) -> int:
    return ld.unet.context_dim or 768


def make_caption_context_fn(ld, prompts_path: Optional[str], batch: int, seed: int,
                            verbose: bool = True) -> Callable[[int], np.ndarray]:
    """Per-iteration context sampler: it -> [batch, 77, context_dim] float32,
    ``RandomState((seed + it) % 2**31).randn`` (no text encoder is ported)."""
    captions = load_captions(prompts_path)
    dim = _ctx_dim(ld)
    if verbose:
        got = f"{len(captions)} captions but " if captions is not None else "no captions, "
        print(f"WARNING: {got}no text encoder -- using seeded random contexts (smoke mode)")

    def random_ctx(it: int) -> np.ndarray:
        rng = np.random.RandomState((seed + it) % (1 << 31))
        return rng.randn(batch, CLIP_SEQ_LEN, dim).astype(np.float32)

    return random_ctx


def make_uncond_context(ld, mb: int, guidance_rate: float,
                        seed: int = 0) -> Optional[np.ndarray]:
    """The CFG unconditional context [mb, 77, context_dim], or None when
    guidance is off (guidance_rate 1.0 never doubles the batch): without a
    text encoder, one fixed seeded row ``RandomState(seed).randn`` repeated."""
    if guidance_rate == 1.0:
        return None
    dim = _ctx_dim(ld)
    one = np.random.RandomState(seed).randn(1, CLIP_SEQ_LEN, dim).astype(np.float32)
    return np.broadcast_to(one, (mb, CLIP_SEQ_LEN, dim)).copy()
