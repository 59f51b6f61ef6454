"""Caption / context conditioning for the Stable Diffusion tier's AMED
training (``ms_coco``).

Counterpart of ``diff_sampler_tpu/training/conditioning.py``.  The reference
draws random captions from the MS-COCO 30k CSV each iteration and encodes
them with the checkpoint's CLIP text tower
(``amed-solver-main/training/training_loop.py:118-126,173-180``); the CFG
unconditional context is the empty-string encoding (:175-177).  A model
loaded from an SD checkpoint carries that tower
(``LatentDiffusion.get_learned_conditioning``), and with a captions file
both contexts are its encodings, the captions drawn with numpy exactly as
the JAX package draws them.  Without captions or without a text encoder
(the random-weight models have none), both fall back to seeded random
contexts of the right shape, as in the JAX package.
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
    """Per-iteration context sampler: it -> [batch, 77, context_dim] float32.
    With a captions file and a bound text encoder: the encodings of
    ``batch`` captions drawn by ``RandomState((seed + it) % 2**31)``;
    otherwise seeded random contexts from the same generator."""
    captions = load_captions(prompts_path)
    dim = _ctx_dim(ld)
    if captions is None or ld.cond_stage_model is None:
        if verbose:
            what = "no captions" if captions is None else "no text encoder"
            print(f"WARNING: {what} -- using seeded random contexts (smoke mode)")

        def random_ctx(it: int) -> np.ndarray:
            rng = np.random.RandomState((seed + it) % (1 << 31))
            return rng.randn(batch, CLIP_SEQ_LEN, dim).astype(np.float32)

        return random_ctx

    if verbose:
        print(f"Loaded {len(captions)} captions from {prompts_path}")

    def encode_ctx(it: int) -> np.ndarray:
        rng = np.random.RandomState((seed + it) % (1 << 31))
        drawn = rng.randint(len(captions), size=batch)
        return ld.encode_in_chunks([captions[i] for i in drawn]).numpy()

    return encode_ctx


def make_uncond_context(ld, mb: int, guidance_rate: float,
                        seed: int = 0) -> Optional[np.ndarray]:
    """The CFG unconditional context [mb, 77, context_dim] f32, or None when
    guidance is off (guidance_rate 1.0 never doubles the batch): the empty
    prompt's encoding, or without a text encoder one fixed seeded row
    ``RandomState(seed).randn`` repeated."""
    if guidance_rate == 1.0:
        return None
    dim = _ctx_dim(ld)
    if ld.cond_stage_model is None:
        one = np.random.RandomState(seed).randn(1, CLIP_SEQ_LEN, dim).astype(np.float32)
        return np.broadcast_to(one, (mb, CLIP_SEQ_LEN, dim)).copy()
    return ld.encode_in_chunks(mb * [""]).numpy()
