"""Image saving: per-seed PNGs (in subdirectories of 1000 seeds) and grids.

Counterpart of ``diff_sampler_tpu/utils/image.py``.  The PNG encoder is the
standard library's ``zlib`` and ``struct``, so the port needs no imaging
package.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

__all__ = ["encode_png", "parse_int_list", "save_grid", "save_images"]

_PNG_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, C] uint8 (C in 1, 3, 4) -> PNG file bytes."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] not in _PNG_COLOR_TYPES:
        raise ValueError(f"expected [H, W, 1|3|4] uint8, got {img.shape} {img.dtype}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    # filter type 0 (None) at the start of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_images(images_uint8: np.ndarray, seeds: Sequence[int], outdir: str,
                subdirs: bool = True) -> None:
    """One PNG per seed, ``{outdir}/{block:06d}/{seed:06d}.png``, each block
    of 1000 seeds in its own directory (``subdirs``), else
    ``{outdir}/{seed:06d}.png``."""
    for img, seed in zip(images_uint8, seeds):
        seed = int(seed)
        d = os.path.join(outdir, f"{seed - seed % 1000:06d}") if subdirs else outdir
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{seed:06d}.png"), "wb") as f:
            f.write(encode_png(np.ascontiguousarray(img)))


def save_grid(images_uint8: np.ndarray, path: str, grid_w: Optional[int] = None) -> None:
    """Tile a batch [N, H, W, C] into one PNG, ``grid_w`` images a row
    (default ceil(sqrt(N))), row-major, the unused tiles black."""
    n, h, w, c = images_uint8.shape
    gw = grid_w or int(np.ceil(np.sqrt(n)))
    gh = int(np.ceil(n / gw))
    canvas = np.zeros((gh * h, gw * w, c), np.uint8)
    for i, img in enumerate(images_uint8):
        r, col = divmod(i, gw)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(canvas))


def parse_int_list(s) -> list:
    """'1,2,5-10' -> [1, 2, 5, ..., 10]."""
    if isinstance(s, (list, tuple)):
        return list(s)
    out = []
    for p in str(s).split(","):
        m = re.match(r"^(\d+)-(\d+)$", p)
        if m:
            out.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            out.append(int(p))
    return out
