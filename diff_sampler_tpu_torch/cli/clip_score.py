"""CLIP score CLI of the port, as ``diff_sampler_tpu/cli/clip_score.py``
(the reference's ``diff-solvers-main/clip_score.py``), with the same flags
and ``--device``:

  python -m diff_sampler_tpu_torch.cli.clip_score --images=out/ \\
      [--captions=MS-COCO_val2014_30k_captions.csv] \\
      [--checkpoint=open_clip_pytorch_model.bin | --model=<local HF CLIP>]

Image i is paired with caption i (the reference generates image i from
caption i) over min(#images, #captions) pairs; the score is mean(100 *
cosine).  ``--checkpoint`` is a local open_clip file (the reference's
ViT-g-14 ``laion2b_s34b_b88k``); without it ``--model`` names a
transformers CLIP in a local directory or the local cache.  Nothing is
downloaded.
"""

from __future__ import annotations

import argparse
import csv
from typing import List, Optional

import numpy as np
import torch

from ..eval.clip_score import clip_score, make_hf_clip_encoders, make_openclip_encoders
from ..eval.dataset import ImageFolderDataset

__all__ = ["load_captions", "main"]


def load_captions(path: Optional[str] = None) -> List[str]:
    """The MS-COCO 30k captions CSV's ``text`` column, read as UTF-8 with
    ``newline=""`` (sample.py:171-180); with no path, the zoo's ``prompts``
    file in the offline roots (``models.zoo.find_file``, which raises where
    it is absent)."""
    if path is None:
        from ..models.zoo import find_file

        path = find_file("prompts")
    with open(path, newline="", encoding="utf-8") as f:
        return [row["text"] for row in csv.DictReader(f)]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.clip_score",
                                description="CLIP score of images against their captions.")
    p.add_argument("--images", dest="image_path", required=True)
    p.add_argument("--captions", dest="caption_path", default=None)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--model", dest="model_name", default="laion/CLIP-ViT-g-14-laion2B-s12B-b42K")
    p.add_argument("--checkpoint", dest="checkpoint_path", default=None,
                   help="local OpenCLIP torch checkpoint (the reference's ViT-g-14 "
                        "laion2b_s34b_b88k detector)")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> float:
    """Prints and returns the score."""
    args = _parser().parse_args(argv)
    if args.batch < 1:
        raise ValueError(f"--batch={args.batch} is out of range")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    captions = load_captions(args.caption_path)
    ds = ImageFolderDataset(args.image_path)
    n = min(len(ds), len(captions))
    print(f"Scoring {n} image/caption pairs...")
    if args.checkpoint_path:
        image_fn, text_fn = make_openclip_encoders(args.checkpoint_path, device=device)
    else:
        image_fn, text_fn = make_hf_clip_encoders(args.model_name, device=device)

    def batches():
        for s in range(0, n, args.batch):
            imgs = np.stack([ds[i][0] for i in range(s, min(s + args.batch, n))])
            yield imgs, captions[s:s + args.batch]

    score = clip_score(image_fn, text_fn, batches())
    print(f"CLIP score: {score:.4f}")
    return score


if __name__ == "__main__":
    main()
