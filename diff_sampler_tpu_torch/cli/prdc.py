"""PRDC CLI of the port: precision / recall / density / coverage between a
generated image set and a reference image set, as
``diff_sampler_tpu/cli/prdc.py`` (the reference's ``sfd-main/prdc.py:252-``),
with the same flags: Inception features of both sets (``--inception`` as in
``cli/fid.py``), then the k-NN-radius formulas (``prdc.py:71-124``).

  python -m diff_sampler_tpu_torch.cli.prdc calc --images=out/ \\
      --images_ref=datasets/cifar10.zip --inception=<detector>
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..eval.dataset import ImageFolderDataset
from ..eval.prdc import compute_prdc
from .fid import _feature_fn


def _features_for_path(path, max_size, batch, seed, feature_fn):
    ds = ImageFolderDataset(path, max_size=max_size, random_seed=seed)
    feats = [feature_fn(imgs).cpu().numpy() for imgs, _ in ds.batches(batch)]
    return np.concatenate(feats, axis=0)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.prdc",
                                description="Precision / recall / density / coverage "
                                            "(sfd-main/prdc.py).")
    sub = p.add_subparsers(dest="command", required=True)
    calc = sub.add_parser("calc", help="PRDC of generated images against reference images")
    calc.add_argument("--images", dest="image_path", required=True,
                      help="generated images (dir or zip)")
    calc.add_argument("--images_ref", dest="ref_path", required=True,
                      help="reference images (dir or zip)")
    calc.add_argument("--num", dest="max_size", type=int, default=5000,
                      help="images per set (the reference asserts 5000, prdc.py:284)")
    calc.add_argument("--nearest_k", type=int, default=5)
    calc.add_argument("--seed", type=int, default=0)
    calc.add_argument("--batch", type=int, default=250)
    calc.add_argument("--inception", default=None,
                      help="imported Inception params (.npz), NVIDIA detector .pkl, or a "
                           "torch state_dict in torchvision names")
    calc.add_argument("--strict-count", dest="strict_count", default=True,
                      action=argparse.BooleanOptionalAction)
    calc.add_argument("--smoke", action="store_true",
                      help="allow a random-init detector (pipeline smoke only)")
    calc.add_argument("--realism", action="store_true", help="also report max realism score")
    return p


def main(argv=None, *, device: str = "cuda") -> dict:
    """Runs the CLI on ``device``; prints the metrics as one JSON line and
    returns them with both sets' features (``fake``, ``real``) and
    ``is_random``."""
    args = _parser().parse_args(argv)
    n_gen = len(ImageFolderDataset(args.image_path, max_size=args.max_size))
    if args.strict_count and n_gen != args.max_size:
        raise SystemExit(f"prdc: {n_gen} generated images found, expected {args.max_size} "
                         "(use --no-strict-count)")
    feature_fn, is_random = _feature_fn(args.inception, allow_random=args.smoke, device=device)
    print(f'Computing features for "{args.image_path}"...')
    fake = _features_for_path(args.image_path, args.max_size, args.batch, args.seed, feature_fn)
    print(f'Computing features for "{args.ref_path}"...')
    real = _features_for_path(args.ref_path, args.max_size, args.batch, args.seed, feature_fn)
    out = compute_prdc(real, fake, nearest_k=args.nearest_k, realism=args.realism,
                       device=device)
    if "realism" in out:  # per-fake-sample array -> summary stats
        r = np.asarray(out.pop("realism"))
        out["realism_mean"], out["realism_max"] = r.mean(), r.max()
    out = {k: float(v) for k, v in out.items()}
    if is_random:
        print("SMOKE-ONLY values (random detector, NOT real PRDC):")
    print(json.dumps(out))
    return dict(out, fake=fake, real=real, is_random=is_random)


if __name__ == "__main__":
    main()
