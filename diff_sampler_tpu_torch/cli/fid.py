"""FID CLI of the port: ``calc`` (images against reference statistics) and
``ref`` (a dataset's statistics), as ``diff_sampler_tpu/cli/fid.py`` (the
reference's ``diff-solvers-main/fid.py:90-165``), with the same flags:

  python -m diff_sampler_tpu_torch.cli.fid ref --data=datasets/cifar10.zip \\
      --dest=cifar10-ref.npz --inception=<detector>
  python -m diff_sampler_tpu_torch.cli.fid calc --images=out/ \\
      --ref=cifar10-ref.npz --inception=<detector>

``--inception`` takes the JAX CLI's two sources: an NVIDIA-style detector
``.pkl`` (read by the order / shape automap or by name, run with the TF
preprocessing) or a ``.npz`` of the JAX package's imported params (as
``utils/checkpoint.py::save_params`` writes it).  The port also takes, where
the JAX CLI does not, any other file as a torch state_dict (or module) in
torchvision / pytorch-fid names, e.g. pytorch-fid's
``pt_inception-2015-12-05-*.pth``.  Without ``--inception`` only
``--smoke`` runs, on a seeded random detector, and its value is labelled as
no FID.  The detector runs on the card, in f32 with TF32 off.
"""

from __future__ import annotations

import argparse
import time

from ..eval.dataset import ImageFolderDataset
from ..eval.fid import calculate_stats, compute_fid, load_stats, make_inception_feature_fn, \
    save_stats
from ..eval.inception import (InceptionV3FID, import_inception_state_dict,
                              import_nvidia_inception_pickle, init_random_inception)


def _feature_fn(inception_path, allow_random=False, device="cuda"):
    """(feature_fn, is_random).  Without imported weights the detector is
    random and any resulting 'FID' is meaningless: refused unless
    ``allow_random`` (--smoke), and then labelled."""
    if inception_path:
        if inception_path.endswith(".pkl"):
            sd, _report = import_nvidia_inception_pickle(inception_path)
            return make_inception_feature_fn(sd, device, tf_preprocessing=True), False
        if inception_path.endswith(".npz"):
            from ..models.convert import inception_state_dict_from_jax
            from ..utils.checkpoint import load_params

            sd = inception_state_dict_from_jax(load_params(inception_path)["params"])
        else:
            from ..models.torch_import import load_torch_file, torch_state_dict

            sd = import_inception_state_dict(torch_state_dict(load_torch_file(inception_path)))
        return make_inception_feature_fn(sd, device), False
    if not allow_random:
        raise SystemExit(
            "fid: no --inception weights given; refusing to compute a meaningless FID from a "
            "random-init detector. Pass --inception=<imported .npz, NVIDIA .pkl or torch "
            "state_dict>, or --smoke to exercise the pipeline only.")
    print("WARNING: random-init detector (--smoke): values are meaningless")
    sd = init_random_inception(InceptionV3FID(), seed=0).state_dict()
    return make_inception_feature_fn(sd, device), True


def _stats_for_path(path, num_expected, batch, inception, seed=0, allow_random=False,
                    device="cuda", timings=None):
    ds = ImageFolderDataset(path, max_size=num_expected, random_seed=seed)
    if num_expected is not None and len(ds) < num_expected:
        raise SystemExit(f"fid: found {len(ds)} images, expected at least {num_expected}")
    if len(ds) < 2:
        raise SystemExit("fid: need at least 2 images")
    feature_fn, is_random = _feature_fn(inception, allow_random, device)
    stats = calculate_stats(feature_fn, (imgs for imgs, _ in ds.batches(batch)),
                            device=device, timings=timings)
    return stats, is_random


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.fid",
                                description="Frechet Inception Distance.")
    sub = p.add_subparsers(dest="command", required=True)
    calc = sub.add_parser("calc", help="FID of an image set against reference statistics")
    calc.add_argument("--images", dest="image_path", required=True)
    calc.add_argument("--ref", dest="ref_path", required=True)
    calc.add_argument("--num", dest="num_expected", type=int, default=50000)
    calc.add_argument("--batch", type=int, default=64)
    calc.add_argument("--inception", default=None,
                      help="imported Inception params (.npz), NVIDIA detector .pkl, or a "
                           "torch state_dict in torchvision names")
    calc.add_argument("--strict-count", dest="strict_count", default=True,
                      action=argparse.BooleanOptionalAction,
                      help="require 10k/30k/50k images (fid.py:43)")
    calc.add_argument("--smoke", action="store_true",
                      help="allow a random-init detector (pipeline smoke only; the result is "
                           "labelled and is NOT an FID)")
    calc.add_argument("--seed", type=int, default=0,
                      help="random seed for selecting the images (fid.py:118)")
    ref = sub.add_parser("ref", help="reference statistics of a dataset")
    ref.add_argument("--data", dest="dataset_path", required=True)
    ref.add_argument("--dest", dest="dest_path", required=True)
    ref.add_argument("--batch", type=int, default=64)
    ref.add_argument("--inception", default=None)
    ref.add_argument("--smoke", action="store_true")
    return p


def main(argv=None, *, device: str = "cuda") -> dict:
    """Runs the CLI on ``device``.  Returns what a caller may check: ``calc``
    gives ``fid``, the stats ``mu`` / ``sigma``, ``is_random`` and the host
    seconds ``decode`` / ``features`` / ``sqrtm``; ``ref`` the stats and
    ``is_random``."""
    args = _parser().parse_args(argv)
    if args.command == "ref":
        (mu, sigma), is_random = _stats_for_path(args.dataset_path, None, args.batch,
                                                 args.inception, allow_random=args.smoke,
                                                 device=device)
        if is_random:
            print("WARNING: stats built with a random detector (--smoke)")
        save_stats(args.dest_path, mu, sigma)
        print(f"Saved reference stats to {args.dest_path}")
        return dict(mu=mu, sigma=sigma, is_random=is_random)
    ds_len = len(ImageFolderDataset(args.image_path, max_size=args.num_expected,
                                    random_seed=args.seed))
    if args.strict_count and ds_len not in (10000, 30000, 50000):
        raise SystemExit(f"fid: {ds_len} images found; expected 10k/30k/50k "
                         "(use --no-strict-count)")
    timings = {}
    (mu, sigma), is_random = _stats_for_path(
        args.image_path, args.num_expected if args.strict_count else None, args.batch,
        args.inception, seed=args.seed, allow_random=args.smoke, device=device,
        timings=timings)
    mu_ref, sigma_ref = load_stats(args.ref_path)
    t0 = time.perf_counter()
    fid = compute_fid(mu, sigma, mu_ref, sigma_ref)
    timings["sqrtm"] = time.perf_counter() - t0
    if is_random:
        print(f"SMOKE-ONLY frechet distance (random detector, NOT FID): {fid:g}")
    else:
        print(f"FID: {fid:g}")
    return dict(fid=fid, mu=mu, sigma=sigma, is_random=is_random, **timings)


if __name__ == "__main__":
    main()
