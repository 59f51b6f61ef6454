"""Trajectory-geometry analysis of a sampler, the port's counterpart of
``scripts/analyze_trajectories.py`` (the script form of the diff-analyzer
notebooks ``main_mp.ipynb`` / ``main_extend.ipynb``), with the same flags
and ``--device``:

  python -m diff_sampler_tpu_torch.cli.analyze_trajectories --dataset_name=cifar10 \\
      --model_path=random --solver=ipndm --num_steps=21 --batch=16 [--device=cuda]

Runs the solver with trajectory capture on the model (and, with ``--data``,
on the dataset-posterior 'optimal' denoiser of those images), and writes
the geometry statistics (magnitude, deviation, segment lengths, cosines,
curvature, PCA curvature / torsion, deviation to the optimal trajectory)
to ``<outdir>/report.json`` and, where matplotlib imports, a plot grid.

``--num_images=N``: the main_mp.ipynb harness: seeds 0..N-1 in batches of
``--batch`` on the one device, each batch's per-sample statistics summed on
the device and accumulated in float64 on the host; the PCA statistics are
skipped.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from .. import analysis
from ..models.factory import create_model
from ..models.precond import bind
from ..ops import get_schedule
from ..ops.geometry import trajectory_curvature, trajectory_deviation, trajectory_lengths
from ..solvers import get_sampler
from ..utils.rng import stacked_randn

__all__ = ["main", "batch_stat_sums"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.analyze_trajectories",
                                description="Geometry statistics of sampling trajectories.")
    p.add_argument("--dataset_name", default="cifar10")
    p.add_argument("--model_path", default="random")
    p.add_argument("--solver", default="ipndm")
    p.add_argument("--num_steps", type=int, default=21)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--data", dest="data_path", default=None,
                   help="image dir/zip for the optimal-denoiser comparison")
    p.add_argument("--num_images", type=int, default=None,
                   help="large-scale mode (the main_mp.ipynb 50k-image harness): accumulate "
                        "the geometry statistics over this many images, batch by batch; PCA "
                        "extras skipped")
    p.add_argument("--outdir", default="analysis_out")
    p.add_argument("--device", default="cuda")
    return p


def batch_stat_sums(xs: torch.Tensor, eps: torch.Tensor, t_steps) -> Dict[str, torch.Tensor]:
    """The ``--num_images`` statistics of one batch's trajectory [T, B, ...]:
    each per-sample statistic summed over the batch on the device."""
    deno = analysis.denoised_trajectory(xs, eps, t_steps)
    return {
        "magnitude": analysis.trajectory_magnitude(xs).sum(0),
        "deviation": trajectory_deviation(xs).sum(0),
        "segment_lengths": trajectory_lengths(xs).sum(0),
        "direction_cosine": analysis.direction_cosines(xs).sum(0),
        "curvature": trajectory_curvature(xs).sum(0),
        "denoised_magnitude": analysis.trajectory_magnitude(deno).sum(0),
    }


def _write(outdir: str, report: Dict[str, np.ndarray]) -> None:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "report.json"), "w") as f:
        json.dump({k: np.asarray(v).tolist() for k, v in report.items()}, f, indent=2)


def _plot(outdir: str, report: Dict[str, np.ndarray]) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        print(f"(plotting skipped: {e})")
        return
    keys = list(report)
    cols = (len(keys) + 1) // 2
    fig, axes = plt.subplots(2, cols, figsize=(4 * cols, 7))
    for ax, k in zip(axes.ravel(), keys):
        ax.plot(report[k])
        ax.set_title(k)
        ax.set_xlabel("step")
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "geometry.png"), dpi=110)
    plt.close(fig)
    print(f"Wrote {outdir}/geometry.png")


@torch.no_grad()
def main(argv=None) -> Dict[str, np.ndarray]:
    """Writes and returns the report."""
    args = _parser().parse_args(argv)
    if args.batch < 1 or args.num_steps < 2 or (args.num_images is not None
                                                and args.num_images < 1):
        raise ValueError("--batch and --num_images must be >= 1 and --num_steps >= 2")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    module, _src = create_model(args.dataset_name, args.model_path, device=device)
    den = bind(module)
    t_steps = get_schedule(args.num_steps, den.sigma_min, den.sigma_max)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    sampler = get_sampler(args.solver)

    if args.num_images is not None:
        acc, total = None, 0
        for start in range(0, args.num_images, args.batch):
            seeds = range(start, min(start + args.batch, args.num_images))
            out = sampler(den, stacked_randn(seeds, shape, device=device), t_steps,
                          return_inters=True)
            sums = {k: v.double().cpu().numpy()
                    for k, v in batch_stat_sums(out.xs, out.eps, t_steps).items()}
            acc = sums if acc is None else {k: acc[k] + sums[k] for k in sums}
            total += len(seeds)
        report = {k: v / total for k, v in acc.items()}
        _write(args.outdir, report)
        print(f"Wrote {args.outdir}/report.json ({total} images, 1 device)")
        return report

    lat = stacked_randn(range(args.batch), shape, device=device)
    out = sampler(den, lat, t_steps, return_inters=True)
    ref_xs = None
    if args.data_path:
        from ..eval.dataset import ImageFolderDataset

        ds = ImageFolderDataset(args.data_path, resolution=module.img_resolution)
        imgs = np.stack([ds[i][0] for i in range(min(len(ds), 5000))])
        opt_den = analysis.optimal_denoiser_from_images(imgs, device=device)
        ref_xs = sampler(opt_den, lat, t_steps, return_inters=True).xs
    report = analysis.trajectory_report(out.xs, out.eps, t_steps, ref_xs)
    _write(args.outdir, report)
    print(f"Wrote {args.outdir}/report.json")
    _plot(args.outdir, report)
    return report


if __name__ == "__main__":
    main()
