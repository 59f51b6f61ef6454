"""The port's counterpart of ``scripts/analyze_extend.py``, the runnable
form of the reference's ``diff-analyzer-main/main_extend.ipynb``, with the
same flags and ``--device``:

  1. sample trajectories from a diffusion model (``--mode=sampling``) or
     from an approximated-score denoiser (full / low-rank Gaussian, full /
     low-rank mixture of Gaussians) of a dataset's statistics;
  2. project each trajectory to its 3D regularity frame (the endpoint axis
     and the top-2 PCs) and plot the raw 3D trajectories;
  3. Procrustes-calibrate them against a base trajectory and plot;
  4. compute the windowed curvature / torsion along arc length and plot.

Writes ``stats_<mode>.json`` and, where matplotlib imports, the three PNGs
into ``--outdir``:

  python -m diff_sampler_tpu_torch.cli.analyze_extend --mode=sampling \\
      --model_path=random --num_steps=201 --batch=16 --outdir=analysis_out
  python -m diff_sampler_tpu_torch.cli.analyze_extend --mode=low_rank_mog

Without ``--data`` the approximated-score modes draw a synthetic dataset
(10 centres, 512 points, ``numpy.random.default_rng(0)``), as the JAX script
does, so they run with no files.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import analysis
from ..models import analytic
from ..models.factory import create_model
from ..models.precond import bind
from ..ops import get_schedule
from ..solvers import get_sampler
from ..utils.rng import stacked_randn

__all__ = ["MODES", "build_denoiser", "main"]

MODES = ["sampling", "full_rank_gaussian", "low_rank_gaussian", "full_rank_mog",
         "low_rank_mog"]


def build_denoiser(mode: str, dataset_name: str, model_path: str, data_path, rank: int,
                   resolution: int, device="cuda"):
    """(denoiser, resolution, channels) of a mode."""
    if mode == "sampling":
        module, _src = create_model(dataset_name, model_path, device=device)
        return bind(module), module.img_resolution, module.img_channels

    # the approximated-score modes need a dataset's statistics
    if data_path:
        from ..eval.dataset import ImageFolderDataset

        ds = ImageFolderDataset(data_path, resolution=resolution, use_labels="mog" in mode)
        n = min(len(ds), 10000)
        imgs = np.stack([ds[i][0] for i in range(n)])  # uint8 NHWC
        labels = None
        if "mog" in mode and ds.label_dim:
            labels = np.stack([ds.get_label(i) for i in range(n)])
        data = imgs.astype(np.float32) / 127.5 - 1.0
    else:  # a synthetic dataset, so the modes run with no files
        rng = np.random.default_rng(0)
        centers = rng.normal(size=(10, resolution * resolution * 3)).astype(np.float32)
        labels = rng.integers(0, 10, size=512)
        data = (centers[labels]
                + 0.1 * rng.normal(size=(512, centers.shape[1]))).astype(np.float32)
    flat = data.reshape(len(data), -1)
    if labels is None:
        labels = np.zeros(len(flat), np.int64)

    if mode == "full_rank_gaussian":
        den = analytic.IsotropicGaussianDenoiser(flat.mean(0), device=device)
    elif mode == "low_rank_gaussian":
        den = analytic.LowRankGaussianDenoiser.from_data(flat, rank, device=device)
    elif mode == "full_rank_mog":
        den = analytic.MixtureGaussianDenoiser.from_labeled_data(flat, labels, device=device)
    elif mode == "low_rank_mog":
        den = analytic.MixtureGaussianDenoiser.from_labeled_data(flat, labels, rank=rank,
                                                                 device=device)
    else:
        raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
    return den, resolution, 3


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.analyze_extend",
                                description="Regularity, calibration and curvature / torsion "
                                            "of sampling trajectories.")
    p.add_argument("--mode", choices=MODES, default="sampling")
    p.add_argument("--dataset_name", default="cifar10")
    p.add_argument("--model_path", default="random")
    p.add_argument("--data", dest="data_path", default=None,
                   help="image dir/zip for dataset statistics (approximated-score modes)")
    p.add_argument("--solver", default="euler")
    p.add_argument("--num_steps", type=int, default=201,
                   help="the notebook uses 1001; 201 is a faster default")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--rank", type=int, default=64, help="PCA rank of the low-rank modes")
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--window", type=int, default=101)
    p.add_argument("--keep_ratio", type=float, default=0.8)
    p.add_argument("--outdir", default="analysis_out")
    p.add_argument("--device", default="cuda")
    return p


def _plot_3d(plt, xs, ys, zs, labels, path: str) -> None:
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for b in range(xs.shape[1]):
        ax.plot3D(xs[:, b], ys[:, b], zs[:, b])
    ax.set_xlabel(labels[0])
    ax.set_ylabel(labels[1])
    ax.set_zlabel(labels[2])
    ax.view_init(elev=8, azim=130)
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _plot_curv_tors(plt, curv, tors, s, path: str) -> None:
    fig, axs = plt.subplots(2, figsize=(6, 4), sharex=True)
    for b in range(curv.shape[1]):
        axs[0].plot(s[:, b], curv[:, b], alpha=0.5)
        axs[1].plot(s[:, b], tors[:, b], alpha=0.5)
    axs[0].set_ylabel("curvature")
    axs[1].set_ylabel("torsion")
    axs[1].set_xlabel("arc length")
    fig.savefig(path, dpi=150)
    plt.close(fig)


@torch.no_grad()
def main(argv=None) -> dict:
    """Writes ``stats_<mode>.json`` (and the PNGs); returns the stats."""
    args = _parser().parse_args(argv)
    if args.batch < 1 or args.num_steps < 4:
        raise ValueError("--batch must be >= 1 and --num_steps >= 4")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        plt = None
        print(f"(plotting skipped: {e})")

    os.makedirs(args.outdir, exist_ok=True)
    mode = args.mode
    den, res, ch = build_denoiser(mode, args.dataset_name, args.model_path, args.data_path,
                                  args.rank, args.resolution, device)
    t_steps = get_schedule(args.num_steps, den.sigma_min, den.sigma_max, "polynomial", 7.0)
    lat = stacked_randn(range(args.batch), (res, res, ch), device=device)
    traj = get_sampler(args.solver)(den, lat, t_steps, return_inters=True).xs.cpu().numpy()

    xs, ys, zs = analysis.regularity_projection(traj)
    kx, ky, kz = analysis.keep_central(xs, ys, zs, args.keep_ratio)
    ax_, ay_, az_ = analysis.procrustes_align(kx, ky, kz, base_idx=0, proj_dim=2)
    w = min(args.window, (traj.shape[0] // 2) * 2 - 1)
    curv, tors, s = analysis.windowed_curvature_torsion(kx, ky, kz, window_size=w)
    if plt is not None:
        out = lambda name: os.path.join(args.outdir, f"{name}_{mode}.png")  # noqa: E731
        _plot_3d(plt, kx, ky, kz, ("x_t0 - x_tN", "PC1", "PC2"), out("traj_3d_raw"))
        _plot_3d(plt, ax_, ay_, az_, ("x_t0 - x_tN", "PC1 (aligned)", "PC2 (aligned)"),
                 out("traj_3d_calibrated"))
        _plot_curv_tors(plt, curv, tors, s, out("curv_tors"))

    stats = {
        "mode": mode,
        "num_steps": args.num_steps,
        "batch": args.batch,
        "mean_curvature": float(np.nanmean(curv)),
        "mean_abs_torsion": float(np.nanmean(np.abs(tors))),
        "mean_final_norm": float(np.linalg.norm(traj[-1].reshape(args.batch, -1),
                                                axis=1).mean()),
        "window_size": w,
    }
    with open(os.path.join(args.outdir, f"stats_{mode}.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
