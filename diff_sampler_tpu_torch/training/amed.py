"""AMED predictor training.

Counterpart of ``diff_sampler_tpu/training/amed.py``, one call per
trajectory:

  * teacher trajectory: the base solver with M inserted steps per segment,
    run under ``torch.no_grad`` with ``return_inters`` and sliced at the
    student's knots;
  * per-segment student: the AMED-family sampler over one segment with
    ``train=True``; gradients flow through the frozen U-Net (which
    ``bind_with_bottleneck`` froze) into the predictor's r / c_n / a_n;
  * one optimizer step per segment, after summing the gradients of the
    ``batch_gpu`` microbatches (a Python loop here, a ``lax.scan`` in JAX),
    dividing by their count and ``nan_to_num``;
  * handoff: single-step students (euler / dpm / amed) restart each segment
    from the teacher's state; multistep students continue from their own
    detached output;
  * loss = sum((student - teacher)^2) / microbatch;
  * a conditional tier (Stable Diffusion) binds its denoiser per
    microbatch from that microbatch's contexts (``denoise_factory``);
  * data parallel (``layout``): each microbatch splits contiguously over the
    data ranks and the summed gradients are averaged over them before the
    division, as the JAX step's ``data``-sharded batch reduces them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import get_schedule
from ..parallel.mesh import ParallelLayout, average_gradients, data_rows
from ..solvers import get_sampler
from ..solvers.amed import AMEDPredictor, _amed_family

__all__ = ["AMEDConfig", "make_amed_train_step", "predictor_from_config",
           "teacher_slice_indices"]


@dataclasses.dataclass(frozen=True)
class AMEDConfig:
    """The reference's training defaults (``amed-solver-main/train.py``),
    the fields of the JAX package's ``AMEDConfig``; saved as the JSON sidecar
    ``predictor_config.json`` that sampling restores."""

    dataset_name: str = "cifar10"
    num_steps: int = 4
    sampler_stu: str = "amed"  # amed | euler | ipndm | dpm | dpmpp
    sampler_tea: str = "heun"
    M: int = 1
    schedule_type: str = "polynomial"
    schedule_rho: float = 7.0
    afs: bool = False
    scale_dir: float = 0.01
    scale_time: float = 0.0
    max_order: int = 4
    predict_x0: bool = True
    lower_order_final: bool = True
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    guidance_type: Optional[str] = None
    guidance_rate: float = 1.0
    lr: float = 5e-3
    total_kimg: int = 10
    batch: int = 512
    # microbatch of gradient accumulation (the reference's --batch-gpu);
    # None: the whole batch at once
    batch_gpu: Optional[int] = None
    # recompute the frozen net's activations in the student backward
    # (torch.utils.checkpoint per net call) instead of storing them
    remat_traj: bool = False


def predictor_from_config(cfg: AMEDConfig, bottleneck_dim: int = 64,
                          device=None) -> AMEDPredictor:
    """An uninitialised predictor for ``cfg`` (``init_params`` or
    ``convert.load_jax_params`` fills it)."""
    return AMEDPredictor(bottleneck_input_dim=bottleneck_dim, scale_dir=cfg.scale_dir,
                         scale_time=cfg.scale_time, device=device)


def teacher_slice_indices(num_steps: int, M: int) -> list:
    """Indices of the student's knots 1..num_steps-1 in the teacher's
    trajectory of (M + 1) * (num_steps - 1) + 1 points."""
    return [i * (M + 1) for i in range(1, num_steps)]


def make_amed_train_step(predictor: AMEDPredictor, denoise_b, cfg: AMEDConfig,
                         optimizer: torch.optim.Optimizer, denoise_factory=None, layout=None):
    """The per-trajectory training step.

    denoise_b: a ``BottleneckDenoiser`` over the FROZEN pre-trained net (a
    latent tier's carries the sigma maps that its ``discrete`` schedule
    needs).
    denoise_factory: for a conditional tier, ``cond -> BottleneckDenoiser``
    bound to one microbatch's conditioning (Stable Diffusion: its text
    contexts); the step then takes them as a second argument and
    ``denoise_b`` may be None (the sigma maps are ``denoise_factory(None)``'s).
    optimizer: over ``predictor.parameters()``; stepped once per segment.
    layout: a ``parallel.mesh.ParallelLayout``: this rank trains on its data
    rows of each microbatch (every rank gets the whole batch) and the
    gradients are averaged over the data group (None: one process).
    Returns ``train_step(latents[, cond]) -> metrics``, latents ~ N(0, 1) of
    shape [batch, H, W, C], cond [batch, ...] split into microbatches as the
    latents are; metrics hold ``loss_per_step`` (a [num_steps - 1] tensor,
    each the mean over microbatches) and ``loss``, on the device.
    """
    probe = denoise_b if denoise_b is not None else denoise_factory(None)
    maps = dict(sigma_fn=probe.sigma_fn, sigma_inv_fn=probe.sigma_inv_fn)
    t_steps = get_schedule(cfg.num_steps, cfg.sigma_min, cfg.sigma_max, cfg.schedule_type,
                           cfg.schedule_rho, **maps)
    n_tea = (cfg.M + 1) * (cfg.num_steps - 1) + 1
    tea_t = get_schedule(n_tea, cfg.sigma_min, cfg.sigma_max, cfg.schedule_type,
                         cfg.schedule_rho, **maps)
    tea_idx = teacher_slice_indices(cfg.num_steps, cfg.M)
    tea_sampler = get_sampler(cfg.sampler_tea)
    single_step_stu = cfg.sampler_stu in ("euler", "dpm", "amed")
    layout = layout or ParallelLayout()
    params = [p for p in predictor.parameters() if p.requires_grad]

    @torch.no_grad()
    def teacher_traj(den, latents):
        out = tea_sampler(den, latents, tea_t, return_inters=True,
                          max_order=cfg.max_order, predict_x0=cfg.predict_x0,
                          lower_order_final=cfg.lower_order_final)
        return out.xs[tea_idx]  # [num_steps - 1, mb, ...]

    def train_step(latents, cond=None):
        batch = latents.shape[0]
        mb = cfg.batch_gpu or batch
        if batch % mb:
            raise ValueError(f"batch {batch} not divisible by batch_gpu {mb}")
        micro = data_rows(latents, mb, layout)
        if denoise_factory is None:
            dens = [denoise_b] * len(micro)
        else:
            dens = [denoise_factory(c) for c in data_rows(cond, mb, layout)]
        teas = [teacher_traj(den, lat) for den, lat in zip(dens, micro)]
        t0 = torch.tensor(t_steps[0], dtype=torch.float32, device=latents.device)
        xs = [lat * t0 for lat in micro]
        buffers = [([], []) for _ in micro]  # multistep history per microbatch
        losses = []
        for step_idx in range(cfg.num_steps - 1):
            seg_t = t_steps[step_idx: step_idx + 2]
            optimizer.zero_grad(set_to_none=True)
            seg_losses, stus = [], []
            for a, (x_in, tea) in enumerate(zip(xs, teas)):
                res, buffers[a], _ = _amed_family(
                    dens[a], predictor, x_in / float(seg_t[0]), seg_t,
                    mode=cfg.sampler_stu, afs=cfg.afs, max_order=cfg.max_order,
                    predict_x0=cfg.predict_x0, lower_order_final=cfg.lower_order_final,
                    buffer_in=buffers[a][0], buffer_t_in=buffers[a][1], train=True,
                    step_idx=step_idx, total_num_steps=cfg.num_steps, remat=cfg.remat_traj)
                loss = ((res.x - tea[step_idx]) ** 2).sum() / x_in.shape[0]
                loss.backward()  # sums into .grad across microbatches
                seg_losses.append(loss.detach())
                stus.append(res.x.detach())
            average_gradients(params, layout.data_group)
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad = torch.nan_to_num(p.grad / len(micro), nan=0.0, posinf=1e5,
                                                  neginf=-1e5)
            optimizer.step()
            losses.append(torch.stack(seg_losses).mean())
            xs = [tea[step_idx] for tea in teas] if single_step_stu else stus
        losses = torch.stack(losses)
        return {"loss_per_step": losses, "loss": losses.mean()}

    return train_step
