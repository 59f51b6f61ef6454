"""SFD: Simple and Fast Distillation of diffusion models (NeurIPS 2024).

Counterpart of ``diff_sampler_tpu/training/sfd.py``, one call per
trajectory, with the JAX step's semantics (``sfd.py:81-200``) as a Python
loop over the segments and microbatches where the JAX package runs one
``lax.scan`` inside one jit:

  * teacher trajectory: the frozen teacher runs the fine schedule of
    (M+1)*(num_steps-1)+1 points with ``cfg.sampler_tea`` (``euler`` in the
    second stage) and ``return_inters``, sliced at the student's knots
    i*(M+1), under ``torch.no_grad``, every microbatch before the first
    segment;
  * student: one Euler step per segment [t_i -> t_{i+1}] from
    ``latents * t_steps[0]``; loss = sum|student - teacher| / microbatch;
    the next segment starts from the DETACHED student output, so each
    segment's graph is freed before the next;
  * one optimizer update per segment: the microbatches' gradients summed,
    divided by their count, ``nan_to_num(nan=0, posinf=1e5, neginf=-1e5)``;
    a trainable tensor that got no gradient takes a zero one, as every leaf
    of a JAX tree does;
  * AFS: segment 0 is ``x / sqrt(1 + t^2)``, with no update, and the
    optimizer's state (its step count included) does not advance;
  * the learning rate: ``lr_schedule(count)``, count the updates made so
    far (optax's ``count``), set on every param group before each update;
  * SFD-v: ``step_condition = float(num_steps)`` goes to the student only;
  * data parallel (``layout``): each microbatch splits contiguously over the
    data ranks, and the summed gradients are averaged over them before the
    division, as the JAX step's ``data``-sharded batch reduces them.

``torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)`` is the
update of ``optax.adam``; ``adam_count`` reads its count.

Tiers: ``make_train_step`` (a pixel-space EDM student, ``EDMPrecond``) and
``make_ldm_train_step`` (a latent LDM / SD student: the trainable latent
U-Net under the CFGPrecond math at guidance 1.0, the loss in latent space).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..models.precond import BoundDenoiser, bind
from ..ops import get_schedule
from ..parallel.mesh import ParallelLayout, average_gradients, data_rows
from ..solvers import get_sampler

__all__ = ["SFDConfig", "adam_count", "make_train_step", "make_train_step_general",
           "make_ldm_train_step", "teacher_slice_indices"]


@dataclasses.dataclass(frozen=True)
class SFDConfig:
    """Distillation hyperparameters, the JAX package's ``SFDConfig``
    (sfd-main/train.py:15-156 defaults)."""

    num_steps: int = 4
    M: int = 3
    sampler_tea: str = "dpmpp"
    schedule_type: str = "polynomial"
    schedule_rho: float = 7.0
    afs: bool = False
    max_order: int = 3
    predict_x0: bool = True
    lower_order_final: bool = True
    use_step_condition: bool = False  # SFD-v
    is_second_stage: bool = False
    sigma_min: float = 0.002
    sigma_max: float = 80.0


def teacher_slice_indices(num_steps: int, M: int) -> list:
    """Indices of the student's knots 1..num_steps-1 in the teacher's
    trajectory of (M + 1) * (num_steps - 1) + 1 points (loss.py:96-97)."""
    return [i * (M + 1) for i in range(1, num_steps)]


def adam_count(optimizer: torch.optim.Optimizer) -> int:
    """The updates an Adam optimizer has made (optax's ``count``): its first
    parameter's ``step``, 0 before the first update."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def make_train_step_general(student_denoise_fn: Callable, teacher_den_factory: Callable,
                            params: Sequence[torch.Tensor], cfg: SFDConfig,
                            optimizer: torch.optim.Optimizer, lpips_fn=None, *,
                            sigma_fn=None, sigma_inv_fn=None, n_acc: int = 1,
                            model_source: str = "edm",
                            lr_schedule: Optional[Callable[[int], float]] = None,
                            layout: Optional[ParallelLayout] = None):
    """The per-trajectory SFD training step, generic over the model tier.

    student_denoise_fn(x, t, cond) -> D_x, differentiable in ``params``;
    teacher_den_factory(cond) -> BoundDenoiser over the frozen teacher;
    params: the student's trainable tensors, which ``optimizer`` updates;
    n_acc: gradient-accumulation rounds: the batch splits into n_acc
      microbatches, whose gradients are summed before each update;
    lpips_fn: optional (a, b) -> [B] perceptual distance, its mean added to
      every element of the final segment's loss in second-stage EDM
      distillation (loss.py:87-88); no CLI passes one;
    lr_schedule: count -> learning rate (None: the optimizer's own);
    layout: a ``parallel.mesh.ParallelLayout``: this rank trains on its data
      rows of each microbatch (every rank gets the whole batch) and the
      gradients are averaged over the data group (None: one process).
    Returns ``train_step(latents, cond=None) -> metrics``: latents ~ N(0, 1)
    [B, H, W, C], scaled by ``t_steps[0]`` inside; cond the per-sample
    conditioning (one-hot labels, text contexts [B, T, D]) or None; metrics
    ``loss_per_step`` ([num_steps - 1], each the mean over microbatches) and
    ``loss``, on the device.  ``train_step.teacher_traj(latents, cond)`` is
    the teacher's trajectory at the knots, [num_steps - 1, B, ...].
    """
    maps = dict(sigma_fn=sigma_fn, sigma_inv_fn=sigma_inv_fn)
    t_steps = get_schedule(cfg.num_steps, cfg.sigma_min, cfg.sigma_max, cfg.schedule_type,
                           cfg.schedule_rho, **maps)
    n_tea = (cfg.M + 1) * (cfg.num_steps - 1) + 1
    tea_t = get_schedule(n_tea, cfg.sigma_min, cfg.sigma_max, cfg.schedule_type,
                         cfg.schedule_rho, **maps)
    tea_idx = teacher_slice_indices(cfg.num_steps, cfg.M)
    tea_sampler = get_sampler("euler" if cfg.is_second_stage else cfg.sampler_tea)
    use_lpips = cfg.is_second_stage and model_source == "edm" and lpips_fn is not None
    params = list(params)
    n_seg = cfg.num_steps - 1
    layout = layout or ParallelLayout()

    @torch.no_grad()
    def teacher_traj(latents, cond):
        out = tea_sampler(teacher_den_factory(cond), latents, tea_t, return_inters=True,
                          max_order=cfg.max_order, predict_x0=cfg.predict_x0,
                          lower_order_final=cfg.lower_order_final)
        return out.xs[tea_idx]  # [num_steps - 1, mb, ...]

    def seg_loss(x, tc, tn, afs, tea, is_last, cond):
        if afs:
            d = x / torch.sqrt(1.0 + tc ** 2)
        else:
            d = (x - student_denoise_fn(x, tc, cond)) / tc
        stu = x + (tn - tc) * d
        elem = (stu - tea).abs()
        if use_lpips and is_last:
            elem = elem + lpips_fn(stu, tea).mean()
        return elem.sum() / x.shape[0], stu

    def train_step(latents, cond=None):
        batch = latents.shape[0]
        if batch % n_acc:
            raise ValueError(f"batch {batch} not divisible by n_acc {n_acc}")
        mb = batch // n_acc
        lats = data_rows(latents, mb, layout)
        conds = [None] * n_acc if cond is None else data_rows(cond, mb, layout)
        teas = [teacher_traj(lat, c) for lat, c in zip(lats, conds)]
        f32 = dict(dtype=torch.float32, device=latents.device)
        ts = torch.tensor(t_steps, **f32)
        xs = [lat * ts[0] for lat in lats]
        losses = []
        for i in range(n_seg):
            tc, tn = ts[i], ts[i + 1]
            afs = cfg.afs and i == 0
            seg_losses, stus = [], []
            for a in range(n_acc):
                with torch.set_grad_enabled(not afs):
                    loss, stu = seg_loss(xs[a], tc, tn, afs, teas[a][i], i == n_seg - 1,
                                         conds[a])
                if not afs:
                    loss.backward()  # sums into .grad across microbatches
                seg_losses.append(loss.detach())
                stus.append(stu.detach())
            if not afs:
                # AFS's segment has no gradient path: no update, and the
                # optimizer's state stays as it is (training_loop.py:282,291)
                with torch.no_grad():
                    for p in params:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                    average_gradients(params, layout.data_group)
                    for p in params:
                        p.grad = torch.nan_to_num(p.grad / n_acc, nan=0.0, posinf=1e5,
                                                  neginf=-1e5)
                if lr_schedule is not None:
                    lr = lr_schedule(adam_count(optimizer))
                    for group in optimizer.param_groups:
                        group["lr"] = lr
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
            losses.append(torch.stack(seg_losses).mean())
            xs = stus
        losses = torch.stack(losses)
        return {"loss_per_step": losses, "loss": losses.mean()}

    train_step.teacher_traj = teacher_traj
    return train_step


def trainable(module: torch.nn.Module) -> list:
    """The parameters of ``module`` that require a gradient."""
    return [p for p in module.parameters() if p.requires_grad]


def _check_eval(*modules) -> None:
    """The student and the teacher run deterministic, as the JAX step runs
    them: a module in train mode (dropout on) is refused, as ``bind``
    refuses one."""
    if any(m.training for m in modules):
        raise ValueError("the SFD train step needs the student and the teacher in eval mode "
                         "(dropout off): call .eval() first")


def make_train_step(student, teacher, cfg: SFDConfig, optimizer: torch.optim.Optimizer,
                    lpips_fn=None, n_acc: int = 1, lr_schedule=None, layout=None):
    """Pixel-space EDM student: ``student`` and ``teacher`` are EDMPreconds
    of one architecture, the teacher a frozen copy (training_loop.py:187),
    both in eval mode (dropout off, as the JAX step runs them
    deterministic).  With ``cfg.use_step_condition`` the student gets
    ``step_condition = float(cfg.num_steps)``, the teacher none.  The
    optimizer updates the student's trainable parameters.

    Returns ``train_step(latents, labels=None) -> metrics``."""
    _check_eval(student, teacher)
    step_cond = float(cfg.num_steps) if cfg.use_step_condition else None

    def student_denoise(x, t, labels):
        return student(x, t, labels, step_condition=step_cond)

    return make_train_step_general(student_denoise, lambda labels: bind(teacher,
                                                                        class_labels=labels),
                                   trainable(student), cfg, optimizer, lpips_fn, n_acc=n_acc,
                                   model_source="edm", lr_schedule=lr_schedule, layout=layout)


def make_ldm_train_step(student_unet, teacher_unet, precond, cfg: SFDConfig,
                        optimizer: torch.optim.Optimizer, n_acc: int = 1, lr_schedule=None,
                        layout=None):
    """Latent LDM / SD student (sfd training_loop.py:85-110): the trainable
    latent U-Net ``student_unet`` under the CFGPrecond math of ``precond``
    (its discrete sigma maps and narrowed sigma_min / sigma_max), at
    guidance_rate 1.0 whatever the sampling rate (training_loop.py:185), so
    the batch is never doubled and no unconditional context is used; the
    teacher is the frozen ``teacher_unet``.  The schedule's range is
    precond's (``cfg.sigma_min`` / ``sigma_max`` are replaced by it).

    Returns ``train_step(latents, context=None) -> metrics``, latents
    [B, res, res, z_channels], context [B, T, D] or None; the loss lives in
    latent space."""
    _check_eval(student_unet, teacher_unet)
    train_precond = dataclasses.replace(precond, guidance_rate=1.0)
    # replace() reruns __post_init__, which resets the sigma range: restore
    # the narrowed one (the factory sets sigma_min 0.1 for ms_coco)
    train_precond.sigma_min = precond.sigma_min
    train_precond.sigma_max = precond.sigma_max
    cfg = dataclasses.replace(cfg, sigma_min=float(train_precond.sigma_min),
                              sigma_max=float(train_precond.sigma_max))

    def apply(unet):
        return lambda xs, ts, cs: unet(xs, ts) if cs is None else unet(xs, ts, cs)

    def student_denoise(x, t, context):
        return train_precond.denoise_with(apply(student_unet), x, t, condition=context)

    def teacher_factory(context):
        def fn(x, t):
            return train_precond.denoise_with(apply(teacher_unet), x, t, condition=context)

        return BoundDenoiser(fn, train_precond.sigma_min, train_precond.sigma_max)

    return make_train_step_general(
        student_denoise, teacher_factory, trainable(student_unet), cfg, optimizer,
        sigma_fn=train_precond.sigma, sigma_inv_fn=train_precond.sigma_inv, n_acc=n_acc,
        model_source="ldm", lr_schedule=lr_schedule, layout=layout)
