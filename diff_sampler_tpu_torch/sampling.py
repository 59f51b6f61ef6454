"""High-level generation API: seeds -> images.

Counterpart of ``diff_sampler_tpu/sampling.py`` on one device.  Image i is
a pure function of seed i at any batch size: each seed has its own latent
generator (and, for a class-conditional net, its own label generator), and
a short last batch is padded by repeating its last seed.  Public shapes stay
NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.precond import BoundDenoiser
from .ops import get_schedule
from .solvers import count_nfe, get_sampler
from .utils.rng import stacked_randint, stacked_randn

__all__ = ["SolverConfig", "build_sample_fn", "generate", "generate_batches", "to_uint8"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver and schedule settings: the reference's SOLVER_FLAGS,
    SCHEDULE_FLAGS and ADDITIONAL_FLAGS, as the JAX package's
    ``SolverConfig`` holds them."""

    solver: str = "heun"
    num_steps: int = 6
    schedule_type: str = "polynomial"
    schedule_rho: float = 7.0
    afs: bool = False
    denoise_to_zero: bool = False
    max_order: Optional[int] = None  # default: 4 (lms family) / 3 (dpmpp, unipc)
    predict_x0: bool = True
    lower_order_final: bool = True
    variant: str = "bh2"
    deis_mode: str = "tab"
    r: float = 0.5
    t_steps: Optional[Tuple[float, ...]] = None  # an explicit sigma schedule
    dp_list: Optional[Tuple[int, ...]] = None  # GITS sub-selection of the schedule
    # None: the model's own range.  When set they override it, as in the JAX
    # package (the reference accepts the flags and then overwrites them with
    # the net's range, MIGRATION.md).
    sigma_min: Optional[float] = None
    sigma_max: Optional[float] = None

    def resolve_t_steps(self, sigma_min: float, sigma_max: float, sigma_fn=None,
                        sigma_inv_fn=None) -> np.ndarray:
        """The sigma schedule (float64): ``t_steps`` if given, else the
        schedule over the model's range (or the ``sigma_min`` / ``sigma_max``
        override), sub-selected by ``dp_list``; the ``discrete`` schedule of
        the latent tiers needs the model's sigma maps ``sigma_fn`` /
        ``sigma_inv_fn``."""
        if self.t_steps is not None:
            return np.asarray(self.t_steps, dtype=np.float64)
        sigma_min = self.sigma_min if self.sigma_min is not None else sigma_min
        sigma_max = self.sigma_max if self.sigma_max is not None else sigma_max
        return get_schedule(self.num_steps, sigma_min, sigma_max, self.schedule_type,
                            self.schedule_rho, sigma_fn=sigma_fn, sigma_inv_fn=sigma_inv_fn,
                            dp_list=self.dp_list)

    def sampler_kwargs(self) -> dict:
        kw = dict(afs=self.afs, denoise_to_zero=self.denoise_to_zero,
                  predict_x0=self.predict_x0, lower_order_final=self.lower_order_final,
                  variant=self.variant, deis_mode=self.deis_mode, r=self.r)
        if self.max_order is not None:
            kw["max_order"] = self.max_order
        return kw

    def nfe(self, cfg_doubled: bool = False) -> int:
        """Denoiser evaluations of one run: the schedule's length is that of
        ``dp_list``, else of ``t_steps``, else ``num_steps``."""
        n = len(self.t_steps) if self.t_steps is not None else self.num_steps
        n = len(self.dp_list) if self.dp_list is not None else n
        return count_nfe(self.solver, n, self.afs, self.denoise_to_zero, cfg_doubled)


def build_sample_fn(denoise: BoundDenoiser, cfg: SolverConfig, *,
                    return_inters: bool = False) -> Callable:
    """``latents -> samples`` (f32) for a bound denoiser, on the schedule of
    ``cfg`` over its sigma range (and its sigma maps, for ``discrete``).
    With ``return_inters`` it returns the whole ``SampleResult`` (the
    trajectory ``xs`` is [num_points, B, ...])."""
    t_steps = cfg.resolve_t_steps(denoise.sigma_min, denoise.sigma_max,
                                  sigma_fn=denoise.sigma_fn, sigma_inv_fn=denoise.sigma_inv_fn)
    sampler = get_sampler(cfg.solver)
    kw = cfg.sampler_kwargs()

    @torch.no_grad()
    def fn(latents):
        out = sampler(denoise, latents, t_steps, return_inters=return_inters, **kw)
        return out if return_inters else out.x

    return fn


def _start_copy_to_host(x: torch.Tensor):
    """Enqueue the device-to-host copy of ``x`` behind the work that makes
    it; returns (host tensor, event that marks the copy done, or None)."""
    x = x.float()
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def generate(denoise: BoundDenoiser, seeds: Sequence[int], sample_shape: Tuple[int, ...],
             cfg: SolverConfig, *, max_batch_size: int = 64, device="cuda",
             label_dim: int = 0, label_kind: str = "onehot", class_idx: Optional[int] = None,
             per_seed_cond=None, return_inters: bool = False,
             batch_callback=None) -> np.ndarray:
    """Generate one sample per seed with the solver of ``cfg``,
    ``max_batch_size`` at a time (``generate_batches``).

    sample_shape: per-sample shape, e.g. (32, 32, 3) NHWC.  Returns a float32
    numpy array [len(seeds), *sample_shape]; with ``return_inters``, the
    whole trajectory [num_points, len(seeds), *sample_shape], x_T and the
    final sample included.

    The denoiser is called as ``denoise(x, t, c)``, as a ``bind``-ed
    preconditioner takes it.  For a pixel tier ``c`` is the class labels:
    None for an unconditional net (``label_dim=0``); else labels drawn per
    seed (``stacked_randint``: seed i gets the same class at any batch
    split, as the reference's ``sample.py`` and the JAX package draw them),
    or ``class_idx`` for every seed, one-hot f32 [B, label_dim] for an
    EDMPrecond (``label_kind="onehot"``) or int64 [B] for a CGPrecond
    (``label_kind="int"``).  With ``per_seed_cond`` (one
    conditioning row per seed, e.g. SD's caption contexts [len(seeds), 77,
    768], numpy or a tensor) ``c`` is each batch's rows, padded as the
    latents are (the JAX package's ``generate(per_seed_cond=...)``); a bound
    CFGPrecond takes them as its ``condition``."""
    def sample_fn(latents, labels):
        den = dataclasses.replace(denoise, fn=lambda x, t: denoise(x, t, labels))
        out = build_sample_fn(den, cfg, return_inters=return_inters)(latents)
        return out.xs if return_inters else out

    return generate_batches(sample_fn, seeds, sample_shape, max_batch_size=max_batch_size,
                            device=device, label_dim=label_dim, label_kind=label_kind,
                            class_idx=class_idx, per_seed_cond=per_seed_cond,
                            batch_callback=batch_callback)


def _labels(seeds, label_dim: int, kind: str, class_idx: Optional[int], device) -> torch.Tensor:
    """Each seed's own class, or ``class_idx`` for every seed: one-hot f32
    [len(seeds), label_dim] (``kind="onehot"``) or int64 [len(seeds)]
    (``kind="int"``)."""
    if kind not in ("onehot", "int"):
        raise ValueError(f"label_kind {kind!r}: 'onehot' or 'int'")
    if class_idx is not None:
        idx = torch.full((len(seeds),), int(class_idx), dtype=torch.int64, device=device)
    else:
        idx = stacked_randint(seeds, (), 0, label_dim, device=device)
    return idx if kind == "int" else F.one_hot(idx, label_dim).float()


def generate_batches(sample_fn: Callable, seeds: Sequence[int], sample_shape: Tuple[int, ...],
                     *, max_batch_size: int = 64, device="cuda", label_dim: int = 0,
                     label_kind: str = "onehot", class_idx: Optional[int] = None,
                     per_seed_cond=None, batch_callback=None) -> np.ndarray:
    """``sample_fn(latents, labels) -> samples`` on each batch of per-seed
    latents, ``max_batch_size`` at a time; returns [len(seeds),
    *sample_shape] f32, or [P, len(seeds), *sample_shape] where ``sample_fn``
    returns a trajectory [P, B, *sample_shape]: the chunks join along the
    batch axis.  ``labels`` is the batch's rows of ``per_seed_cond`` where
    given, else None when ``label_dim`` is 0, else the per-seed labels of
    ``generate`` (``label_kind``), padded as the latents are.

    One batch stays in flight: batch i+1 is enqueued on the device before
    the host waits for batch i, so the host's copy and ``batch_callback``
    overlap the device's work on the next batch.
    ``batch_callback(start, images)`` gets each batch in seed order with the
    padding stripped (float32 numpy); the result is the same with or
    without it.
    """
    seeds = np.asarray(list(seeds), dtype=np.int64)
    n = len(seeds)
    batch = max(1, min(max_batch_size, n))
    if per_seed_cond is not None:
        if len(per_seed_cond) != n:
            raise ValueError(f"per_seed_cond has {len(per_seed_cond)} rows for {n} seeds")
        per_seed_cond = torch.as_tensor(per_seed_cond)  # stays where it is: rows move per batch
    out = None

    def drain(pending):
        nonlocal out
        start, m, host, done = pending
        if done is not None:
            done.synchronize()
        host = host.numpy()
        lead = host.ndim - 1 - len(sample_shape)  # 1 for a trajectory, else 0
        if out is None:
            out = np.empty(host.shape[:lead] + (n,) + tuple(sample_shape), dtype=np.float32)
        rows = (slice(None),) * lead + (slice(start, start + m),)
        out[rows] = host[(slice(None),) * lead + (slice(0, m),)]
        if batch_callback is not None:
            batch_callback(start, out[rows])

    pending = None  # (start, chunk length, host tensor, copy-done event)
    for start in range(0, n, batch):
        chunk = seeds[start:start + batch]
        pad = batch - len(chunk)
        chunk_p = np.concatenate([chunk, chunk[-1:].repeat(pad)]) if pad else chunk
        latents = stacked_randn(chunk_p.tolist(), sample_shape, device=device)
        if per_seed_cond is not None:
            # rows by position in the seed list, the last one repeated as padding
            pos = np.minimum(np.arange(start, start + batch), start + len(chunk) - 1)
            labels = per_seed_cond[torch.as_tensor(pos, device=per_seed_cond.device)].to(device)
        elif label_dim:
            labels = _labels(chunk_p.tolist(), label_dim, label_kind, class_idx, device)
        else:
            labels = None
        x = sample_fn(latents, labels)
        host, done = _start_copy_to_host(x)
        if pending is not None:
            drain(pending)  # the device works on this batch meanwhile
        pending = (start, len(chunk), host, done)
    if pending is not None:
        drain(pending)
    return out if out is not None else np.empty((0,) + tuple(sample_shape), np.float32)


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> uint8 pixels, as the reference's ``sample.py`` does."""
    return np.clip(np.asarray(x) * 127.5 + 128, 0, 255).astype(np.uint8)
