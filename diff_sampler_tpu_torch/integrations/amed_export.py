"""Export a trained AMED predictor as static per-step schedules.

Counterpart of ``diff_sampler_tpu/integrations/amed_export.py``.  The
reference ships a diffusers ``DPMSolverMultistepScheduler`` subclass that
consumes AMED r / scale lists for SD / SDXL
(``amed-solver-main/diffusers_amed_plugin_dpmpp.py:27-439``).  The port
samples with the predictor in the loop (``solvers/amed.py``); this exporter
distils the predictor's outputs into the interleaved timestep list and the
scale_dirs / scale_times the plugin expects (set_timesteps semantics: the
odd entries are the AMED-inserted midpoints), so diffusers users can run a
predictor trained here.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import get_schedule
from ..solvers.amed import _amed_family
from ..utils.rng import stacked_randn

__all__ = ["export_amed_schedule", "save_amed_schedule"]


@torch.no_grad()
def export_amed_schedule(predictor, denoise_b, sample_shape, num_steps: int,
                         sigma_min: float, sigma_max: float, *,
                         schedule_type: str = "polynomial", schedule_rho: float = 7.0,
                         alphas_cumprod: Optional[np.ndarray] = None,
                         seeds: Sequence[int] = range(16), device="cuda") -> Dict:
    """Run the AMED sampler over a probe batch (``seeds``) and average the
    predictor's outputs per step.

    ``predictor(bottleneck, t_cur, t_next) -> (r, scale_dir, scale_time)``
    (an ``AMEDPredictor``); ``denoise_b`` a ``BottleneckDenoiser``.  Returns
    {sigmas, r, scale_dir, scale_time, t_mid, num_steps, schedule_type,
    schedule_rho, scale_dirs_interleaved, scale_times_interleaved,
    timesteps?}: sigmas is the base schedule, t_mid the learned midpoints;
    with ``alphas_cumprod`` (a discrete model's table) ``timesteps`` is the
    interleaved 2N-1 index list of the reference's diffusers plugin.
    """
    t_steps = get_schedule(num_steps, sigma_min, sigma_max, schedule_type, schedule_rho)
    latents = stacked_randn(list(seeds), tuple(sample_shape), device=device)

    rs, sds, sts = [], [], []
    x = latents * float(t_steps[0])
    for i in range(num_steps - 1):
        seg = t_steps[i:i + 2]
        res, _buffers, (r, sd, st) = _amed_family(
            denoise_b, predictor, x / float(seg[0]), seg, mode="amed", train=True,
            step_idx=i, total_num_steps=num_steps)
        x = res.x
        rs.append(float(r.mean()))
        sds.append(float(sd.mean()))
        sts.append(float(st.mean()))

    t = np.asarray(t_steps)
    r = np.asarray(rs)
    t_mid = t[1:] ** r * t[:-1] ** (1.0 - r)
    out = dict(sigmas=t.tolist(), r=r.tolist(), scale_dir=sds, scale_time=sts,
               t_mid=t_mid.tolist(), num_steps=num_steps, schedule_type=schedule_type,
               schedule_rho=schedule_rho)

    # Interleaved per-step lists in the plugin's indexing: the scheduler
    # applies scale_dirs[step_index] at EVERY interleaved step and shifts the
    # odd-indexed eval times by scale_times (diffusers_amed_plugin_dpmpp.py
    # :54-58, :433).  The even entries (the base schedule's steps) are 1.
    n_inter = 2 * (num_steps - 1) + 1
    sd_inter = np.ones(n_inter)
    st_inter = np.ones(n_inter)
    sd_inter[1::2] = np.asarray(sds)
    st_inter[1::2] = np.asarray(sts)
    out["scale_dirs_interleaved"] = sd_inter.tolist()
    out["scale_times_interleaved"] = st_inter.tolist()

    if alphas_cumprod is not None:
        # interleave (t_i, t_mid_i) and map each to the nearest discrete index
        all_sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
        inter = np.empty(n_inter)
        inter[0::2] = t
        inter[1::2] = t_mid
        out["timesteps"] = [int(np.abs(all_sigmas - s).argmin()) for s in inter]
    return out


def save_amed_schedule(path: str, schedule: Dict) -> None:
    with open(path, "w") as f:
        json.dump(schedule, f, indent=2)
