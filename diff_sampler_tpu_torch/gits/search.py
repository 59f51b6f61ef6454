"""GITS: the DP search for a sampling schedule (Chen et al., ICML 2024).

Counterpart of ``diff_sampler_tpu/gits/search.py``:

  * the teacher's trajectory and gradients from one sampler run with
    ``return_inters`` on a fine schedule, over batches of warmup latents;
  * cost[i, j]: the batch mean error of one Euler jump i -> j against the
    teacher's state at j, one row of all j at a time on the device,
    averaged over the warmup batches (float64 on the host);
  * the DP shortest path and its backtracking on the host (numpy, the JAX
    package's code as it is, so the two agree bit for bit on one matrix);
  * with AFS, the insertion search: try each free first step, keep the
    schedule whose student lands nearest the teacher (mean L2).

The JAX package's ``jit_params`` / ``bind_params`` route a big frozen net
through its TPU compile service; PyTorch runs eagerly, so they have no
counterpart here.  Warmup latents come from the port's ``stacked_randn``:
the same seeds give PyTorch's numbers, not JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.precond import BoundDenoiser
from ..ops import get_schedule, multistep
from ..ops.geometry import trajectory_deviation
from ..solvers import get_sampler
from ..solvers.samplers import _lms_sample
from ..utils.rng import stacked_randn

__all__ = ["GITSConfig", "compute_cost_matrix", "dp_search", "dp_search_multi",
           "gits_schedule"]


@dataclasses.dataclass(frozen=True)
class GITSConfig:
    """The reference CLI's GITS_FLAGS (``gits-main/sample.py:159-166``)."""

    num_steps: int = 6  # student schedule length (num_steps - 1 jumps)
    num_steps_tea: int = 61
    num_warmup: int = 256
    solver_tea: str = "ipndm"
    solver: str = "ipndm"
    metric: str = "dev"  # l1 | l2 | dev
    coeff: float = 1.15
    schedule_type: str = "polynomial"
    schedule_rho: float = 7.0
    max_order: int = 4
    afs: bool = False
    batch_size: int = 64


def compute_cost_matrix(traj: torch.Tensor, eps: torch.Tensor, t_steps,
                        metric: str) -> torch.Tensor:
    """cost[i, j] (j > i, else 0): the batch mean error of the Euler jump
    i -> j.  traj: [N, B, ...] teacher states (traj[0] the initial x);
    eps: [N-1, B, ...] the teacher's gradient d_i at each state."""
    if metric not in ("l1", "l2", "dev"):
        raise NotImplementedError(f"Unknown metric: {metric}")
    n, b = traj.shape[:2]
    t = torch.as_tensor(np.asarray(t_steps), dtype=traj.dtype, device=traj.device)
    flat = traj.reshape(n, b, -1)
    idx = torch.arange(n, device=traj.device)
    if metric == "dev":
        dev_tea = trajectory_deviation(traj).mean(dim=0)  # [N-2]
        dev_tea = torch.cat([dev_tea, dev_tea.new_zeros(1)])  # [N-1]
        # the teacher's deviation at j - 1 (clamped; row i masks j <= i)
        dev_prev = dev_tea[(idx - 1).clamp(0, n - 2)][:, None]
        start, end = flat[0], flat[-1]  # [B, D]
        bc = end - start
        bc_unit = bc / torch.linalg.vector_norm(bc, dim=-1, keepdim=True)
    rows = []
    for i in range(n - 1):
        # x_next[j] = x_i + (t_j - t_i) d_i, every j at once
        dt = (t - t[i]).reshape(n, 1, 1)
        x_next = flat[i][None] + dt * eps[i].reshape(1, b, -1)  # [N, B, D]
        if metric == "l1":
            c = (x_next - flat).abs().sum(dim=-1).mean(dim=-1)
        elif metric == "l2":
            c = torch.linalg.vector_norm(x_next - flat, dim=-1).mean(dim=-1)
        else:
            # deviation of x_next[j] from the line start -> end, less the
            # teacher's deviation at j
            ac = end[None] - x_next
            proj = (ac * bc_unit).sum(dim=-1, keepdim=True) * bc_unit
            dev_stu = torch.linalg.vector_norm(ac - proj, dim=-1)  # [N, B]
            c = (dev_stu - dev_prev).mean(dim=-1)
        rows.append(torch.where(idx > i, c, torch.zeros_like(c)))
    rows.append(traj.new_zeros(n))
    return torch.stack(rows)


def dp_search(cost_mat: np.ndarray, num_steps: int, num_steps_tea: int,
              coeff: float) -> list:
    """DP shortest path V[j][k] = min_i cost[j][i] + coeff * V[i][k-1] with
    first-match backtracking (``gits_utils.py:185-212``)."""
    K = num_steps - 1
    V = np.full((num_steps_tea, K + 1), np.inf)
    for i in range(num_steps_tea):
        V[i][1] = cost_mat[i][-1]
    for k in range(2, K + 1):
        for j in range(num_steps_tea - 1):
            for i in range(j + 1, num_steps_tea - 1):
                V[j][k] = min(V[j][k], cost_mat[j][i] + coeff * V[i][k - 1])
    phi, w = [0], 0
    for temp in range(K):
        k = K - temp
        for j in range(w + 1, num_steps_tea):
            if V[w][k] == cost_mat[w][j] + coeff * V[j][k - 1]:
                phi.append(j)
                w = j
                break
    phi.append(num_steps_tea - 1)
    return phi


def dp_search_multi(cost_mat: np.ndarray, num_steps: int, num_steps_tea: int,
                    coeffs: Sequence[float] = (0.8, 0.85, 0.9, 0.95, 1.0, 1.05,
                                               1.10, 1.15, 1.2),
                    dump_path: Optional[str] = None, desc: str = "",
                    t_steps: Optional[np.ndarray] = None) -> dict:
    """The DP at several coefficients and lengths, {(coeff, K): phi} (the
    reference's ``dp_record.txt``, ``gits_utils.py:214-231``); with
    ``dump_path``, appends the schedules to that file in its format."""
    out = {}
    for coeff in coeffs:
        for K_temp in range(2, num_steps):
            out[(coeff, K_temp)] = dp_search(cost_mat, K_temp + 1, num_steps_tea, coeff)
    if dump_path is not None:
        with open(dump_path, "a") as f:
            for coeff in coeffs:
                f.write(f"{desc}-{coeff}\n")
                for K_temp in range(2, num_steps):
                    phi = out[(coeff, K_temp)]
                    if t_steps is not None:
                        f.write(f"{phi} {[round(float(t_steps[i]), 4) for i in phi]}\n")
                    else:
                        f.write(f"{phi}\n")
    return out


def _student(cfg: GITSConfig, den):
    """``(latents, t_cand) -> x`` of the student under AFS, for the
    insertion search: the LMS family through ``_lms_sample`` with its
    coefficient stack, dpmpp / unipc with their coefficients handed in
    (order at most 3), any other solver as registered."""
    lms = {"euler": lambda t: multistep.euler_coeffs(t),
           "ipndm": lambda t: multistep.ipndm_coeffs(t, cfg.max_order),
           "ipndm_v": lambda t: multistep.ipndm_v_coeffs(t, cfg.max_order),
           "deis": lambda t: multistep.deis_coeffs(t, cfg.max_order)}
    if cfg.solver in lms:
        return lambda lat, t: _lms_sample(den, lat, t, lms[cfg.solver](t), afs=True).x
    stu = get_sampler(cfg.solver)
    if cfg.solver in ("dpmpp", "unipc"):
        # dpmpp / unipc cap at order 3 (gits sample.py:142); GITSConfig's
        # default 4 is the LMS family's
        mo = min(cfg.max_order or 3, 3)
        coeff_fn = multistep.dpm_pp_coeffs if cfg.solver == "dpmpp" else multistep.unipc_coeffs
        return lambda lat, t: stu(den, lat, t, afs=True, max_order=mo,
                                  coeffs=coeff_fn(t, mo)).x
    return lambda lat, t: stu(den, lat, t, afs=True, max_order=cfg.max_order).x


@torch.no_grad()
def gits_schedule(denoise, sample_shape: Tuple[int, ...], cfg: GITSConfig, *,
                  seeds: Optional[Sequence[int]] = None, sigma_fn=None, sigma_inv_fn=None,
                  per_seed_cond: Optional[np.ndarray] = None, denoise_with_cond=None,
                  return_cost: bool = False, device="cuda"):
    """The whole GITS search; returns (dp_list, t_steps[dp_list]) (and the
    averaged cost matrix with ``return_cost``).

    denoise: a bound denoiser; its ``sigma_fn`` / ``sigma_inv_fn`` serve the
    ``discrete`` schedule unless given here.  sample_shape: per-sample NHWC.
    Warmup seeds default to 0 .. num_warmup - 1, ``cfg.batch_size`` at a
    time.  A conditioned model (SD captions) takes ``per_seed_cond`` (one
    row per warmup seed) and ``denoise_with_cond(x, t, c)``: each warmup
    batch then runs on its own rows."""
    sigma_fn = sigma_fn if sigma_fn is not None else getattr(denoise, "sigma_fn", None)
    sigma_inv_fn = (sigma_inv_fn if sigma_inv_fn is not None
                    else getattr(denoise, "sigma_inv_fn", None))
    t_full = get_schedule(cfg.num_steps_tea, denoise.sigma_min, denoise.sigma_max,
                          cfg.schedule_type, cfg.schedule_rho, sigma_fn=sigma_fn,
                          sigma_inv_fn=sigma_inv_fn)
    tea = get_sampler(cfg.solver_tea)
    seeds = np.asarray(list(range(cfg.num_warmup) if seeds is None else seeds), np.int64)
    conditioned = per_seed_cond is not None and denoise_with_cond is not None

    def den_for(c):
        if c is None:
            return denoise
        return BoundDenoiser(lambda x, t: denoise_with_cond(x, t, c), denoise.sigma_min,
                             denoise.sigma_max, sigma_fn, sigma_inv_fn)

    cost_sum = np.zeros((cfg.num_steps_tea, cfg.num_steps_tea))
    rounds = 0
    latents = cond = terminal = None
    for start in range(0, len(seeds), cfg.batch_size):
        chunk = seeds[start:start + cfg.batch_size]
        latents = stacked_randn(chunk.tolist(), sample_shape, device=device)
        if conditioned:
            cond = torch.as_tensor(per_seed_cond[start:start + len(chunk)], device=device)
        out = tea(den_for(cond), latents, t_full, return_inters=True, max_order=cfg.max_order)
        cost = compute_cost_matrix(out.xs, out.eps, t_full, cfg.metric)
        cost_sum += cost.double().cpu().numpy()
        terminal = out.xs[-1]
        rounds += 1
        del out
    cost_mat = cost_sum / rounds

    phi = dp_search(cost_mat, cfg.num_steps, cfg.num_steps_tea, cfg.coeff)
    dp_list = phi
    if cfg.afs:
        # the insertion search on the last warmup batch and its conditioning
        student = _student(cfg, den_for(cond))
        best = np.inf
        for k in range(1, phi[1]):
            cand = phi[:1] + [k] + phi[1:]
            x = student(latents, t_full[np.asarray(cand)])
            d = torch.linalg.vector_norm((x - terminal).reshape(x.shape[0], -1),
                                         dim=-1).mean().item()
            if d < best:
                best = d
                dp_list = cand

    t_steps = t_full[np.asarray(dp_list)]
    if return_cost:
        return dp_list, t_steps, cost_mat
    return dp_list, t_steps
