"""Host-side coefficient precompute for every multistep ODE solver.

The port's own copy of ``diff_sampler_tpu/ops/multistep.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_schedules.py`` holds
the two bit for bit.  The reference computes these quantities step by step
inside its Python sampling loops (`diff-solvers-main/solvers.py`,
`solver_utils.py`); every per-step scalar is a pure function of the sigma
schedule, so the full coefficient tables are computed once on the host in
float64 and the samplers read them as Python floats.

Covered solvers and their reference sources:
  * Euler / iPNDM / iPNDM_v / DEIS -> one "eps-space linear multistep" family
    with a coefficient matrix C[N,4]:
        x_{i+1} = x_i + C[i,0]*d_i + C[i,1]*d_{i-1} + C[i,2]*d_{i-2} + C[i,3]*d_{i-3}
    - Euler: C[i] = [h_i, 0, 0, 0]                      (solvers.py:19-96)
    - iPNDM: fixed Adams-Bashforth weights * h_i        (solvers.py:278-374)
    - iPNDM_v: variable-step AB weights * h_i           (solvers.py:379-499)
    - DEIS (tab / rhoab): exp-integrator coefficients   (solver_utils.py:297-400)
  * DPM-Solver++(multistep): per-step (A, B[3]) such that
        x_{i+1} = A[i]*x_i + B[i,0]*m_i + B[i,1]*m_{i-1} + B[i,2]*m_{i-2}
    where m is the (optionally dynamically-thresholded) denoised prediction
    (predict_x0=True) or the eps prediction (predict_x0=False).
    (solver_utils.py:90-163)
  * UniPC: per-step scalars (alpha, h_phi_1, B_h, rks, rhos_p, rhos_c,
    order, use_corrector).                              (solver_utils.py:174-287)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .schedules import vp_params, vp_sigma_inv

__all__ = [
    "MAX_LMS_ORDER",
    "euler_coeffs",
    "ipndm_coeffs",
    "ipndm_v_coeffs",
    "deis_coeffs",
    "DpmPpCoeffs",
    "dpm_pp_coeffs",
    "UniPCCoeffs",
    "unipc_coeffs",
]

MAX_LMS_ORDER = 4


# ---------------------------------------------------------------------------
# eps-space linear multistep family: x += sum_k C[i,k] * d_{i-k}
# ---------------------------------------------------------------------------


def euler_coeffs(t_steps: np.ndarray) -> np.ndarray:
    t = np.asarray(t_steps, dtype=np.float64)
    n = len(t) - 1
    C = np.zeros((n, MAX_LMS_ORDER), dtype=np.float64)
    C[:, 0] = t[1:] - t[:-1]
    return C


# Fixed Adams-Bashforth weights, orders 1..4 (solvers.py:345-352).
_AB_FIXED = [
    np.array([1.0]),
    np.array([3.0, -1.0]) / 2.0,
    np.array([23.0, -16.0, 5.0]) / 12.0,
    np.array([55.0, -59.0, 37.0, -9.0]) / 24.0,
]


def ipndm_coeffs(t_steps: np.ndarray, max_order: int = 4) -> np.ndarray:
    assert 1 <= max_order <= 4
    t = np.asarray(t_steps, dtype=np.float64)
    n = len(t) - 1
    C = np.zeros((n, MAX_LMS_ORDER), dtype=np.float64)
    for i in range(n):
        order = min(max_order, i + 1)
        h = t[i + 1] - t[i]
        C[i, :order] = h * _AB_FIXED[order - 1]
    return C


def _ipndm_v_row(t: np.ndarray, i: int, order: int) -> np.ndarray:
    """Variable-step AB weights for one step (solvers.py:447-477)."""
    h_n = t[i + 1] - t[i]
    out = np.zeros(MAX_LMS_ORDER, dtype=np.float64)
    if order == 1:
        out[0] = 1.0
        return out
    h_n_1 = t[i] - t[i - 1]
    if order == 2:
        out[0] = (2.0 + h_n / h_n_1) / 2.0
        out[1] = -(h_n / h_n_1) / 2.0
        return out
    h_n_2 = t[i - 1] - t[i - 2]
    if order == 3:
        temp = (
            1.0
            - h_n / (3.0 * (h_n + h_n_1)) * (h_n * (h_n + h_n_1)) / (h_n_1 * (h_n_1 + h_n_2))
        ) / 2.0
        out[0] = (2.0 + h_n / h_n_1) / 2.0 + temp
        out[1] = -(h_n / h_n_1) / 2.0 - (1.0 + h_n_1 / h_n_2) * temp
        out[2] = temp * h_n_1 / h_n_2
        return out
    h_n_3 = t[i - 2] - t[i - 3]
    temp1 = (
        1.0 - h_n / (3.0 * (h_n + h_n_1)) * (h_n * (h_n + h_n_1)) / (h_n_1 * (h_n_1 + h_n_2))
    ) / 2.0
    temp2 = (
        (1.0 - h_n / (3.0 * (h_n + h_n_1))) / 2.0
        + (1.0 - h_n / (2.0 * (h_n + h_n_1))) * h_n / (6.0 * (h_n + h_n_1 + h_n_2))
    ) * (
        (h_n * (h_n + h_n_1) * (h_n + h_n_1 + h_n_2))
        / (h_n_1 * (h_n_1 + h_n_2) * (h_n_1 + h_n_2 + h_n_3))
    )
    out[0] = (2.0 + h_n / h_n_1) / 2.0 + temp1 + temp2
    out[1] = (
        -(h_n / h_n_1) / 2.0
        - (1.0 + h_n_1 / h_n_2) * temp1
        - (1.0 + h_n_1 / h_n_2 + h_n_1 * (h_n_1 + h_n_2) / (h_n_2 * (h_n_2 + h_n_3))) * temp2
    )
    out[2] = temp1 * h_n_1 / h_n_2 + (
        h_n_1 / h_n_2
        + h_n_1 * (h_n_1 + h_n_2) / (h_n_2 * (h_n_2 + h_n_3)) * (1.0 + h_n_2 / h_n_3)
    ) * temp2
    out[3] = -temp2 * (h_n_1 * (h_n_1 + h_n_2) / (h_n_2 * (h_n_2 + h_n_3))) * h_n_1 / h_n_2
    return out


def ipndm_v_coeffs(t_steps: np.ndarray, max_order: int = 4) -> np.ndarray:
    assert 1 <= max_order <= 4
    t = np.asarray(t_steps, dtype=np.float64)
    n = len(t) - 1
    C = np.zeros((n, MAX_LMS_ORDER), dtype=np.float64)
    for i in range(n):
        order = min(max_order, i + 1)
        h = t[i + 1] - t[i]
        C[i] = h * _ipndm_v_row(t, i, order)
    return C


# --- DEIS (solver_utils.py:297-400) ----------------------------------------


def _edm2t(edm_steps: np.ndarray, epsilon_s=1e-3, sigma_min=0.002, sigma_max=80.0):
    beta_d, beta_min = vp_params(sigma_min, sigma_max, epsilon_s)
    t = vp_sigma_inv(beta_d, beta_min, np.asarray(edm_steps, dtype=np.float64))
    return t, beta_min, beta_d + beta_min


def _cal_poly(prev_t: np.ndarray, j: int, taus: np.ndarray) -> np.ndarray:
    poly = np.ones_like(taus)
    for k in range(prev_t.shape[0]):
        if k == j:
            continue
        poly = poly * (taus - prev_t[k]) / (prev_t[j] - prev_t[k])
    return poly


def _deis_integrand(beta_0: float, beta_1: float, taus: np.ndarray) -> np.ndarray:
    # alpha(t) = exp(-0.5 t^2 (b1-b0) - t b0); the reference differentiates
    # log(alpha) with autograd (solver_utils.py:323-331) -- here we use the
    # closed form d(log alpha)/dt = -t (b1-b0) - b0.
    log_alpha = -0.5 * taus**2 * (beta_1 - beta_0) - taus * beta_0
    alpha = np.exp(log_alpha)
    d_log_alpha = -taus * (beta_1 - beta_0) - beta_0
    return -0.5 * d_log_alpha / np.sqrt(alpha * (1.0 - alpha))


def deis_coeffs(
    t_steps: np.ndarray, max_order: int = 4, N: int = 10000, deis_mode: str = "tab"
) -> np.ndarray:
    """DEIS coefficient matrix C[N-1, 4] in the eps-space LMS form."""
    assert 1 <= max_order <= 4
    t_edm = np.asarray(t_steps, dtype=np.float64)
    n = len(t_edm) - 1
    C = np.zeros((n, MAX_LMS_ORDER), dtype=np.float64)

    if deis_mode == "tab":
        t, beta_0, beta_1 = _edm2t(t_edm)
        for i in range(n):
            order = min(i + 1, max_order)
            if order == 1:
                C[i, 0] = t_edm[i + 1] - t_edm[i]  # first Euler step (solvers.py:575-576)
                continue
            t_cur, t_next = t[i], t[i + 1]
            taus = np.linspace(t_cur, t_next, N)
            dtau = (t_next - t_cur) / N
            prev_t = t[[i - k for k in range(order)]]
            integrand = _deis_integrand(beta_0, beta_1, taus)
            for j in range(order):
                C[i, j] = np.sum(integrand * _cal_poly(prev_t, j, taus)) * dtau
    elif deis_mode == "rhoab":
        t = t_edm

        def int2(a, b, start, end, c):
            coeff = (
                (end**3 - start**3) / 3
                - (end**2 - start**2) * (a + b) / 2
                + (end - start) * a * b
            )
            return coeff / ((c - a) * (c - b))

        def int3(a, b, c, start, end, d):
            coeff = (
                (end**4 - start**4) / 4
                - (end**3 - start**3) * (a + b + c) / 3
                + (end**2 - start**2) * (a * b + a * c + b * c) / 2
                - (end - start) * a * b * c
            )
            return coeff / ((d - a) * (d - b) * (d - c))

        for i in range(n):
            order = min(i, max_order)
            t_cur, t_next = t[i], t[i + 1]
            if order == 0:
                C[i, 0] = t_next - t_cur
                continue
            prev = t[[i - k for k in range(order + 1)]]
            if order == 1:
                C[i, 0] = ((t_next - prev[1]) ** 2 - (t_cur - prev[1]) ** 2) / (
                    2 * (t_cur - prev[1])
                )
                C[i, 1] = (t_next - t_cur) ** 2 / (2 * (prev[1] - t_cur))
            elif order == 2:
                C[i, 0] = int2(prev[1], prev[2], t_cur, t_next, t_cur)
                C[i, 1] = int2(t_cur, prev[2], t_cur, t_next, prev[1])
                C[i, 2] = int2(t_cur, prev[1], t_cur, t_next, prev[2])
            else:
                C[i, 0] = int3(prev[1], prev[2], prev[3], t_cur, t_next, t_cur)
                C[i, 1] = int3(t_cur, prev[2], prev[3], t_cur, t_next, prev[1])
                C[i, 2] = int3(t_cur, prev[1], prev[3], t_cur, t_next, prev[2])
                C[i, 3] = int3(t_cur, prev[1], prev[2], t_cur, t_next, prev[3])
    else:
        raise ValueError(f"unknown deis_mode {deis_mode}")
    return C


# ---------------------------------------------------------------------------
# DPM-Solver++ multistep (solver_utils.py:90-163)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DpmPpCoeffs:
    """x_{i+1} = A[i]*x_i + B[i,0]*m_i + B[i,1]*m_{i-1} + B[i,2]*m_{i-2}."""

    A: np.ndarray  # [N-1]
    B: np.ndarray  # [N-1, 3]


def _dpm_pp_row(t_hist: np.ndarray, t_next: float, order: int, predict_x0: bool):
    """Coefficients for one multistep DPM-Solver++ update.

    t_hist: times of the buffered model outputs, most recent first
            (t_hist[0] = t_prev_0 = current step time).
    """
    lam = -np.log(np.concatenate([[t_next], t_hist[:order]]))
    lam_t, lam0 = lam[0], lam[1]
    h = lam_t - lam0
    t = t_next
    b = np.zeros(3, dtype=np.float64)
    if predict_x0:
        phi_1 = np.expm1(-h)
        A = t / t_hist[0]
        if order == 1:
            b[0] = -phi_1
        elif order == 2:
            r0 = (lam0 - lam[2]) / h
            b[0] = -phi_1 * (1.0 + 0.5 / r0)
            b[1] = phi_1 * 0.5 / r0
        else:
            r0 = (lam0 - lam[2]) / h
            r1 = (lam[2] - lam[3]) / h
            c0, c1 = 1.0 / r0, 1.0 / r1
            w = r0 / (r0 + r1)
            v = 1.0 / (r0 + r1)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            b[0] = -phi_1 + phi_2 * (1.0 + w) * c0 - phi_3 * v * c0
            b[1] = -phi_2 * ((1.0 + w) * c0 + w * c1) + phi_3 * v * (c0 + c1)
            b[2] = phi_2 * w * c1 - phi_3 * v * c1
    else:
        phi_1 = np.expm1(h)
        A = 1.0
        if order == 1:
            b[0] = -t * phi_1
        elif order == 2:
            r0 = (lam0 - lam[2]) / h
            b[0] = -t * phi_1 * (1.0 + 0.5 / r0)
            b[1] = t * phi_1 * 0.5 / r0
        else:
            r0 = (lam0 - lam[2]) / h
            r1 = (lam[2] - lam[3]) / h
            c0, c1 = 1.0 / r0, 1.0 / r1
            w = r0 / (r0 + r1)
            v = 1.0 / (r0 + r1)
            phi_2 = phi_1 / h - 1.0
            phi_3 = phi_2 / h - 0.5
            b[0] = -t * (phi_1 + phi_2 * (1.0 + w) * c0 + phi_3 * v * c0)
            b[1] = t * (phi_2 * ((1.0 + w) * c0 + w * c1) + phi_3 * v * (c0 + c1))
            b[2] = -t * (phi_2 * w * c1 + phi_3 * v * c1)
    return A, b


def dpm_pp_coeffs(
    t_steps: np.ndarray,
    max_order: int = 3,
    predict_x0: bool = True,
    lower_order_final: bool = True,
) -> DpmPpCoeffs:
    assert 1 <= max_order <= 3
    t = np.asarray(t_steps, dtype=np.float64)
    num_steps = len(t)
    n = num_steps - 1
    A = np.zeros(n, dtype=np.float64)
    B = np.zeros((n, 3), dtype=np.float64)
    for i in range(n):
        if lower_order_final:
            order = i + 1 if i + 1 < max_order else min(max_order, num_steps - (i + 1))
        else:
            order = min(max_order, i + 1)
        # Buffered model-output times, most recent first: t_i, t_{i-1}, ...
        t_hist = t[max(0, i - 2) : i + 1][::-1]
        A[i], B[i] = _dpm_pp_row(t_hist, t[i + 1], order, predict_x0)
    return DpmPpCoeffs(A=A, B=B)


# ---------------------------------------------------------------------------
# UniPC (solver_utils.py:174-287)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UniPCCoeffs:
    """Per-step scalars for the UniPC predictor-corrector sampler.

    Buffer convention: buf[0] = most recent model output (at time t_hist[0]).
    D1s_k = (buf[k] - buf_at_t_prev0...).
    """

    alpha: np.ndarray  # [N-1] multiplier on x (t/t_prev0 in x0 mode, 1 in eps mode)
    t_next: np.ndarray  # [N-1]
    h_phi_1: np.ndarray  # [N-1]
    B_h: np.ndarray  # [N-1]
    inv_rks: np.ndarray  # [N-1, 2] 1/r_k for D1s (0 where unused)
    rhos_p: np.ndarray  # [N-1, 2] predictor weights (0 padded)
    rhos_c: np.ndarray  # [N-1, 2] corrector weights on D1s (0 padded)
    rhos_c_last: np.ndarray  # [N-1] corrector weight on D1_t
    use_corrector: np.ndarray  # [N-1] bool
    predict_x0: bool = True


def _unipc_rb(rks: np.ndarray, hh: float, variant: str, order: int):
    h_phi_1 = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1.0
    if variant == "bh1":
        B_h = hh
    elif variant == "bh2":
        B_h = np.expm1(hh)
    else:
        raise NotImplementedError(variant)
    R, b = [], []
    factorial_i = 1.0
    for i in range(1, order + 1):
        R.append(rks ** (i - 1))
        b.append(h_phi_k * factorial_i / B_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return np.stack(R), np.asarray(b), h_phi_1, B_h


def unipc_coeffs(
    t_steps: np.ndarray,
    max_order: int = 3,
    predict_x0: bool = True,
    lower_order_final: bool = True,
    variant: str = "bh2",
) -> UniPCCoeffs:
    assert 1 <= max_order <= 3
    t = np.asarray(t_steps, dtype=np.float64)
    num_steps = len(t)
    n = num_steps - 1
    out = dict(
        alpha=np.ones(n),
        t_next=t[1:].copy(),
        h_phi_1=np.zeros(n),
        B_h=np.zeros(n),
        inv_rks=np.zeros((n, 2)),
        rhos_p=np.zeros((n, 2)),
        rhos_c=np.zeros((n, 2)),
        rhos_c_last=np.zeros(n),
        use_corrector=np.zeros(n, dtype=bool),
    )
    for i in range(n):
        if i + 1 < max_order:
            order = i + 1
            use_corrector = True
        else:
            order = min(max_order, num_steps - i - 1) if lower_order_final else max_order
            use_corrector = i != num_steps - 2
        # Times of buffered model outputs, most recent first.  During warmup
        # the buffer holds outputs at t_0..t_i; afterwards at t_{i-2}..t_i.
        t_hist = t[max(0, i - (max_order - 1)) : i + 1][::-1][:order]
        lam = -np.log(t_hist)
        lam_t = -np.log(t[i + 1])
        h = lam_t - lam[0]
        rks = np.ones(order, dtype=np.float64)
        for k in range(1, order):
            rks[k - 1] = (lam[k] - lam[0]) / h
        hh = -h if predict_x0 else h
        R, b, h_phi_1, B_h = _unipc_rb(rks, hh, variant, order)
        if order == 2:
            rhos_p = np.array([0.5])
        elif order > 2:
            rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
        else:
            rhos_p = np.zeros(0)
        if order == 1:
            rhos_c = np.array([0.5])
        else:
            rhos_c = np.linalg.solve(R, b)
        out["alpha"][i] = t[i + 1] / t[i] if predict_x0 else 1.0
        out["h_phi_1"][i] = h_phi_1
        out["B_h"][i] = B_h
        out["inv_rks"][i, : order - 1] = 1.0 / rks[: order - 1]
        out["rhos_p"][i, : order - 1] = rhos_p
        out["rhos_c"][i, : order - 1] = rhos_c[:-1]
        out["rhos_c_last"][i] = rhos_c[-1]
        out["use_corrector"][i] = use_corrector
    return UniPCCoeffs(predict_x0=predict_x0, **out)
