"""The port's own copies of the host-side schedules and multistep
coefficients (``diff_sampler_tpu_torch/ops``) against the JAX package's:
bit for bit, for every schedule type and every coefficient builder."""

import dataclasses

import numpy as np
import pytest

from diff_sampler_tpu.ops import multistep as JM
from diff_sampler_tpu.ops import schedules as JSch
from diff_sampler_tpu_torch.ops import multistep as TM
from diff_sampler_tpu_torch.ops import schedules as TSch

BUILDERS = {
    "euler": lambda m, t: m.euler_coeffs(t),
    "ipndm": lambda m, t: m.ipndm_coeffs(t, 4),
    "ipndm_order2": lambda m, t: m.ipndm_coeffs(t, 2),
    "ipndm_v": lambda m, t: m.ipndm_v_coeffs(t, 4),
    "deis_tab": lambda m, t: m.deis_coeffs(t, 3, N=1000),
    "deis_rhoab": lambda m, t: m.deis_coeffs(t, 3, deis_mode="rhoab"),
    "dpm_pp": lambda m, t: m.dpm_pp_coeffs(t, 3),
    "dpm_pp_eps": lambda m, t: m.dpm_pp_coeffs(t, 2, predict_x0=False, lower_order_final=False),
    "unipc": lambda m, t: m.unipc_coeffs(t, 3),
    "unipc_bh1_eps": lambda m, t: m.unipc_coeffs(t, 2, predict_x0=False, variant="bh1"),
}


def _schedule(sch, kind, n=7):
    if kind == "discrete":
        beta_d, beta_min = sch.vp_params(0.002, 80.0)
        return sch.get_schedule(n, 0.002, 80.0, "discrete", 7.0,
                                sigma_fn=lambda t: sch.vp_sigma(beta_d, beta_min, t),
                                sigma_inv_fn=lambda s: sch.vp_sigma_inv(beta_d, beta_min, s),
                                dp_list=[0, 2, 3, 5, 6])
    return sch.get_schedule(n, 0.002, 80.0, kind, 7.0)


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("kind", ["polynomial", "logsnr", "time_uniform", "discrete"])
def test_copies_match_the_jax_package_bit_for_bit(kind, builder):
    t_j, t_t = _schedule(JSch, kind), _schedule(TSch, kind)
    assert t_t.dtype == np.float64 and np.array_equal(t_t, t_j)
    got, want = BUILDERS[builder](TM, t_t), BUILDERS[builder](JM, t_j)
    if dataclasses.is_dataclass(want):
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]
        pairs = [(getattr(got, f.name), getattr(want, f.name))
                 for f in dataclasses.fields(want)]
    else:
        pairs = [(got, want)]
    for a, b in pairs:
        assert np.array_equal(np.asarray(a), np.asarray(b)), builder
