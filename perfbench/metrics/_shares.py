"""What the per-layer readers share: a class's roofline share from the
window's counted work and its kernels' device time."""

from perfbench.reference.ops import Work

# the peak rate each op class is held to: the stated math is f32, whose
# fastest path on the chip is TF32 on the tensor cores; GroupNorm's few
# operations per element on the CUDA cores (it is bound by its bytes)
PEAK_KEY = {"attention": "tf32_flops", "conv_gemm": "tf32_flops",
            "groupnorm": "fp32_cuda_core_flops"}


def roofline(t: dict, op: str):
    """100 x the class's least time over its kernels' device time in the
    traced window; None where no kernel of the class ran or no peak is known."""
    peaks, work, device_s = t["peaks"], t["work"], t["class_s"].get(op, 0.0)
    if peaks is None or device_s <= 0.0 or not isinstance(work, Work) or not work.ops[op]:
        return None
    bound = work.bound_s(op, peaks[PEAK_KEY[op]], peaks["hbm_bytes_per_s"])
    return 100.0 * bound / device_s
