"""100 x the least time of the traced window's model arithmetic (every
convolution, matrix product and attention, counted once from the reference
at the timed shapes) at the chip's TF32 peak, over the window's time, in a
sampling cell."""


def read(t):
    peaks, work = t["peaks"], t["work"]
    if peaks is None or t["window_s"] <= 0.0:
        return None
    flops = work.flops["attention"] + work.flops["conv_gemm"]
    return 100.0 * flops / peaks["tf32_flops"] / t["window_s"]
