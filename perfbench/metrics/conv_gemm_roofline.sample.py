"""The convolutions' and matrix products' share of their roofline in a
sampling cell."""
from perfbench.metrics._shares import roofline


def read(t):
    return roofline(t, "conv_gemm")
