"""The GroupNorm kernels' share of their roofline in a sampling cell."""
from perfbench.metrics._shares import roofline


def read(t):
    return roofline(t, "groupnorm")
