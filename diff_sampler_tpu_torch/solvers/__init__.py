"""ODE samplers of the port."""

from .samplers import SOLVER_REGISTRY, SampleResult, count_nfe, get_sampler

__all__ = ["SOLVER_REGISTRY", "SampleResult", "count_nfe", "get_sampler"]
