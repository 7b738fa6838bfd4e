"""Frozen copy of the program's trace generator (``spec``, ``rng`` and
the vectorized ``sampler``): the reference
regenerates the traces of the simulations it checks from the workload's
parameters and the trace seed, and takes no trace from the program."""
from .sampler import generate
from .spec import TraceSpec

__all__ = ["TraceSpec", "generate"]
