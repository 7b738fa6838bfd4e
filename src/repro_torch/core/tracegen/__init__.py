"""Vectorized trace generation: the port's copy of ``repro.core.tracegen``.

Host-side numpy, bit-exact with the reference (tests/test_torch_tracegen.py):

  * ``spec.py``    — ``TraceSpec`` + ``lower()``: archetype mixtures are
    lowered to per-warp parameter arrays and a disjoint address layout;
  * ``rng.py``     — splitmix64 counter RNG on ``np.uint64``;
  * ``sampler.py`` — the batched sampler (``generate``, ``generate_batch``);
  * ``ref.py``     — the loop generator (per warp, per instruction, per
    lane), the exact-parity oracle of the sampler (``generate_ref``);
  * ``stress.py``  — the 1k–4k-warp stress matrix and the phased families.

The engines take the finished arrays as torch tensors.
"""
from repro_torch.core.tracegen.ref import generate_ref
from repro_torch.core.tracegen.sampler import generate, generate_batch
from repro_torch.core.tracegen.spec import (ARCHETYPES, AddressLayout,
                                            Phase, TraceSpec, WarpParams,
                                            compile_schedule, lower,
                                            lowered_gap, phase_of_instr,
                                            trace_key)
from repro_torch.core.tracegen.stress import (PHASED_RECOVER_SPECS,
                                              PHASED_SPECS,
                                              SHARD_STRESS_SPECS,
                                              STRESS_SPECS)

__all__ = [
    "ARCHETYPES", "AddressLayout", "Phase", "TraceSpec", "WarpParams",
    "compile_schedule", "lower", "lowered_gap", "phase_of_instr",
    "trace_key", "generate", "generate_batch", "generate_ref",
    "PHASED_RECOVER_SPECS", "PHASED_SPECS", "SHARD_STRESS_SPECS",
    "STRESS_SPECS",
]
