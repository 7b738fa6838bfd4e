"""Vectorized trace generation: the port's copy of ``repro.core.tracegen``.

Bit-exact with the reference (tests/test_torch_tracegen.py) on either
path:

  * ``spec.py``    — ``TraceSpec`` + ``lower_warps()`` / ``lower()``:
    archetype mixtures are lowered to per-warp parameter arrays and a
    disjoint address layout, on the host in numpy;
  * ``rng.py``     — splitmix64 counter RNG on ``np.uint64``;
  * ``sampler.py`` — the batched numpy sampler (``generate``,
    ``generate_batch``) and ``CELLS``, the cells sampled on each path;
  * ``ref.py``     — the loop generator (per warp, per instruction, per
    lane), the exact-parity oracle of the sampler (``generate_ref``);
  * ``stress.py``  — the 1k–4k-warp stress matrix and the phased families.

Where the cells are drawn: a sweep on the card without a mesh draws them
on the card, with the CUDA sampler ``repro_torch.kernels.tracegen`` (the
host lowers the warps, the kernel writes ``lines``, ``pcs`` and
``oracle_wtype`` into device memory); every other caller (the CPU, mesh
sweeps, ``generate`` / ``generate_batch``) draws them on the host with
the numpy sampler. The two give the same bits.
"""
from repro_torch.core.tracegen.ref import generate_ref
from repro_torch.core.tracegen.sampler import (CELLS, generate,
                                               generate_batch)
from repro_torch.core.tracegen.spec import (ARCHETYPES, AddressLayout,
                                            Phase, TraceSpec, WarpParams,
                                            compile_schedule, lower,
                                            lower_warps, lowered_gap,
                                            phase_of_instr, trace_key,
                                            working_sets)
from repro_torch.core.tracegen.stress import (PHASED_RECOVER_SPECS,
                                              PHASED_SPECS,
                                              SHARD_STRESS_SPECS,
                                              STRESS_SPECS)

# the reference's exports; ``CELLS``, ``lower_warps`` and ``working_sets``
# serve the CUDA sampler and stay outside them
__all__ = [
    "ARCHETYPES", "AddressLayout", "Phase", "TraceSpec", "WarpParams",
    "compile_schedule", "lower", "lowered_gap", "phase_of_instr",
    "trace_key", "generate", "generate_batch", "generate_ref",
    "PHASED_RECOVER_SPECS", "PHASED_SPECS", "SHARD_STRESS_SPECS",
    "STRESS_SPECS",
]
