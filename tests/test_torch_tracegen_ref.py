"""The port's loop trace generator (``tracegen.ref.generate_ref``) bitwise
against the reference's loop generator and against the port's own
vectorized sampler.

The loop is the exact-parity oracle of the sampler: every draw is a
counter-RNG draw at the cell's (tag, index), so all three must give the
same arrays, not close ones. The loop costs one Python iteration a cell,
so the workloads are cut (16 warps × 16 instructions, and the phased and
stress specs likewise) and run at 3 seeds.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import tracegen as JTG
from repro.core import workloads as JWL

from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL

SEEDS = (0, 1, 2)
CUT = dict(n_warps=16, n_instr=16)
KEYS = ("lines", "pcs", "compute_gap", "archetype", "archetype2",
        "oracle_wtype", "archetype_phases")


def _equal(a, b, what):
    assert set(a) == set(b) == set(KEYS), what
    for k in KEYS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


def _check(spec, jspec, **cut):
    """Both packages' copies of one spec, equal, then cut alike."""
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec), spec.name
    spec = dataclasses.replace(spec, **cut)
    jspec = dataclasses.replace(jspec, **cut)
    for seed in SEEDS:
        loop = TG.generate_ref(spec, seed)
        _equal(loop, JTG.generate_ref(jspec, seed),
               f"{spec.name}/{seed} port loop vs reference loop")
        _equal(loop, TG.generate(spec, seed),
               f"{spec.name}/{seed} port loop vs port sampler")


@pytest.mark.parametrize("name", WL.WORKLOAD_NAMES)
def test_loop_matches_reference_and_sampler_on_workloads(name):
    _check(TG.TraceSpec.from_workload(WL.WORKLOADS[name]),
           JTG.TraceSpec.from_workload(JWL.WORKLOADS[name]), **CUT)


@pytest.mark.parametrize("name", list(TG.PHASED_SPECS)
                         + list(TG.PHASED_RECOVER_SPECS))
def test_loop_matches_reference_and_sampler_on_phased_specs(name):
    """Phase schedules: per-phase archetype flips and working-set
    rekeying (the non-legacy plans), both drift directions."""
    spec = {**TG.PHASED_SPECS, **TG.PHASED_RECOVER_SPECS}[name]
    jspec = {**JTG.PHASED_SPECS, **JTG.PHASED_RECOVER_SPECS}[name]
    _check(spec, jspec, n_warps=16, n_instr=min(spec.n_instr, 24))


@pytest.mark.parametrize("name", list(TG.STRESS_SPECS))
def test_loop_matches_reference_and_sampler_on_stress_specs(name):
    """Boosted shared fractions and aggressive phase shifts, shrunk."""
    _check(TG.STRESS_SPECS[name], JTG.STRESS_SPECS[name], **CUT)


def test_exported_as_in_the_reference():
    assert "generate_ref" in TG.__all__
    assert set(TG.__all__) == set(JTG.__all__)
