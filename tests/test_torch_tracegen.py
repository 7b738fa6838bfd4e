"""The port's trace generator against the reference's, bit-exact.

``repro_torch.core.tracegen`` is a host-side numpy copy of
``repro.core.tracegen`` (splitmix64 on ``np.uint64``); every array the
engines consume must match: ``lines``, ``pcs``, ``compute_gap`` and
``oracle_wtype``, over the 15 paper workloads × 3 seeds, every phased
spec of both drift directions, the stress matrix at 128 warps and
HAMMER2K once at full size.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import tracegen as JTG
from repro.core import workloads as JWL

from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL

KEYS = ("lines", "pcs", "compute_gap", "oracle_wtype", "archetype")


def _same(a, b, what):
    for k in KEYS:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


def _spec_pair(table, jtable, name, **replace):
    spec, jspec = table[name], jtable[name]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec), name
    return (dataclasses.replace(spec, **replace),
            dataclasses.replace(jspec, **replace))


@pytest.mark.parametrize("name", WL.WORKLOAD_NAMES)
def test_workloads_bit_exact(name):
    assert WL.WORKLOAD_NAMES == JWL.WORKLOAD_NAMES
    assert dataclasses.asdict(WL.WORKLOADS[name]) == \
        dataclasses.asdict(JWL.WORKLOADS[name])
    for seed in (0, 1, 2):
        _same(JWL.generate(JWL.WORKLOADS[name], seed),
              WL.generate(WL.WORKLOADS[name], seed), f"{name}/{seed}")


@pytest.mark.parametrize("name", list(TG.PHASED_SPECS)
                         + list(TG.PHASED_RECOVER_SPECS))
def test_phased_specs_bit_exact(name):
    table = {**TG.PHASED_SPECS, **TG.PHASED_RECOVER_SPECS}
    jtable = {**JTG.PHASED_SPECS, **JTG.PHASED_RECOVER_SPECS}
    spec, jspec = _spec_pair(table, jtable, name)
    _same(JTG.generate(jspec, 0), TG.generate(spec, 0), name)


@pytest.mark.parametrize("name", list(TG.STRESS_SPECS))
def test_stress_specs_bit_exact_at_128_warps(name):
    spec, jspec = _spec_pair(TG.STRESS_SPECS, JTG.STRESS_SPECS, name,
                             n_warps=128)
    _same(JTG.generate(jspec, 1), TG.generate(spec, 1), name)


def test_hammer2k_full_size_bit_exact():
    spec, jspec = _spec_pair(TG.STRESS_SPECS, JTG.STRESS_SPECS, "HAMMER2K")
    assert spec.n_warps == 2048
    _same(JTG.generate(jspec, 0), TG.generate(spec, 0), "HAMMER2K")


def test_generate_batch_bit_exact():
    """The seed-stacked layout the sweeps consume, with a phased spec
    (per-instruction gaps) beside a static one."""
    specs = [TG.TraceSpec.from_workload(WL.WORKLOADS["BFS"]),
             TG.PHASED_SPECS["PHASED48"]]
    jspecs = [JTG.TraceSpec.from_workload(JWL.WORKLOADS["BFS"]),
              JTG.PHASED_SPECS["PHASED48"]]
    a, b = JTG.generate_batch(jspecs, (0, 3)), TG.generate_batch(specs, (0, 3))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
