"""The port's wavefront engine against the JAX reference on the phased
drift families: the five-rung labeling ladder with oracle labels and
per-instruction compute gaps (``PHASED48`` and ``PHASED_RECOVER48``, cut
to 24 instructions: 8 per phase, the same three-regime schedule).

Same contract as tests/test_torch_engine.py: integer metrics and every
per-element output bitwise, float reductions within rtol 1e-6 (only
their summation order differs).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import baselines as JBL
from repro.core import engine as JE
from repro.core import tracegen as JTG

from repro_torch.core import baselines as BL
from repro_torch.core import engine as E

FLOAT_REDUCTIONS = ("ipc", "ipc_makespan", "qdelay_sum", "stall_cycles",
                    "energy", "perf_per_energy", "mean_qdelay", "miss_rate")


def check_ladder(tr, *, n_warps, lanes):
    args = (tr["lines"], tr["pcs"], tr["compute_gap"])
    ref = JE.simulate_sweep(
        *[jnp.asarray(a) for a in args], JBL.LABELING_LADDER,
        n_warps=n_warps, lanes=lanes, prm=JE.SimParams(),
        engine="wavefront", scan_backend="ref", cache_backend="ref",
        oracle_types=jnp.asarray(tr["oracle_wtype"]))
    out = E.simulate_sweep(
        *args, BL.LABELING_LADDER, n_warps=n_warps, lanes=lanes,
        prm=E.SimParams(), engine="wavefront",
        oracle_types=tr["oracle_wtype"], device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        a, b = np.asarray(ref[k]), out[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in FLOAT_REDUCTIONS:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("name", ["PHASED48", "PHASED_RECOVER48"])
def test_phased48_labeling_ladder_oracle_labels(name):
    """The phased drift schedule (cut to 24 instructions: 8 per phase),
    five labeling rungs, per-instruction compute gaps, oracle labels."""
    spec = {**JTG.PHASED_SPECS, **JTG.PHASED_RECOVER_SPECS}[name]
    tr = JTG.generate(dataclasses.replace(spec, n_instr=24), 0)
    assert np.ndim(tr["compute_gap"]) == 1
    check_ladder(tr, n_warps=48, lanes=16)
