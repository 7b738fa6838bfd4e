"""The timing pass of one wave: the port's plain version against the JAX
reference's ``wave_queue_recovery(backend="ref")``, bitwise. (The CUDA
kernel against the plain version: tests/test_torch_kernels_cuda.py.)

Fuzzed waves follow tests/test_kernels.py's generator: sorted arrivals,
random queue membership, a random cross-wave carry with some never-used
queues (-inf anchors), dyadic and non-dyadic times. Every output is
compared on every slot, ``t0`` included (outside ``go_dram`` it is the
deterministic value the same formulas give).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.wavefront_scan import ops as JOPS
from repro.kernels.wavefront_scan.ref import QueueCarry as JQueueCarry

from repro_torch.kernels.wavefront_scan import ops as OPS
from repro_torch.kernels.wavefront_scan.ref import QueueCarry


KW = dict(banks=8, channels=4, l2_svc=4.0, l2_lat=20.0, occ_rowhit=4.0,
          occ_rowmiss=10.0)
KW_PAPER = dict(banks=6, channels=8, l2_svc=4.0, l2_lat=20.0,
                occ_rowhit=5.0, occ_rowmiss=10.0)


def wave_case(rng, n, dyadic=True, empty=False, banks=8, channels=4,
              warm_carry=True):
    """One fuzzed wave as numpy arrays: (slot arrays..., carry fields)."""
    step = 0.25 if dyadic else 0.7
    t_s = (np.cumsum(rng.integers(0, 4, n)) * step).astype(np.float32)
    bank = rng.integers(0, banks, n).astype(np.int32)
    ch = rng.integers(0, channels, n).astype(np.int32)
    row = rng.integers(0, 6, n).astype(np.int32)
    valid = np.zeros(n, bool) if empty else rng.random(n) < 0.9
    byp = (rng.random(n) < 0.2) & valid
    hit = (rng.random(n) < 0.4) & valid & ~byp
    use_l2 = valid & ~byp
    go_dram = valid & (byp | ~hit)
    hp = rng.random(n) < 0.5

    def qvec(q, lo, hi):
        return (rng.uniform(lo, hi, q) * (4 if dyadic else 1)).astype(
            np.float32)
    neg = np.where(rng.random(channels) < 0.3, -np.inf, 0.0).astype(
        np.float32)
    negb = np.where(rng.random(banks) < 0.3, -np.inf, 0.0).astype(
        np.float32)
    if not warm_carry:
        negb = np.full(banks, -np.inf, np.float32)
        neg = np.full(channels, -np.inf, np.float32)
    carry = dict(
        bank_free=qvec(banks, 0, 30), bank_ts=qvec(banks, 0, 20) + negb,
        hp_free=qvec(channels, 0, 40), hp_ts=qvec(channels, 0, 20) + neg,
        hp_sa=qvec(channels, 0, 20) + neg,
        lp_free=qvec(channels, 0, 40), lp_ts=qvec(channels, 0, 20) + neg,
        lp_sa=qvec(channels, 0, 20) + neg,
        cur_row=rng.integers(-1, 6, channels).astype(np.int32))
    return (t_s, bank, use_l2, ch, row, go_dram, byp, hp), carry


def run_jax(case, exact, kw):
    slots, carry = case
    return JOPS.wave_queue_recovery(
        *[jnp.asarray(x) for x in slots],
        JQueueCarry(**{k: jnp.asarray(v) for k, v in carry.items()}),
        exact=exact, backend="ref", **kw)


def run_torch(case, exact, kw, backend="ref", device="cpu"):
    slots, carry = case
    return OPS.wave_queue_recovery(
        *[torch.tensor(x, device=device) for x in slots],
        QueueCarry(**{k: torch.tensor(v, device=device)
                      for k, v in carry.items()}),
        exact=exact, backend=backend, **kw)


def assert_same(a, b):
    """(t_head, t0, row_hit, carry), every slot and field, bitwise."""
    for name, x, y in zip(("t_head", "t0", "row_hit"), a[:3], b[:3]):
        x = np.asarray(x.cpu() if torch.is_tensor(x) else x)
        y = np.asarray(y.cpu() if torch.is_tensor(y) else y)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for f, x, y in zip(QueueCarry._fields, a[3], b[3]):
        x = np.asarray(x.cpu() if torch.is_tensor(x) else x)
        y = np.asarray(y.cpu() if torch.is_tensor(y) else y)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f"carry.{f}")


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n", [1, 17, 96, 600])
def test_ref_matches_jax_bitwise(n, dyadic, exact):
    case = wave_case(np.random.default_rng(n * 2 + dyadic), n, dyadic=dyadic)
    assert_same(run_jax(case, exact, KW), run_torch(case, exact, KW))


@pytest.mark.parametrize("exact", [False, True])
def test_ref_matches_jax_paper_queues(exact):
    """The paper's hierarchy: 6 L2 banks, 8 DRAM channels."""
    case = wave_case(np.random.default_rng(31), 512, dyadic=False, banks=6,
                     channels=8)
    assert_same(run_jax(case, exact, KW_PAPER),
                run_torch(case, exact, KW_PAPER))


def test_ref_empty_wave_is_a_noop():
    """A wave with no valid slot leaves the carry bitwise unchanged."""
    case = wave_case(np.random.default_rng(13), 48, dyadic=False, empty=True)
    out = run_torch(case, False, KW)
    assert_same(run_jax(case, False, KW), out)
    for f, v in case[1].items():
        np.testing.assert_array_equal(v, getattr(out[3], f).numpy(),
                                      err_msg=f)


def test_ref_single_slots():
    """n=1 waves across every request species: L2-only, DRAM hp, DRAM lp,
    bypass-direct."""
    slots, carry = wave_case(np.random.default_rng(17), 1, dyadic=False)
    for use, go, byp, hp in [(True, False, False, False),
                             (True, True, False, True),
                             (True, True, False, False),
                             (False, True, True, True)]:
        case = ((slots[0], slots[1], np.asarray([use]), slots[3], slots[4],
                 np.asarray([go]), np.asarray([byp]), np.asarray([hp])),
                carry)
        for exact in (False, True):
            assert_same(run_jax(case, exact, KW), run_torch(case, exact, KW))


def test_ref_cold_carry():
    """All-virgin queues (-inf anchors, as at t=0) give +inf backlogs,
    never NaN."""
    case = wave_case(np.random.default_rng(23), 96, dyadic=False,
                     warm_carry=False)
    out = run_torch(case, False, KW)
    assert_same(run_jax(case, False, KW), out)
    assert not torch.isnan(out[1]).any()


def test_backend_gate():
    case = wave_case(np.random.default_rng(5), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_torch(case, False, KW, backend="cuda")
    with pytest.raises(ValueError, match="unknown scan backend"):
        run_torch(case, False, KW, backend="pallas")
    assert OPS.resolve_backend("auto", torch.device("cpu")) == "ref"
    assert OPS.resolve_backend("auto", torch.device("cuda")) == "cuda"
    assert OPS.resolve_backend("ref", torch.device("cuda")) == "ref"
