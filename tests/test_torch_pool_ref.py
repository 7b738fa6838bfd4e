"""The port's dict-based pool oracle (``serving.pool_ref.DictPoolManager``)
against the reference's, and the port's array pool against it.

1. Port dict pool vs reference dict pool on seeded random operation
   sequences (access with and without a residency-key override, prefill
   inserts, slot resets): every return value, the eviction callbacks in
   order, and the final ``snapshot()``s and residency maps, equal.
2. Port array pool (``serving.pool.MedicPoolManager``) vs port dict pool
   in the replay the reference runs between its own two pools
   (tests/test_policy_engine.py, ``_replay``), for medic and lru.
"""
import numpy as np
import pytest

from repro.serving import pool as JPOOL
from repro.serving import pool_ref as JREF

from repro_torch.serving import pool as TPOOL
from repro_torch.serving import pool_ref as TREF


def _snap_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert type(x) is type(y), k
            assert x == y or (x != x and y != y), (k, x, y)


def _ops(seed: int, steps: int, n_slots: int):
    """A seeded operation sequence shared by both pools."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        op = rng.random()
        slot = int(rng.integers(0, n_slots))
        if op < 0.05:
            yield step, "reset", slot, None
        elif op < 0.15:
            yield step, "prefill", slot, (slot, int(rng.integers(0, 50)))
        else:
            hot = rng.random() < 0.5
            blocks = [int(rng.integers(0, 4 if hot else 1000))
                      for _ in range(int(rng.integers(1, 5)))]
            shared = rng.random() < 0.2
            key = (n_slots + int(rng.integers(0, 2)), blocks[0]) \
                if shared else None
            yield step, "access", slot, (blocks[:1] if shared else blocks,
                                         key)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["medic", "lru"])
def test_dict_pool_matches_reference(policy, seed):
    kw = dict(budget_blocks=24, sampling_interval=8, policy=policy,
              fetch_occupancy=2.0)
    ev_t, ev_j = [], []
    t = TREF.DictPoolManager(TPOOL.PoolConfig(**kw), max_seqs=10,
                             on_evict=ev_t.append)
    j = JREF.DictPoolManager(JPOOL.PoolConfig(**kw), max_seqs=10,
                             on_evict=ev_j.append)
    for step, op, slot, arg in _ops(seed, 400, 6):
        if op == "reset":
            t.reset_slot(slot)
            j.reset_slot(slot)
        elif op == "prefill":
            stype = int(j.seq_type[slot])
            assert stype == int(t.seq_type[slot]), step
            t.insert_prefill(arg, stype)
            j.insert_prefill(arg, stype)
        else:
            blocks, key = arg
            rt = t.access(slot, blocks, float(step), resident_key=key)
            rj = j.access(slot, blocks, float(step), resident_key=key)
            assert rt == rj, step
            assert t.is_resident((slot, blocks[0])) == \
                j.is_resident((slot, blocks[0])), step
    _snap_equal(t.snapshot(), j.snapshot())
    assert t.resident == j.resident
    assert t.owner_type == j.owner_type
    assert ev_t == ev_j and len(ev_t) > 0


def _replay(policy: str, seed: int = 0, steps: int = 300):
    """tests/test_policy_engine.py's ``_replay``, on the port's pools."""
    cfg = TPOOL.PoolConfig(budget_blocks=24, sampling_interval=8,
                           policy=policy, fetch_occupancy=2.0)
    ev_a, ev_b = [], []
    arr = TPOOL.MedicPoolManager(cfg, max_seqs=8, on_evict=ev_a.append)
    ref = TREF.DictPoolManager(cfg, max_seqs=8, on_evict=ev_b.append)
    rng = np.random.default_rng(seed)
    for step in range(steps):
        op = rng.random()
        slot = int(rng.integers(0, 6))
        if op < 0.05:
            arr.reset_slot(slot)
            ref.reset_slot(slot)
        elif op < 0.15:
            key = (slot, int(rng.integers(0, 50)))
            stype = int(ref.seq_type[slot])
            arr.insert_prefill(key, stype)
            ref.insert_prefill(key, stype)
        else:
            hot = rng.random() < 0.5
            blocks = [int(rng.integers(0, 4 if hot else 1000))
                      for _ in range(int(rng.integers(1, 5)))]
            ra, fa = arr.access(slot, blocks, float(step))
            rb, fb = ref.access(slot, blocks, float(step))
            assert ra == rb and fa == fb, step
    return arr, ref, ev_a, ev_b


@pytest.mark.parametrize("policy", ["medic", "lru"])
def test_array_pool_matches_dict_pool(policy):
    arr, ref, ev_a, ev_b = _replay(policy)
    sa, sb = arr.snapshot(), ref.snapshot()
    assert set(sa) == set(sb)
    for k in sa:
        assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k]),
                              equal_nan=True), k
    # full residency contents + eviction callbacks, in order
    assert arr.resident == ref.resident
    assert ev_a == ev_b
    assert len(ev_a) > 0                      # the trace exercised eviction
