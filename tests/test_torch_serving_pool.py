"""The port's serving control plane against the JAX reference, bitwise:
``DecisionTables`` for every pool preset and labeling-ladder policy, the
``MedicPoolManager`` under seeded random operation sequences, and the
request generator."""
import dataclasses

import numpy as np
import pytest

from repro.core import baselines as JBL
from repro.policy import DecisionTables as JTables, to_arrays as j_to_arrays
from repro.serving import pool as JPOOL
from repro.serving import request as JREQ

from repro_torch.core import baselines as TBL
from repro_torch.policy import DecisionTables as TTables
from repro_torch.policy import to_arrays as t_to_arrays
from repro_torch.serving import pool as TPOOL
from repro_torch.serving import request as TREQ

#: every preset the two packages share, by name
PRESETS = sorted({p.name for p in JBL.ALL_NAMED + JBL.LABELING_LADDER
                  + JBL.RAND_SWEEP})


def _pair(name):
    jp = {p.name: p for p in JBL.ALL_NAMED + JBL.LABELING_LADDER
          + JBL.RAND_SWEEP}[name]
    tp = {p.name: p for p in TBL.ALL_NAMED + TBL.LABELING_LADDER
          + TBL.RAND_SWEEP}[name]
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    return jp, tp


def _assert_tables_equal(a, b):
    for f in ("bypass_by_type", "rank_by_type", "hp_by_type"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("rrip_max", [3, 7])
def test_decision_tables_match_reference(name, rrip_max):
    jp, tp = _pair(name)
    _assert_tables_equal(JTables.from_arrays(j_to_arrays(jp), rrip_max),
                         TTables.from_arrays(t_to_arrays(tp), rrip_max))


@pytest.mark.parametrize("policy", sorted(JPOOL.POOL_POLICIES))
def test_pool_policy_presets_match_reference(policy):
    assert dataclasses.asdict(JPOOL.POOL_POLICIES[policy]) == \
        dataclasses.asdict(TPOOL.POOL_POLICIES[policy])
    cfg = dict(budget_blocks=8, policy=policy)
    a = JPOOL.MedicPoolManager(JPOOL.PoolConfig(**cfg), 4)
    b = TPOOL.MedicPoolManager(TPOOL.PoolConfig(**cfg), 4)
    _assert_tables_equal(a.tables, b.tables)


# ---------------------------------------------------------------------------
# seeded random operation sequences on both pools
# ---------------------------------------------------------------------------

def _snap_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert type(x) is type(y) and (x == y or (x != x and y != y)), k


def _drive(mgr, ops, evicted):
    """Apply ``ops`` to ``mgr``; return every result, in order."""
    out = []
    for op in ops:
        kind = op[0]
        if kind == "access":
            _, slot, blocks, now, rkey = op
            out.append(mgr.access(slot, blocks, now, resident_key=rkey))
        elif kind == "batch":
            _, owner, kslot, kblk, now = op
            s, r = mgr.access_batch(owner, kslot, kblk, now)
            out.append((s.tolist(), r.tolist()))
        elif kind == "prefill":
            mgr.insert_prefill(op[1], op[2])
        elif kind == "reset":
            mgr.reset_slot(op[1])
        elif kind == "oracle":
            mgr.set_oracle_type(op[1], op[2])
        out.append(("state", [int(t) for t in mgr.seq_type],
                    sorted(mgr.resident.items()), len(evicted)))
    return out


def _ops(seed, n_slots, n_ops, n_blocks):
    rng = np.random.default_rng(seed)
    ops = []
    now = 0.0
    for _ in range(n_ops):
        now += float(rng.integers(0, 3))
        r = rng.random()
        slot = int(rng.integers(0, n_slots))
        if r < 0.45:
            blocks = [int(b) for b in rng.integers(0, n_blocks,
                                                   rng.integers(1, 4))]
            rkey = None
            if rng.random() < 0.3:
                rkey = (n_slots + int(rng.integers(0, 2)),
                        int(rng.integers(0, 3)))
                blocks = blocks[:1]
            ops.append(("access", slot, blocks, now, rkey))
        elif r < 0.75:
            owners = np.sort(rng.integers(0, n_slots, rng.integers(1, 12)))
            kslot = owners.copy()
            shared = rng.random(owners.size) < 0.25
            kslot[shared] = n_slots + rng.integers(0, 2, shared.sum())
            kblk = rng.integers(0, n_blocks, owners.size)
            ops.append(("batch", owners, kslot, kblk, now))
        elif r < 0.88:
            ops.append(("prefill", (slot, int(rng.integers(0, n_blocks))),
                        int(rng.integers(0, 5))))
        elif r < 0.96:
            ops.append(("reset", slot))
        else:
            ops.append(("oracle", slot, int(rng.integers(0, 5))))
    return ops


def _pool_cases():
    cases = []
    for policy in ("lru", "medic"):
        for budget in (1, 3, 6, 16):
            for interval in (4, 32):
                cases.append((policy, budget, interval))
    return cases


@pytest.mark.parametrize("policy,budget,interval", _pool_cases())
def test_pool_random_sequences_bitwise(policy, budget, interval):
    n_slots = 4
    cfg = dict(budget_blocks=budget, sampling_interval=interval,
               policy=policy, fetch_occupancy=1.5)
    ev_j, ev_t = [], []
    a = JPOOL.MedicPoolManager(JPOOL.PoolConfig(**cfg), n_slots + 2,
                               on_evict=ev_j.append)
    b = TPOOL.MedicPoolManager(TPOOL.PoolConfig(**cfg), n_slots + 2,
                               on_evict=ev_t.append)
    ops = _ops(budget * 100 + interval, n_slots, 300, 12)
    assert _drive(a, ops, ev_j) == _drive(b, ops, ev_t)
    assert ev_j == ev_t
    _snap_equal(a.snapshot(), b.snapshot())


@pytest.mark.parametrize("name", ["MeDiC-stale", "MeDiC-oracle",
                                  "MeDiC-fast", "WByp", "PCAL"])
def test_pool_labeling_policies_bitwise(name):
    jp, tp = _pair(name)
    ev_j, ev_t = [], []
    cfg = dict(budget_blocks=5, sampling_interval=8)
    a = JPOOL.MedicPoolManager(JPOOL.PoolConfig(**cfg), 6, policy=jp,
                               on_evict=ev_j.append)
    b = TPOOL.MedicPoolManager(TPOOL.PoolConfig(**cfg), 6, policy=tp,
                               on_evict=ev_t.append)
    ops = _ops(7, 4, 300, 10)
    assert _drive(a, ops, ev_j) == _drive(b, ops, ev_t)
    assert ev_j == ev_t
    _snap_equal(a.snapshot(), b.snapshot())


def test_pool_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        TPOOL.MedicPoolManager(TPOOL.PoolConfig(budget_blocks=0), 2)
    with pytest.raises(ValueError):
        TPOOL.MedicPoolManager(TPOOL.PoolConfig(budget_blocks=2,
                                                policy="fifo"), 2)


# ---------------------------------------------------------------------------
# request generation
# ---------------------------------------------------------------------------

WORKLOADS = [
    dict(),
    dict(n_requests=24, chat_frac=0.6),
    dict(n_requests=40, chat_frac=0.2, arrival_rate=0.5),
    dict(n_requests=17, chat_frac=1.0, n_shared_prefixes=3,
         shared_prefix_len=32, decode=(4, 9)),
]


@pytest.mark.parametrize("wl", WORKLOADS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_requests_identical(wl, seed):
    a = JREQ.generate_requests(JREQ.ServeWorkload(**wl), seed=seed)
    b = TREQ.generate_requests(TREQ.ServeWorkload(**wl), seed=seed)
    assert [dataclasses.asdict(r) for r in a] == \
        [dataclasses.asdict(r) for r in b]
