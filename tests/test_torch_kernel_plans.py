"""What the port decides on the host around two of its kernels, checked on
the CPU: the cache pass's instance plan (shared-memory bytes, resident or
global state, the wave limits) and the packed layouts of its outputs; the
pool gather's several-pool form against the JAX reference; the serving
engine's offload table built on the device. The kernels themselves are
held against these on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``)."""
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.medic_gather.ref import medic_gather_ref as j_gather_ref

from repro_torch.core import baselines as BL
from repro_torch.core.engine.state import SimParams
from repro_torch.kernels.cache_pass import ops as CPASS
from repro_torch.kernels.medic_gather import ops as GATHER
from repro_torch.serving import engine as ENG

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the cache pass's plan
# ---------------------------------------------------------------------------

def test_plan_at_the_papers_hierarchy_keeps_the_state_in_shared_memory():
    """SimParams(): four pointer tables of 512 sets (8 KB), tags, rrip and
    meta of 512 x 8 (3 x 16 KB), 4096 EAF stamps (16 KB) and three PC
    tables of 256 (3 KB)."""
    plan = CPASS.plan_wave_cache(SimParams(), 512)
    assert plan.smem_bytes == 4 * 4 * 512 + 4 * (3 * 4096 + 4096 + 3 * 256)
    assert plan.smem_bytes == 76800
    assert plan == CPASS.WaveCachePlan(True, 76800, 512, 1)
    assert plan.smem_bytes <= CPASS.SMEM_BUDGET == 232448 - 1024


@pytest.mark.parametrize("sets,ways,eaf_bits,pc", [
    (1, 8, 4096, 256), (8, 6, 4096, 256), (512, 12, 1000, 7),
    (1024, 8, 4096, 256), (3, 5, 9, 3)])
def test_plan_bytes_round_every_array_to_16_bytes(sets, ways, eaf_bits, pc):
    prm = SimParams(sets=sets, ways=ways, eaf_bits=eaf_bits, pc_entries=pc)
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    want = 4 * (4 * r4(sets) + 3 * r4(sets * ways) + r4(eaf_bits)
                + 3 * r4(pc))
    plan = CPASS.plan_wave_cache(prm, 64)
    assert plan.resident and plan.smem_bytes == want


@pytest.mark.parametrize("sets", [4096, 8192, 14464])
def test_plan_takes_the_global_instance_where_the_state_does_not_fit(sets):
    plan = CPASS.plan_wave_cache(SimParams(sets=sets), 512)
    assert not plan.resident
    assert plan.smem_bytes == 4 * 4 * sets <= CPASS.SMEM_BUDGET


def test_plan_refuses_pointer_tables_over_shared_memory():
    with pytest.raises(ValueError, match="pointer tables"):
        CPASS.plan_wave_cache(SimParams(sets=14465), 512)


@pytest.mark.parametrize("b,threads,spt", [
    (1, 32, 1), (33, 64, 1), (512, 512, 1), (513, 512, 2), (1024, 512, 2),
    (1025, 512, 4), (2048, 512, 4), (2049, 1024, 8), (3000, 1024, 8),
    (8192, 1024, 8)])
def test_plan_threads_and_slots_per_thread(b, threads, spt):
    plan = CPASS.plan_wave_cache(SimParams(), b)
    assert (plan.threads, plan.slots_per_thread) == (threads, spt)
    assert plan.threads * plan.slots_per_thread >= b


@pytest.mark.parametrize("b", [0, -1, CPASS.KERNEL_MAX_B + 1])
def test_plan_refuses_waves_outside_the_kernel(b):
    with pytest.raises(ValueError, match="slots per wave"):
        CPASS.plan_wave_cache(SimParams(), b)


def test_plan_gives_the_global_instance_on_request():
    plan = CPASS.plan_wave_cache(SimParams(), 512, resident=False)
    assert plan == CPASS.WaveCachePlan(False, 4 * 4 * 512, 512, 1)
    assert CPASS.plan_wave_cache(SimParams(), 512, resident=True) == \
        CPASS.plan_wave_cache(SimParams(), 512)


def test_plan_refuses_a_resident_state_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        CPASS.plan_wave_cache(SimParams(sets=4096), 512, resident=True)


def _c_const(name: str) -> int:
    src = (ROOT / "src/repro_torch/csrc/wave_cache.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("b", [1, 31, 32, 500, 512, 513, 1500, 2048, 2049,
                               4097, 8192])
def test_plan_is_inside_the_c_entrys_bounds(b):
    """The C entry launches the plan as it is and refuses one outside its
    instances: threads a multiple of 32, up to kMidThreads for 1, 2 or 4
    slots a thread and kMaxThreads for 8, covering the wave."""
    mid, most = _c_const("kMidThreads"), _c_const("kMaxThreads")
    for resident in (None, False):
        plan = CPASS.plan_wave_cache(SimParams(), b, resident=resident)
        assert plan.slots_per_thread in (1, 2, 4, 8)
        cap = most if plan.slots_per_thread == 8 else mid
        assert 32 <= plan.threads <= cap and plan.threads % 32 == 0
        assert plan.threads * plan.slots_per_thread >= b


# ---------------------------------------------------------------------------
# the packed outputs
# ---------------------------------------------------------------------------

def _spans(views):
    """(start, end) byte ranges of the views, and their storages."""
    spans = [(v.data_ptr(), v.data_ptr() + v.numel() * v.element_size())
             for v in views]
    return spans, {v.untyped_storage().data_ptr() for v in views}


def _check_packed(views):
    spans, storages = _spans(views)
    assert len(storages) == 1                    # one allocation
    assert all(lo % 16 == 0 for lo, _ in spans)  # 16-byte starts
    spans.sort()
    for (_, end), (lo, _) in zip(spans, spans[1:]):
        assert end <= lo                         # disjoint
    assert all(v.is_contiguous() for v in views)


def _wave(monkeypatch, sets, b, lanes, addr_hi):
    monkeypatch.setattr(CS, "DEV", CPU)
    prm = SimParams(sets=sets)
    st, args, pa = CS.cache_case(np.random.default_rng(b + lanes), 2 * b, b,
                                 lanes, prm, BL.MEDIC, addr_hi)
    return st, args, prm, pa


@pytest.mark.parametrize("sets,b,lanes", [(8, 12, 5), (512, 512, 16),
                                          (4, 1, 1), (16, 1000, 3)])
def test_record_views_hold_the_plain_versions_records(monkeypatch, sets, b,
                                                      lanes):
    st, args, prm, pa = _wave(monkeypatch, sets, b, lanes, 60)
    _, _, recs = CPASS._ref.wave_cache_pass_ref(st, *args, prm, pa)
    views = CPASS.record_views(lanes, b, CPU)
    assert len(views) == len(recs) == 9
    for v, r in zip(views, recs):
        assert (v.dtype, v.shape) == (r.dtype, r.shape)
    _check_packed(views)
    for v, r in zip(views, recs):
        v.copy_(r)
    for v, r in zip(views, recs):
        assert torch.equal(v, r)


@pytest.mark.parametrize("sets,b", [(8, 12), (512, 512), (3, 7)])
def test_state_views_hold_the_plain_versions_state(monkeypatch, sets, b):
    st, args, prm, pa = _wave(monkeypatch, sets, b, 4, 60)
    st1, clf, _ = CPASS._ref.wave_cache_pass_ref(st, *args, prm, pa)
    new, rows = CPASS.state_views(prm, b, CPU)
    assert tuple(new) == CPASS._STATE_FIELDS
    want = [getattr(st1, f) for f in CPASS._STATE_FIELDS] + list(clf)
    views = list(new.values()) + list(rows)
    for v, r in zip(views, want):
        assert (v.dtype, v.shape) == (r.dtype, r.shape)
    _check_packed(views)
    for v, r in zip(views, want):
        v.copy_(r)
    for v, r in zip(views, want):
        assert torch.equal(v, r)


def test_cache_kernel_entry_refuses_cpu_tensors(monkeypatch):
    st, args, prm, pa = _wave(monkeypatch, 8, 6, 2, 60)
    with pytest.raises(ValueError, match="CUDA"):
        CPASS.wave_cache_cuda(st, *args, prm, pa)


# ---------------------------------------------------------------------------
# the pool gather over several pools
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pools(rng, n_pools, shape, dtype):
    jd, td = DTYPES[dtype]
    xs = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(n_pools)]
    return [jnp.asarray(x, jd) for x in xs], \
        [torch.from_numpy(x).to(td) for x in xs]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_pools", [1, 2, 3])
def test_gather_pools_at_the_offload_shape_with_holes(dtype, n_pools):
    """The engine's offload read (every layer's cache as one pool of
    blocks, one block per layer) and a table with holes, per pool bitwise
    equal to the JAX reference."""
    rng = np.random.default_rng(7 + n_pools)
    n_layers, slots, pages, page = 4, 4, 5, 16
    jp, tp = _pools(rng, n_pools, (n_layers * slots * pages, page, 2, 32),
                    dtype)
    offload = ENG.offload_table(n_layers, slots, pages, 2, 3, CPU)
    holes = rng.integers(0, n_layers * slots * pages, (3, 6))
    holes[rng.random((3, 6)) < 0.3] = -1
    for tbl in (offload, torch.from_numpy(holes.astype(np.int32)),
                torch.full((2, 3), -1, dtype=torch.int32)):
        outs = GATHER.medic_gather_pools(tp, tbl)
        assert outs.shape == (n_pools, *tbl.shape, page, 2, 32)
        for o, pj, pt in zip(outs, jp, tp):
            ref = j_gather_ref(pj, jnp.asarray(tbl.numpy()))
            np.testing.assert_array_equal(o.float().numpy(),
                                          np.asarray(ref, np.float32))
            assert torch.equal(o, GATHER.medic_gather(pt, tbl))


def test_gather_pools_backend_gate():
    pool = torch.zeros(4, 2, 1, 8)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        GATHER.medic_gather_pools((pool, pool), tbl, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        GATHER.medic_gather_pools_cuda((pool, pool), tbl)
    with pytest.raises(ValueError, match="unknown"):
        GATHER.medic_gather_pools((pool,), tbl, backend="pallas")


# ---------------------------------------------------------------------------
# the engine's offload table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,n_slots,pages", [(28, 4, 28), (2, 4, 28),
                                                    (3, 12, 5), (1, 1, 1)])
def test_offload_table_on_the_device_equals_the_host_built_one(
        n_layers, n_slots, pages):
    for slot in sorted({0, n_slots - 1, n_slots // 2}):
        for idx in sorted({0, pages - 1, pages // 3}):
            host = ((torch.arange(n_layers, dtype=torch.int32) * n_slots
                     + slot) * pages + idx).view(n_layers, 1)
            dev = ENG.offload_table(n_layers, n_slots, pages, slot, idx, CPU)
            assert dev.dtype == torch.int32 and dev.is_contiguous()
            assert torch.equal(dev, host)
