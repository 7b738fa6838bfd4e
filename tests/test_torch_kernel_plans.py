"""What the port decides on the host around its kernels, checked on the
CPU: the cache pass's instance plan (shared-memory bytes, resident or
global state, the wave limits) and the packed layouts of its outputs; the
timing pass's plan (slots a thread, threads, block passes) and its packed
call; the RG-LRU kernel's plan (copy instance, channels, tile steps, ring
stages) and a model of its walk through the ring; the pool gather's several-pool form against the JAX reference; the
serving engine's offload table built on the device. The kernels themselves are
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
from repro_torch.kernels.rg_lru import ops as RGLRU
from repro_torch.kernels.rg_lru import ref as RGLRU_REF
from repro_torch.kernels.wavefront_scan import ops as WSCAN
from repro_torch.kernels.wavefront_scan.ref import QueueCarry
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
    (8192, 1024, 8), (8193, 1024, 16), (12000, 1024, 16),
    (16384, 1024, 16)])
def test_plan_threads_and_slots_per_thread(b, threads, spt):
    plan = CPASS.plan_wave_cache(SimParams(), b)
    assert (plan.threads, plan.slots_per_thread) == (threads, spt)
    assert plan.threads * plan.slots_per_thread >= b


@pytest.mark.parametrize("b", [0, -1, CPASS.KERNEL_MAX_B + 1, 16385])
def test_plan_refuses_waves_outside_the_kernel(b):
    with pytest.raises(ValueError, match="slots per wave"):
        CPASS.plan_wave_cache(SimParams(), b)


@pytest.mark.parametrize("n_warps", [65536, 16384 * 4 + 3])
def test_plan_takes_the_widest_traces_default_wave(n_warps):
    """WIDE64K (65,536 warps) runs at the default wave of W/4 = 16,384
    slots: the plan covers it, in both instances."""
    from repro_torch.core.engine import wavefront as WF
    b = WF.default_wave_size(n_warps)
    assert b == n_warps // 4 and b <= CPASS.KERNEL_MAX_B == 16384
    for resident in (None, False):
        plan = CPASS.plan_wave_cache(SimParams(), b, resident=resident)
        assert (plan.threads, plan.slots_per_thread) == (1024, 16)


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
                               4097, 8192, 8193, 16383, 16384])
def test_plan_is_inside_the_c_entrys_bounds(b):
    """The C entry launches the plan as it is and refuses one outside its
    instances: threads a multiple of 32, up to kMidThreads for 1, 2 or 4
    slots a thread and kMaxThreads for 8 or 16, covering the wave."""
    mid, most = _c_const("kMidThreads"), _c_const("kMaxThreads")
    src = (ROOT / "src/repro_torch/csrc/wave_cache.cu").read_text()
    instances = {int(x) for x in re.findall(r"if \(spt == (\d+)\) return "
                                            r"launch_ways<", src)}
    assert instances == {1, 2, 4, 8, 16}
    assert "spt >= 8 ? kMaxThreads : kMidThreads" in src
    for resident in (None, False):
        plan = CPASS.plan_wave_cache(SimParams(), b, resident=resident)
        assert plan.slots_per_thread in instances
        cap = most if plan.slots_per_thread >= 8 else mid
        assert 32 <= plan.threads <= cap and plan.threads % 32 == 0
        assert plan.threads * plan.slots_per_thread >= b


# ---------------------------------------------------------------------------
# the timing pass's plan and packed call
# ---------------------------------------------------------------------------

def _wq_const(name: str) -> int:
    src = (ROOT / "src/repro_torch/csrc/wave_queue.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("n,blocks,threads,k,passes", [
    (0, 1, 32, 1, 1), (1, 1, 32, 1, 1), (17, 1, 32, 1, 1), (33, 1, 64, 1, 1),
    (600, 1, 224, 3, 1), (1024, 1, 256, 4, 1), (1025, 2, 192, 3, 1),
    (8192, 8, 256, 4, 1), (8193, 8, 224, 5, 1), (16384, 8, 256, 8, 1),
    (40000, 8, 320, 16, 1), (65536, 8, 512, 16, 1), (65537, 8, 512, 16, 2),
    (262144, 8, 512, 16, 4)])
def test_wave_queue_plan(n, blocks, threads, k, passes):
    """One block of the cluster per 1024 slots (at most 8), then K =
    ceil(slots a block / 256) slots a thread (at most 16) on as few warps
    as cover them: HAMMER2K's wave of 8192 on 8 blocks of 256 threads of 4
    slots, HAMMER4K's 16,384 at 8 a thread; passes of 65,536 above
    (WIDE64K's 262,144 in 4)."""
    plan = WSCAN.plan_wave_queue(n)
    assert (plan.blocks, plan.threads, plan.slots_per_thread,
            plan.passes) == (blocks, threads, k, passes)
    assert plan.smem_bytes == 16 * k * (threads + 1)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 511, 513, 1000, 1025, 4097,
                               8191, 8192, 16383, 16384, 16385, 50000,
                               65536, 65537, 262144, 1 << 20])
def test_wave_queue_plan_is_inside_the_c_entrys_bounds(n):
    """The C entry launches the plan as it is and refuses one outside the
    kernel: a cluster of 1..kMaxBlocks blocks of whole warps up to
    kMaxThreads, 1..kMaxK slots a thread, four words of shared memory a
    slot of a pass (rows of threads + 1), under the card's 227 KB; the
    passes cover the wave, and only the last is partial."""
    plan = WSCAN.plan_wave_queue(n)
    most, kmax = _wq_const("kMaxThreads"), _wq_const("kMaxK")
    assert (_wq_const("kMaxBlocks"), most, kmax) == (
        WSCAN.MAX_BLOCKS, WSCAN.MAX_THREADS, WSCAN.MAX_SLOTS_PER_THREAD)
    assert 1 <= plan.blocks <= WSCAN.MAX_BLOCKS
    assert 32 <= plan.threads <= most and plan.threads % 32 == 0
    assert 1 <= plan.slots_per_thread <= kmax
    per_pass = plan.blocks * plan.threads * plan.slots_per_thread
    assert plan.passes * per_pass >= n > (plan.passes - 1) * per_pass \
        or n == 0
    assert 16 * plan.slots_per_thread * (plan.threads + 1) \
        == plan.smem_bytes <= 232448 - 4096
    src = (ROOT / "src/repro_torch/csrc/wave_queue.cu").read_text()
    assert "smem < 16LL * p.k * (threads + 1)" in src
    assert "blocks < 1 || blocks > kMaxBlocks" in src
    # a one-pass wave fills its blocks but for the last one's tail
    if plan.passes == 1 and n:
        assert (plan.blocks - 1) * plan.threads * plan.slots_per_thread < n


def test_wave_queue_plan_refuses_a_negative_wave():
    with pytest.raises(ValueError, match="slots"):
        WSCAN.plan_wave_queue(-1)


def _queue_inputs(n, banks=6, channels=8):
    slots = (torch.zeros(n), torch.zeros(n, dtype=torch.int32),
             torch.zeros(n, dtype=torch.bool),
             torch.zeros(n, dtype=torch.int32),
             torch.zeros(n, dtype=torch.int32),
             torch.zeros(n, dtype=torch.bool),
             torch.zeros(n, dtype=torch.bool),
             torch.zeros(n, dtype=torch.bool))
    carry = QueueCarry(*(torch.zeros(banks if i < 2 else channels)
                         for i in range(8)),
                       cur_row=torch.zeros(channels, dtype=torch.int32))
    return slots, carry


QKW = dict(banks=6, channels=8, l2_svc=4.0, l2_lat=20.0, occ_rowhit=5.0,
           occ_rowmiss=10.0)


def test_wave_queue_layout_packs_the_call():
    """The argument array's head is the plan and the float32 bits of the
    constants (12 words, as the C entry reads them: pointers from word
    12); the one output buffer holds t_head, t0, the eight float
    carry fields, cur_row and row_hit in whole words, back to back."""
    n = 1000
    lay = WSCAN._layout(n, 6, 8, 0, 4.0, 20.0, 5.0, 10.0, True)
    plan = WSCAN.plan_wave_queue(n)
    assert lay.plan == plan
    assert lay.head[:8] == [n, 6, 8, 1, plan.blocks, plan.threads,
                            plan.slots_per_thread, plan.smem_bytes]
    bits = np.array([4.0, 20.0, 5.0, 10.0], np.float32).view(np.int32)
    assert lay.head[8:] == bits.tolist() and len(lay.head) == 12
    assert lay.split == [n, n, 6, 6] + [8] * 6 + [8, 250]
    assert lay.words == sum(lay.split)
    assert lay.offsets == [4 * sum(lay.split[:i]) for i in range(12)]
    assert len(lay.expect) == len(lay.names) == 17
    assert lay.names[:8] == ("t_s", "bank", "ch", "row", "use_l2",
                             "go_dram", "byp", "hp")


@pytest.mark.parametrize("kw,match", [
    (dict(banks=9), "banks and channels"), (dict(channels=0), "banks"),
    (dict(occ_rowhit=5.5), "integer-valued"),
    (dict(l2_svc=4.0, occ_rowmiss=70.0), "2\\*\\*24")])
def test_wave_queue_layout_refuses_what_the_kernel_does_not_take(kw, match):
    args = {**QKW, **kw}
    n = 250000
    with pytest.raises(ValueError, match=match):
        WSCAN._layout(n, args["banks"], args["channels"], 0, args["l2_svc"],
                      20.0, args["occ_rowhit"], args["occ_rowmiss"], False)


def test_wave_queue_kernel_entry_refuses_cpu_tensors():
    slots, carry = _queue_inputs(10)
    with pytest.raises(ValueError, match="CUDA"):
        WSCAN.wave_queue_cuda(*slots, carry, exact=False, **QKW)
    with pytest.raises(ValueError, match="CUDA"):
        WSCAN.wave_queue_recovery(*slots, carry, exact=False,
                                  backend="cuda", **QKW)


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
    offload = ENG.offload_table(n_layers, slots, pages, 2, 3, 1, CPU)
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
# the RG-LRU kernel's plan and its walk through the ring
# ---------------------------------------------------------------------------

def _rg_const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("w,aligned,vec", [
    (2560, True, 4), (36, True, 4), (100, True, 4), (4, True, 4),
    (2560, False, 1), (36, False, 1), (7, True, 1), (65, True, 1),
    (1, True, 1), (102, True, 1)])
def test_rg_lru_plan_instance_by_width_and_alignment(w, aligned, vec):
    """16-byte copies where W % 4 == 0 and a and b are 16-byte aligned
    (the hybrid's W 2560), else 4-byte copies (W 7, 65; a view that starts
    off 16 bytes)."""
    plan = RGLRU.plan_rg_lru(2, 33, w, aligned)
    assert plan.vec == vec
    assert RGLRU.plan_rg_lru(2, 33, w, aligned, vec=1).vec == 1
    if vec == 1:
        with pytest.raises(ValueError, match="16-byte copy instance"):
            RGLRU.plan_rg_lru(2, 33, w, aligned, vec=4)
    with pytest.raises(ValueError, match="copy instance"):
        RGLRU.plan_rg_lru(2, 33, w, aligned, vec=2)


def test_rg_lru_plan_at_the_hybrid_prefill():
    assert RGLRU.plan_rg_lru(2, 3072, 2560, True) == RGLRU.RgLruPlan(
        4, 32, 32, 4, 32768, 160)


def test_rg_lru_aligned16_reads_every_pointer():
    buf = torch.zeros(64)
    assert RGLRU.aligned16(buf, buf[4:])
    assert not RGLRU.aligned16(buf, buf[1:])
    assert not RGLRU.aligned16(buf[2:])


def test_rg_lru_plan_tiles_are_the_c_sources():
    """The C entry launches the tiles it was built with (kC, kT, kStages)
    and refuses a plan that names others; the planner states the same, and
    the ring fits the card's 227 KB of shared memory a block."""
    src = (ROOT / "src/repro_torch/csrc/rg_lru.cu").read_text()
    assert (_rg_const(src, "kC"), _rg_const(src, "kT"),
            _rg_const(src, "kStages")) == (RGLRU.CHANNELS, RGLRU.STEPS,
                                           RGLRU.STAGES)
    assert "c == kC && t == kT && stages == kStages" in src
    assert "b <= 65535" in src and RGLRU.MAX_B == 65535
    assert 2 * RGLRU.STAGES * RGLRU.STEPS * RGLRU.CHANNELS * 4 <= 227 * 1024


@pytest.mark.parametrize("b,s,w", [(1, 1, 1), (2, 3072, 2560), (3, 1000, 7),
                                   (65535, 2, 36), (1, 33, 65)])
def test_rg_lru_plan_is_inside_the_c_entrys_bounds(b, s, w):
    """Every shape the kernel takes gets the built tiles, ceil(W / C) x B
    blocks and the instance its width allows."""
    plan = RGLRU.plan_rg_lru(b, s, w, True)
    assert plan[1:4] == (RGLRU.CHANNELS, RGLRU.STEPS, RGLRU.STAGES)
    assert plan.smem_bytes == 2 * plan.stages * plan.steps * plan.channels * 4
    assert plan.blocks == -(-w // plan.channels) * b
    assert plan.vec == (4 if w % 4 == 0 else 1)


@pytest.mark.parametrize("b,s,w,match", [
    (65536, 8, 32, "B <="), (0, 8, 32, "B <="), (1, 0, 32, "S >= 1"),
    (1, 8, 0, "W >= 1"), (2, -3, 7, "S >= 1")])
def test_rg_lru_plan_refuses_shapes_outside_the_kernel(b, s, w, match):
    with pytest.raises(ValueError, match=match):
        RGLRU.plan_rg_lru(b, s, w, True)


def _rg_inputs(rng, b, s, w):
    a = torch.from_numpy(rng.uniform(0.8, 0.999, (b, s, w)).astype(np.float32))
    x = torch.from_numpy((rng.standard_normal((b, s, w)) * 0.1)
                         .astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32))
    return a, x, h0


@pytest.mark.parametrize("s", [1, 33, 1000])
@pytest.mark.parametrize("w", [7, 65, 2560])
def test_rg_lru_ring_walk_equals_the_plain_version_bitwise(s, w):
    """The kernel's walk, tile by tile through the ring with h carried
    across tiles, under the built tiles and others (two stages of 8 steps;
    8 stages of 128; tiles longer than S)."""
    b = 1 if w == 2560 else 2
    args = _rg_inputs(np.random.default_rng(s * w), b, s, w)
    plain = RGLRU_REF.rg_lru_ref(*args)
    for steps, stages in ((RGLRU.STEPS, RGLRU.STAGES), (8, 2), (128, 8),
                          (24, 3)):
        got = RGLRU_REF.rg_lru_ring_model(*args, steps, stages)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)


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
            dev = ENG.offload_table(n_layers, n_slots, pages, slot, idx, 1,
                                    CPU)
            assert dev.dtype == torch.int32 and dev.is_contiguous()
            assert torch.equal(dev, host)
            # a block of several pages (a ring read in pages smaller than
            # a pool block): its consecutive pages in every layer
            n = pages - idx
            many = ENG.offload_table(n_layers, n_slots, pages, slot, idx, n,
                                     CPU)
            assert many.dtype == torch.int32 and many.is_contiguous()
            assert torch.equal(many, host + torch.arange(n,
                                                         dtype=torch.int32))
