"""Sharded sweeps in the port, on CPU meshes: bitwise to the unsharded run,
and equal to the reference's unsharded run.

The meshes repeat the CPU device (``make_local_mesh(..., device="cpu")``),
the port's stand-in for the reference's virtual host devices, so the
whole split, exchange and merge logic runs here:

  * the event engine with policy and seed axes on cut fig7 workloads
    (BFS and BP at 6 warps × 4 instructions, 4 policies, seeds 0 and 1);
  * the wavefront engine with policy and warp axes on PHASED48 cut to 8
    instructions (the sharded-warp path);
  * the replication fallback (3 policies on a 2-wide axis) and a size-1
    mesh, which take the unsharded path.

Each sharded run equals the port's unsharded run bitwise
(``array_equal``, NaN equal to NaN) and the reference's unsharded
``Experiment.run`` at ``tests/test_torch_api.py``'s tolerance (integers
and per-element outputs exactly, float reductions to rtol 1e-6); the
reference's own sharded == unsharded is its subprocess smoke
(``tests/test_sharded_sweep.py``). Then the wave selection's shard merge
against the global stable sort, and one launch of each pass a wave
whatever the shard count.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import baselines as JBL
from repro.core import tracegen as JTG
from repro.core import workloads as JWL

from repro_torch import api
from repro_torch import sharding as SH
from repro_torch.core import baselines as BL
from repro_torch.core import tracegen as TG
from repro_torch.core import workloads as WL
from repro_torch.core.engine import SimParams, simulate, simulate_sweep
from repro_torch.core.engine import wavefront as WF
from repro_torch.launch import make_local_mesh

FLOAT_REDUCTIONS = ("ipc", "ipc_makespan", "qdelay_sum", "stall_cycles",
                    "energy", "perf_per_energy", "mean_qdelay", "miss_rate")

CUT = dict(n_warps=6, n_instr=4)
EV_POLS = ((BL.BASELINE, BL.PCAL, BL.WBYP, BL.MEDIC),
           (JBL.BASELINE, JBL.PCAL, JBL.WBYP, JBL.MEDIC))
WF_POLS = ((BL.BASELINE, BL.MEDIC_STALE, BL.MEDIC, BL.MEDIC_ORACLE),
           (JBL.BASELINE, JBL.MEDIC_STALE, JBL.MEDIC, JBL.MEDIC_ORACLE))
PHASED_INSTR = 8


def _fig7(pkg, tg, wl):
    """BFS and BP cut, seeds 0 and 1: one bucket of 4 traces."""
    return tuple(pkg.Scenario.from_spec(dataclasses.replace(
        tg.TraceSpec.from_workload(wl.WORKLOADS[n]), **CUT), seeds=(0, 1))
        for n in ("BFS", "BP"))


def _phased(pkg, tg):
    return (pkg.Scenario.from_spec(dataclasses.replace(
        tg.PHASED_SPECS["PHASED48"], n_instr=PHASED_INSTR)),)


def _bitwise(a, b):
    assert a.scenarios == b.scenarios and a.policies == b.policies
    for sc in a.scenarios:
        for seed in a.seeds(sc):
            x, y = a.get(sc, seed=seed), b.get(sc, seed=seed)
            assert set(x) == set(y)
            for k in x:
                assert np.array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                      equal_nan=True), (sc, seed, k)


def _like_reference(rs, jrs):
    assert rs.scenarios == jrs.scenarios and rs.policies == jrs.policies
    for sc in jrs.scenarios:
        for seed in jrs.seeds(sc):
            got, want = rs.get(sc, seed=seed), jrs.get(sc, seed=seed)
            assert set(got) == set(want)
            for k in want:
                a, b = np.asarray(got[k]), np.asarray(want[k])
                if k in FLOAT_REDUCTIONS:
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                               err_msg=k)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def runs():
    """Each experiment once unsharded in the port and in the reference."""
    ev = api.Experiment("ev", _fig7(api, TG, WL), EV_POLS[0], device="cpu")
    jev = japi.Experiment("ev", _fig7(japi, JTG, JWL), EV_POLS[1])
    wf = api.Experiment("wf", _phased(api, TG), WF_POLS[0],
                        engine="wavefront", device="cpu")
    jwf = japi.Experiment("wf", _phased(japi, JTG), WF_POLS[1],
                          engine="wavefront")
    return {"ev": (ev, ev.run(), jev.run()),
            "wf": (wf, wf.run(), jwf.run())}


@pytest.mark.parametrize("mesh_shape,axes,want", [
    ((2, 4), ("data", "model", None), ("data", "model", None)),
    ((2, 2), ("data", "model", None), ("data", "model", None)),
    ((1, 4), None, (None, "model", None)),
    ((2, 4), (("data", "model"), None, None), (None, None, None)),
    ((2, 2), (("data", "model"), None, None),
     (("data", "model"), None, None)),
])
def test_event_policy_and_seed_sharding_is_bitwise(runs, mesh_shape, axes,
                                                   want):
    exp, rs, jrs = runs["ev"]
    sh = exp.with_(mesh=make_local_mesh(*mesh_shape, device="cpu"),
                   mesh_axes=axes)
    call = sh.compile().calls[0]
    assert (call.policy_axes, call.seed_axes, call.warp_axes) == want
    srs = sh.run()
    _bitwise(rs, srs)
    _like_reference(srs, jrs)


@pytest.mark.parametrize("mesh_shape,axes,want", [
    ((2, 4), ("data", None, "model"), ("data", None, "model")),
    ((1, 4), (None, None, "model"), (None, None, "model")),
    ((2, 4), (None, None, ("data", "model")),
     (None, None, ("data", "model"))),
])
def test_wavefront_policy_and_warp_sharding_is_bitwise(runs, mesh_shape,
                                                       axes, want):
    exp, rs, jrs = runs["wf"]
    sh = exp.with_(mesh=make_local_mesh(*mesh_shape, device="cpu"),
                   mesh_axes=axes)
    call = sh.compile().calls[0]
    assert (call.policy_axes, call.seed_axes, call.warp_axes) == want
    assert "sharded(" in sh.compile().describe()
    srs = sh.run()
    _bitwise(rs, srs)
    _like_reference(srs, jrs)


@pytest.mark.parametrize("engine,mesh_shape,axes", [
    ("event", (2, 4), ("data", "model", None)),
    ("event", (1, 4), None),
    ("event", (2, 2), (("data", "model"),)),
    ("wavefront", (2, 4), ("data", None, "model")),
    ("wavefront", (2, 4), (None, "data", ("model",))),
])
def test_plan_placement_matches_reference(engine, mesh_shape, axes):
    """Each bucket's resolved placement, ``describe()`` and executable
    count equal the reference's plan on the same mesh shape (compiled
    only, nothing run)."""
    from jax.sharding import AbstractMesh
    port = api.Experiment("p", _fig7(api, TG, WL) + _phased(api, TG),
                          EV_POLS[0], engine=engine, device="cpu").with_(
        mesh=make_local_mesh(*mesh_shape, device="cpu"), mesh_axes=axes)
    ref = japi.Experiment("p", _fig7(japi, JTG, JWL) + _phased(japi, JTG),
                          EV_POLS[1], engine=engine).with_(
        mesh=AbstractMesh(mesh_shape, ("data", "model")), mesh_axes=axes)
    pp, rp = port.compile(), ref.compile()
    assert port.mesh_axes == ref.mesh_axes
    assert pp.describe() == rp.describe()
    assert pp.n_executables == rp.n_executables
    assert [(c.policy_axes, c.seed_axes, c.warp_axes) for c in pp.calls] \
        == [(c.policy_axes, c.seed_axes, c.warp_axes) for c in rp.calls]


def test_nondividing_axes_fall_back_to_replication():
    """3 policies on a 2-wide axis and a 2-seed stack on a 4-wide one:
    every placement resolves to None, the plan still runs, and equals the
    mesh-less run and the reference."""
    sc = _fig7(api, TG, WL)[:1]
    exp = api.Experiment("fb", sc, (BL.BASELINE, BL.PCAL, BL.MEDIC),
                         device="cpu")
    sh = exp.with_(mesh=make_local_mesh(2, 4, device="cpu"),
                   mesh_axes=("data", "model", None))
    call = sh.compile().calls[0]
    assert call.mesh is not None
    assert (call.policy_axes, call.seed_axes, call.warp_axes) == \
        (None, None, None)
    jexp = japi.Experiment("fb", _fig7(japi, JTG, JWL)[:1],
                           (JBL.BASELINE, JBL.PCAL, JBL.MEDIC))
    rs, srs = exp.run(), sh.run()
    _bitwise(rs, srs)
    _like_reference(srs, jexp.run())
    assert sh.compile().describe().splitlines()[1].endswith(
        "flat=2 sharded(policy=None seed=None warp=None): BFSx2")


def test_size1_mesh_is_the_unsharded_run(runs):
    exp, rs, _ = runs["wf"]
    sh = exp.with_(mesh=make_local_mesh(1, 1, device="cpu"),
                   mesh_axes=("data", "model", None))
    call = sh.compile().calls[0]
    assert (call.policy_axes, call.seed_axes, call.warp_axes) == \
        (None, None, None)
    _bitwise(rs, sh.run())
    assert sh.compile().n_executables == exp.compile().n_executables == 1
    assert sh.compile().calls[0].compile_key(4, SimParams()) != \
        exp.compile().calls[0].compile_key(4, SimParams())


def _trace(n_warps=24, n_instr=6, seed=3):
    spec = dataclasses.replace(TG.PHASED_SPECS["PHASED48"], n_warps=n_warps,
                               n_instr=n_instr)
    return TG.generate(spec, seed)


def test_simulate_warp_sharding_is_bitwise_and_stays_on_the_mesh():
    """``simulate(mesh=, warp_axes=)`` directly: bitwise, outputs on the
    mesh's first device; a device of another type raises."""
    tr = _trace()
    kw = dict(n_warps=24, lanes=tr["lines"].shape[-1], prm=SimParams(),
              pol=BL.MEDIC, engine="wavefront",
              oracle_types=tr["oracle_wtype"])
    base = simulate(tr["lines"], tr["pcs"], tr["compute_gap"],
                    device="cpu", **kw)
    mesh = make_local_mesh(1, 8, device="cpu")
    got = simulate(tr["lines"], tr["pcs"], tr["compute_gap"], mesh=mesh,
                   warp_axes="model", **kw)
    for k in base:
        assert got[k].device.type == "cpu"
        assert np.array_equal(base[k].numpy(), got[k].numpy(),
                              equal_nan=True), k
    with pytest.raises(ValueError, match="device type"):
        simulate(tr["lines"], tr["pcs"], tr["compute_gap"], mesh=mesh,
                 warp_axes="model", device="cuda", **kw)
    with pytest.raises(ValueError, match="without a mesh"):
        simulate(tr["lines"], tr["pcs"], tr["compute_gap"],
                 warp_axes="model", device="cpu", **kw)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_warp_shards_are_cut_from_the_callers_trace(monkeypatch, n_shards):
    """With warp axes the trace stays where the caller has it: each shard
    is its contiguous block, cut from the caller's array with no copy of
    the whole on the way (on a card, each block goes straight from the
    host to its shard's device)."""
    tr = _trace(n_warps=16, n_instr=4, seed=2)
    lines = np.ascontiguousarray(tr["lines"], dtype=np.int32)
    seen = []
    make = WF.make_shards
    monkeypatch.setattr(WF, "make_shards",
                        lambda *a: seen.append(make(*a)) or seen[-1])
    simulate(lines, tr["pcs"], tr["compute_gap"], n_warps=16,
             lanes=lines.shape[-1], prm=SimParams(), pol=BL.MEDIC,
             engine="wavefront", mesh=make_local_mesh(1, n_shards,
                                                      device="cpu"),
             warp_axes="model", oracle_types=tr["oracle_wtype"])
    (shards,) = seen
    wk = 16 // n_shards
    assert len(shards) == n_shards
    for j, sh in enumerate(shards):
        assert np.shares_memory(sh.lines.numpy(), lines)
        assert np.array_equal(sh.lines.numpy(), lines[:, j * wk:(j + 1) * wk]
                              .transpose(1, 0, 2))


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _trace(n_warps=8, n_instr=2)
    mesh = SH.Mesh(np.full((1, 2), "cuda:0", dtype=object),
                   ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"],
                       (BL.MEDIC,), n_warps=8, lanes=tr["lines"].shape[-1],
                       prm=SimParams(), engine="wavefront", mesh=mesh,
                       warp_axes="model", oracle_types=tr["oracle_wtype"])
    exp = api.Experiment("c", _fig7(api, TG, WL)[:1], (BL.MEDIC,),
                         mesh=mesh)
    with pytest.raises(RuntimeError, match="CUDA device"):
        exp.run()
    # with one card, a mesh naming a second raises before any work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    two = SH.Mesh(np.array([["cuda:0", "cuda:1"]], dtype=object),
                  ("data", "model"))
    with pytest.raises(ValueError, match=r"names \['cuda:1'\]"):
        api.Experiment("c", _fig7(api, TG, WL)[:1], (BL.MEDIC,),
                       mesh=two).run()


# ---------------------------------------------------------------------------
# the wave selection's shard merge, and one launch of each pass a wave
# ---------------------------------------------------------------------------

def _shards_of(ready, ptr, n):
    w = ready.shape[0]
    wk = w // n
    mesh = make_local_mesh(1, n, device="cpu")
    zeros = torch.zeros((w, 1, 1), dtype=torch.int32)
    shards = WF.make_shards(
        zeros, zeros[..., 0], zeros[..., 0], torch.zeros(w, dtype=torch.bool),
        lambda x: SH.split_leading(x, mesh, "model" if n > 1 else None))
    for j, sh in enumerate(shards):
        sh.ready[:wk] = ready[j * wk:(j + 1) * wk]
        sh.ptr[:wk] = ptr[j * wk:(j + 1) * wk]
    return shards


@pytest.mark.parametrize("seed", range(6))
def test_shard_merge_equals_the_global_stable_sort(seed):
    """Many tied ready times, inactive warps and waves wider than a
    shard: the merged candidates equal the first B of the global stable
    sort, ties by warp id included."""
    rng = np.random.default_rng(seed)
    n_instr = 4
    for w in (8, 24, 64):
        ready = torch.tensor(rng.integers(0, 3, w).astype(np.float32))
        ptr = torch.tensor(rng.integers(0, n_instr + 1, w), dtype=torch.int32)
        ptr[rng.integers(0, w)] = n_instr          # at least one inactive
        key = torch.where(ptr < n_instr, ready, float("inf"))
        order = torch.sort(key, stable=True).indices
        for n in (1, 2, 4, 8):
            if w % n:
                continue
            shards = _shards_of(ready, ptr, n)
            for b in (1, 3, w // n, w // n + 1, w):
                got = WF.select_wave(shards, n_instr, min(b, w),
                                     torch.device("cpu"))
                assert torch.equal(got, order[:min(b, w)]), (w, n, b)


class _Count:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_each_pass_runs_once_a_wave_whatever_the_shard_count(
        monkeypatch, n_shards):
    """The cache pass and the timing pass are called once a wave on the
    simulation's device, and the waves are the unsharded run's."""
    tr = _trace(n_warps=16, n_instr=4, seed=1)
    cache = _Count(WF.CPASS.wave_cache_pass)
    queue = _Count(WF.WSCAN.wave_queue_recovery)
    monkeypatch.setattr(WF.CPASS, "wave_cache_pass", cache)
    monkeypatch.setattr(WF.WSCAN, "wave_queue_recovery", queue)
    mesh = make_local_mesh(1, n_shards, device="cpu")
    before = WF.WAVES.waves
    out = simulate(tr["lines"], tr["pcs"], tr["compute_gap"], n_warps=16,
                   lanes=tr["lines"].shape[-1], prm=SimParams(),
                   pol=BL.MEDIC, engine="wavefront", mesh=mesh,
                   warp_axes="model", oracle_types=tr["oracle_wtype"])
    waves = WF.WAVES.waves - before
    assert waves > 0 and cache.calls == waves and queue.calls == waves
    # the unsharded run takes as many waves (a size-1 axis: no shards)
    before = WF.WAVES.waves
    base = simulate(tr["lines"], tr["pcs"], tr["compute_gap"], n_warps=16,
                    lanes=tr["lines"].shape[-1], prm=SimParams(),
                    pol=BL.MEDIC, engine="wavefront", device="cpu",
                    oracle_types=tr["oracle_wtype"])
    assert WF.WAVES.waves - before == waves
    for k in base:
        assert np.array_equal(out[k].numpy(), base[k].numpy(),
                              equal_nan=True), k
