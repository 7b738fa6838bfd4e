"""The port's trace generator against the reference's, bit-exact.

``repro_torch.core.tracegen`` is a host-side numpy copy of
``repro.core.tracegen`` (splitmix64 on ``np.uint64``); every array the
engines consume must match: ``lines``, ``pcs``, ``compute_gap`` and
``oracle_wtype``, over the 15 paper workloads × 3 seeds, every phased
spec of both drift directions, the stress matrix at 128 warps and
HAMMER2K once at full size.

Below them, the CUDA sampler's host side on the CPU: ``lower_warps`` is
``lower`` without the working-set tables (rebuilt from the keys, they are
the reference's), the kernel's inputs run through its formula in numpy
(``kernels.tracegen.ref.tracegen_model``) give the numpy sampler's bits,
and a sweep on the CPU or on a mesh samples every cell on the host
(``CELLS``), with ``ResultSet.trace`` the same numpy arrays either way.
The kernel itself is held against the sampler on the card
(tests/test_torch_kernels_cuda.py).
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


# ---- the CUDA sampler's host side -----------------------------------------

def _cut_specs(tg=TG, wl=WL):
    """A paper workload, a legacy flip, scheduled phases with churn in
    both directions, a boosted shared pool and a warp override (from the
    port's tables, or the reference's)."""
    rep = dataclasses.replace
    return [tg.TraceSpec.from_workload(wl.WORKLOADS["BFS"]),
            rep(tg.STRESS_SPECS["PHASE2K"], n_warps=96),
            tg.PHASED_SPECS["PHASED256"],
            tg.PHASED_RECOVER_SPECS["PHASED_RECOVER48"],
            rep(tg.STRESS_SPECS["FRONTIER2K"], n_warps=64),
            rep(tg.SHARD_STRESS_SPECS["HAMMER16K"], n_warps=130)]


@pytest.mark.parametrize("k", range(6))
def test_lower_warps_is_lower_without_its_tables(k):
    spec, jspec = _cut_specs()[k], _cut_specs(JTG, JWL)[k]
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    seeds = (0, 2**31 + 9)
    layout, wp = TG.lower(spec, seeds)
    layout2, bare = TG.lower_warps(spec, seeds)
    jlayout, jwp = JTG.lower(jspec, seeds)
    assert layout == layout2 and bare.ws_table is None
    for f in dataclasses.fields(wp):
        if f.name != "ws_table":
            x, y = getattr(wp, f.name), getattr(bare, f.name)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    table = TG.working_sets(spec, layout2, bare.ws_key)
    assert table.dtype == np.asarray(jwp.ws_table).dtype
    np.testing.assert_array_equal(table, wp.ws_table)
    np.testing.assert_array_equal(table, np.asarray(jwp.ws_table))
    for f in ("arch", "ws_size", "reuse", "shared", "pc_table", "pool"):
        np.testing.assert_array_equal(getattr(bare, f),
                                      np.asarray(getattr(jwp, f)),
                                      err_msg=f)


@pytest.mark.parametrize("k", range(6))
def test_kernel_formula_on_its_inputs_is_the_sampler(k):
    """The kernel's per-cell formula over the packed inputs, in numpy,
    against the numpy sampler at two seeds; the packed buffer holds each
    input at its offset."""
    from repro_torch.core.tracegen.sampler import _sample_cells
    from repro_torch.kernels.tracegen import ops as KTG
    from repro_torch.kernels.tracegen import ref as KREF
    spec, seeds = _cut_specs()[k], (3, 2**32 + 5)
    ins, wp = KREF.cell_inputs(spec, seeds)
    host = _sample_cells(spec, seeds)
    lines, pcs, oracle = KREF.tracegen_model(ins)
    for k, v in (("lines", lines), ("pcs", pcs), ("oracle_wtype", oracle)):
        assert v.dtype == host[k].dtype and v.shape == host[k].shape, k
        np.testing.assert_array_equal(v, host[k], err_msg=k)
    blob, offsets = KTG._pack(ins[1:])
    for a, o in zip(ins[1:], offsets):
        assert o % 16 == 0 and a.flags.c_contiguous
        np.testing.assert_array_equal(
            blob[o:o + a.nbytes].view(a.dtype).reshape(a.shape), a)


def test_materialize_on_the_cpu_is_the_host_trace():
    from repro_torch.api.scenario import Scenario
    for sc in (Scenario.workload("BFS", seeds=(0, 4)),
               Scenario.phased("PHASED48", seeds=(2,)),
               Scenario.stress("HAMMER2K", seeds=(1,), n_warps=64)):
        host, cpu = sc.materialize(), sc.materialize("cpu")
        assert set(host) == set(cpu)
        for k, v in host.items():
            got = cpu[k].numpy() if k in ("lines", "pcs", "oracle_wtype") \
                else cpu[k]
            assert got.dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_sampler_backend_gate():
    from repro_torch.kernels.tracegen import ops as KTG
    spec = TG.PHASED_SPECS["PHASED48"]
    assert KTG.resolve_backend("auto", "cpu") == "ref"
    with pytest.raises(ValueError, match="CUDA"):
        KTG.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        KTG.sample_cells_cuda(spec, (0,), "cpu")
    with pytest.raises(ValueError, match="unknown"):
        KTG.sample_cells(spec, (0,), "cpu", backend="triton")


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_cpu_and_mesh_sweeps_sample_on_the_host(where):
    """A sweep on the CPU and one on a (CPU) mesh draw every cell with the
    numpy sampler; ``ResultSet.trace`` gives numpy arrays, equal to the
    host trace, on both."""
    from repro_torch import api
    from repro_torch.core import baselines as BL
    from repro_torch.launch import make_local_mesh
    specs = [dataclasses.replace(TG.TraceSpec.from_workload(
        WL.WORKLOADS[n]), n_instr=4, n_warps=8, lines_per_instr=4)
        for n in ("BFS", "BP")]
    scens = tuple(api.Scenario.from_spec(s, seeds=(0, 7)) for s in specs)
    extra = dict(device="cpu") if where == "cpu" else dict(
        mesh=make_local_mesh(2, 1, device="cpu"))
    exp = api.Experiment("t", scens, (BL.BASELINE, BL.MEDIC), **extra)
    before = dict(TG.CELLS)
    rs = exp.run(keep_traces=True)
    assert TG.CELLS["device"] == before["device"]
    assert TG.CELLS["host"] - before["host"] == 2 * 2 * 4 * 8 * 4
    for sc in scens:
        host = sc.materialize()
        for f, seed in enumerate(sc.seeds):
            tr = rs.trace(scenario=sc.name, seed=seed)
            assert set(tr) == {"lines", "pcs", "compute_gap", "archetype",
                               "oracle_wtype"}
            for k, v in tr.items():
                assert isinstance(v, (np.ndarray, np.generic)), k
                assert v.dtype == host[k].dtype, k
                assert np.shape(v) == host[k].shape[1:], k
                np.testing.assert_array_equal(v, host[k][f], err_msg=k)
