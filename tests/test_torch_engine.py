"""The port's wavefront engine end to end against the JAX reference.

``repro_torch`` ``simulate_sweep(device="cpu")`` (the plain PyTorch
passes) against ``repro`` ``simulate_sweep(engine="wavefront",
scan_backend="ref", cache_backend="ref")`` on the same traces. Integer
metrics and every per-element output (``warp_time``, ``makespan``,
``ratio_over_time``, ``warp_type``, ``warp_hit_ratio``) must be bitwise
equal; the float reductions may differ only in summation order
(``request.py``'s closing sums and the per-wave ``qdelay_sum`` /
``stall_cycles`` adds), so they are held to rtol 1e-6.

The phased labeling-ladder cases are in tests/test_torch_engine_phased.py.
Also here: the facade's error contract, and that nothing under
``src/repro_torch/``, no ``examples/torch_*.py`` and not ``chip_smoke.py``
imports JAX or the reference.
"""
import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JBL
from repro.core import engine as JE
from repro.core import tracegen as JTG
from repro.core import workloads as JWL

from repro_torch.core import baselines as BL
from repro_torch.core import engine as E
from repro_torch.core import tracegen as TG

ROOT = Path(__file__).resolve().parents[1]

#: float reductions whose summation order differs between torch and XLA
FLOAT_REDUCTIONS = ("ipc", "ipc_makespan", "qdelay_sum", "stall_cycles",
                    "energy", "perf_per_energy", "mean_qdelay", "miss_rate")

FOUR = ((BL.BASELINE, BL.PCAL, BL.WBYP, BL.MEDIC),
        (JBL.BASELINE, JBL.PCAL, JBL.WBYP, JBL.MEDIC))


def check_sweep(tr, pols, *, n_warps, lanes, wave_size=None):
    """Run both packages on trace dict ``tr`` and compare every metric."""
    args = (tr["lines"], tr["pcs"], tr["compute_gap"])
    ref = JE.simulate_sweep(
        *[jnp.asarray(a) for a in args], pols[1], n_warps=n_warps,
        lanes=lanes, prm=JE.SimParams(), engine="wavefront",
        wave_size=wave_size, scan_backend="ref", cache_backend="ref",
        oracle_types=jnp.asarray(tr["oracle_wtype"]))
    out = E.simulate_sweep(
        *args, pols[0], n_warps=n_warps, lanes=lanes, prm=E.SimParams(),
        engine="wavefront", wave_size=wave_size,
        oracle_types=tr["oracle_wtype"], device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        a, b = np.asarray(ref[k]), out[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in FLOAT_REDUCTIONS:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    return out


def _workload(name, n_instr):
    wl = JWL.WORKLOADS[name]
    return JTG.generate(dataclasses.replace(
        JTG.TraceSpec.from_workload(wl), n_instr=n_instr), 0)


def test_bfs_four_policies():
    check_sweep(_workload("BFS", 16), FOUR, n_warps=48, lanes=16)


def test_srad_phase_shift():
    pols = ((BL.EAF, BL.PC_BYP, BL.MEDIC), (JBL.EAF, JBL.PC_BYP, JBL.MEDIC))
    check_sweep(_workload("SRAD", 16), pols, n_warps=48, lanes=16)


def _small_spec(**kw):
    base = dict(name="SMALL", mix=(0.1, 0.3, 0.2, 0.2, 0.2), intensity=0.9,
                n_warps=6, n_instr=6, lines_per_instr=8, n_pcs=4,
                shared_pool_lines=16, shared_boost=4.0)
    base.update(kw)
    return JTG.TraceSpec(**base)


def test_wave_of_one_warp_takes_the_exact_floor():
    check_sweep(JTG.generate(_small_spec(), 3), FOUR, n_warps=6, lanes=8,
                wave_size=1)


def test_seed_stacked_sweep():
    tr = JTG.generate_batch([_small_spec(n_warps=16, n_instr=8)], (0, 1))
    tr = {k: v[0] for k, v in tr.items()}              # [S=2, ...]
    out = check_sweep(tr, ((BL.MEDIC, BL.WBYP), (JBL.MEDIC, JBL.WBYP)),
                      n_warps=16, lanes=8)
    assert out["ipc"].shape == (2, 2)


def test_port_tracegen_feeds_the_engine():
    """The port's own trace generator drives ``simulate`` (one policy)."""
    spec = TG.TraceSpec(**dataclasses.asdict(_small_spec()))
    tr = TG.generate(spec, 0)
    one = E.simulate(tr["lines"], tr["pcs"], tr["compute_gap"], n_warps=6,
                     lanes=8, prm=E.SimParams(), pol=BL.MEDIC,
                     engine="wavefront", device="cpu")
    sweep = E.simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"],
                             (BL.MEDIC,), n_warps=6, lanes=8,
                             prm=E.SimParams(), engine="wavefront",
                             device="cpu")
    for k in one:
        torch.testing.assert_close(one[k], sweep[k][0], rtol=0, atol=0)


def _tiny_args():
    tr = TG.generate(TG.TraceSpec(**dataclasses.asdict(_small_spec())), 0)
    return (tr["lines"], tr["pcs"], tr["compute_gap"]), \
        dict(n_warps=6, lanes=8, prm=E.SimParams())


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, kw = _tiny_args()
    with pytest.raises(RuntimeError, match="CUDA device"):
        E.simulate_sweep(*args, (BL.MEDIC,), engine="wavefront", **kw)
    with pytest.raises(RuntimeError, match="CUDA device"):
        E.simulate(*args, pol=BL.MEDIC, engine="wavefront", **kw)


def test_engine_and_backend_errors():
    args, kw = _tiny_args()
    # the reference's event contract: the event engine takes no wave size
    # and no non-default wavefront backend
    with pytest.raises(ValueError, match="wave_size"):
        E.simulate_sweep(*args, (BL.MEDIC,), wave_size=2, device="cpu",
                         **kw)
    with pytest.raises(ValueError, match="scan_backend"):
        E.simulate(*args, pol=BL.MEDIC, engine="event", scan_backend="ref",
                   device="cpu", **kw)
    with pytest.raises(ValueError, match="cache_backend"):
        E.validate_engine_args("event", cache_backend="cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        E.validate_engine_args("scan")
    for bad in ("fused", "pallas", "triton"):
        with pytest.raises(ValueError, match="scan_backend"):
            E.validate_engine_args("wavefront", scan_backend=bad)
        with pytest.raises(ValueError, match="cache_backend"):
            E.validate_engine_args("wavefront", cache_backend=bad)
    with pytest.raises(ValueError, match="wave_size"):
        E.validate_engine_args("wavefront", wave_size=0)
    with pytest.raises(ValueError, match="oracle"):
        E.simulate_sweep(*args, (BL.MEDIC_ORACLE,), engine="wavefront",
                         device="cpu", **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        E.simulate_sweep(*args, (BL.MEDIC,), engine="wavefront",
                         scan_backend="cuda", device="cpu", **kw)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)} imports {mod}"
