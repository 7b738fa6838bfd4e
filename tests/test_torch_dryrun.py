"""The dry run (``repro_torch.launch.dryrun``) and its op-stream counter
(``launch.hlo_analysis``) against the reference's, on the CPU.

Analyzer units (the counterparts of ``tests/test_dryrun_small.py``'s):
bytes of a shape, a Python-loop matmul chain of L layers counting
2·B·D·D·L, a loop-free product equal to ``flop_registry``'s, the traffic
and live-bytes rules, and the kernels' launches on meta tensors (each
kernel's products against its plain version's). Then ``run_cell`` on a
(1, 1) mesh against the reference's (monkeypatched as that file does):
argument bytes, dot FLOPs per device and model FLOPs of a dense and an
MoE train step, a prefill and a hybrid's decode. Then eight virtual host
devices in a subprocess: argument bytes on (2, 4) and (8, 1), dot FLOPs
on (8, 1) equal and on (2, 4) a lower bound, and the set of (logical
axes, shape) constraints that ``shard_act`` resolves in one train step
of each family. Last, the CLI, the collectives of the parameter plan and
the roofline's links.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from torch.utils.flop_counter import flop_registry

from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import get_config as jget
from repro.launch.mesh import make_local_mesh as jmesh

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.kernels.decode_attention import ops as DEC
from repro_torch.kernels.flash_attention import ops as FLASH
from repro_torch.kernels.mlstm import ops as MLSTM
from repro_torch.kernels.rg_lru import ops as RGLRU
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import make_local_mesh, make_production_mesh
from repro_torch.sharding import Mesh

aten = torch.ops.aten
META = "meta"


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _reference_dryrun():
    """``repro.launch.dryrun``, imported after this process's JAX backend
    has started: its import sets ``XLA_FLAGS`` to 512 host devices, which
    is put back as it was for the processes started later."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as JDR
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return JDR


# ---------------------------------------------------------------------------
# analyzer units
# ---------------------------------------------------------------------------

def test_shape_bytes():
    assert HA.nbytes(_meta(128, 64)) == 4 * 128 * 64
    assert HA.nbytes(_meta(2, 3, dtype=torch.bfloat16)) + \
        HA.nbytes(_meta(dtype=torch.int32)) == 16
    assert HA.nbytes(_meta(8, 8)[2:4]) == 4 * 16     # a view: its elements


def test_counter_counts_a_python_loop_of_matmuls():
    """The reference rolls a scanned chain up by its trip count; eager
    torch runs the loop, so every layer's product is its own op."""
    L, B, D = 8, 4, 32
    ws, x = _meta(L, D, D), _meta(B, D)
    with HA.OpCounter(META) as c:
        y = x
        for layer in range(L):
            y = torch.tanh(y @ ws[layer])
        y.sum()
    assert c.summary.dot_flops == 2 * B * D * D * L
    # mm, tanh and sum outputs, x2; the select views count nothing
    assert c.summary.mem_bytes == 2 * (2 * L * B * D * 4 + 4)
    assert c.summary.peak_bytes == 3 * B * D * 4


def test_loop_free_products_match_flop_registry():
    a, b = torch.randn(64, 128), torch.randn(128, 96)
    x, y = torch.randn(3, 4, 5), torch.randn(3, 5, 6)
    bias = torch.randn(96)
    with HA.OpCounter("cpu") as c:
        ab = a @ b
    assert c.summary.dot_flops == flop_registry[aten.mm](a, b, out_val=ab)
    with HA.OpCounter("cpu") as c:
        xy = torch.bmm(x, y)
        out = torch.addmm(bias, a, b)
    assert c.summary.dot_flops == \
        flop_registry[aten.bmm](x, y, out_val=xy) + \
        flop_registry[aten.addmm](bias, a, b, out_val=out)


def test_traffic_views_inplace_and_reads():
    """Views and shape-only allocations count no bytes; an in-place op
    counts what it writes; ``read`` says which watched tensors were read
    (a whole overwrite and a ``full_like`` read nothing)."""
    w, r, s, k, u = (_meta(4, 8), _meta(4, 8), _meta(4, 8), _meta(16),
                     _meta(4, 8))
    with HA.OpCounter(META, watch=(w, r, s, k, u)) as c:
        u.view(8, 4).t()                    # views (a view reads)
        torch.full_like(s, 1.0)             # shape only, writes 4*8*4
        w.copy_(torch.zeros(4, 8, device=META))
        r.add_(1.0)
        k[:4].fill_(0.0)                    # a slice view, then fill_
    assert c.read == {1, 3, 4}
    assert c.summary.mem_bytes == 2 * (128 + 128 + 128 + 128 + 16)
    assert c.summary.dot_flops == 0


def test_kernels_on_meta_are_one_op_with_their_products():
    """On meta tensors the gate ``auto`` takes the card's route: one
    counted launch each, its products the plain version's (flash: only
    the pairs its mask leaves), its bytes read and written once."""
    b, s, h, kv, d = 2, 48, 4, 2, 16
    q, k, v = _meta(b, s, h, d), _meta(b, s, kv, d), _meta(b, s, kv, d)
    for causal, window in ((False, None), (True, None), (True, 20)):
        with HA.OpCounter(META) as kern:
            out = FLASH.flash_attention(q, k, v, causal=causal,
                                        window=window)
        with HA.OpCounter(META) as plain:
            FLASH.flash_attention(q, k, v, causal=causal, window=window,
                                  backend="ref")
        assert out.shape == q.shape and out.device.type == META
        assert kern.summary.kernels == {"flash_attention": 1}
        i = torch.arange(s)[:, None]
        j = torch.arange(s)[None]
        live = torch.ones(s, s, dtype=torch.bool)
        if causal:
            live &= j <= i
        if window is not None:
            live &= i - j < window
        assert kern.summary.dot_flops == 4 * b * h * d * int(live.sum())
        assert plain.summary.dot_flops == 4 * b * h * d * s * s
        assert kern.summary.mem_bytes == 2 * HA.nbytes(q) + 2 * HA.nbytes(k)
    # decode over 3 pages of 16: the plain version's products exactly
    qd = _meta(b, kv, h // kv, d)
    pool = _meta(b * 3, 16, kv, d)
    tbl = torch.empty((b, 3), dtype=torch.int32, device=META)
    ln = torch.empty((b,), dtype=torch.int32, device=META)
    counts = []
    for backend in ("auto", "ref"):
        with HA.OpCounter(META) as c:
            DEC.paged_decode_attention(qd, pool, pool, tbl, ln,
                                       backend=backend)
        counts.append(c.summary.dot_flops)
    assert counts[0] == counts[1] == 4 * b * h * d * 48
    # mLSTM chunks (64, 64, 22): the plain chunkwise version's products
    s2, dv = 150, 24
    qm, vm = _meta(b, s2, h, d), _meta(b, s2, h, dv)
    gm = _meta(b, s2, h)
    counts = []
    for backend in ("auto", "ref"):
        with HA.OpCounter(META) as c:
            hm, (cm, nm, mm) = MLSTM.mlstm(qm, qm, vm, gm, gm,
                                           backend=backend)
        counts.append(c.summary.dot_flops)
        assert hm.shape == (b, s2, h, dv) and cm.shape == (b, h, d, dv)
    assert counts[0] == counts[1] == MLSTM.flops(b, s2, h, d, dv)
    with HA.OpCounter(META) as c:
        RGLRU.rg_lru(_meta(b, s, 8), _meta(b, s, 8), _meta(b, 8))
    assert c.summary.kernels == {"rg_lru": 1} and c.summary.dot_flops == 0


# ---------------------------------------------------------------------------
# run_cell on a (1, 1) mesh against the reference
# ---------------------------------------------------------------------------

CELLS = [
    ("qwen3_1_7b", "train_4k", 64, 4, "train", dict(num_layers=2)),
    ("olmoe_1b_7b", "train_4k", 64, 4, "train", dict(num_layers=2)),
    ("qwen3_1_7b", "prefill_32k", 64, 4, "prefill", dict(num_layers=2)),
    ("recurrentgemma_2b", "decode_32k", 64, 4, "decode",
     dict(num_layers=4)),
]


def _plain_models(monkeypatch):
    """The dry run's models built with the plain versions in place of the
    kernels' route (the reference's own products)."""
    build = DR.build_model
    monkeypatch.setattr(DR, "build_model", lambda cfg, device: build(
        cfg, device, backend="ref"))


@pytest.mark.parametrize("arch,shape,seq,batch,kind,red", CELLS)
def test_run_cell_matches_reference_on_one_device(monkeypatch, arch, shape,
                                                  seq, batch, kind, red):
    JDR = _reference_dryrun()
    jc = jget(arch).reduced(**red)
    monkeypatch.setattr(JDR, "get_config", lambda a: jc)
    monkeypatch.setattr(JDR, "make_production_mesh",
                        lambda multi_pod=False: jmesh(1, 1))
    monkeypatch.setitem(JDR.SHAPES, shape, JShape(shape, seq, batch, kind))
    ref = JDR.run_cell(arch, shape, multi_pod=False)
    cfg = get_config(arch).reduced(**red)
    cell = dict(cfg=cfg, shape=ShapeConfig(shape, seq, batch, kind),
                mesh=make_local_mesh(1, 1, device=META))
    if kind == "prefill":
        auto = DR.run_cell(arch, shape, False, **cell)
        _plain_models(monkeypatch)
    got = DR.run_cell(arch, shape, False, **cell)
    assert got["status"] == ref["status"] == "ok"
    assert got["n_devices"] == ref["n_devices"] == 1
    assert got["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
    assert got["hlo"]["dot_flops_per_dev"] == \
        ref["hlo"]["dot_flops_per_dev"]
    assert got["model_flops_global"] == ref["model_flops_global"]
    assert got["roofline"]["dominant"] in ("compute", "memory")
    if kind == "prefill":
        # the flash kernel's route counts only the causal pairs: the
        # reference's products less the masked upper triangle's
        masked = 4 * batch * cfg.num_heads * cfg.head_dim * \
            (seq * seq - seq * (seq + 1) // 2) * cfg.num_layers
        assert auto["hlo"]["dot_flops_per_dev"] == \
            got["hlo"]["dot_flops_per_dev"] - masked
        assert auto["hlo"]["kernels"] == {"flash_attention": 2}
        assert auto["memory"]["argument_bytes"] == \
            got["memory"]["argument_bytes"]


# ---------------------------------------------------------------------------
# eight virtual host devices (the device count is fixed at jax's import)
# ---------------------------------------------------------------------------

#: (arch, layers, batch, seq) of the one train step recorded per family
FAMILY_STEPS = [("qwen3_1_7b", 2, 8, 32), ("olmoe_1b_7b", 2, 8, 32),
                ("recurrentgemma_2b", 3, 8, 32), ("xlstm_125m", 2, 8, 32),
                ("whisper_tiny", 2, 8, 32), ("llama_3_2_vision_11b", 2, 8,
                                             32)]

_SUBPROC = textwrap.dedent("""
    import json, os, re, sys
    flags = re.sub(r"--xla_force_host_platform_device_count=\\\\d+", "",
                   os.environ.get("XLA_FLAGS", ""))
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8")
    import jax
    assert len(jax.devices()) == 8, jax.devices()
    import repro.launch.dryrun as DR
    import repro.sharding as SH
    from repro.configs.base import ShapeConfig, get_config
    from repro.launch.mesh import make_local_mesh

    out = {"cells": {}, "constraints": {}}
    cfg = get_config("qwen3_1_7b").reduced(num_layers=2)
    DR.get_config = lambda a: cfg
    DR.SHAPES["train_4k"] = ShapeConfig("train_4k", 64, 8, "train")
    for shape in ((2, 4), (8, 1)):
        DR.make_production_mesh = lambda multi_pod=False: make_local_mesh(
            *shape)
        r = DR.run_cell("qwen3_1_7b", "train_4k", multi_pod=False)
        out["cells"]["%dx%d" % shape] = [r["memory"]["argument_bytes"],
                                         r["hlo"]["dot_flops_per_dev"]]
    seen = []
    spec_for = SH.spec_for

    def recording(logical, shape, mesh, rules):
        seen.append([list(logical), list(shape)])
        return spec_for(logical, shape, mesh, rules)

    for arch, layers, batch, seq in json.loads(sys.argv[1]):
        c = get_config(arch).reduced(num_layers=layers)
        DR.get_config = lambda a: c
        DR.make_production_mesh = lambda multi_pod=False: make_local_mesh(
            2, 4)
        DR.SHAPES["train_4k"] = ShapeConfig("train_4k", seq, batch, "train")
        _, _, mesh, rules, fn, args = DR.build_cell(arch, "train_4k", False)
        del seen[:]
        SH.spec_for = recording
        try:
            with mesh, SH.sharding_ctx(mesh, rules):
                fn.lower(*args)
        finally:
            SH.spec_for = spec_for
        out["constraints"][arch] = seen[:]
    print("DRYRUN8=" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def eight_devices(tmp_path_factory):
    script = tmp_path_factory.mktemp("dryrun8") / "dryrun8.py"
    script.write_text(_SUBPROC)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), os.pardir, "src"),
         env.get("PYTHONPATH", "")])
    res = subprocess.run([sys.executable, str(script),
                          json.dumps(FAMILY_STEPS)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout + res.stderr
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("DRYRUN8=")][0]
    return json.loads(line[len("DRYRUN8="):])


@pytest.mark.parametrize("shape", [(2, 4), (8, 1)])
def test_eight_device_argument_bytes_and_flops(eight_devices, shape):
    ref_args, ref_flops = eight_devices["cells"]["%dx%d" % shape]
    mesh = Mesh([[META] * shape[1]] * shape[0], ("data", "model"))
    got = DR.run_cell("qwen3_1_7b", "train_4k", False,
                      cfg=get_config("qwen3_1_7b").reduced(num_layers=2),
                      shape=ShapeConfig("train_4k", 64, 8, "train"),
                      mesh=mesh)
    assert got["n_devices"] == 8
    assert got["memory"]["argument_bytes"] == ref_args
    if shape == (8, 1):     # no model axis: XLA splits the work evenly
        assert got["hlo"]["dot_flops_per_dev"] == ref_flops
    else:                   # XLA replicates what 2 kv heads do not divide
        assert got["hlo"]["dot_flops_per_dev"] < ref_flops


@pytest.mark.parametrize("arch,layers,batch,seq", FAMILY_STEPS)
def test_shard_act_constraints_match_reference(eight_devices, arch, layers,
                                               batch, seq):
    cfg = get_config(arch).reduced(num_layers=layers)
    shape = ShapeConfig("train_4k", seq, batch, "train")
    mesh = Mesh([[META] * 4] * 2, ("data", "model"))
    cell = DR.build_cell(cfg, shape, mesh)
    from repro_torch.sharding import record_constraints, sharding_ctx
    with sharding_ctx(mesh, cell.rules), record_constraints() as rec:
        cell.fn(*cell.args)
    got = {(tuple(lg), tuple(s)) for lg, s, _ in rec}
    want = {(tuple(lg), tuple(s))
            for lg, s in eight_devices["constraints"][arch]}
    assert got == want
    assert got


# ---------------------------------------------------------------------------
# the CLI, the parameter plan's collectives, the links
# ---------------------------------------------------------------------------

def test_cli_writes_one_json_per_cell(monkeypatch, tmp_path, capsys):
    tiny = get_config("qwen3_1_7b").reduced(num_layers=2)
    monkeypatch.setattr(DR, "get_config", lambda a: tiny)
    rc = DR.main(["--arch", "qwen3_1_7b", "--shape", "long_500k",
                  "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "done; 0 failures"
    rec = json.loads((tmp_path / "qwen3_1_7b__long_500k__sp.json"
                      ).read_text())
    assert rec["status"] == "skipped" and "unbounded" in rec["reason"]
    assert DR.main(["--arch", "qwen3_1_7b", "--shape", "long_500k",
                    "--out", str(tmp_path)]) == 0
    assert "[cached ]" in capsys.readouterr().out


def test_decode_cell_on_the_multipod_mesh(monkeypatch):
    """A reduced decode cell on the 512-entry meta mesh: the parameter
    plan's all-gathers run over the 16-entry data axis (within a pod), and
    the cache's batch and ring shard over pod × data and model."""
    cfg = get_config("qwen3_1_7b").reduced(num_layers=2)
    r = DR.run_cell("qwen3_1_7b", "decode_32k", True, cfg=cfg)
    assert r["mesh"] == "2x16x16" and r["n_devices"] == 512
    kinds = {k.split("@")[0] for k in r["hlo"]["coll_by_group"]}
    assert kinds == {"all-gather"}
    assert r["hlo"]["cross_pod_bytes"] == 0
    assert r["hlo"]["kernels"] == {"paged_decode_attention": 2}
    assert r["memory"]["fits_80gb"]


def test_train_plan_collectives_cross_pods():
    cfg = get_config("qwen3_1_7b").reduced(num_layers=2, remat=True)
    mesh = make_production_mesh(multi_pod=True, device=META)
    cell = DR.build_cell(cfg, ShapeConfig("t", 32, 64, "train"), mesh)
    summ = HA.OpSummary()
    seconds = DR.param_collectives(cell, summ)
    groups = {k: g for k, g in summ.coll_by_group}
    assert set(summ.coll_bytes) == {"all-gather", "reduce-scatter",
                                    "all-reduce"}
    # remat: the forward's gather twice, once more than the scatter
    assert summ.coll_bytes["all-gather"] == \
        2 * summ.coll_bytes["reduce-scatter"]
    assert {g for (k, g) in summ.coll_by_group if k != "all-reduce"} == {16}
    assert {g for (k, g) in summ.coll_by_group if k == "all-reduce"} <= \
        {2, 32}
    assert summ.cross_pod_bytes() == summ.coll_bytes["all-reduce"] > 0
    assert seconds == pytest.approx(summ.coll_total / DR.HW["net_bw"])
    assert groups


def test_links_and_roofline():
    m16 = make_production_mesh(device=META)
    assert DR.link_bw(m16, ["data"]) == DR.HW["net_bw"]
    assert DR.link_bw(m16, ["model"]) == DR.HW["net_bw"]
    small = Mesh([[META] * 2] * 4, ("data", "model"))
    assert DR.link_bw(small, ["data"]) == DR.HW["nvlink_bw"]
    t = DR.roofline_terms(989e12, 3.35e12 * 2, 0.5, 989e12 * 4, 4)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 2.0
    assert t["dominant"] == "memory" and t["roofline_fraction"] == 0.5
    assert DR._opt_cfg(get_config("grok_1_314b")).moment_dtype == "bfloat16"
    assert DR._opt_cfg(get_config("qwen3_1_7b")).moment_dtype == "float32"
    assert DR.model_flops(get_config("qwen3_1_7b"),
                          ShapeConfig("d", 8, 3, "decode")) == \
        2.0 * get_config("qwen3_1_7b").num_active_params * 3
