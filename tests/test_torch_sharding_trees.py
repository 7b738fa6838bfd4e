"""The dry run's config helpers and logical-axis trees against the
reference's, on the CPU.

``SHAPES``, ``shape_applicable`` (skip reasons word for word),
``num_params`` / ``num_active_params``, ``is_subquadratic`` and
``has_decoder`` of the ten full configs; then every parameter, batch and
cache spec of the ten full configs on the 16 × 16 and 2 × 16 × 16
production meshes (the reference's through ``AbstractMesh``, the port's
through meshes of meta devices), ``input_specs`` and ``cache_specs`` leaf
for leaf, and the filled cache's ``len`` and ``kv_pos``.

The port's layers are not stacked: layer ``i``'s parameter ``rest`` is the
reference's ``stack/scan/{pos}_{kind}/rest`` at group ``g`` (or
``stack/tail/{j}_{kind}/rest``), whose spec leads with the stacked
``layers`` axis; no mesh axis takes it, so the port's spec is the rest.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as JSH
from repro.configs import base as JB
from repro.models import model as JM

from repro_torch import sharding as SH
from repro_torch.configs import base as TB
from repro_torch.launch import make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models.stack import layer_slots

ARCHS = TB.ARCH_IDS
MESHES = [False, True]      # multi_pod


def _jmesh(multi_pod):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _spec(p):
    """A partition spec as a plain tuple (either package's)."""
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _jmodel(arch):
    m = JM.build_model(JB.get_config(arch))
    return m, jax.eval_shape(m.init_params, jax.random.PRNGKey(0))


def _flat(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# config helpers
# ---------------------------------------------------------------------------

def test_shapes_registry_is_the_references():
    assert list(TB.SHAPES) == list(JB.SHAPES)
    for name, s in TB.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(JB.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_helpers_match_reference(arch):
    tc, jc = TB.get_config(arch), JB.get_config(arch)
    for name in TB.SHAPES:
        assert TB.shape_applicable(tc, TB.SHAPES[name]) == \
            JB.shape_applicable(jc, JB.SHAPES[name]), name
    assert tc.is_subquadratic == jc.is_subquadratic
    assert tc.has_decoder is jc.has_decoder is True
    assert tc.num_params == jc.num_params
    assert tc.num_active_params == jc.num_active_params
    assert TM.count_params(tc) == tc.num_params


def test_active_params_of_reduced_moe():
    """k / E of the expert leaves, taken over the stacked leaf (OLMoE and
    Grok reduced to 4 experts, 2 a token)."""
    for arch in ("olmoe_1b_7b", "grok_1_314b"):
        tc = TB.get_config(arch).reduced(num_layers=3)
        jc = JB.get_config(arch).reduced(num_layers=3)
        assert TM.count_params_analytic(tc, active_only=True) == \
            JM.count_params_analytic(jc, active_only=True)
        assert tc.num_active_params < tc.num_params


# ---------------------------------------------------------------------------
# specs of the ten full configs on both production meshes
# ---------------------------------------------------------------------------

def _param_pairs(tm, jshapes):
    """(port name, reference path, leading stacked axis?) of every
    parameter."""
    pairs = []
    jflat = _flat(jshapes)
    stacks = [("layers", "stack", tm.stack)]
    if tm.enc_stack is not None:
        stacks.append(("encoder", "enc_stack", tm.enc_stack))
    slots = {p: layer_slots(s) for p, _, s in stacks}
    names = {p: j for p, j, _ in stacks}
    for name, _ in tm.named_parameters():
        prefix, *rest = name.split(".")
        if prefix in slots:
            sec, key, g = slots[prefix][int(rest[0])]
            path = (names[prefix], sec, key) + tuple(rest[1:])
            pairs.append((name, path, g is not None))
        else:
            pairs.append((name, (name,), False))
    assert {p for _, p, _ in pairs} == set(jflat)
    return pairs


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, multi_pod):
    jm, jshapes = _jmodel(arch)
    jmesh = _jmesh(multi_pod)
    jspecs = _flat(JSH.tree_specs(jm.logical_params(), jshapes, jmesh,
                                  JSH.build_rules(jmesh)))
    tm = TM.Model(TB.get_config(arch), "meta")
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    params = dict(tm.named_parameters())
    tspecs = SH.tree_specs(tm.logical_params(), params, mesh,
                           SH.build_rules(mesh))
    assert set(tspecs) == set(params)
    jleaves = _flat(jshapes)
    for name, path, stacked in _param_pairs(tm, jshapes):
        j, shape = _spec(jspecs[path]), jleaves[path].shape
        if stacked:
            assert j[0] is None, (path, j)   # "layers": no mesh axis
            j, shape = j[1:], shape[1:]
        assert tuple(params[name].shape) == shape
        assert _spec(tspecs[name]) == j, (name, tspecs[name], j)


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, multi_pod):
    jm, _ = _jmodel(arch)
    jmesh = _jmesh(multi_pod)
    jrules = JSH.build_rules(jmesh)
    tm = TM.Model(TB.get_config(arch), "meta")
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rules = SH.build_rules(mesh)
    for name, js in JB.SHAPES.items():
        ts = TB.SHAPES[name]
        # input_specs and batch specs
        jin, tin = jm.input_specs(js), tm.input_specs(ts)
        assert set(jin) == set(tin)
        for k in jin:
            assert tuple(tin[k].shape) == jin[k].shape
            assert str(tin[k].dtype).split(".")[1] == str(jin[k].dtype)
            assert tin[k].device.type == "meta"
        jb = JSH.tree_specs(jm.batch_logical(js), jin, jmesh, jrules)
        tb = SH.tree_specs(tm.batch_logical(ts), tin, mesh, rules)
        assert {k: _spec(v) for k, v in tb.items()} == \
            {k: _spec(v) for k, v in jb.items()}
        if js.kind == "train":
            continue
        # cache_specs and cache specs
        jc = _flat(jm.cache_specs(js))
        tc = _flat(tm.cache_specs(ts))
        assert set(jc) == set(tc), name
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, (name, k)
            assert str(tc[k].dtype).split(".")[1] == str(jc[k].dtype)
        jcs = _flat(JSH.tree_specs(jm.cache_logical(js.global_batch, js),
                                   jm.cache_specs(js), jmesh, jrules))
        tcs = _flat(SH.tree_specs(tm.cache_logical(ts.global_batch, ts),
                                  tm.cache_specs(ts), mesh, rules))
        assert {k: _spec(v) for k, v in tcs.items()} == \
            {k: _spec(v) for k, v in jcs.items()}, name


# ---------------------------------------------------------------------------
# the filled cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq", [("qwen3_1_7b", 40),
                                      ("h2o_danube_1_8b", 75),
                                      ("recurrentgemma_2b", 50),
                                      ("whisper_tiny", 24)])
def test_filled_cache_len_and_kv_pos(arch, seq):
    """Full attention, a sliding window of 32 (the ring wraps), the
    hybrid's local window of 16, and the encoder-decoder's enc_out."""
    tc, jc = TB.get_config(arch).reduced(), JB.get_config(arch).reduced()
    tshape, jshape = (TB.ShapeConfig("d", seq, 3, "decode"),
                      JB.ShapeConfig("d", seq, 3, "decode"))
    tcache = TM.Model(tc, "cpu").init_cache(3, tshape, filled=True)
    jcache = JM.build_model(jc).init_cache(3, jshape, filled=True)
    for k in ("len", "kv_pos"):
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(
            jcache[k]))
        assert tcache[k].dtype == torch.int32
    assert set(_flat(tcache)) == set(_flat(jcache))
    for k, v in _flat(jcache).items():
        np.testing.assert_array_equal(
            _flat(tcache)[k].float().numpy(), np.asarray(v, np.float32))
    empty = TM.Model(tc, "cpu").init_cache(3, tshape)
    assert bool((empty["len"] == 0).all()) and \
        bool((empty["kv_pos"] == -1).all())


# ---------------------------------------------------------------------------
# the sharding helpers on meta meshes
# ---------------------------------------------------------------------------

def test_named_sharding_shard_shape_and_bytes():
    mesh = make_production_mesh(multi_pod=True, device="meta")
    assert mesh.size == 512 and dict(mesh.shape) == {
        "pod": 2, "data": 16, "model": 16}
    ns = SH.sharding_for(("batch", "kv_seq", "kv_heads", None),
                         (128, 32768, 8, 128), mesh, SH.build_rules(mesh))
    assert _spec(ns.spec) == (("pod", "data"), "model", None, None)
    assert ns.shard_shape((128, 32768, 8, 128)) == (4, 2048, 8, 128)
    assert ns.shard_bytes((128, 32768, 8, 128), torch.bfloat16) == \
        4 * 2048 * 8 * 128 * 2
    assert ns == SH.NamedSharding(mesh, ns.spec)
    with pytest.raises(ValueError, match="rank"):
        SH.sharding_for(("batch",), (4, 4), mesh, SH.build_rules(mesh))


def test_shard_act_on_a_meta_mesh_resolves_and_records():
    mesh = make_production_mesh(device="meta")
    x = torch.empty((32, 64, 2048), device="meta")
    with SH.sharding_ctx(mesh), SH.record_constraints() as rec:
        assert SH.shard_act(x, "batch", "seq_sp", None) is x
        with pytest.raises(ValueError, match="rank"):
            SH.shard_act(x, "batch", None)
    assert rec == [(("batch", "seq_sp", None), (32, 64, 2048),
                    SH.P("data", "model", None))]
    with SH.sharding_ctx(mesh):
        SH.shard_act(x, "batch", None, None)      # nothing records
    assert len(rec) == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()                    # distinct cards: none here
