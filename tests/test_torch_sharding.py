"""The port's sharding resolution contract against the reference's, on the
CPU.

``repro_torch.sharding`` keeps its own copy of the reference's pure-Python
resolution logic (``build_rules``, ``spec_for``, ``resolve_axes``) and
``core.engine.validate_mesh_args``; each is held against
``repro.sharding`` / ``repro.core.engine`` on the same sizes and names.
The reference's meshes are ``AbstractMesh(sizes, names)`` (the installed
jax's form); the port's are ``Mesh``es that repeat the CPU device. The
cases mirror ``tests/test_sharded_sweep.py`` and ``tests/test_sharding.py``:
size-1 axes never consumed, a degenerate mesh equal to the reduced one,
the divisibility fallback, missing axes dropped, the multipod batch
axes, the front-door errors word for word, ``mesh_axes`` without a mesh,
the ``make_local_mesh`` refusal and ``shard_act`` as the identity. Also
the block order of a dimension cut over several axes, against JAX's own
placement on eight virtual host devices (a subprocess).
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as JSH
from repro.api import registry as jregistry
from repro.core.engine import validate_mesh_args as j_validate

from repro_torch import sharding as SH
from repro_torch.api import registry
from repro_torch.core.engine import validate_mesh_args
from repro_torch.launch import (make_local_mesh, make_production_mesh,
                                single_device_mesh)


def _meshes(shape, names):
    """The same mesh in both packages: (port, reference)."""
    return (SH.Mesh(np.full(shape, "cpu", dtype=object), names),
            AbstractMesh(tuple(shape), tuple(names)))


def _flat_axes(spec):
    out = []
    for a in spec:
        if a is not None:
            out.extend((a,) if isinstance(a, str) else a)
    return out


_CASES = [
    (("batch", "embed"), (16, 64)),
    (("embed", "heads"), (64, 8)),
    (("batch", "heads", "mlp"), (16, 8, 64)),
    (("expert", "embed", "mlp"), (8, 64, 32)),
    (("batch", "kv_seq"), (16, 256)),
    (("embed", "heads", "head_dim"), (4096, 32, 128)),
    (("embed", "heads", "head_dim"), (2560, 10, 256)),
    (("expert", "embed", "mlp"), (64, 2048, 1024)),
    (("batch", None), (256, 4096)),
    (("batch", "kv_seq"), (1, 524288)),
]

_MESHES = [
    ((1, 4), ("data", "model")),
    ((4, 1), ("data", "model")),
    ((1, 8), ("data", "model")),
    ((8, 1), ("data", "model")),
    ((2, 2), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((16, 16), ("data", "model")),
    ((1, 2, 4), ("pod", "data", "model")),
    ((2, 1, 4), ("pod", "data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
]


@pytest.mark.parametrize("shape,names", _MESHES)
def test_build_rules_and_spec_match_reference(shape, names):
    """On every mesh: the rules equal the reference's, every spec equals
    the reference's, no size-1 axis appears, each axis at most once, and
    every assignment divides its dimension."""
    mesh, jmesh = _meshes(shape, names)
    rules = SH.build_rules(mesh)
    assert rules == JSH.build_rules(jmesh)
    sizes = dict(zip(names, shape))
    for logical, dims in _CASES:
        s = SH.spec_for(logical, dims, mesh, rules)
        js = JSH.spec_for(logical, dims, jmesh, JSH.build_rules(jmesh))
        assert isinstance(s, SH.P) and s == tuple(js), (logical, dims, s, js)
        flat = _flat_axes(s)
        assert not {a for a in flat if sizes[a] == 1}, (logical, s)
        assert len(flat) == len(set(flat)), (logical, s)
        for dim, a in zip(dims, s):
            if a is not None:
                axs = (a,) if isinstance(a, str) else a
                assert dim % int(np.prod([sizes[x] for x in axs])) == 0


@pytest.mark.parametrize("deg_shape,deg_names,eff_shape,eff_names", [
    ((1, 8), ("data", "model"), (8,), ("model",)),
    ((8, 1), ("data", "model"), (8,), ("data",)),
    ((1, 1, 8), ("pod", "data", "model"), (8,), ("model",)),
])
def test_spec_degenerate_mesh_matches_reduced_mesh(
        deg_shape, deg_names, eff_shape, eff_names):
    """A mesh with size-1 axes gives exactly the specs of the mesh without
    them, in the port and in the reference."""
    deg, jdeg = _meshes(deg_shape, deg_names)
    eff, jeff = _meshes(eff_shape, eff_names)
    for logical, dims in _CASES:
        got = SH.spec_for(logical, dims, deg, SH.build_rules(deg))
        assert got == SH.spec_for(logical, dims, eff, SH.build_rules(eff))
        assert got == tuple(JSH.spec_for(logical, dims, jeff,
                                         JSH.build_rules(jeff)))
        assert got == tuple(JSH.spec_for(logical, dims, jdeg,
                                         JSH.build_rules(jdeg)))


def test_spec_examples_read_as_the_references():
    """``test_sharding.py``'s worked examples: the basic spec, the
    divisibility fallback, a missing mesh axis, the multipod batch."""
    m, jm = _meshes((16, 16), ("data", "model"))
    r = SH.build_rules(m)
    assert SH.spec_for(("embed", "heads", "head_dim"), (4096, 32, 128),
                       m, r) == SH.P("data", "model", None)
    assert SH.spec_for(("embed", "heads", "head_dim"), (2560, 10, 256),
                       m, r) == SH.P("data", None, None)
    assert SH.spec_for(("expert", "embed", "mlp"), (8, 6144, 32768),
                       m, r) == SH.P(None, "data", "model")
    assert SH.spec_for(("expert", "embed", "mlp"), (64, 2048, 1024),
                       m, r) == SH.P("model", "data", None)
    assert SH.spec_for(("batch", None), (256, 4096), m, r) == \
        SH.P("data", None)
    pod, jpod = _meshes((2, 16, 16), ("pod", "data", "model"))
    rp = SH.build_rules(pod)
    assert SH.spec_for(("batch", None), (256, 4096), pod, rp) == \
        SH.P(("pod", "data"), None)
    assert SH.spec_for(("batch", "kv_seq"), (1, 524288), pod, rp) == \
        SH.P(None, "model")
    for logical, dims in (("batch", None), (256, 4096)), \
            (("batch",), (256,)), ((), ()):
        assert repr(SH.spec_for(logical, dims, pod, rp)) == repr(
            JSH.spec_for(logical, dims, jpod, JSH.build_rules(jpod)))
    assert SH.build_rules(m, (("mlp", None),))["mlp"] is None


@pytest.mark.parametrize("seed", range(4))
def test_spec_never_overassigns_and_matches_reference(seed):
    """A seeded grid in place of the reference's hypothesis property (not
    installed here): random logical names and dimensions on the 16 x 16
    mesh, each spec equal to the reference's and never reusing an axis
    or leaving a dimension undivided."""
    rng = np.random.default_rng(seed)
    m, jm = _meshes((16, 16), ("data", "model"))
    r, jr = SH.build_rules(m), JSH.build_rules(jm)
    names = ["batch", "embed", "heads", "mlp", "vocab", "expert", None]
    for _ in range(50):
        k = int(rng.integers(1, 5))
        logical = tuple(names[i] for i in rng.integers(0, len(names), k))
        dims = tuple(int(d) for d in rng.choice(
            [1, 2, 7, 16, 48, 64, 256, 4096], k))
        s = SH.spec_for(logical, dims, m, r)
        assert s == tuple(JSH.spec_for(logical, dims, jm, jr))
        flat = _flat_axes(s)
        assert len(flat) == len(set(flat))
        for dim, a in zip(dims, s):
            if a is not None:
                axs = (a,) if isinstance(a, str) else a
                assert dim % (16 ** len(axs)) == 0


_RESOLVE = [
    ((1, 8), "data", 8), ((1, 8), ("data", "model"), 16),
    ((1, 8), "model", 12), ((1, 8), "model", 16), ((1, 8), None, 16),
    ((2, 2), ("data", "model"), 8), ((2, 2), ("data", "model"), 6),
    ((2, 4), ("model", "data"), 16), ((2, 4), "data", 3),
    ((1, 1), ("data", "model"), 4),
]


@pytest.mark.parametrize("shape,axes,dim", _RESOLVE)
def test_resolve_axes_matches_reference(shape, axes, dim):
    """Size-1 axes never shard and are dropped from tuples; a product
    that does not divide resolves to None (replication, never an error)."""
    mesh, jmesh = _meshes(shape, ("data", "model"))
    assert SH.resolve_axes(mesh, axes, dim) == \
        JSH.resolve_axes(jmesh, axes, dim)
    assert SH.resolve_axes(None, axes, dim) is None
    assert SH.norm_axes(axes) == JSH.norm_axes(axes)


def test_resolve_axes_contract():
    """``test_sharded_sweep.py``'s worked contract, in the port."""
    mesh, _ = _meshes((1, 8), ("data", "model"))
    assert SH.resolve_axes(mesh, "data", 8) is None
    assert SH.resolve_axes(mesh, ("data", "model"), 16) == "model"
    assert SH.resolve_axes(mesh, "model", 12) is None
    assert SH.resolve_axes(mesh, "model", 16) == "model"
    m22, _ = _meshes((2, 2), ("data", "model"))
    assert SH.resolve_axes(m22, ("data", "model"), 8) == ("data", "model")
    assert SH.resolve_axes(m22, ("data", "model"), 6) is None


_BAD = [
    dict(mesh=None, policy_axes="data"),
    dict(mesh=None, seed_axes="model", warp_axes="data"),
    dict(policy_axes="pod"),
    dict(policy_axes="data", seed_axes="data"),
    dict(seed_axes=("model",), warp_axes=("data", "model"),
         engine="wavefront"),
    dict(warp_axes="model", engine="event"),
]


@pytest.mark.parametrize("kw", _BAD)
def test_validate_mesh_args_errors_word_for_word(kw):
    """Each of the front door's errors, with the reference's message."""
    mesh, jmesh = _meshes((2, 4), ("data", "model"))
    kw = dict(kw)
    use = kw.pop("mesh", "given")
    pm, jm = (None, None) if use is None else (mesh, jmesh)
    with pytest.raises(ValueError) as got:
        validate_mesh_args(pm, **kw)
    with pytest.raises(ValueError) as want:
        j_validate(jm, **kw)
    assert str(got.value) == str(want.value)


def test_validate_mesh_args_accepts_what_the_reference_does():
    mesh, jmesh = _meshes((2, 4), ("data", "model"))
    for kw in (dict(policy_axes="data", seed_axes="model"),
               dict(policy_axes="data", warp_axes="model",
                    engine="wavefront"), {}):
        validate_mesh_args(mesh, **kw)
        j_validate(jmesh, **kw)
    validate_mesh_args(None)


def test_experiment_mesh_refusals_match_reference():
    """``mesh_axes`` without a mesh, a mesh with the serving engine and
    four axis entries raise in both packages with equal messages."""
    mesh, jmesh = _meshes((2, 4), ("data", "model"))
    cases = [
        (lambda r: r.paper_fig7(("BFS",), name="x").with_(
            mesh_axes=("data", None, None)), None),
        (lambda r: r.serving(("SERVE_POISSON64",), name="s"), "mesh"),
        (lambda r: r.paper_fig7(("BFS",), name="x"), "four"),
    ]
    for build, extra in cases:
        msgs = []
        for reg, m in ((registry, mesh), (jregistry, jmesh)):
            with pytest.raises(ValueError) as ei:
                exp = build(reg)
                if extra == "mesh":
                    exp.with_(mesh=m)
                elif extra == "four":
                    exp.with_(mesh=m, mesh_axes=("data", None, None, None))
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_experiment_default_axes_and_padding_match_reference():
    mesh, jmesh = _meshes((2, 4), ("data", "model"))
    port = registry.paper_fig7(("BFS",), name="x")
    ref = jregistry.paper_fig7(("BFS",), name="x")
    assert port.with_(mesh=mesh).mesh_axes == \
        ref.with_(mesh=jmesh).mesh_axes == ("data", "model", None)
    one, jone = _meshes((8,), ("model",))
    assert port.with_(mesh=one).mesh_axes == \
        ref.with_(mesh=jone).mesh_axes == ("model", None, None)
    assert port.with_(mesh=mesh, mesh_axes=("model",)).mesh_axes == \
        ref.with_(mesh=jmesh, mesh_axes=("model",)).mesh_axes


def test_make_local_mesh_refuses_more_cards_than_exist(monkeypatch):
    """Distinct cards only, never fewer than asked for; without a card
    the call raises as the engine's device check does. A CPU mesh of any
    size is always constructible."""
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_local_mesh(1, 2)
        with pytest.raises(RuntimeError, match="CUDA device"):
            single_device_mesh()
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_local_mesh(2, 2, device="cuda:0")
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError) as ei:
            make_local_mesh(2, 2)
        msg = str(ei.value)
        assert "needs 4 device(s)" in msg
        assert "only 1 are available" in msg
        assert "device='cpu'" in msg
        with pytest.raises(ValueError, match="needs 256 device"):
            make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 device"):
            make_production_mesh(multi_pod=True)
        with pytest.raises(ValueError, match="does not exist"):
            make_local_mesh(1, 2, device="cuda:1")
        one = single_device_mesh()
        assert one.size == 1 and str(one.devices[0, 0]) == "cuda:0"
        rep = make_local_mesh(2, 2, device="cuda:0")
        assert rep.size == 4 and {str(d) for d in rep.devices.flat} == \
            {"cuda:0"}
    cpu = make_local_mesh(2, 4, device="cpu")
    assert dict(cpu.shape) == {"data": 2, "model": 4}
    assert cpu.size == 8 and len(cpu.devices) == 2
    assert cpu.axis_names == ("data", "model")
    assert make_local_mesh(1, 1, device="cpu").size == 1


def test_mesh_is_hashable_by_names_sizes_and_devices():
    a = make_local_mesh(2, 4, device="cpu")
    assert a == make_local_mesh(2, 4, device="cpu")
    assert hash(a) == hash(make_local_mesh(2, 4, device="cpu"))
    assert a != make_local_mesh(4, 2, device="cpu")
    assert a != SH.Mesh(np.full((2, 4), "cpu", dtype=object),
                        ("pod", "model"))
    assert len({a, make_local_mesh(2, 4, device="cpu")}) == 1
    with pytest.raises(ValueError, match="one type"):
        SH.Mesh(np.array(["cpu", "cuda:0"], dtype=object), ("model",))
    with pytest.raises(ValueError, match="axis names"):
        SH.Mesh(np.full((2, 2), "cpu", dtype=object), ("model",))


def test_shard_act_is_the_identity_where_the_reference_is():
    """Without a context and on a mesh of one device entry the input comes
    back as it is; on a (1, N) mesh of real devices (``size`` N, though
    ``len(devices)`` is 1) the port refuses rather than run unsharded."""
    x = torch.ones(4, 4)
    assert SH.shard_act(x, "batch", None) is x
    jx = jax.numpy.ones((4, 4))
    assert JSH.shard_act(jx, "batch", None) is jx
    with SH.sharding_ctx(make_local_mesh(1, 1, device="cpu")):
        assert SH.current_mesh().size == 1
        assert SH.current_rules() == SH.build_rules(SH.current_mesh())
        assert SH.shard_act(x, "batch", None) is x
    wide = make_local_mesh(1, 4, device="cpu")
    assert len(wide.devices) == 1 and wide.size == 4
    with SH.sharding_ctx(wide):
        with pytest.raises(NotImplementedError, match="SPMD"):
            SH.shard_act(x, "batch", "heads")
    assert SH.current_mesh() is None and SH.current_rules() is None
    assert SH.Logical("batch", None) == SH.Logical("batch", None)
    assert repr(SH.Logical("a")) == repr(JSH.Logical("a"))


def test_split_leading_places_contiguous_blocks():
    mesh = make_local_mesh(2, 4, device="cpu")
    x = torch.arange(16).reshape(8, 2)
    assert SH.split_leading(x, mesh, None)[0] is x
    blocks = SH.split_leading(x, mesh, ("data", "model"))
    assert len(blocks) == 8
    assert torch.equal(torch.cat(blocks), x)
    assert [c for c in SH.block_coords(mesh, ("data", "model"))][:3] == \
        [{"data": 0, "model": 0}, {"data": 0, "model": 1},
         {"data": 0, "model": 2}]
    assert SH.block_coords(mesh, None) == [{}]
    at = SH.split_leading(x, mesh, "model", at={"data": 1})
    assert len(at) == 4 and torch.equal(torch.cat(at), x)
    # placement by coordinates, on a mesh naming eight cards (no tensor
    # moves there: these are only names)
    cards = SH.Mesh(np.array([f"cuda:{i}" for i in range(8)],
                             dtype=object).reshape(2, 4), ("data", "model"))
    assert str(SH.block_device(cards, {"data": 1}, {"model": 2})) == \
        "cuda:6"
    assert str(SH.block_device(cards, {"model": 3})) == "cuda:3"
    assert [str(cards.device_at(c)) for c in SH.block_coords(
        cards, ("model", "data"))] == [f"cuda:{i}" for i in
                                       (0, 4, 1, 5, 2, 6, 3, 7)]
    with pytest.raises(ValueError, match="no axis"):
        cards.device_at({"pod": 0})
    with pytest.raises(ValueError, match="does not split"):
        SH.split_leading(torch.zeros(6), mesh, "model")


_JAX_ORDER = textwrap.dedent("""
    import json, os, re
    flags = re.sub(r"--xla_force_host_platform_device_count=\\d+", "",
                   os.environ.get("XLA_FLAGS", ""))
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8")
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    pos = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
           for d in mesh.devices.flat}
    out = {}
    for axes in (("data", "model"), ("model", "data"), "model", "data"):
        ns = NamedSharding(mesh, P(axes))
        idx = ns.devices_indices_map((16,))
        out[json.dumps(axes)] = sorted(
            (idx[d][0].start // (16 // (8 if isinstance(axes, tuple)
                                       else mesh.shape[axes])), pos[d])
            for d in mesh.devices.flat)
    print(json.dumps(out))
""")


def test_block_order_is_jaxs(tmp_path):
    """A dimension cut over several mesh axes puts block k where JAX's
    ``PartitionSpec`` entry puts shard k (eight virtual host devices, in
    a subprocess since the device count is fixed at jax's import)."""
    import json
    script = tmp_path / "order.py"
    script.write_text(_JAX_ORDER)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    jax_order = json.loads(res.stdout.strip().splitlines()[-1])
    mesh = make_local_mesh(2, 4, device="cpu")
    for key, placed in jax_order.items():
        axes = json.loads(key)
        axes = tuple(axes) if isinstance(axes, list) else axes
        coords = SH.block_coords(mesh, axes)
        for block, (d, m) in placed:
            c = coords[block]
            for a, want in (("data", d), ("model", m)):
                if a in c:
                    assert c[a] == want, (axes, block, c, d, m)
