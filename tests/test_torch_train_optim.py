"""The port's optimizer against the reference's: ``lr_schedule``,
``quantize_int8``, ``compressed_psum``, ``adamw_update`` (float32 and
bf16 moments, int8 compression) from the same numpy inputs, and
``make_train_step`` with microbatches 1 and 2 over 3 steps from the same
weights and batches.

Tolerances: the schedule within 1e-7 relative; one AdamW update within
1e-6 (float32), or one bf16 step of the moment (2^-8 relative) and one
quantization step of the int8 gradient; ``compressed_psum`` within the
reference's atol 0.02 of its input on one member; over 3 train steps the
metrics within rtol 1e-5, the moments within 1e-6 and the parameters
within 2e-4 (2 % of the learning rate: AdamW's first steps move a weight
by about lr · sign(g), so a gradient within float32 noise of 0 can move
it the other way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCFG
from repro.models.model import build_model as j_build
from repro.optim import optimizer as JO

from repro_torch.configs import base as TCFG
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import build_model, params_from_numpy
from repro_torch.optim import optimizer as TO
from repro_torch.sharding import Mesh

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)


def _cfgs(**kw):
    return JCFG.OptimizerConfig(**{**OPT, **kw}), \
        TCFG.OptimizerConfig(**{**OPT, **kw})


def test_configs_match_reference_field_for_field():
    import dataclasses
    for name in ("OptimizerConfig", "TrainConfig", "MeshConfig",
                 "MedicConfig"):
        assert dataclasses.asdict(getattr(JCFG, name)()) == \
            dataclasses.asdict(getattr(TCFG, name)()), name
    assert TCFG.MeshConfig((2, 3, 4)).num_devices == 24


@pytest.mark.parametrize("warmup,total", [(100, 10000), (0, 10), (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    jc, tc = _cfgs(warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 3, 5, 6, 99, 100, 101, 5000, 10000, 20000):
        np.testing.assert_allclose(
            float(TO.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))),
            float(JO.lr_schedule(jc, jnp.int32(step))), rtol=1e-7, atol=0)


def test_quantize_int8_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    e = (0.01 * rng.standard_normal((5, 7))).astype(np.float32)
    jd, je = JO.quantize_int8(jnp.asarray(x), jnp.asarray(e))
    td, te = TO.quantize_int8(torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    bd, _ = TO.quantize_int8(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(e))
    assert bd.dtype == torch.bfloat16


def test_compressed_psum_on_one_member_and_over_an_axis():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64,)).astype(np.float32))
    (y,) = TO.compressed_psum([x], make_local_mesh(1, 1, device="cpu"))
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=0.02)
    # a (2, 3) mesh: each of the 3 "model" columns sums its 2 members
    mesh = Mesh(np.array(["cpu"] * 6).reshape(2, 3), ("data", "model"))
    xs = [x * (i + 1) for i in range(6)]
    out = TO.compressed_psum(xs, mesh, "data")
    for i in range(6):
        col = i % 3
        want = xs[col] + xs[col + 3]
        scale = float(max(xs[col].abs().max(), xs[col + 3].abs().max())) / 127
        assert float((out[i] - want).abs().max()) <= scale + 1e-6
    assert torch.equal(out[0], out[3])
    with pytest.raises(ValueError, match="members"):
        TO.compressed_psum(xs[:2], mesh)


@pytest.mark.parametrize("moments,compression", [
    ("float32", "none"), ("bfloat16", "none"), ("float32", "int8"),
    ("bfloat16", "int8")])
def test_adamw_update_matches_reference(moments, compression):
    """One update from the same params, grads and state (count 4, moments
    and error buffers non-zero); a grad norm above the clip."""
    jc, tc = _cfgs(moment_dtype=moments, grad_compression=compression)
    rng = np.random.default_rng(1)
    shapes = {"a": (6, 5), "b": (7,), "c": ()}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g = {k: 3 * rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    mdt = jnp.dtype(moments)
    st = {"m": {k: (0.1 * rng.standard_normal(s)).astype(mdt)
                for k, s in shapes.items()},
          "v": {k: (0.01 * rng.random(s)).astype(mdt)
                for k, s in shapes.items()},
          "count": np.int32(4)}
    if compression == "int8":
        st["err"] = {k: (0.01 * rng.standard_normal(s)).astype(np.float32)
                     for k, s in shapes.items()}
    jp, js, jm = JO.adamw_update(jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, st),
                                 jax.tree.map(jnp.asarray, p), jc)

    def tt(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.array(a))
    tp, ts, tm = TO.adamw_update(
        {k: tt(a) for k, a in g.items()},
        {k: ({n: tt(a) for n, a in v.items()} if isinstance(v, dict)
             else tt(v)) for k, v in st.items()},
        {k: tt(a) for k, a in p.items()}, tc)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(ts["count"]) == int(js["count"]) == 5
    qstep = {k: float(np.abs(g[k]).max()) * 1.0 / 127 for k in g}
    for k in shapes:
        # the int8 gradient may round across one step where the clip
        # factor differs in its last bit; AdamW then moves the weight by
        # at most lr · (that step's share of the update)
        atol = 1e-6 if compression == "none" else 1e-6 + 2e-2 * qstep[k]
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=atol, rtol=1e-6, err_msg=k)
        for n in ("m", "v"):
            r = np.asarray(js[n][k], np.float32)
            rtol = 1e-6 if moments == "float32" else 2 ** -8
            np.testing.assert_allclose(
                ts[n][k].float().numpy(), r, rtol=rtol,
                atol=1e-7 + (0 if compression == "none" else qstep[k]),
                err_msg=f"{n}.{k}")
            assert ts[n][k].dtype == getattr(torch, moments)
        if compression == "int8":
            np.testing.assert_allclose(ts["err"][k].numpy(),
                                       np.asarray(js["err"][k]),
                                       atol=1e-6 + qstep[k], err_msg=k)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    jo, to = _cfgs()
    jc = JCFG.get_config("qwen3_1_7b").reduced(num_layers=2, dtype="float32")
    tc = TCFG.get_config("qwen3_1_7b").reduced(num_layers=2, dtype="float32")
    jm = j_build(jc)
    tree = jax.tree.map(np.asarray,
                        jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    tm = build_model(tc, "cpu")
    tp = params_from_numpy(tree, tc, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    js, ts = JO.init_opt_state(jp, jo), TO.init_opt_state(tp, to)
    jstep = jax.jit(JO.make_train_step(jm, jo, microbatches))
    tstep = TO.make_train_step(tm, to, microbatches)
    ds = SyntheticLM(DataConfig(vocab_size=jc.vocab_size, seq_len=16,
                                global_batch=4, n_chains=2))
    given = {k: v.clone() for k, v in tp.items()}
    for i in range(3):
        batch = ds.get_batch(i)
        jp, js, jmet = jstep(jp, js, batch)
        tp_next, ts, tmet = tstep(tp, ts, batch)
        assert tmet.keys() == jmet.keys()
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        tp = tp_next
    for k, v in given.items():       # the step made new tensors
        assert torch.equal(v, params_from_numpy(tree, tc, "cpu")[k])
    assert int(ts["count"]) == 3
    for name, ours, ref, atol in (
            ("params", tp, jp, 2e-4), ("m", ts["m"], js["m"], 1e-6),
            ("v", ts["v"], js["v"], 1e-6)):
        ref = params_from_numpy(jax.tree.map(np.asarray, ref), tc, "cpu")
        for k in ours:
            np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                       atol=atol, rtol=1e-5,
                                       err_msg=f"{name}.{k}")


@pytest.mark.parametrize("moments,compression", [("float32", "none"),
                                                 ("bfloat16", "int8")])
def test_adamw_update_in_groups_equals_one_group(monkeypatch, moments,
                                                 compression):
    """Leaves cut into several multi-tensor groups (``GROUP_ELEMENTS``
    under a leaf's size) give the update of one group, bitwise."""
    tc = TCFG.OptimizerConfig(**OPT, moment_dtype=moments,
                              grad_compression=compression)
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": (6, 5), "b": (7,), "c": (), "d": (3, 3)}
    p = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    g = {k: 3 * torch.randn(s, generator=gen) for k, s in shapes.items()}
    st = TO.init_opt_state(p, tc)
    for k in shapes:
        st["m"][k] += 0.1 * torch.randn(shapes[k], generator=gen)
        st["v"][k] += 0.01 * torch.rand(shapes[k], generator=gen)
    whole = TO.adamw_update(g, st, p, tc)
    monkeypatch.setattr(TO, "GROUP_ELEMENTS", 8)
    assert [len(k) for k in TO._groups(list(p), p)] == [1, 2, 1]
    cut = TO.adamw_update(g, st, p, tc)
    for a, b in zip(whole[:2], cut[:2]):
        for n in ("m", "v") if "m" in a else (None,):
            x, y = (a[n], b[n]) if n else (a, b)
            for k in shapes:
                assert torch.equal(x[k], y[k]), (n, k)
    assert torch.equal(whole[2]["grad_norm"], cut[2]["grad_norm"])


def test_make_train_step_accumulates_in_groups_as_in_one(monkeypatch):
    """Two microbatches accumulated over several multi-tensor groups give
    the step of one group, bitwise (params, moments and metrics)."""
    to = TCFG.OptimizerConfig(**OPT)
    tc = TCFG.get_config("qwen3_1_7b").reduced(num_layers=2, dtype="float32")
    tm = build_model(tc, "cpu")
    p = tm.init_params(torch.Generator().manual_seed(0))
    batch = SyntheticLM(DataConfig(vocab_size=tc.vocab_size, seq_len=16,
                                   global_batch=4, n_chains=2)).get_batch(0)
    outs = []
    for group in (TO.GROUP_ELEMENTS, 4096):
        monkeypatch.setattr(TO, "GROUP_ELEMENTS", group)
        outs.append(TO.make_train_step(tm, to, 2)(
            p, TO.init_opt_state(p, to), batch))
    assert len(list(TO._groups(list(p), p))) > 2
    (p1, s1, m1), (p2, s2, m2) = outs
    for k in p:
        assert torch.equal(p1[k], p2[k]) and torch.equal(
            s1["m"][k], s2["m"][k]) and torch.equal(s1["v"][k], s2["v"][k])
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
