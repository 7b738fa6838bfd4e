"""Whisper's and Llama-3.2-Vision's pieces against the JAX reference, one
by one at reduced width: cross-attention in prefill and decode, the
encoder layer, the ungated MLP, ``layer_norm``, ``params_from_numpy``
over the encoder and the 0-d gates, parameter counts, and the refusals.
The whole models' prefill + decode parity is in ``test_torch_model.py``
(``PREFILL_DECODE``). Weights are numpy draws in the shapes the
reference's initializers give (``jax.eval_shape``), with the gates and
biases that start at zero drawn non-zero. Tolerance: 1e-5 in float32,
2e-2 in bfloat16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCFG
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro.models.model import count_params_analytic

from repro_torch.configs import base as TCFG
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as DEC
from repro_torch.kernels.flash_attention import ops as FLASH
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.model import _flatten, build_model, params_from_numpy

from test_torch_model import (TOL, memory_inputs, nonzero_gates_and_biases,
                              to_torch)

DTYPES = ("float32", "bfloat16")


def _cfgs(arch, dtype="float32", **kw):
    return (JCFG.get_config(arch).reduced(dtype=dtype, **kw),
            TCFG.get_config(arch).reduced(dtype=dtype, **kw))


def _draw(init, cfg, seed=0):
    """numpy parameters in the shapes and dtypes of the reference's
    ``init(key, cfg)``: matrices ~ N(0, 1 / fan_in), vectors ~ N(0, 0.1^2),
    gates and biases as ``nonzero_gates_and_biases``."""
    shapes = jax.eval_shape(lambda k: init(k, cfg)[0], jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(s):
        a = rng.standard_normal(s.shape)
        a = a / np.sqrt(s.shape[0]) if len(s.shape) >= 2 else 0.1 * a
        return a.astype(s.dtype)
    return nonzero_gates_and_biases(jax.tree.map(fill, shapes), seed)


def _act(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return a.astype(jnp.dtype(dtype))


def _close(a, b, dtype, what):
    np.testing.assert_allclose(
        a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32),
        np.asarray(b, np.float32), atol=TOL[dtype], rtol=TOL[dtype],
        err_msg=what)


def _module(cls, cfg, tree):
    m = cls(cfg)
    m.load_state_dict({k: to_torch(v) for k, v in _flatten(tree).items()},
                      assign=True)
    return m


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_reference(dtype):
    x = _act((2, 5, 64), dtype, 0)
    scale, bias = _act((64,), "float32", 1), _act((64,), "float32", 2)
    ours = TL.layer_norm(to_torch(x), to_torch(scale), to_torch(bias), 1e-6)
    ref = JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                        1e-6)
    assert ours.dtype == getattr(torch, dtype)
    _close(ours, ref, dtype, "layer_norm")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ungated_mlp_matches_reference(dtype):
    """Whisper's MLP: act(x W_up + b_up) W_down + b_down with the tanh
    GELU, biases non-zero; the port's initializer gives the reference's
    names, shapes and zero biases."""
    jc, tc = _cfgs("whisper_tiny", dtype)
    p = _draw(lambda k, c: JL.mlp_params(k, c, gated=False), jc)
    x = _act((2, 3, 64), dtype, 3)
    ours = TL.mlp_apply(tc, {k: to_torch(v) for k, v in p.items()},
                        to_torch(x))
    ref = JL.mlp_apply(jc, {k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    _close(ours, ref, dtype, "ungated mlp")
    fresh = TL.mlp_params(torch.Generator().manual_seed(0), tc, gated=False)
    assert {k: (tuple(v.shape), v.dtype) for k, v in fresh.items()} == \
        {k: (v.shape, getattr(torch, dtype)) for k, v in p.items()}
    assert not fresh["b_up"].any() and not fresh["b_down"].any()


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attn_params_have_no_bias(qkv_bias):
    """``attn_params(cross=True)`` keeps no q/k/v biases even under
    ``qkv_bias``, as the reference's."""
    jc, tc = _cfgs("whisper_tiny", qkv_bias=qkv_bias)
    for cross in (False, True):
        ref = jax.eval_shape(lambda k: JL.attn_params(k, jc, cross=cross)[0],
                             jax.random.PRNGKey(0))
        ours = TL.attn_params(None, tc, cross=cross)
        assert {k: tuple(v.shape) for k, v in ours.items()} == \
            {k: v.shape for k, v in ref.items()}
        assert ("bq" in ours) == (qkv_bias and not cross)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,se", [(5, 16), (16, 16), (9, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_reference(dtype, s, se):
    """Prefill: k, v from the memory (Se keys, Se != S), written into the
    cross cache in its dtype; then a decode step reading them from the
    cache. Output and cache against the reference's ``_cross_attention``
    (fresh, then not)."""
    jc, tc = _cfgs("llama_3_2_vision_11b", dtype)
    p = _draw(lambda k, c: JL.attn_params(k, c, cross=True), jc)
    tp = {k: to_torch(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x, mem = _act((2, s, 64), dtype, 4), _act((2, se, 64), dtype, 5)
    kv, hd = tc.num_kv_heads, tc.head_dim
    shape = (2, se, kv, hd)
    jcache = {n: jnp.zeros(shape, jnp.dtype(dtype)) for n in ("xk", "xv")}
    tcache = {n: torch.zeros(shape, dtype=getattr(torch, dtype))
              for n in ("xk", "xv")}
    ref, jcache = JB._cross_attention(jc, jp, jnp.asarray(x),
                                      jnp.asarray(mem), jnp.arange(se),
                                      jcache, fresh=True)
    ours, tcache = TB._cross_attention(tc, tp, to_torch(x), to_torch(mem),
                                       {"mode": "prefill"}, tcache)
    _close(ours, ref, dtype, "prefill output")
    for n in ("xk", "xv"):
        _close(tcache[n], jcache[n], dtype, f"prefill {n}")
    x1 = _act((2, 1, 64), dtype, 6)
    ref, _ = JB._cross_attention(jc, jp, jnp.asarray(x1), None, None, jcache,
                                 fresh=False)
    ours, _ = TB._cross_attention(tc, tp, to_torch(x1), None,
                                  {"mode": "decode"}, tcache)
    _close(ours, ref, dtype, "decode output")


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_enc_layer_matches_reference(dtype, qkv_bias):
    """Whisper's encoder layer: bidirectional attention with no rope (and,
    with ``qkv_bias``, its biases), the ungated MLP, no cache."""
    jc, tc = _cfgs("whisper_tiny", dtype, qkv_bias=qkv_bias)
    p = _draw(JB.enc_layer_init, jc)
    x = _act((2, 16, 64), dtype, 7)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    ref, _, _ = JB.enc_layer_apply(jc, jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), {"q_pos": jnp.asarray(pos)},
                                   None)
    layer = _module(TB.EncLayer, tc, p)
    aux = {"mode": "encode", "q_pos": torch.from_numpy(pos.copy())}
    ours, cache, _ = layer(to_torch(x), aux, None)
    assert cache is None
    _close(ours, ref, dtype, "encoder layer")


# ---------------------------------------------------------------------------
# the model's parameters
# ---------------------------------------------------------------------------

def _ref_tree(jc, seed=0):
    """numpy draws in the shapes of the reference's whole init_params."""
    return _draw(lambda k, c: (j_build(c).init_params(k), None), jc, seed)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["whisper_tiny", "llama_3_2_vision_11b"])
def test_params_from_numpy_carries_encoder_and_gates(arch, dtype):
    """Every leaf crosses exactly: the encoder's stacked leaves to
    ``encoder.{i}``, ``enc_norm``, and the VLM's 0-d float32 gates to the
    cross layers (positions k - 1 of each group of k)."""
    jc, tc = _cfgs(arch, dtype)
    tree = _ref_tree(jc)
    state = params_from_numpy(tree, tc, "cpu")
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in state.values()) == n_ref == tc.num_params
    if arch == "whisper_tiny":
        enc = _flatten(tree["enc_stack"]["scan"]["0_enc"])
        assert len(enc) == 10    # norm1, attn (4), norm2, mlp (4)
        for i in range(tc.num_encoder_layers):
            for k, a in enc.items():
                t = state[f"encoder.{i}.{k}"]
                assert t.dtype == to_torch(a).dtype
                np.testing.assert_array_equal(t.float().numpy(),
                                              np.asarray(a[i], np.float32))
        np.testing.assert_array_equal(state["enc_norm"].numpy(),
                                      tree["enc_norm"])
    else:
        every = tc.cross_attn_every
        cross = tree["stack"]["scan"][f"{every - 1}_cross"]
        for g in range(tc.num_layers // every):
            for n in ("gate_attn", "gate_mlp"):
                t = state[f"layers.{g * every + every - 1}.{n}"]
                assert t.dtype == torch.float32 and t.shape == ()
                assert float(t) == float(cross[n][g]) != 0.0
    model = build_model(tc, "cpu")
    model.load_params(state)


@pytest.mark.parametrize("kw", [dict(), dict(num_layers=2), dict(
    qkv_bias=True), dict(num_layers=6, cross_attn_every=3)])
@pytest.mark.parametrize("arch", ["whisper_tiny", "llama_3_2_vision_11b"])
def test_num_params_matches_reference(arch, kw):
    jc, tc = _cfgs(arch, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.num_params == count_params_analytic(jc)


def test_vlm_refuses_cross_every_not_dividing():
    """Both packages refuse a VLM whose ``cross_attn_every`` does not
    divide ``num_layers`` (the reference asserts)."""
    jc, tc = _cfgs("llama_3_2_vision_11b", num_layers=5)
    with pytest.raises(AssertionError):
        j_build(jc)
    with pytest.raises(ValueError, match="cross_attn_every"):
        build_model(tc, "cpu")
    build_model(dataclasses.replace(tc, cross_attn_every=5), "cpu")


# ---------------------------------------------------------------------------
# the kernels' gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper_tiny", "llama_3_2_vision_11b"])
def test_no_fallback_without_a_card(arch, monkeypatch):
    """``backend="cuda"`` on CPU tensors raises in prefill (encoder, self-
    and cross-attention all go through the gate); ``build_model`` without
    ``device`` and without a card raises."""
    _, tc = _cfgs(arch)
    m = build_model(tc, "cpu", backend="cuda")
    m.init_params(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.ones((2, 4), dtype=torch.int32),
             **{k: to_torch(a) for k, a in memory_inputs(tc, 2).items()}}
    with pytest.raises(ValueError, match="cuda"):
        m.prefill(batch, m.init_cache(2, ShapeConfig("s", 8, 2, "decode")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tc)


@pytest.mark.parametrize("arch", ["whisper_tiny", "llama_3_2_vision_11b"])
def test_card_path_launches_the_kernels_only(arch, monkeypatch):
    """The card's route on the CPU: the gate resolves to ``cuda`` and each
    ``*_cuda`` wrapper is its plain version, counted; ``attention_full``
    must not be called. Flash launches once a self-attention, encoder and
    cross-attention layer in prefill, decode once a self and cross layer a
    step, and the logits are those of the plain route, bitwise."""
    _, tc = _cfgs(arch)
    calls = {"flash": 0, "decode": 0}

    def flash(q, k, v, **kw):
        calls["flash"] += 1
        return FLASH._ref.flash_attention_ref(q, k, v, **kw)

    def decode(*a):
        calls["decode"] += 1
        return DEC._ref.paged_decode_attention_ref(*a)

    def no_plain(*a, **kw):
        raise AssertionError("the card path called attention_full")

    def run(backend, steps=2):
        m = build_model(tc, "cpu", backend=backend)
        m.init_params(torch.Generator().manual_seed(0))
        batch = {"tokens": torch.arange(1, 9, dtype=torch.int32).view(2, 4),
                 **{k: to_torch(a) for k, a in memory_inputs(tc, 2).items()}}
        cache = m.init_cache(2, ShapeConfig("s", 8, 2, "decode"))
        out = [m.prefill(batch, cache)]
        for i in range(steps):
            out.append(m.decode(torch.full((2, 1), i + 1, dtype=torch.int32),
                                out[-1][1]))
        return [lg for lg, _ in out], calls.copy()

    plain, _ = run("ref")
    monkeypatch.setattr(_build, "resolve_backend",
                        lambda kind, backend, device: "cuda")
    monkeypatch.setattr(FLASH, "flash_attention_cuda", flash)
    monkeypatch.setattr(DEC, "paged_decode_attention_cuda", decode)
    monkeypatch.setattr(TL, "attention_full", no_plain)
    kern, launched = run("cuda")
    n = tc.num_layers
    if arch == "whisper_tiny":
        want = {"flash": tc.num_encoder_layers + 2 * n, "decode": 2 * n * 2}
    else:
        want = {"flash": n, "decode": n * 2}
    assert launched == want
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
