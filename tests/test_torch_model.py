"""The port's LMs against the JAX reference: configs, the layers, and
prefill + decode through the model with the reference's weights carried
across by ``params_from_numpy`` (every family; the encoder-decoder's and
the VLM's blocks are held one by one in ``test_torch_encdec_vlm.py``).
Tolerance: 1e-5 in float32, 2e-2 in bfloat16 (both rounding orders
differ; bf16 rounds at different places in the two frameworks)."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCFG
from repro.models import layers as JL
from repro.models.model import build_model as j_build
from repro.models.model import count_params_analytic

from repro_torch.configs import base as TCFG
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model, params_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(**kw):
    return (JCFG.get_config("qwen3_1_7b").reduced(**kw),
            TCFG.get_config("qwen3_1_7b").reduced(**kw))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TCFG.ARCH_IDS)
def test_config_matches_reference_field_for_field(arch):
    j, t = JCFG.get_config(arch), TCFG.get_config(arch.replace("_", "-"))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.padded_vocab == t.padded_vocab
    assert t.num_params == count_params_analytic(j)
    if arch == "qwen3_1_7b":
        assert t.padded_vocab == 152064


@pytest.mark.parametrize("kw", [dict(), dict(num_layers=2),
                                dict(num_layers=2, dtype="float32"),
                                dict(d_model=96, num_heads=6)])
def test_reduced_config_matches_reference(kw):
    j, t = _cfgs(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.num_params == count_params_analytic(j)


def test_get_config_refuses_unported_and_unknown_archs():
    assert len(TCFG.ARCH_IDS) == 10
    with pytest.raises(ValueError, match="unknown arch"):
        TCFG.get_config("gpt5")
    assert set(TCFG.ARCH_IDS) == set(JCFG.ARCH_IDS)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_rope_and_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 900, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5, rtol=1e-5)
    jc, tc = _cfgs(num_layers=1, dtype="float32")
    p = {k: rng.standard_normal(s).astype(np.float32) / 8 for k, s in
         (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    h = rng.standard_normal((2, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        TL.mlp_apply(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(h)),
        np.asarray(JL.mlp_apply(jc, {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(h))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_full_matches_reference_on_a_ring(window):
    rng = np.random.default_rng(1)
    b, w, h, kv, d = 3, 12, 4, 2, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, w, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, w, kv, d)).astype(np.float32)
    kv_pos = np.full((b, w), -1, np.int32)
    kv_pos[0, :4] = np.arange(4)
    kv_pos[1] = (np.arange(w) + 12) % w + 12     # wrapped ring
    q_pos = np.array([[3], [23], [0]], np.int32)  # row 2: nothing valid
    ours = TL.attention_decode(*(torch.from_numpy(a) for a in
                                 (q, k, v, q_pos, kv_pos)), window=window)
    ref = JL.attention_decode(*(jnp.asarray(a) for a in
                                (q, k, v, q_pos, kv_pos)), window=window)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(ours[2]) == 0


@pytest.mark.parametrize("page", [None, 1, 4, 12])
@pytest.mark.parametrize("filled", [[1, 5, 12], [12, 12, 12], [0, 7, 11]])
def test_paged_route_equals_attention_decode(page, filled):
    """The ring [B, W, Kv, D] read as pages through the decode kernel's
    plain version is attention_decode for full attention, wrapped or not."""
    rng = np.random.default_rng(sum(filled))
    b, w, h, kv, d = 3, 12, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, w, kv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, w, kv, d)).astype(np.float32))
    kv_pos = np.full((b, w), -1, np.int32)
    q_pos = np.zeros((b, 1), np.int32)
    for i, n in enumerate(filled):
        length = n + 17 * (n == w)          # a full ring has wrapped
        for p in range(max(0, length - w), length):
            kv_pos[i, p % w] = p
        q_pos[i] = length - 1
    page_ = w if page is None else page
    tbl = torch.arange(b * (w // page_), dtype=torch.int32).view(b, -1)
    lengths = torch.tensor(filled, dtype=torch.int32)
    paged = TL.attention_decode_paged(q, k, v, tbl, lengths, page=page_)
    plain = TL.attention_decode(q, k, v, torch.from_numpy(q_pos),
                                torch.from_numpy(kv_pos))
    torch.testing.assert_close(paged, plain, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model, with the reference's weights
# ---------------------------------------------------------------------------

#: leaves that start at zero in both packages: the VLM's cross gates
#: (tanh(0) = 0 would hide its cross layers) and the ungated MLP's biases
ZERO_LEAVES = ("gate_attn", "gate_mlp", "b_up", "b_down")


def nonzero_gates_and_biases(tree, seed=0):
    """``tree`` (numpy leaves) with every ``ZERO_LEAVES`` leaf drawn from a
    seeded generator: gates with |tanh| in [0.3, 0.9] and either sign,
    biases ~ N(0, 0.1), in each leaf's dtype."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("gate_attn", "gate_mlp"):
            g = np.arctanh(rng.uniform(0.3, 0.9, a.shape)) \
                * rng.choice([-1.0, 1.0], a.shape)
            return g.astype(a.dtype)
        if name in ("b_up", "b_down"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(draw, tree)


def _models(dtype, num_layers=2, arch="qwen3_1_7b", **kw):
    jc = JCFG.get_config(arch).reduced(num_layers=num_layers, dtype=dtype,
                                       **kw)
    tc = TCFG.get_config(arch).reduced(num_layers=num_layers, dtype=dtype,
                                       **kw)
    jm = j_build(jc)
    tree = nonzero_gates_and_biases(
        jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0))))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(tc, "cpu")
    tm.load_params(params_from_numpy(tree, tc, "cpu"))
    return jm, jp, tm


def memory_inputs(cfg, b, seed=0):
    """The batch's memory for cross-attention, as numpy in ``cfg``'s dtype:
    ``frames`` [b, Se, D] (encdec) or ``image_embeds`` [b, Ti, D] (vlm);
    {} for the other families."""
    n = {"encdec": ("frames", cfg.encoder_seq_len),
         "vlm": ("image_embeds", cfg.num_image_tokens)}.get(cfg.family)
    if n is None:
        return {}
    a = np.random.default_rng(seed).standard_normal(
        (b, n[1], cfg.d_model)).astype(np.float32)
    return {n[0]: a.astype(jnp.dtype(cfg.dtype))}


def to_torch(a):
    """A numpy array (bfloat16 included) as a CPU tensor, exactly."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x,
                                                                   np.float32)


def _close(a, b, dtype, what):
    np.testing.assert_allclose(_np(a), _np(b), atol=TOL[dtype],
                               rtol=TOL[dtype], err_msg=what)


#: (arch, dtype, prompt s, ring w, page, config overrides) of each prefill
#: + decode case. Danube's sliding window is 32 at the reduced size, so
#: its ring of 32 wraps in prefill (a prompt of 40) and the window binds
#: in both phases; OLMoE's prompt of 20 x 2 rows routes 80 assignments
#: into 4 experts of capacity 32 (at capacity factor 0.5, of 16: the
#: prefill drops assignments), and Grok adds the logit softcap. Whisper
#: (4 decoder and 2 encoder layers, Se 16) and the VLM (("self",
#: "cross") x 2, Ti 16) cross-attend to memories longer than the prompt
#: and shorter, with their gates and biases drawn non-zero.
PREFILL_DECODE = (
    [("qwen3_1_7b", dtype, s, w, page, {})
     for dtype in ("float32", "bfloat16")
     for s, w, page in ((20, 32, 8), (20, 24, None), (7, 8, 4))]
    + [("granite_3_8b", "float32", 20, 32, 8, {}),
       ("qwen1_5_110b", "float32", 20, 24, None, {}),
       ("h2o_danube_1_8b", "float32", 40, 32, 8, {}),
       ("olmoe_1b_7b", "float32", 20, 32, 8, {}),
       ("olmoe_1b_7b", "float32", 20, 32, 8, {"capacity_factor": 0.5}),
       ("olmoe_1b_7b", "bfloat16", 20, 24, 4, {}),
       ("grok_1_314b", "float32", 7, 8, 4, {})]
    + [(arch, dtype, s, w, page, {})
       for arch, s, w, page in (("whisper_tiny", 7, 12, 4),
                                ("llama_3_2_vision_11b", 20, 24, 8))
       for dtype in ("float32", "bfloat16")])


def _case_id(case):
    """The qwen3 cases keep the ids they had before the other archs."""
    arch, dtype, s, w, page, kw = case
    tail = f"{s}-{w}-{page}-{dtype}"
    if kw:
        tail = "-".join(f"{k}{v}" for k, v in kw.items()) + "-" + tail
    return tail if arch == "qwen3_1_7b" else f"{arch}-{tail}"


@pytest.mark.parametrize("arch,dtype,s,w,page,kw", PREFILL_DECODE,
                         ids=[_case_id(c) for c in PREFILL_DECODE])
def test_prefill_and_decode_match_reference(arch, dtype, s, w, page, kw):
    """Prefill, then three decode steps (five when the ring wraps: prompt +
    decode > W), comparing logits, every cache leaf (the K/V rings, the
    cross caches ``xk``/``xv``, the encoder's output), len and kv_pos. The
    MoE family's and Whisper's bf16 reference runs op by op
    (``jax.disable_jit``: under ``jit`` XLA rounds the expert products'
    and the tanh GELU's bf16 elsewhere)."""
    from repro.configs.base import ShapeConfig as JShape
    from repro_torch.configs.base import ShapeConfig as TShape
    jm, jp, tm = _models(dtype, arch=arch, **kw)
    op_by_op = jax.disable_jit if (jm.cfg.family in ("moe", "encdec", "vlm")
                                   and dtype == "bfloat16") \
        else contextlib.nullcontext
    toks = np.random.default_rng(s).integers(1, 512, (2, s)).astype(np.int32)
    batch = {"tokens": toks, **memory_inputs(jm.cfg, 2, seed=s)}
    jc = jm.init_cache(2, JShape("serve", w, 2, "decode"))
    tcache = tm.init_cache(2, TShape("serve", w, 2, "decode"))
    with op_by_op():
        jl, jc = jm.prefill(jp, {k: jnp.asarray(a) for k, a in batch.items()},
                            jc)
    tl, tcache = tm.prefill({k: to_torch(a) for k, a in batch.items()},
                            tcache)
    _close(tl, jl, dtype, "prefill logits")
    steps = 3 if s + 3 <= w else 5
    for step in range(steps + 1):
        for key, leaves in tcache["stack"]["scan"].items():
            for n, a in leaves.items():
                _close(a, jc["stack"]["scan"][key][n], dtype,
                       f"{key}.{n} after step {step}")
        if "enc_out" in jc:
            _close(tcache["enc_out"], jc["enc_out"], dtype,
                   f"enc_out after step {step}")
        np.testing.assert_array_equal(tcache["len"].numpy(), jc["len"])
        np.testing.assert_array_equal(tcache["kv_pos"].numpy(),
                                      jc["kv_pos"])
        if step == steps:
            break
        t = np.full((2, 1), 3 + step, np.int32)
        with op_by_op():
            jl, jc = jm.decode(jp, jnp.asarray(t), jc)
        tl, tcache = tm.decode(torch.from_numpy(t), tcache, page=page)
        _close(tl, jl, dtype, f"decode logits step {step}")
    assert s + steps <= w or int(tcache["len"][0]) > w


def test_init_params_is_seeded_and_complete():
    _, tc = _cfgs(num_layers=2)
    a = build_model(tc, "cpu").init_params(torch.Generator().manual_seed(3))
    b = build_model(tc, "cpu").init_params(torch.Generator().manual_seed(3))
    c = build_model(tc, "cpu").init_params(torch.Generator().manual_seed(4))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    m = build_model(tc, "cpu")
    m.load_params(a)
    assert sum(p.numel() for p in m.parameters()) == tc.num_params
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in m.parameters())
    assert m.embed.dtype == torch.bfloat16
    assert m.layers[1].attn["q_norm"].dtype == torch.float32


def test_params_from_numpy_carries_every_leaf():
    jm, jp, tm = _models("bfloat16", num_layers=3)
    state = dict(tm.named_parameters())
    wq = np.asarray(jp["stack"]["scan"]["0_layer"]["attn"]["wq"], np.float32)
    for i in range(3):
        np.testing.assert_array_equal(state[f"layers.{i}.attn.wq"].float(),
                                      wq[i])
    np.testing.assert_array_equal(state["embed"].float(),
                                  np.asarray(jp["embed"], np.float32))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in state.values()) == n_ref


def test_params_from_numpy_carries_the_moe_router_exactly():
    jm, jp, tm = _models("bfloat16", num_layers=2, arch="olmoe_1b_7b")
    state = dict(tm.named_parameters())
    moe = jp["stack"]["scan"]["0_moe_layer"]["moe"]
    for i in range(2):
        r = state[f"layers.{i}.moe.router"]
        assert r.dtype == torch.float32
        np.testing.assert_array_equal(r.numpy(), np.asarray(moe["router"][i]))
        for n in ("w_gate", "w_up", "w_down"):
            w = state[f"layers.{i}.moe.{n}"]
            assert w.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                w.float().numpy(), np.asarray(moe[n][i], np.float32))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in state.values()) == n_ref


def test_model_refuses_what_it_does_not_run():
    _, tc = _cfgs(num_layers=1)
    m = build_model(tc, "cpu")
    m.init_params(torch.Generator().manual_seed(0))
    from repro_torch.configs.base import ShapeConfig
    cache = m.init_cache(1, ShapeConfig("s", 12, 1, "decode"))
    with pytest.raises(ValueError, match="pages"):
        m.decode(torch.zeros((1, 1), dtype=torch.int32), cache, page=5)
    # a sliding-window ring longer than the window (init_cache never
    # makes one) would let the window mask filled slots
    swa = dataclasses.replace(tc, sliding_window=8)
    ms = build_model(swa, "cpu")
    ms.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="window"):
        ms.decode(torch.zeros((1, 1), dtype=torch.int32), cache)
    # the VLM's pattern needs cross_attn_every to divide num_layers, as
    # the reference asserts
    vlm = TCFG.get_config("llama_3_2_vision_11b").reduced(num_layers=3)
    with pytest.raises(ValueError, match="cross_attn_every"):
        build_model(vlm, "cpu")
    with pytest.raises(ValueError, match="backend"):
        build_model(tc, "cpu", backend="pallas")


def test_build_model_defaults_to_the_card(monkeypatch):
    """``device=None`` is the card: without one it raises instead of
    falling back to the CPU; ``count_params`` still works on meta
    tensors."""
    _, tc = _cfgs(num_layers=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tc)
    assert build_model(tc, "cpu").device.type == "cpu"
    assert tc.num_params > 0
