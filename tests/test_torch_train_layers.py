"""The training path's plain versions: ``attention_train`` against the
reference's (forward and gradients, both branches), ``gradcheck`` in
float64 of each plain version the train path differentiates, and the
kernels' wrappers refusing inputs that require grad (a train step on the
card's route launches no kernel).

Tolerances: attention outputs and gradients within 2e-5 of the
reference's (float32; both sides sum the same terms in other orders);
``gradcheck`` at its float64 defaults (eps 1e-6, atol 1e-5, rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.configs.base import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as DEC
from repro_torch.kernels.flash_attention import ops as FLASH
from repro_torch.kernels.medic_gather import ops as GATHER
from repro_torch.kernels.mlstm import ops as MLSTM
from repro_torch.kernels.mlstm import ref as MREF
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
from repro_torch.kernels.rg_lru import ops as RGLRU
from repro_torch.kernels.rg_lru.ref import rg_lru_ref
from repro_torch.models import layers as TL
from repro_torch.models import xlstm as TX
from repro_torch.models.model import build_model

TOL = 2e-5
F64 = torch.float64


def _qkv(b, s, h, kv, d, seed, skv=None):
    rng = np.random.default_rng(seed)
    skv = skv or s
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32),
            rng.standard_normal((b, skv, kv, d)).astype(np.float32))


def _ours_and_ref(q, k, v, window, causal, **kw):
    """(output, d/dq, d/dk, d/dv) of sum(out * w) for both packages, w a
    fixed random cotangent."""
    s, skv = q.shape[1], k.shape[1]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), q.shape[:2])
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), k.shape[:2])
    w = np.random.default_rng(99).standard_normal(q.shape).astype(np.float32)

    def jf(q, k, v):
        o = JL.attention_train(q, k, v, jnp.asarray(pos), jnp.asarray(kpos),
                               window=window, causal=causal, **kw)
        return jnp.sum(o * w), o
    (_, jo), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = TL.attention_train(tq, tk, tv, torch.from_numpy(pos.copy()),
                            torch.from_numpy(kpos.copy()), window=window,
                            causal=causal, **kw)
    (to * torch.from_numpy(w)).sum().backward()
    return ((to, tq.grad, tk.grad, tv.grad),
            (jo,) + tuple(jg))


CASES = [  # (b, s, h, kv, d, window, causal): GQA with G 2, D 16
    (2, 40, 4, 2, 16, None, True),       # the full branch
    (2, 40, 4, 2, 16, 9, True),
    (2, 40, 4, 2, 16, None, False),
    (1, 2048, 4, 2, 16, None, True),     # the chunked branch: 4 x 4 chunks
    (1, 2048, 4, 2, 16, 640, True),      # SWA band of 640 // 512 + 2 = 3
    (1, 2048, 4, 2, 16, None, False),
]


@pytest.mark.parametrize("b,s,h,kv,d,window,causal", CASES)
def test_attention_train_matches_reference(b, s, h, kv, d, window, causal):
    q, k, v = _qkv(b, s, h, kv, d, seed=s + (window or 0))
    ours, ref = _ours_and_ref(q, k, v, window, causal)
    for name, a, r in zip(("out", "dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_attention_train_chunked_branch_equals_full():
    """The chunked online softmax computes attention_full's function (the
    SWA band drops only chunks the window masks whole)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2048, 4, 2, 16, 5))
    pos = torch.arange(2048, dtype=torch.int32)[None]
    for window in (None, 640, 100):
        full = TL.attention_full(q, k, v, pos, pos, window=window)
        chunked = TL.attention_train(q, k, v, pos, pos, window=window)
        torch.testing.assert_close(chunked, full, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# gradcheck of the plain versions, float64
# ---------------------------------------------------------------------------

@pytest.fixture
def f64(monkeypatch):
    """The plain versions compute in their modules' ``F32``; for a float64
    gradcheck that constant is float64 for the test's duration."""
    for mod in (TL, TX, MREF):
        monkeypatch.setattr(mod, "F32", F64)


def _f64(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, dtype=F64)
            ).requires_grad_(True)


@pytest.mark.parametrize("window", [None, 3])
def test_gradcheck_attention_train_full_branch(f64, window):
    q, k, v = _f64(1, 6, 4, 4, seed=1), _f64(1, 6, 2, 4, seed=2), \
        _f64(1, 6, 2, 4, seed=3)
    pos = torch.arange(6, dtype=torch.int32)[None]
    assert torch.autograd.gradcheck(
        lambda q, k, v: TL.attention_train(q, k, v, pos, pos,
                                           window=window), (q, k, v))


def test_gradcheck_attention_train_chunked_branch(f64):
    """At S 1040 with chunks of 520 (two query chunks, a band of 2),
    checked along random directions (``fast_mode``)."""
    q, k, v = _f64(1, 1040, 2, 4, seed=4), _f64(1, 1040, 1, 4, seed=5), \
        _f64(1, 1040, 1, 4, seed=6)
    pos = torch.arange(1040, dtype=torch.int32)[None]
    assert torch.autograd.gradcheck(
        lambda q, k, v: TL.attention_train(q, k, v, pos, pos, window=8,
                                           q_chunk=520, kv_chunk=520),
        (q, k, v), fast_mode=True)


def test_gradcheck_rg_lru_plain_loop():
    """The RG-LRU's plain loop writes h_t into a preallocated output in
    place; autograd takes it."""
    a = torch.rand((2, 5, 3), dtype=F64).requires_grad_(True)
    b, h0 = _f64(2, 5, 3, seed=7), _f64(2, 3, seed=8)
    assert torch.autograd.gradcheck(rg_lru_ref, (a, b, h0))


def test_gradcheck_mlstm_chunkwise(f64):
    """Chunks of 4 over S 10 (the last chunk short), from a carried state;
    the gradient of h and of the final (C, n, m)."""
    b, s, h, dk, dv = 1, 10, 2, 3, 4
    q, k, v = _f64(b, s, h, dk, seed=9), _f64(b, s, h, dk, seed=10), \
        _f64(b, s, h, dv, seed=11)
    li = _f64(b, s, h, seed=12)
    lf = torch.nn.functional.logsigmoid(_f64(b, s, h, seed=13) + 2
                                        ).detach().requires_grad_(True)
    c0, n0 = _f64(b, h, dk, dv, seed=14, scale=0.1), _f64(b, h, dk, seed=15)
    m0 = _f64(b, h, seed=16, scale=0.1)

    def f(q, k, v, li, lf, c0, n0, m0):
        hs, (c, n, m) = mlstm_chunkwise_ref(q, k, v, li, lf, (c0, n0, m0),
                                            chunk=4)
        return hs, c, n, m
    assert torch.autograd.gradcheck(f, (q, k, v, li, lf, c0, n0, m0))


def test_gradcheck_slstm_loop(f64):
    cfg = get_config("xlstm_125m").reduced(d_model=8, num_heads=2,
                                           dtype="float64")
    p = {n: t.to(F64).requires_grad_(True) for n, t in TX.slstm_params(
        torch.Generator().manual_seed(0), cfg, dtype=F64).items()}
    x = _f64(2, 4, 8, seed=17)

    def f(x, w_gates, b_gates, r_gates, w_out):
        q = {"w_gates": w_gates, "b_gates": b_gates, "r_gates": r_gates,
             "w_out": w_out}
        return TX.slstm_apply(cfg, q, x)[0]
    assert torch.autograd.gradcheck(
        f, (x, p["w_gates"], p["b_gates"], p["r_gates"], p["w_out"]))


# ---------------------------------------------------------------------------
# no kernel on the training path
# ---------------------------------------------------------------------------

def test_refuse_grad_helper():
    x = torch.ones(3)
    _build.refuse_grad("k", x, None)                 # nothing requires grad
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("k", x, w)
    with torch.no_grad():
        _build.refuse_grad("k", w)                   # grad mode off


def _requiring_grad_calls():
    """Each ``*_cuda`` wrapper that takes model activations, called with
    CPU inputs of the right shapes, one of which requires grad."""
    g = torch.ones
    q4 = g((1, 4, 2, 8), requires_grad=True)
    kv4 = g((1, 4, 1, 8))
    tbl = torch.zeros((1, 1), dtype=torch.int32)
    a = g((1, 4, 3), requires_grad=True)
    return {
        "flash_attention": lambda: FLASH.flash_attention_cuda(q4, kv4, kv4),
        "paged_decode_attention": lambda: DEC.paged_decode_attention_cuda(
            g((1, 1, 2, 8)), g((1, 4, 1, 8), requires_grad=True),
            g((1, 4, 1, 8)), tbl, torch.ones(1, dtype=torch.int32)),
        "rg_lru": lambda: RGLRU.rg_lru_cuda(a, g((1, 4, 3)), g((1, 3))),
        "mlstm": lambda: MLSTM.mlstm_cuda(
            q4, g((1, 4, 2, 8)), g((1, 4, 2, 8)), g((1, 4, 2)),
            g((1, 4, 2))),
        "medic_gather": lambda: GATHER.medic_gather_cuda(
            g((2, 4, 1, 8), requires_grad=True), tbl),
        "medic_gather_pools": lambda: GATHER.medic_gather_pools_cuda(
            (g((2, 4, 1, 8)), g((2, 4, 1, 8), requires_grad=True)), tbl),
    }


@pytest.mark.parametrize("kernel", sorted(_requiring_grad_calls()))
def test_cuda_wrapper_refuses_input_that_requires_grad(kernel):
    """The refusal comes before anything else the wrapper checks, so it
    shows on the CPU; under ``no_grad`` the same call goes on to the
    wrapper's own checks (CUDA tensors only)."""
    call = _requiring_grad_calls()[kernel]
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def _batch(cfg):
    """Tokens [2, 8], with Whisper's frames or the VLM's image embeddings
    (ones) beside them."""
    batch = {"tokens": torch.arange(16, dtype=torch.int32).view(2, 8)}
    n = {"encdec": ("frames", cfg.encoder_seq_len),
         "vlm": ("image_embeds", cfg.num_image_tokens)}.get(cfg.family)
    if n is not None:
        batch[n[0]] = torch.ones((2, n[1], cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "recurrentgemma_2b",
                                  "xlstm_125m", "whisper_tiny",
                                  "llama_3_2_vision_11b"])
def test_train_step_on_the_cards_route_launches_no_kernel(arch, monkeypatch):
    """The card's route on the CPU: every gate resolves to ``cuda`` and
    every ``*_cuda`` wrapper is its plain version, counted. ``Model.loss``
    and its backward launch none of them, and the gradients equal those
    of the CPU route bitwise; a serving prefill on the same route does
    launch, and a wrapper handed an input that requires grad refuses."""
    cfg = get_config(arch).reduced(num_layers=4 if arch.startswith("llama")
                                   else 3, dtype="float32")
    calls = {"flash": 0, "decode": 0, "rg_lru": 0, "mlstm": 0}

    def counted(name, ref):
        """The plain version in the wrapper's place, refusing a
        grad-requiring input first as the wrapper does."""
        def fn(*a, **kw):
            _build.refuse_grad(name, *[t for t in a if torch.is_tensor(t)])
            calls[name] += 1
            return ref(*a, **kw)
        return fn

    def run():
        m = build_model(cfg, "cpu", backend="auto")
        m.init_params(torch.Generator().manual_seed(0))
        m.requires_grad_(True)
        total, _ = m.loss(_batch(cfg))
        total.backward()
        return {k: p.grad for k, p in m.named_parameters()}

    plain = run()
    monkeypatch.setattr(_build, "resolve_backend",
                        lambda kind, backend, device: "cuda"
                        if backend != "ref" else "ref")
    monkeypatch.setattr(FLASH, "flash_attention_cuda", counted(
        "flash", FLASH._ref.flash_attention_ref))
    monkeypatch.setattr(DEC, "paged_decode_attention_cuda", counted(
        "decode", DEC._ref.paged_decode_attention_ref))
    monkeypatch.setattr(RGLRU, "rg_lru_cuda", counted("rg_lru", rg_lru_ref))
    monkeypatch.setattr(MLSTM, "mlstm_cuda", counted(
        "mlstm", mlstm_chunkwise_ref))
    card = run()
    assert calls == {"flash": 0, "decode": 0, "rg_lru": 0, "mlstm": 0}
    for k in plain:
        torch.testing.assert_close(card[k], plain[k], atol=0, rtol=0)
    # the serving route does reach the (stubbed) kernels
    from repro_torch.configs.base import ShapeConfig
    m = build_model(cfg, "cpu")
    m.init_params(torch.Generator().manual_seed(0))
    m.prefill(_batch(cfg), m.init_cache(2, ShapeConfig("s", 8, 2, "decode")))
    assert sum(calls.values()) > 0
    # and a kernel route handed a grad-requiring input refuses it
    q = torch.ones((1, 4, 2, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        TL.attention_prefill(q, q[:, :, :1].detach(), q[:, :, :1].detach(),
                             backend="cuda")
