"""The port's CUDA kernels: their C bindings (checked here, on any
machine) and, on the card, each kernel against its plain PyTorch version.

The card tests carry the ``cuda`` marker and skip without a CUDA device;
on the card run ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
This file imports no JAX, so it runs where only the port is installed.
The fuzz grids are chip_smoke.py's own.
"""
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.core import baselines as BL  # noqa: E402
from repro_torch.core import tracegen as TG  # noqa: E402
from repro_torch.core import workloads as WL  # noqa: E402
from repro_torch.core.engine import SimParams, simulate_sweep  # noqa: E402
from repro_torch.core.tracegen.sampler import _sample_cells  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cache_pass import ops as CPASS  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DEC  # noqa: E402
from repro_torch.kernels.event_loop import ops as EVL  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FLASH  # noqa: E402
from repro_torch.kernels.medic_gather import ops as GATHER  # noqa: E402
from repro_torch.kernels.mlstm import ops as MLSTM  # noqa: E402
from repro_torch.kernels.rg_lru import ops as RGLRU  # noqa: E402
from repro_torch.kernels.tracegen import ops as KTG  # noqa: E402
from repro_torch.kernels.wavefront_scan import ops as WSCAN  # noqa: E402

WAVEFRONT_KERNELS = {"wave_queue": WSCAN.WAVE_QUEUE,
                     "wave_cache": CPASS.WAVE_CACHE}
KERNELS = {**WAVEFRONT_KERNELS, "medic_gather": GATHER.MEDIC_GATHER,
           "decode_attention": DEC.DECODE_ATTENTION,
           "flash_attention": FLASH.FLASH_ATTENTION,
           "rg_lru": RGLRU.RG_LRU, "mlstm": MLSTM.MLSTM,
           "event_loop": EVL.EVENT_LOOP, "tracegen": KTG.TRACEGEN}


@pytest.fixture
def cuda_device():
    """The card, or a skip: the kernels have no CPU form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _c_params(name):
    """Parameter list of ``int <name>_launch(...)`` in csrc/<name>.cu."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf"int {name}_launch\((.*?)\)\s*{{", src, re.S)
    assert m, f"{name}_launch not found"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_binding_matches_the_c_signature(name):
    """Every C parameter has a ctypes argtype of its kind: pointers and the
    stream as c_void_p (a 32-bit int would cut them), ints, floats."""
    params = _c_params(name)
    kinds = [("void" if "*" in p else p.split()[0]) for p in params]
    want = {"void": "c_void_p", "int": "c_int", "float": "c_float"}
    got = [t.__name__ for t in KERNELS[name].argtypes]
    assert got == [want[k] for k in kinds]
    assert f"{name}_error_string" in (_build.CSRC / f"{name}.cu").read_text()


def test_build_is_named_by_source_hash_in_the_repo():
    for name in KERNELS:
        path = _build.lib_path(name)
        assert path.parent == ROOT / "build" / "repro_torch_kernels"
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{12}}\.so", path.name)
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast-math" in f or "fast_math" in f
                   for f in _build.NVCC_FLAGS)


@pytest.mark.cuda
def test_wave_queue_kernel_bitwise_on_card(cuda_device):
    assert CS.phase_wave_queue()["max_abs_err"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n", [8192, 16384, 262144])
def test_wave_queue_wide_waves_bitwise_on_card(cuda_device, n, dyadic,
                                               exact):
    """HAMMER2K's wave (one block pass of 16 slots a thread), HAMMER4K's
    (two passes) and WIDE64K's (32 passes), against the plain version."""
    import numpy as np
    slots, carry = CS.wave_case(np.random.default_rng(n + dyadic), n, dyadic)
    kern = WSCAN.wave_queue_cuda(*slots, carry, exact=exact, **CS.QKW)
    plain = WSCAN._ref.wave_queue_recovery_ref(*slots, carry, exact=exact,
                                               **CS.QKW)
    assert CS.max_abs_err(CS.flat(kern), CS.flat(plain)) == 0.0


@pytest.mark.cuda
def test_wave_cache_kernel_bitwise_on_card(cuda_device):
    assert CS.phase_wave_cache()["max_abs_err"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("sets,b,lanes,hi,ways", CS.CACHE_EXTRA + [
    (512, 512, 16, 4000, 8), (4, 12, 5, 30, 8)])
def test_wave_cache_both_instances_on_card(cuda_device, sets, b, lanes, hi,
                                           ways):
    """The shared-memory-resident and the global-state instances against
    the plain version, bitwise; sparse waves leave most sets untouched, and
    those must reach the outputs unchanged."""
    import numpy as np
    prm = SimParams(sets=sets, ways=ways)
    st, args, pa = CS.cache_case(np.random.default_rng(sets + b), 2 * b, b,
                                 lanes, prm, BL.MEDIC, hi)
    assert CS._wave_cache_both(st, args, prm, pa, f"sets={sets}") == 0.0
    if lanes * b < sets // 4:                  # a sparse wave
        plain, _, _ = CPASS._ref.wave_cache_pass_ref(st, *args, prm, pa)
        kern, _, _ = CPASS.wave_cache_cuda(st, *args, prm, pa)
        same = (plain.tags == st.tags).all(dim=1)
        assert int(same.sum()) > sets // 2
        assert torch.equal(kern.tags[same], st.tags[same])
        assert torch.equal(kern.rrip[same], st.rrip[same])


@pytest.mark.cuda
def test_medic_gather_routes_on_card(cuda_device):
    """The 16-byte loop and the byte route, over one pool and several,
    with holes and an all-hole table; the one-pool form is the pools
    form's first row."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    pools = [CS._randn((50, 16, 8, 128), torch.bfloat16, gen, cuda_device)
             for _ in range(3)]
    small = [CS._randn((9, 3, 1, 5), torch.float32, gen, cuda_device)
             for _ in range(2)]
    holes = torch.randint(0, 50, (4, 7), generator=gen, device=cuda_device)
    holes[0, ::2] = -1
    tables = (holes.to(torch.int32),
              torch.full((2, 3), -1, dtype=torch.int32, device=cuda_device),
              torch.tensor([[49, 0]], dtype=torch.int32, device=cuda_device))
    for tbl in tables:
        for ps in (pools[:1], pools[:2], pools, small):
            t = tbl.clamp(max=ps[0].shape[0] - 1) if ps is small else tbl
            t = torch.where(tbl < 0, tbl, t).contiguous()
            outs = GATHER.medic_gather_pools_cuda(ps, t)
            assert outs.shape[0] == len(ps)
            for o, p in zip(outs, ps):
                assert torch.equal(o, GATHER._ref.medic_gather_ref(p, t))
            assert torch.equal(GATHER.medic_gather_cuda(ps[0], t), outs[0])


@pytest.mark.cuda
def test_engine_kernels_match_plain_on_card(cuda_device):
    tr = WL.generate(WL.WORKLOADS["BFS"], 0)
    args = (tr["lines"][:16], tr["pcs"][:16], tr["compute_gap"])
    pols = (BL.BASELINE, BL.PCAL, BL.WBYP, BL.MEDIC)
    kw = dict(n_warps=48, lanes=16, prm=SimParams(), engine="wavefront",
              device=cuda_device)
    before = {k: v.launches for k, v in WAVEFRONT_KERNELS.items()}
    out = simulate_sweep(*args, pols, **kw)
    assert all(v.launches > before[k]
               for k, v in WAVEFRONT_KERNELS.items())
    ref = simulate_sweep(*args, pols, scan_backend="ref",
                         cache_backend="ref", **kw)
    for k in out:
        if k in CS.FLOAT_REDUCTIONS:
            torch.testing.assert_close(out[k], ref[k], rtol=1e-6, atol=0)
        else:
            assert torch.equal(out[k], ref[k]), k


def test_chip_smoke_builds_and_reports_every_kernel():
    assert set(CS.SOURCES.values()) == set(KERNELS)
    assert set(CS.SOURCES) == set(CS.KERNELS) | set(CS.PORT_KERNELS)
    for row in CS.KERNELS.values():
        assert (ROOT / row["source"]).exists()
        path, line = row["replaces"].split(":")
        assert "pallas_call" in (ROOT / path).read_text() and int(line) > 0
    # port-side kernels replace a loop of the reference, not a Pallas call
    for row in CS.PORT_KERNELS.values():
        assert (ROOT / row["source"]).exists() and row["pallas"] is None
        path, line = row["replaces"].split(":")
        src = (ROOT / path).read_text().splitlines()
        assert "pallas_call" not in "\n".join(src)
        assert src[int(line) - 1].startswith("def ")


@pytest.mark.cuda
def test_medic_gather_kernel_bitwise_on_card(cuda_device):
    assert CS.phase_medic_gather(cuda_device)["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_decode_attention_kernel_matches_plain_on_card(cuda_device):
    out = CS.phase_decode_attention(cuda_device)
    assert out["max_abs_err"] <= CS.TOL[torch.bfloat16]
    assert out["max_abs_err_f32"] <= CS.TOL[torch.float32]


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain_on_card(cuda_device):
    out = CS.phase_flash_attention(cuda_device)
    assert out["max_abs_err"] <= CS.TOL[torch.bfloat16]
    assert out["max_abs_err_f32"] <= CS.TOL[torch.float32]


@pytest.mark.cuda
def test_serving_engine_kernels_match_plain_on_card(cuda_device):
    """A short MeDiC run of a 2-layer Qwen3-1.7B-width engine through the
    kernels and through their plain versions: same snapshot, K/V caches
    within 2e-2 (float32)."""
    import dataclasses
    cfg = dataclasses.replace(CS.get_config("qwen3_1_7b"), num_layers=2,
                              dtype="float32")
    params = CS.ENG.init_params(cfg, 0, cuda_device)
    pool = dataclasses.replace(CS.SERVE_POOL, policy="medic")
    runs = []
    for backend in ("cuda", "ref"):
        before = {k: v.launches for k, v in KERNELS.items()}
        eng = CS.ENG.ServeEngine(cfg, CS.SERVE_ECFG, pool,
                                 device=cuda_device, backend=backend,
                                 params=params)
        snap = eng.run(CS.generate_requests(CS.SERVE_WL, seed=0),
                       max_steps=60)
        launched = {k: v.launches - before[k] for k, v in KERNELS.items()}
        runs.append((snap, eng._kv_leaves(), launched))
    (sk, kvk, lk), (sr, kvr, lr) = runs
    assert CS._snaps_equal(sk, sr)
    assert lk["flash_attention"] > 0 and lk["decode_attention"] > 0
    assert not any(lr.values())
    for n in ("k", "v"):
        torch.testing.assert_close(kvk[n], kvr[n], atol=2e-2, rtol=2e-2)


def test_chip_smoke_leaves_no_pallas_kernel_unported():
    """Every function of the reference that reaches ``pl.pallas_call``
    has its row; none is still to port."""
    assert not CS.TO_PORT
    assert len(CS.KERNELS) == 7


@pytest.mark.cuda
def test_rg_lru_kernel_bitwise_on_card(cuda_device):
    assert CS.phase_rg_lru(cuda_device)["max_abs_err"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("vec", [4, 1])
def test_rg_lru_each_copy_instance_bitwise_on_card(cuda_device, vec):
    """Each copy instance asked for by name: every chip_smoke case it
    takes (the 16-byte one needs W % 4 == 0), the 4-byte one also on views
    that start off 16 bytes; torch.equal to the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(vec)
    cases = [c + (0,) for c in CS.RG_LRU_CASES if vec == 1 or c[2] % 4 == 0]
    if vec == 1:
        cases += [(2, 65, 2560, 0.9, 0.999, 1), (1, 100, 36, 0.8, 0.999, 3)]
    for b, s, w, lo, hi, offset in cases:
        args = CS._rg_lru_case(gen, cuda_device, b, s, w, lo, hi, offset)
        plan = RGLRU.plan_rg_lru(b, s, w, RGLRU.aligned16(*args[:2]),
                                 vec=vec)
        out = RGLRU.rg_lru_cuda(*args, plan=plan)
        assert torch.equal(out, RGLRU._ref.rg_lru_ref(*args)), (b, s, w)


@pytest.mark.cuda
def test_rg_lru_refuses_what_the_kernel_does_not_take(cuda_device):
    """Non-float32 or non-contiguous inputs raise before the launch; a plan
    outside the C entry's bounds, or the 16-byte instance on a view off 16
    bytes, raises from the launch; none counts as a launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a, x, h0 = CS._rg_lru_case(gen, cuda_device, 2, 8, 36, 0.8, 0.999)
    before = RGLRU.RG_LRU.launches
    with pytest.raises(ValueError, match="contiguous"):
        RGLRU.rg_lru_cuda(a.double(), x, h0)
    with pytest.raises(ValueError, match="contiguous"):
        RGLRU.rg_lru_cuda(a.transpose(1, 2).contiguous().transpose(1, 2),
                          x, h0)
    with pytest.raises(RuntimeError, match="launch failed"):
        RGLRU.rg_lru_cuda(a, x, h0,
                          plan=RGLRU.RgLruPlan(4, 32, 12, 4, 12288, 4))
    va, vx, _ = CS._rg_lru_case(gen, cuda_device, 2, 8, 36, 0.8, 0.999, 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        RGLRU.rg_lru_cuda(va, vx, h0,
                          plan=RGLRU.plan_rg_lru(2, 8, 36, True, vec=4))
    assert RGLRU.RG_LRU.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dk", [192, 256])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1024])
def test_mlstm_chunk_edges_on_card(cuda_device, s, dk, dtype):
    """One position, a chunk less one, one chunk, one more, the prefill's
    16 chunks; from a nonzero state and from the empty one: outputs and
    the final state within 5e-4 / 5e-3 of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + dk)
    for with_state in (True, False):
        args, state = CS._mlstm_inputs(gen, cuda_device, 1, s, 2, dk, 384,
                                       dtype, with_state)
        out, st = MLSTM.mlstm_cuda(*args, state)
        p_out, p_st = MLSTM._ref.mlstm_chunkwise_ref(*args, state)
        for a, ref in zip((out,) + st, (p_out,) + p_st):
            assert bool(torch.isfinite(a).all())
            torch.testing.assert_close(a, ref, atol=5e-4, rtol=5e-3)


@pytest.mark.cuda
def test_mlstm_kernel_matches_plain_on_card(cuda_device):
    """Outputs and final state within 5e-4 / 5e-3 (checked inside)."""
    assert CS.phase_mlstm(cuda_device)["max_abs_err"] < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_kernels_at_head_dim_256_on_card(cuda_device, dtype):
    """RecurrentGemma's local attention: MQA with G 10, D 256, windowed
    prefill and decode over a ring of 2048 (as one page and as pages)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for s, window in ((1, 2048), (37, 16), (300, 64), (700, 256)):
        q = CS._randn((2, s, 10, 256), dtype, gen, cuda_device)
        k = CS._randn((2, s, 1, 256), dtype, gen, cuda_device)
        v = CS._randn((2, s, 1, 256), dtype, gen, cuda_device)
        out = FLASH.flash_attention_cuda(q, k, v, window=window)
        plain = FLASH._ref.flash_attention_ref(q, k, v, window=window)
        CS._close(out, plain, dtype, f"flash D=256 S={s}")
    hyb = CS._decode_attention_hybrid(gen, cuda_device)
    assert hyb["max_abs_err"] <= CS.TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_125m"])
def test_recurrent_models_kernels_match_plain_on_card(cuda_device, arch):
    """Three layers at full width in float32: prefill of 300 tokens (the
    hybrid's ring of 256 wraps) and 4 decode steps through the kernels and
    through their plain versions, logits within the family's
    SERVE_F32_TOL."""
    import dataclasses
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(CS.get_config(arch), num_layers=3,
                              dtype="float32")
    kern = build_model(cfg, cuda_device, backend="cuda")
    state = kern.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    plain = build_model(cfg, cuda_device, backend="ref")
    plain.load_params(state)
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), dtype=torch.int32,
                            device=cuda_device)
    ko, toks, _, _, _ = CS._generate(kern, prompts, 256, 4)
    po, _, _, _, _ = CS._generate(plain, prompts, 256, 4, forced=toks)
    tol = CS.SERVE_F32_TOL[cfg.family]
    for a, b in zip(ko, po):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", [("h2o_danube_1_8b", 256),
                                         ("granite_3_8b", None),
                                         ("olmoe_1b_7b", None)])
def test_dense_and_moe_models_kernels_match_plain_on_card(cuda_device, arch,
                                                          window):
    """Three layers at full width in float32: prefill of 300 tokens and 4
    decode steps through the kernels and through their plain versions.
    Danube's window is cut to 256, so its ring (the window) wraps in
    prefill and in decode; the full-attention models get a ring of 304,
    which holds every position. Logits within the family's SERVE_F32_TOL
    (chip_smoke.py's ``_compare``); for OLMoE every routing flip between
    the two runs is a near-tie (``_flips``: gap under FLIP_GAP)."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(CS.get_config(arch), num_layers=3,
                              dtype="float32")
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    kern = build_model(cfg, cuda_device, backend="cuda")
    state = kern.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    plain = build_model(cfg, cuda_device, backend="ref")
    plain.load_params(state)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen,
                            dtype=torch.int32, device=cuda_device)
    with CS._Routing() as rk:
        ko, toks, _, _, _ = CS._generate(kern, prompts, 304, 4)
    with CS._Routing() as rp:
        po, _, _, _, _ = CS._generate(plain, prompts, 304, 4, forced=toks)
    ring = kern.init_cache(2, ShapeConfig("serve", 304, 2, "decode"))
    assert ring["kv_pos"].shape[1] == (window or 304)
    if cfg.family == "moe":
        CS._flips(cfg, cfg.num_layers, rk.calls, rp.calls)
    CS._compare(cfg, ko, po, CS.SERVE_F32_TOL[cfg.family])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers,every", [("whisper_tiny", 2, 0),
                                               ("llama_3_2_vision_11b", 4, 2)])
def test_encdec_and_vlm_models_kernels_match_plain_on_card(cuda_device, arch,
                                                           layers, every):
    """Full width in float32, the depth cut (Whisper: 2 decoder and 2
    encoder layers over its 1500 frames; the VLM: ("self", "cross") x 2
    over 6400 image tokens, a cross layer every 2nd so that 4 layers hold
    two), the gates and biases drawn non-zero
    (``liven``): prefill of 300 tokens and 4 decode steps through the
    kernels and through their plain versions. Logits, ``enc_out`` and the
    cross caches within the family's SERVE_F32_TOL, ``len`` / ``kv_pos``
    equal (``_compare``, ``_compare_caches``); the attention kernels
    launched as ``attention_launches`` says."""
    import dataclasses
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(CS.get_config(arch), num_layers=layers,
                              dtype="float32")
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, num_encoder_layers=layers)
    else:
        cfg = dataclasses.replace(cfg, cross_attn_every=every)
    kern = build_model(cfg, cuda_device, backend="cuda")
    state = kern.init_params(torch.Generator(device=cuda_device).manual_seed(0))
    drawn = CS.liven(state)
    assert drawn["gates"] + drawn["biases"] > 0
    plain = build_model(cfg, cuda_device, backend="ref")
    plain.load_params(state)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen,
                            dtype=torch.int32, device=cuda_device)
    extra = CS.memory_inputs(cfg, 2, cuda_device)
    before = CS.launches_of(CS.RECURRENT_KERNELS)
    ko, toks, _, _, kcache = CS._generate(kern, prompts, 304, 4, extra=extra)
    launched = {k: n - before[k]
                for k, n in CS.launches_of(CS.RECURRENT_KERNELS).items()}
    po, _, _, _, pcache = CS._generate(plain, prompts, 304, 4, forced=toks,
                                       extra=extra)
    assert launched == {"rg_lru": 0, "mlstm": 0,
                        **CS.attention_launches(cfg, 4)}
    tol = CS.SERVE_F32_TOL[cfg.family]
    CS._compare(cfg, ko, po, tol)
    CS._compare_caches(cfg, kcache, pcache, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,skv,h,hkv,d,dtype", CS.FLASH_CROSS)
def test_flash_attention_cross_on_card(cuda_device, b, s, skv, h, hkv, d,
                                       dtype):
    """The flash kernel without a mask over keys of their own length
    (Whisper's encoder and cross-attention, the VLM's cross-attention,
    and S / Skv off every tile), q and v at ``AMP``: within TOL (atol +
    rtol |plain|) of the plain version, whose outputs have an rms of at
    least MIN_RMS."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    case = CS.flash_cross(gen, cuda_device, b, s, skv, h, hkv, d, dtype)
    assert case["tol_share"] <= 1.0
    assert case["rms_plain"] >= CS.MIN_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hkv,g,d,page,p", [(4, 8, 2, 128, 16, 28),
                                              (2, 1, 10, 256, 2048, 1),
                                              (2, 1, 10, 256, 16, 128),
                                              (3, 2, 16, 64, 4, 40)]
                         + CS.DECODE_SERVE)
def test_decode_attention_split_edges_on_card(cuda_device, dtype, b, hkv, g,
                                              d, page, p):
    """The split-KV kernel at lengths on its own splits' edges, 0 beside a
    full row, and holes among many short splits (chip_smoke.py's
    ``decode_edges``, q and v at ``AMP``), at the serve paths' shapes
    too: within TOL, every live row's plain output of rms MIN_RMS or more."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    case = CS.decode_edges(gen, cuda_device, b, hkv, g, d, page, p, dtype)
    assert case["tol_share"] <= 1.0
    assert case["min_rms_plain"] >= CS.MIN_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 6, 8, 10, 16])
def test_flash_attention_bf16_groups_on_card(cuda_device, g):
    """The tensor-core kernel with G query heads folded into its rows: S
    off the tile of 64, windows shorter than a key tile, D 32 to 256
    (80: Danube's)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for s, d, window, causal in ((100, 256, 16, True), (77, 128, None, True),
                                 (130, 64, 8, True), (333, 256, 100, True),
                                 (45, 32, None, False), (333, 80, 100, True),
                                 (200, 80, None, True)):
        q = CS._randn((2, s, 2 * g, d), torch.bfloat16, gen, cuda_device)
        k = CS._randn((2, s, 2, d), torch.bfloat16, gen, cuda_device)
        v = CS._randn((2, s, 2, d), torch.bfloat16, gen, cuda_device)
        out = FLASH.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
        plain = FLASH._ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
        CS._close(out, plain, torch.bfloat16,
                  f"flash G={g} S={s} D={d} window={window}")


@pytest.mark.cuda
@pytest.mark.parametrize("w,i,l", [(1, 8, 16), (48, 1, 16), (64, 8, 1)])
def test_event_loop_kernel_bitwise_on_card(cuda_device, w, i, l):
    """All four instances against the plain loop on the card, the fig7
    policies plus the stale and oracle rungs, a per-instruction gap."""
    both = [(None, None), (False, False), (True, False), (False, True)]
    CS._event_both(CS.event_case(w, i, l), CS.EVENT_POLICIES, w, l,
                   SimParams(), f"W{w} I{i} L{l}", both)


@pytest.mark.cuda
def test_event_engine_is_one_launch_per_sweep_on_card(cuda_device):
    tr = WL.generate(WL.WORKLOADS["BFS"], 0)
    before = EVL.EVENT_LOOP.launches
    out = simulate_sweep(tr["lines"][:4], tr["pcs"][:4], tr["compute_gap"],
                         (BL.BASELINE, BL.MEDIC), n_warps=48, lanes=16,
                         prm=SimParams())
    assert EVL.EVENT_LOOP.launches == before + 1
    assert out["ipc"].device.type == "cuda" and out["ipc"].shape == (2,)


# ---- the CUDA sampler (csrc/tracegen.cu) against the numpy sampler -------

def _tracegen_bitwise(spec, seeds, dev):
    """The kernel's outputs against the numpy sampler's, bitwise, from one
    launch; the counter takes the cells as the device's."""
    import numpy as np
    host = _sample_cells(spec, seeds)
    launches, cells = KTG.TRACEGEN.launches, dict(TG.CELLS)
    got = KTG.sample_cells(spec, seeds, dev)
    torch.cuda.synchronize()
    assert KTG.TRACEGEN.launches == launches + 1
    assert TG.CELLS == {"device": cells["device"] + host["lines"].size,
                        "host": cells["host"]}
    assert set(got) == set(host)
    for k, v in host.items():
        g = got[k].cpu().numpy() if k in KTG.DEVICE_KEYS else got[k]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=f"{spec.name}: {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", WL.WORKLOAD_NAMES)
def test_tracegen_kernel_paper_workloads_bitwise_on_card(cuda_device, name):
    _tracegen_bitwise(TG.TraceSpec.from_workload(WL.WORKLOADS[name]),
                      (0, 2**31 + 11), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TG.STRESS_SPECS))
def test_tracegen_kernel_stress_specs_bitwise_on_card(cuda_device, name):
    """The 1k-4k-warp matrix; PHASE2K holds the legacy flip."""
    _tracegen_bitwise(TG.STRESS_SPECS[name], (3,), cuda_device)


@pytest.mark.cuda
def test_tracegen_kernel_hammer16k_bitwise_on_card(cuda_device):
    _tracegen_bitwise(TG.SHARD_STRESS_SPECS["HAMMER16K"], (2**31 + 99,),
                      cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TG.PHASED_SPECS)
                         + list(TG.PHASED_RECOVER_SPECS))
def test_tracegen_kernel_phased_specs_bitwise_on_card(cuda_device, name):
    """Scheduled phases with churn re-keying, in both drift directions."""
    table = {**TG.PHASED_SPECS, **TG.PHASED_RECOVER_SPECS}
    _tracegen_bitwise(table[name], (0, 5), cuda_device)


@pytest.mark.cuda
def test_tracegen_kernel_warp_override_bitwise_on_card(cuda_device):
    from repro_torch.api.scenario import Scenario
    for sc in (Scenario.workload("BFS", n_warps=200),
               Scenario.phased("PHASED_RECOVER48", n_warps=97)):
        _tracegen_bitwise(sc.trace_spec, (1, 2**33 + 3), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["event", "wavefront"])
def test_experiment_device_traces_match_host_traces_on_card(cuda_device,
                                                            engine):
    """The same experiment with its traces drawn on the card and drawn by
    the numpy sampler (the backend forced to ``"ref"``): every output and
    every kept trace bitwise, each path shown by the counter. Fig 7 on the
    event engine; a stress spec on the wavefront engine."""
    import functools
    from unittest import mock

    import numpy as np
    from repro_torch.api import registry as REG
    from repro_torch.api import scenario as SCN
    exp = (REG.paper_fig7(seeds=(7, 2**31 + 1)) if engine == "event"
           else REG.stress(("HAMMER2K",), seeds=(7,)))
    cells = sum(s.n_seeds * int(np.prod(s.shape)) for s in exp.scenarios)
    runs = []
    for backend in ("auto", "ref"):
        before = dict(TG.CELLS)
        with mock.patch.object(SCN.KTG, "sample_cells", functools.partial(
                KTG.sample_cells, backend=backend)):
            rs = exp.run(keep_traces=True)
        moved = {k: TG.CELLS[k] - before[k] for k in before}
        runs.append((rs, moved))
    (dev, moved_dev), (host, moved_host) = runs
    assert moved_dev == {"device": cells, "host": 0}
    assert moved_host == {"device": 0, "host": cells}
    for blk_d, blk_h in zip(dev._blocks, host._blocks):
        assert blk_d.entries == blk_h.entries
        for k, v in blk_h.metrics.items():
            np.testing.assert_array_equal(blk_d.metrics[k], v, err_msg=k)
        for td, th in zip(blk_d.traces, blk_h.traces):
            for k, v in th.items():
                assert isinstance(td[k], (np.ndarray, np.generic)), k
                assert td[k].dtype == v.dtype
                assert np.shape(td[k]) == np.shape(v)
                np.testing.assert_array_equal(td[k], v, err_msg=k)
