"""The plain versions of the three serving-path kernels against the JAX
reference: each against the reference's ``ref.py`` and its Pallas kernel
in interpret mode, on ``tests/test_kernels.py``'s grids, plus the cases the
serving path adds (ragged S, windows, all-hole rows, lengths ending inside
a page). Tolerance is the reference's own ``TOL`` (3e-5 in float32, 4e-2
in bfloat16); the gather is bitwise. On the CPU the gated wrappers run the
plain versions; the kernels are held to them on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import paged_decode_attention as j_decode
from repro.kernels.decode_attention.ref import paged_decode_attention_ref as j_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.kernels.medic_gather.ops import medic_gather as j_gather
from repro.kernels.medic_gather.ref import medic_gather_ref as j_gather_ref

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as DEC
from repro_torch.kernels.flash_attention import ops as FLASH
from repro_torch.kernels.medic_gather import ops as GATHER

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 3e-5, "bfloat16": 4e-2}


def _randn(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# flash attention (B5)
# ---------------------------------------------------------------------------

FLASH_GRID = [  # tests/test_kernels.py:24-29
    (2, 256, 4, 2, 64, None),
    (1, 256, 4, 4, 64, 128),
    (2, 384, 6, 2, 64, None),
    (1, 512, 8, 1, 32, 256),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,h,hkv,d,window", FLASH_GRID)
def test_flash_attention_matches_reference_and_pallas(b, s, h, hkv, d, window,
                                                      dtype):
    rng = np.random.default_rng(s + h + d)
    (qj, qt), (kj, kt), (vj, vt) = (_randn(rng, (b, s, h, d), dtype),
                                    _randn(rng, (b, s, hkv, d), dtype),
                                    _randn(rng, (b, s, hkv, d), dtype))
    o = FLASH.flash_attention(qt, kt, vt, causal=True, window=window)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    _close(o, j_flash_ref(qj, kj, vj, causal=True, window=window), dtype)
    _close(o, j_flash(qj, kj, vj, causal=True, window=window,
                      interpret=True), dtype)


#: serving-path shapes and edges: ragged S (prompts of any length), the
#: Qwen3 head layout, windows, a non-causal call
FLASH_EXTRA = [
    (1, 16, 16, 8, 128, None, True),
    (1, 96, 16, 8, 128, None, True),
    (1, 100, 4, 2, 64, None, True),
    (2, 37, 4, 1, 32, 8, True),
    (1, 130, 6, 3, 16, 33, True),
    (1, 1, 4, 2, 16, None, True),
    (2, 45, 4, 2, 32, None, False),
    (1, 70, 4, 4, 32, 16, False),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,s,h,hkv,d,window,causal", FLASH_EXTRA)
def test_flash_attention_ragged_and_windowed(b, s, h, hkv, d, window, causal,
                                             dtype):
    rng = np.random.default_rng(3 * s + d)
    (qj, qt), (kj, kt), (vj, vt) = (_randn(rng, (b, s, h, d), dtype),
                                    _randn(rng, (b, s, hkv, d), dtype),
                                    _randn(rng, (b, s, hkv, d), dtype))
    o = FLASH.flash_attention(qt, kt, vt, causal=causal, window=window)
    _close(o, j_flash_ref(qj, kj, vj, causal=causal, window=window), dtype)


# ---------------------------------------------------------------------------
# paged decode attention (B4)
# ---------------------------------------------------------------------------

DECODE_GRID = [  # tests/test_kernels.py:63-67
    (3, 2, 4, 64, 16, 8, 4),
    (2, 1, 8, 32, 8, 16, 3),
    (1, 4, 1, 128, 32, 8, 8),
]


def _decode_inputs(rng, b, hkv, g, d, npages, page, p, dtype, tbl, lens):
    q = _randn(rng, (b, hkv, g, d), dtype)
    kp = _randn(rng, (npages, page, hkv, d), dtype)
    vp = _randn(rng, (npages, page, hkv, d), dtype)
    tbl = np.asarray(tbl, np.int32)
    lens = np.asarray(lens, np.int32)
    jargs = (q[0], kp[0], vp[0], jnp.asarray(tbl), jnp.asarray(lens))
    targs = (q[1], kp[1], vp[1], torch.from_numpy(tbl),
             torch.from_numpy(lens))
    return jargs, targs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hkv,g,d,npages,page,p", DECODE_GRID)
def test_paged_decode_matches_reference_and_pallas(b, hkv, g, d, npages, page,
                                                   p, dtype):
    rng = np.random.default_rng(b * 10 + d)
    tbl = rng.permutation(npages)[: b * p].reshape(b, p)
    tbl[0, -1] = -1  # a hole (non-resident block)
    lens = np.minimum(rng.integers(1, p * page, b), p * page)
    jargs, targs = _decode_inputs(rng, b, hkv, g, d, npages, page, p, dtype,
                                  tbl, lens)
    o = DEC.paged_decode_attention(*targs)
    assert o.dtype == targs[0].dtype and o.shape == targs[0].shape
    _close(o, j_decode_ref(*jargs), dtype)
    _close(o, j_decode(*jargs, interpret=True), dtype)


#: an all-hole row, lengths that end inside a page, at a page edge, zero,
#: the whole table, and the serving path's shape (4 sequences x 28 pages
#: of 16, Hkv 8, G 2, D 128)
DECODE_EXTRA = {
    "all_hole_row": (2, 2, 2, 32, 8, 4, 3, [[-1, -1, -1], [4, 5, 6]],
                     [7, 10]),
    "inside_page": (3, 1, 4, 16, 12, 4, 4,
                    [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]],
                    [5, 1, 15]),
    "page_edges": (3, 2, 2, 16, 9, 4, 3,
                   [[0, 1, 2], [3, 4, 5], [6, 7, 8]], [4, 8, 12]),
    "zero_and_holes": (2, 1, 3, 16, 6, 4, 3, [[0, -1, 2], [3, 4, -1]],
                       [0, 9]),
    "serving_path": (4, 8, 2, 128, 112, 16, 28,
                     np.arange(112).reshape(4, 28), [1, 17, 300, 448]),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(DECODE_EXTRA))
def test_paged_decode_edges(case, dtype):
    b, hkv, g, d, npages, page, p, tbl, lens = DECODE_EXTRA[case]
    rng = np.random.default_rng(len(case))
    jargs, targs = _decode_inputs(rng, b, hkv, g, d, npages, page, p, dtype,
                                  tbl, lens)
    o = DEC.paged_decode_attention(*targs)
    _close(o, j_decode_ref(*jargs), dtype)
    dead = [i for i in range(b)
            if lens[i] == 0 or all(t < 0 for t in np.asarray(tbl)[i])]
    for i in dead:   # nothing to attend to gives exact zeros
        assert torch.count_nonzero(o[i]) == 0


# ---------------------------------------------------------------------------
# pool gather (B3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_medic_gather_bitwise(dtype):
    """tests/test_kernels.py:86-94's case."""
    rng = np.random.default_rng(5)
    pj, pt = _randn(rng, (12, 8, 2, 32), dtype)
    tbl = np.asarray([[0, 5, -1], [3, -1, 11]], np.int32)
    o = GATHER.medic_gather(pt, torch.from_numpy(tbl))
    assert o.dtype == pt.dtype and o.shape == (2, 3, 8, 2, 32)
    for ref in (j_gather_ref(pj, jnp.asarray(tbl)),
                j_gather(pj, jnp.asarray(tbl), interpret=True)):
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_medic_gather_serving_offload_shape_bitwise(dtype):
    """The engine's offload read: all layers' cache [L, B, W, Kv, D] as a
    pool of blocks, one block per layer, with holes."""
    rng = np.random.default_rng(6)
    n_layers, slots, pages, page = 3, 4, 5, 4
    pj, pt = _randn(rng, (n_layers * slots * pages, page, 2, 16), dtype)
    tbl = ((np.arange(n_layers) * slots + 2) * pages + 3)[:, None]
    tbl = np.concatenate([tbl, -np.ones_like(tbl)], axis=1).astype(np.int32)
    o = GATHER.medic_gather(pt, torch.from_numpy(tbl))
    np.testing.assert_array_equal(
        o.float().numpy(),
        np.asarray(j_gather_ref(pj, jnp.asarray(tbl)), np.float32))
    cache = pt.view(n_layers, slots, pages * page, 2, 16)
    assert torch.equal(o[:, 0], cache[:, 2, 3 * page:4 * page])
    assert torch.count_nonzero(o[:, 1]) == 0


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def _tiny():
    q = torch.zeros(1, 1, 1, 16)
    pool = torch.zeros(2, 4, 1, 16)
    tbl = torch.zeros(1, 1, dtype=torch.int32)
    return q, pool, tbl, torch.ones(1, dtype=torch.int32)


@pytest.mark.parametrize("call", ["gather", "decode", "flash"])
def test_cuda_backend_refuses_cpu_tensors(call):
    q, pool, tbl, lens = _tiny()
    x = torch.zeros(1, 4, 2, 16)
    fns = {"gather": lambda be: GATHER.medic_gather(pool, tbl, backend=be),
           "decode": lambda be: DEC.paged_decode_attention(
               q, pool, pool, tbl, lens, backend=be),
           "flash": lambda be: FLASH.flash_attention(x, x, x, backend=be)}
    with pytest.raises(ValueError, match="CUDA"):
        fns[call]("cuda")
    with pytest.raises(ValueError, match="unknown"):
        fns[call]("pallas")
    ref = fns[call]("ref")
    assert torch.equal(fns[call]("auto"), ref)


@pytest.mark.parametrize("fn", [GATHER.medic_gather_cuda,
                                DEC.paged_decode_attention_cuda,
                                FLASH.flash_attention_cuda])
def test_kernel_entry_points_need_cuda_tensors(fn):
    q, pool, tbl, lens = _tiny()
    args = {GATHER.medic_gather_cuda: (pool, tbl),
            DEC.paged_decode_attention_cuda: (q, pool, pool, tbl, lens),
            FLASH.flash_attention_cuda: (pool, pool, pool)}[fn]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert _build.BACKENDS == ("auto", "ref", "cuda")
