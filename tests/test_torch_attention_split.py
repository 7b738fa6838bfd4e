"""The numerics of the two redesigned attention kernels, on the CPU.

The Hopper kernels run only on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``). What they do differently from the plain versions is
held here against the JAX reference:

* ``plan_splits``: the split of each sequence's positions over blocks
  covers ``[0, length)`` exactly once, whatever the table and the length.
* ``paged_decode_attention_split_model``: the decode kernel's splits,
  chunks and combine in plain PyTorch, within the reference's ``TOL`` of
  ``repro.kernels.decode_attention.ref`` (exact zeros where nothing is
  live).
* ``flash_attention_tc_model``: the bf16 flash kernel's rounding (bf16
  products summed in float32, P rounded to bf16 before P.V), within the
  bf16 ``TOL`` of ``repro.kernels.flash_attention.ref``.
"""
import re

import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import paged_decode_attention_ref as j_decode_ref
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as DEC
from repro_torch.kernels.decode_attention import ref as DREF
from repro_torch.kernels.flash_attention import ref as FREF
from test_torch_attention import (DECODE_EXTRA, DECODE_GRID, DTYPES,  # noqa: E402
                                  FLASH_EXTRA, FLASH_GRID, _close,
                                  _decode_inputs, _randn)

#: H100's SMs, which the wrapper reads from the card
N_SM = 132


# ---------------------------------------------------------------------------
# plan_splits
# ---------------------------------------------------------------------------

#: (B, Hkv, page, P, lengths): the hybrid's ring as one page and as pages,
#: Qwen3's serving table, tables shorter than a chunk, a batch wide enough
#: for one split, lengths at 0, at split edges and at the table's end
PLAN_GRID = [
    (2, 1, 2048, 1, [0, 1, 15, 16, 17, 2047, 2048]),
    (2, 1, 16, 128, [0, 1, 16, 1500, 2048]),
    (4, 8, 16, 28, [0, 1, 55, 56, 57, 112, 447, 448]),
    (3, 2, 8, 4, [0, 5, 31, 32]),
    (1, 1, 4, 3, [0, 7, 12]),
    (1, 1, 5, 1, [0, 3, 5]),
    (1, 1, 16, 1, [0, 16]),
    (64, 8, 16, 28, [0, 300, 448]),
    (1, 4, 32, 8, [0, 255, 256]),
    (1, 1, 4096, 4, [0, 8191, 16384]),
]


@pytest.mark.parametrize("n_sm", [N_SM, 114, 1])
@pytest.mark.parametrize("b,hkv,page,p,lengths", PLAN_GRID)
def test_plan_splits_cover_every_position_once(b, hkv, page, p, lengths,
                                               n_sm):
    cap = page * p
    plan = DEC.plan_splits(b, hkv, page, p, n_sm)
    assert 1 <= plan.n_split <= DEC.MAX_SPLITS
    assert plan.n_split * plan.split_len >= cap          # the table is covered
    assert (plan.n_split - 1) * plan.split_len < cap     # no split past it
    assert plan.split_len >= min(DEC.CHUNK, cap)         # none under a chunk
    assert b * hkv * plan.n_split <= max(2 * n_sm, b * hkv)
    for n in lengths:
        ranges = plan.ranges(n, cap)
        assert len(ranges) == plan.n_split
        covered = [t for lo, hi in ranges for t in range(lo, hi)]
        assert covered == list(range(min(n, cap)))
        for s, (lo, hi) in enumerate(ranges):            # each in its slot
            assert lo <= hi
            if lo < hi:
                assert s * plan.split_len == lo
                assert hi <= (s + 1) * plan.split_len


def test_plan_splits_at_the_paths_shapes():
    """128 splits of 16 for the hybrid's ring of 2048 (B 2, Hkv 1), 8 of 56
    for Qwen3's 28 pages of 16 (B 4, Hkv 8), on H100's 132 SMs."""
    assert DEC.plan_splits(2, 1, 2048, 1, N_SM) == (128, 16)
    assert DEC.plan_splits(2, 1, 16, 128, N_SM) == (128, 16)
    assert DEC.plan_splits(4, 8, 16, 28, N_SM) == (8, 56)


def test_split_constants_match_the_kernel_sources():
    dec = (_build.CSRC / "decode_attention.cu").read_text()
    assert re.search(rf"constexpr int TC = {DEC.CHUNK};", dec)
    assert re.search(rf"constexpr int MAX_SPLITS = {DEC.MAX_SPLITS};", dec)
    flash = (_build.CSRC / "flash_attention.cu").read_text()
    inst = re.findall(r"launch_tc_d<(\d+), (\d+), (\d+)>\(sh", flash)
    assert sorted(int(dp) for dp, _, _ in inst) == [64, 128, 256]
    block_k = FREF.flash_attention_tc_model.__kwdefaults__["block_k"]
    assert {int(bk) for _, bk, _ in inst} == {block_k}


# ---------------------------------------------------------------------------
# the decode kernel's split-then-combine
# ---------------------------------------------------------------------------

def _split_model(targs):
    q, kp, _, tbl, _ = targs
    plan = DEC.plan_splits(q.shape[0], q.shape[1], kp.shape[1],
                           tbl.shape[1], N_SM)
    return DREF.paged_decode_attention_split_model(*targs, *plan,
                                                   chunk=DEC.CHUNK)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hkv,g,d,npages,page,p", DECODE_GRID)
def test_split_model_matches_reference_on_the_grid(b, hkv, g, d, npages,
                                                   page, p, dtype):
    rng = np.random.default_rng(b * 10 + d)
    tbl = rng.permutation(npages)[: b * p].reshape(b, p)
    tbl[0, -1] = -1
    lens = np.minimum(rng.integers(1, p * page, b), p * page)
    jargs, targs = _decode_inputs(rng, b, hkv, g, d, npages, page, p, dtype,
                                  tbl, lens)
    o = _split_model(targs)
    assert o.dtype == targs[0].dtype and o.shape == targs[0].shape
    _close(o, j_decode_ref(*jargs), dtype)


def _hybrid_holes():
    rng = np.random.default_rng(7)
    tbl = rng.permutation(256).reshape(2, 128)
    tbl[0, [3, 40, 41]] = -1
    return tbl


#: the decode kernel's own edges: lengths at split boundaries (Qwen3's
#: splits of 56), the hybrid's ring as one page (128 splits of 16) and as
#: pages with holes, many short splits with holes, length 0 next to a
#: full row, a row all holes beside a full one
SPLIT_EDGES = {
    "split_boundaries": (4, 8, 2, 128, 112, 16, 28,
                         np.arange(112).reshape(4, 28), [1, 55, 56, 57]),
    "split_full_and_zero": (4, 8, 2, 128, 112, 16, 28,
                            np.arange(112).reshape(4, 28), [448, 0, 447, 113]),
    "hybrid_ring": (2, 1, 10, 256, 2, 2048, 1, [[1], [0]], [2048, 1]),
    "hybrid_ring_edges": (2, 1, 10, 256, 2, 2048, 1, [[0], [1]], [15, 17]),
    "hybrid_pages_holes": (2, 1, 10, 256, 256, 16, 128, _hybrid_holes(),
                           [2048, 1500]),
    "many_splits_holes": (1, 1, 4, 32, 64, 4, 64,
                          np.where(np.arange(64) % 5 == 2, -1,
                                   np.arange(64)[::-1])[None], [250]),
    "zero_next_to_full": (2, 2, 4, 64, 8, 16, 4,
                          [[0, 1, 2, 3], [4, 5, 6, 7]], [0, 64]),
    "hole_row_next_to_full": (2, 1, 16, 16, 8, 8, 4,
                              [[-1, -1, -1, -1], [4, 5, 6, 7]], [32, 32]),
}
SPLIT_CASES = {**DECODE_EXTRA, **SPLIT_EDGES}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_model_matches_reference_on_the_edges(case, dtype):
    b, hkv, g, d, npages, page, p, tbl, lens = SPLIT_CASES[case]
    rng = np.random.default_rng(len(case))
    jargs, targs = _decode_inputs(rng, b, hkv, g, d, npages, page, p, dtype,
                                  tbl, lens)
    o = _split_model(targs)
    _close(o, j_decode_ref(*jargs), dtype)
    dead = [i for i in range(b)
            if lens[i] == 0 or all(t < 0 for t in np.asarray(tbl)[i])]
    for i in dead:   # nothing to attend to gives exact zeros
        assert torch.count_nonzero(o[i]) == 0


# ---------------------------------------------------------------------------
# the bf16 flash kernel's rounding
# ---------------------------------------------------------------------------

#: the hybrid's local attention at a CPU size (G 10 on one KV head, D 256,
#: windows of 64 and shorter than a tile), S off the tile of 64, and the
#: group sizes the kernel folds into its rows: 1, 2, 10, 16
FLASH_TC_EXTRA = [
    (1, 300, 10, 1, 256, 64, True),
    (2, 100, 10, 1, 256, 16, True),
    (1, 77, 16, 1, 64, None, True),
    (1, 130, 2, 1, 128, None, True),
    (1, 70, 1, 1, 32, 8, True),
    (1, 65, 16, 8, 128, None, True),
    (2, 33, 10, 1, 256, None, False),
]


def _flash_case(b, s, h, hkv, d, window, causal, seed):
    rng = np.random.default_rng(seed)
    (qj, qt), (kj, kt), (vj, vt) = (_randn(rng, (b, s, h, d), "bfloat16"),
                                    _randn(rng, (b, s, hkv, d), "bfloat16"),
                                    _randn(rng, (b, s, hkv, d), "bfloat16"))
    o = FREF.flash_attention_tc_model(qt, kt, vt, causal=causal,
                                      window=window)
    assert o.dtype == torch.bfloat16 and o.shape == qt.shape
    _close(o, j_flash_ref(qj, kj, vj, causal=causal, window=window),
           "bfloat16")


@pytest.mark.parametrize("b,s,h,hkv,d,window", FLASH_GRID)
def test_tc_model_matches_reference_on_the_grid(b, s, h, hkv, d, window):
    _flash_case(b, s, h, hkv, d, window, True, s + h + d)


@pytest.mark.parametrize("b,s,h,hkv,d,window,causal",
                         FLASH_EXTRA + FLASH_TC_EXTRA)
def test_tc_model_matches_reference_ragged_windowed_grouped(b, s, h, hkv, d,
                                                            window, causal):
    _flash_case(b, s, h, hkv, d, window, causal, 3 * s + d)
