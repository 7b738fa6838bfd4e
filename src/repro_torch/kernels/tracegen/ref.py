"""Host side of the CUDA sampler and a numpy model of its kernel.

``cell_inputs`` lowers a spec for the kernel (``csrc/tracegen.cu``): the
per-(seed, warp, phase) rows of ``spec.lower_warps``, the seeds' stream
keys and the instruction → phase map, in the dtypes and order the kernel
reads. No working-set table is built: the kernel permutes the one index a
cell draws. ``tracegen_model`` evaluates the kernel's per-cell formula on
those same inputs, in numpy, so the CPU tests hold the inputs and the
index arithmetic against the numpy sampler; the kernel itself is held
against the sampler on the card. The kernel's plain version is the numpy
sampler, ``core/tracegen/sampler.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.core import warp_types as WT
from repro_torch.core.tracegen import rng
from repro_torch.core.tracegen.sampler import cell_keys
from repro_torch.core.tracegen.spec import (WS_REGION_BITS, TraceSpec,
                                            WarpParams, lower_warps,
                                            phase_of_instr)


class CellInputs(NamedTuple):
    """The kernel's inputs: ``dims`` (S, I, W, L, P, n_pcs, pool_n,
    fresh_base, fresh_stride, ws_region_bits), then the arrays in the
    kernel's pointer order."""
    dims: Tuple[int, ...]
    keys: np.ndarray        # u64[S, 4]: reuse, shared, pool, ws-index keys
    phase_of: np.ndarray    # i32[I]
    ws_size: np.ndarray     # i32[S, W, P]
    reuse: np.ndarray       # f64[S, W, P]
    shared: np.ndarray      # f64[S, W, P]
    ws_key: np.ndarray      # u64[S, W, P]
    otype: np.ndarray       # i32[S, W, P] ground-truth warp type
    pc_table: np.ndarray    # i32[S, W, n_pcs]
    pool: np.ndarray        # i32[S, pool_n]


def cell_inputs(spec: TraceSpec, seeds) -> Tuple[CellInputs, WarpParams]:
    """The kernel's inputs for ``spec`` × ``seeds``, and the lowered warp
    parameters they came from (for the per-warp outputs)."""
    seeds = np.atleast_1d(np.asarray(seeds, np.int64))
    layout, wp = lower_warps(spec, seeds)
    dims = (len(seeds), spec.n_instr, spec.n_warps, spec.lines_per_instr,
            wp.n_phases, spec.n_pcs, spec.shared_pool_lines,
            layout.fresh_base, layout.fresh_stride, WS_REGION_BITS)

    def c(x, dtype):
        return np.ascontiguousarray(x, dtype)
    ins = CellInputs(
        dims=tuple(int(d) for d in dims),
        keys=c(cell_keys(spec, seeds), np.uint64),
        phase_of=c(phase_of_instr(spec), np.int32),
        ws_size=c(wp.ws_size, np.int32), reuse=c(wp.reuse, np.float64),
        shared=c(wp.shared, np.float64), ws_key=c(wp.ws_key, np.uint64),
        otype=c(WT.oracle_type_np(wp.reuse, wp.ws_size), np.int32),
        pc_table=c(wp.pc_table, np.int32), pool=c(wp.pool, np.int32))
    return ins, wp


def tracegen_model(ins: CellInputs):
    """The kernel's formula over every cell, in numpy: ``(lines i32[S, I,
    W, L], pcs i32[S, I, W], oracle i32[S, I, W])`` from the flat cell
    index alone, as the kernel's threads compute them."""
    s_n, i_n, w_n, l_n, p_n, n_pcs, pool_n, base, stride, ws_bits = ins.dims
    per_seed = i_n * w_n * l_n
    c = np.arange(s_n * per_seed, dtype=np.int64)
    s = c // per_seed
    f = c - s * per_seed
    row = f // l_n
    lane = f - row * l_n
    i = row // w_n
    w = row - i * w_n
    swp = (s * w_n + w) * p_n + ins.phase_of[i]
    k = ins.keys[s]
    fu = f.astype(np.uint64)
    ws = ins.ws_size.reshape(-1)[swp]
    sh = ins.shared.reshape(-1)[swp]
    reuse_hit = (ws > 0) & (rng.uniform(k[:, 0], fu)
                            < ins.reuse.reshape(-1)[swp])
    use_pool = reuse_hit & (sh > 0) & (rng.uniform(k[:, 1], fu) < sh)
    pool_j = (rng.bits(k[:, 2], fu) % np.uint64(pool_n)).astype(np.int64)
    ws_j = rng.bits(k[:, 3], fu) % np.maximum(ws, 1).astype(np.uint64)
    lines = np.where(
        use_pool, ins.pool.reshape(-1)[s * pool_n + pool_j],
        np.where(reuse_hit,
                 ((w + 1) << ws_bits)
                 + rng.perm12(ws_j, ins.ws_key.reshape(-1)[swp]),
                 base + w * stride + i * l_n + lane))
    first = lane == 0
    s0, w0, i0, swp0 = s[first], w[first], i[first], swp[first]
    pcs = ins.pc_table.reshape(-1)[(s0 * w_n + w0) * n_pcs + i0 % n_pcs]
    oracle = ins.otype.reshape(-1)[swp0]
    return (lines.astype(np.int32).reshape(s_n, i_n, w_n, l_n),
            pcs.astype(np.int32).reshape(s_n, i_n, w_n),
            oracle.astype(np.int32).reshape(s_n, i_n, w_n))
