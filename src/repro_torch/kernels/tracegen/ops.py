"""Backend-gated trace sampler: every cell of a spec's [S, I, W, L] trace.

``sample_cells`` returns ``lines`` i32[S, I, W, L], ``pcs`` and
``oracle_wtype`` i32[S, I, W] as tensors on ``device``, beside the
per-warp numpy arrays ``archetype``, ``archetype2`` and
``archetype_phases``. Backends:

  * ``"ref"``  — the numpy sampler (``core/tracegen/sampler.py``) on the
    host, its arrays then moved to ``device``.
  * ``"cuda"`` — the hand-written Hopper kernel ``csrc/tracegen.cu``: the
    host lowers the warps (``ref.cell_inputs``, O(S·W·P), no working-set
    table), one copy takes them to the card, one launch draws every cell
    in a thread of its own. It takes a CUDA device only and raises
    otherwise.
  * ``"auto"`` — the kernel for a CUDA device, the numpy sampler for the
    CPU.

The kernel is bitwise equal to the numpy sampler on every output
(tests/test_torch_kernels_cuda.py, on the card). ``CELLS`` in
``core/tracegen`` counts the cells each path sampled.
"""
from __future__ import annotations

import array
import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tracegen.sampler import (CELLS, _sample_cells,
                                               warp_outputs)
from repro_torch.core.tracegen.spec import TraceSpec
from repro_torch.kernels import _build
from repro_torch.kernels._build import Kernel, stream_of
from repro_torch.kernels.tracegen import ref as _ref

I32 = torch.int32

BACKENDS = _build.BACKENDS

#: the outputs made where the trace is sampled (the rest are per-warp
#: numpy arrays from the host's lowering)
DEVICE_KEYS = ("lines", "pcs", "oracle_wtype")

_V = ctypes.c_void_p
TRACEGEN = Kernel("tracegen", [_V, _V, _V])


def resolve_backend(backend: str, device) -> str:
    """``"auto"`` -> ``"cuda"`` for a CUDA device, ``"ref"`` for the CPU;
    ``"cuda"`` on the CPU raises."""
    return _build.resolve_backend("tracegen", backend, device)


def _pack(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, list]:
    """The arrays in one byte buffer, each at a 16-byte-aligned offset: one
    copy to the card for all of a launch's inputs."""
    offsets, at = [], 0
    for a in arrays:
        offsets.append(at)
        at += -(-a.nbytes // 16) * 16
    blob = np.zeros(at, np.uint8)
    for a, o in zip(arrays, offsets):
        blob[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    return blob, offsets


def _draw(dims: Sequence[int], buf: torch.Tensor, offsets: Sequence[int]):
    """One launch on the packed inputs ``buf`` (on the card; each input at
    its offset): ``(lines, pcs, oracle)``, fresh tensors beside it."""
    s_n, i_n, w_n, l_n = dims[:4]
    dev = buf.device
    lines = torch.empty((s_n, i_n, w_n, l_n), dtype=I32, device=dev)
    pcs = torch.empty((s_n, i_n, w_n), dtype=I32, device=dev)
    oracle = torch.empty((s_n, i_n, w_n), dtype=I32, device=dev)
    base = buf.data_ptr()
    ptrs = array.array("q", [base + o for o in offsets]
                       + [t.data_ptr() for t in (lines, pcs, oracle)])
    dims_q = array.array("q", dims)
    TRACEGEN.launch(dims_q.buffer_info()[0], ptrs.buffer_info()[0],
                    stream_of(lines))
    return lines, pcs, oracle


def sample_cells_cuda(spec: TraceSpec, seeds,
                      device) -> Dict[str, object]:
    """The Hopper kernel: every cell of ``spec`` × ``seeds`` drawn on the
    CUDA ``device``, from one copy of the inputs and one launch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("sample_cells_cuda needs a CUDA device")
    ins, wp = _ref.cell_inputs(spec, seeds)
    blob, offsets = _pack(ins[1:])
    with torch.cuda.device(dev):
        buf = torch.from_numpy(blob).to(dev, non_blocking=True)
        lines, pcs, oracle = _draw(ins.dims, buf, offsets)
    CELLS["device"] += lines.numel()
    return {"lines": lines, "pcs": pcs, "oracle_wtype": oracle,
            **warp_outputs(wp)}


def sample_cells(spec: TraceSpec, seeds, device,
                 backend: str = "auto") -> Dict[str, object]:
    """Every cell of ``spec`` × ``seeds`` under the selected backend:
    ``DEVICE_KEYS`` as tensors on ``device``, the per-warp arrays in
    numpy."""
    if resolve_backend(backend, device) == "ref":
        out = _sample_cells(spec, seeds)
        return {k: torch.from_numpy(v).to(device) if k in DEVICE_KEYS
                else v for k, v in out.items()}
    return sample_cells_cuda(spec, seeds, device)
