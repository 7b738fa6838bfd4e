"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. It is
compiled at first use with ``nvcc`` for Hopper (``sm_90a``, ``-O3``,
``--fmad=false``, no fast math) into ``build/repro_torch_kernels/`` at
the repository root, named by the hash of its source, and loaded with
``ctypes``. ``build_all`` starts one ``nvcc`` per source at once.

Each ``Kernel`` keeps ``launches``, the number of launches its wrapper
made: the wrapper adds one after each successful launch and nowhere
else, so a run can show that it went through the kernel. No kernel has a
backward: the wrappers that take model activations refuse an input that
requires grad (``refuse_grad``).

On ``meta`` tensors (the dry run, ``repro_torch.launch.dryrun``) the
model's kernels take their card route without a card: ``meta_launch``
returns the kernel's outputs as shapes and hands the launch, with the
products it computes, to the counters in ``META_SINKS``, which take it
as one operation, as a custom call is one instruction of XLA's program.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

BACKENDS = ("auto", "ref", "cuda")

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def build_all(names: Sequence[str]) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes at once. Returns ``{name: {"seconds", "log"}}`` (the log
    holds ptxas' register and shared-memory report)."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names if not lib_path(n).exists()}
    report = {n: {"seconds": 0.0, "log": "cached"} for n in names}
    failed = []
    for n, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]


class Kernel:
    """One C entry point ``<name>_launch`` of ``csrc/<name>.cu``, bound at
    first call. Every entry point returns the ``cudaError_t`` of its
    launch; the source also exports ``<name>_error_string``."""

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = load(self.name)
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{self._err(rc).decode()} (cudaError {rc})")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, for a ``c_void_p`` argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> int:
    """Handle of the current CUDA stream of the tensor's device, for a
    ``c_void_p`` argument: read through PyTorch's raw-stream accessor,
    which builds no ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def resolve_backend(kind: str, backend: str, device) -> str:
    """A ``{kind}_backend`` gate: ``"auto"`` -> ``"cuda"`` for CUDA tensors,
    ``"ref"`` for CPU ones; ``"cuda"`` on a CPU tensor raises."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown {kind} backend {backend!r}; choose from {BACKENDS}")
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "cuda" if on_cuda else "ref"
    if backend == "cuda" and not on_cuda:
        raise ValueError(f"{kind}_backend='cuda' needs CUDA tensors; the "
                         "CUDA kernel has no CPU form (use 'ref' or 'auto')")
    return backend


#: callables ``(name, inputs, outputs, flops)`` that count the launches
#: made on meta tensors (``launch.hlo_analysis.OpCounter`` while active)
META_SINKS: list = []


def on_meta(backend: str, device) -> bool:
    """Whether a wrapper called with ``backend`` on ``device`` takes the
    card's route on meta tensors: ``"auto"`` on the meta device."""
    return backend == "auto" and torch.device(device).type == "meta"


def meta_launch(name: str, inputs, outputs, flops: float):
    """The card's launch of kernel ``name`` on meta tensors: ``outputs``
    (meta tensors of the kernel's shapes) are returned as they are, and
    every sink of ``META_SINKS`` is told of the launch: its ``inputs``
    read once, its ``outputs`` written once and its ``flops`` of matrix
    products. Nothing is computed and no launch is counted."""
    for sink in META_SINKS:
        sink(name, inputs, outputs, flops)
    return outputs


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: the
    Hopper kernels write their outputs through raw pointers and have no
    backward, so their outputs carry no ``grad_fn`` and a training step
    through one would silently leave its inputs' producers without a
    gradient. Training runs the plain versions under autograd."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the Hopper kernel has no backward; an input "
            "requires grad (train through the plain version, "
            "backend='ref')")


def check_tensor(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel's wrapper checks before passing pointers."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")
