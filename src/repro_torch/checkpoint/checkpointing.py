"""Atomic, async checkpointing with auto-resume and restore onto a device
(port of ``repro.checkpoint.checkpointing``, with its on-disk layout).

Layout:  <dir>/step_<N>/arrays.npz + manifest.json  (+ .tmp staging)

  * atomic publish: writes go to ``step_N.tmp``, the manifest is fsynced,
    and the directory is renamed only then, so a killed writer never
    corrupts the latest checkpoint;
  * async save: a background thread serializes the host snapshot that
    ``save()`` takes before it returns, so the train loop resumes at
    once and may free or replace its tensors;
  * device-agnostic restore: arrays are stored whole and placed at load
    on ``device`` (or on the template leaf's device), the counterpart of
    the reference's ``shardings``;
  * retention: the last ``keep`` checkpoints stay, older ones go.

A tree is nested dicts (and lists or tuples) of tensors, numpy arrays or
numbers; a leaf's key is its path joined by ``/`` (a sequence index as
``#i``), as the reference names it. bfloat16 is stored as a uint16 view
(npz-safe) with ``"bfloat16"`` in the manifest's dtypes, and read back
through torch's views, so the port reads the reference's checkpoints and
the reference reads the port's.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

SEP = "/"


def _items(tree, prefix=()):
    """(path, leaf) pairs in the tree's own order."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (f"#{i}",))
    else:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array that nothing else shares (bfloat16 as
    its uint16 view)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    out, dtypes = {}, {}
    for path, leaf in _items(tree):
        key = SEP.join(path)
        arr = _host(leaf)
        out[key] = arr
        dtypes[key] = _dtype_name(leaf, arr)
    return out, dtypes


def to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its recorded dtype (a bfloat16
    leaf from its uint16 view, bit for bit)."""
    arr = np.require(arr, requirements="C")     # keeps 0-d arrays 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten(template, flat: Mapping[str, np.ndarray],
               dtypes: Mapping[str, str], device, prefix=()):
    if isinstance(template, Mapping):
        return {k: _unflatten(v, flat, dtypes, device, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, flat, dtypes, device, prefix + (f"#{i}",))
            for i, v in enumerate(template))
    key = SEP.join(prefix)
    t = to_tensor(flat[key], dtypes.get(key, str(flat[key].dtype)))
    if device is not None:
        dev = device
    elif isinstance(template, torch.device):
        dev = template
    else:
        dev = template.device if torch.is_tensor(template) else "cpu"
    return t.to(dev)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False):
        """Snapshot ``tree`` to the host now and write it as ``step``
        (in the background unless ``block`` or ``async_save=False``)."""
        flat, dtypes = _flatten(tree)
        extra = dict(extra or {})
        self.wait()

        def _write():
            tmp = os.path.join(self.directory, f"step_{step}.tmp")
            final = os.path.join(self.directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "extra": extra,
                           "dtypes": dtypes, "keys": sorted(flat)}, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.async_save and not block:
            def _guarded():
                try:
                    _write()
                except BaseException as e:  # noqa: BLE001 — re-raised by wait
                    self._error = e
            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        """Join a background save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- load -----------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, step: int) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """Step ``step`` raw: every stored leaf by key as a CPU tensor of
        its recorded dtype, and the manifest."""
        path = os.path.join(self.directory, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        return ({k: to_tensor(a, dtypes.get(k, str(a.dtype)))
                 for k, a in flat.items()}, manifest)

    def restore(self, step: int, template: Any,
                device=None) -> Tuple[Any, Dict]:
        """Step ``step`` in the structure of ``template``: each leaf on
        ``device``, or where the template's leaf says (a tensor's device,
        a ``torch.device`` itself; the CPU for any other leaf). Returns
        (tree, extra)."""
        path = os.path.join(self.directory, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        tree = _unflatten(template, flat, manifest.get("dtypes", {}),
                          device)
        return tree, manifest["extra"]

    def restore_latest(self, template: Any, device=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, template, device)
        return step, tree, extra
