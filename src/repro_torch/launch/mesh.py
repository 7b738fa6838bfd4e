"""Mesh construction over torch devices (the port of
``repro.launch.mesh``).

Functions, not module constants, so importing this module touches no
device. A mesh of distinct cards never holds fewer cards than asked for:
where the machine has too few, construction raises. A mesh that repeats
one device (``device=``) stands in for the reference's virtual host
devices: the CPU in the tests, one card on a one-card machine.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.sharding import Mesh


def _cards(shape: Sequence[int], names: Sequence[str], what: str) -> Mesh:
    """A mesh of ``shape`` over the distinct cards ``cuda:0..n-1``."""
    resolve_device("cuda")        # raises without a card
    n = int(np.prod(shape))
    avail = torch.cuda.device_count()
    if n > avail:
        raise ValueError(
            f"{what} needs {n} device(s) but only {avail} are available; "
            "lower the mesh, or build one that repeats a device "
            f"(make_local_mesh(..., device='cpu') gives {n} entries of the "
            "CPU)")
    devs = [torch.device("cuda", i) for i in range(n)]
    return Mesh(np.array(devs, dtype=object).reshape(tuple(shape)), names)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: Optional[object] = None) -> Mesh:
    """A ``(data, model)`` mesh with axes ``("data", "model")``.

    ``device=None`` takes the distinct cards ``cuda:0`` .. ``cuda:n-1``
    (n = data·model) and raises when fewer exist, or without a card.
    ``device`` names one device that all data·model entries repeat:
    ``"cpu"`` for the CPU tests, or one card."""
    if device is None:
        return _cards((data, model), ("data", "model"),
                      f"make_local_mesh(data={data}, model={model})")
    dev = resolve_device(device)  # a card raises without one
    if dev.type == "cuda":
        index = dev.index or 0
        if index >= torch.cuda.device_count():
            raise ValueError(
                f"make_local_mesh: {dev} does not exist; "
                f"{torch.cuda.device_count()} card(s) are available")
    devs = np.array([dev] * (data * model), dtype=object)
    return Mesh(devs.reshape(data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[object] = None) -> Mesh:
    """The reference's production mesh: (16, 16) as ``("data",
    "model")``, or (2, 16, 16) as ``("pod", "data", "model")`` with
    ``multi_pod``. ``device=None`` takes distinct cards and raises on a
    machine with fewer; ``device`` names one device that every entry
    repeats: ``"meta"`` gives the dry run's 256- or 512-entry mesh, the
    counterpart of the reference's virtual host devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is None:
        return _cards(shape, axes,
                      f"make_production_mesh(multi_pod={multi_pod})")
    dev = resolve_device(device)  # a card raises without one
    devs = np.array([dev] * int(np.prod(shape)), dtype=object)
    return Mesh(devs.reshape(shape), axes)


def single_device_mesh(device: Optional[object] = None) -> Mesh:
    """A (1, 1) ``("data", "model")`` mesh of one device: ``None`` is the
    first card (raising without one)."""
    if device is None:
        return _cards((1, 1), ("data", "model"), "single_device_mesh()")
    return make_local_mesh(1, 1, device=device)
