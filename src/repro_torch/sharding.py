"""Logical-axis sharding rules and sweep-axis placement over a mesh of
torch devices (the port of ``repro.sharding``).

The reference places arrays with JAX ``NamedSharding``s on a
``jax.sharding.Mesh`` and runs one program over it. The port keeps one
process and one caller: ``Mesh`` is an array of ``torch.device``s with
axis names, and a sharded dimension is cut into contiguous blocks, each
moved to its mesh device (``split_leading``, ``block_device``). A mesh may
repeat a device: eight entries of the CPU in the tests, or four of one
card, stand in for the reference's virtual host devices, so the split,
exchange and merge logic runs wherever the port does.

Parallelism carried by each mesh axis (the reference's rules):
  pod    -- pure data parallelism across pods
  data   -- data parallelism + FSDP (the ``embed`` logical axis)
  model  -- tensor, expert and sequence parallelism

The logical-axis half (``build_rules``, ``spec_for``, ``Logical``,
``sharding_ctx``, ``sharding_for``, ``tree_shardings``, ``tree_specs``)
is pure Python, equal to the reference's on every mesh shape;
``spec_for`` returns ``P``, a tuple that reads like JAX's
``PartitionSpec``, and ``NamedSharding`` pairs it with a mesh and gives
the shard a device holds. The models tag their activations with
``shard_act`` at the reference's points: the identity outside a context
and on a mesh of one device; on a mesh of ``meta`` devices (the dry run's
stand-in for the reference's virtual host devices) it resolves the spec
and records it (``record_constraints``). The port has no SPMD execution,
so on a mesh of real devices of more than one entry it raises.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MeshAxes = Union[None, str, Tuple[str, ...]]

# Order matters: earlier rules win a mesh axis; later rules that would reuse
# an already-taken mesh axis on the same tensor are dropped.
DEFAULT_LOGICAL_RULES: Tuple[Tuple[str, MeshAxes], ...] = (
    ("batch", ("pod", "data")),
    ("capacity", ("pod", "data")),
    ("expert", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("lru", "model"),
    ("seq_sp", "model"),      # sequence parallelism (residual stream)
    ("kv_seq", "model"),      # decode KV-cache length sharding
    ("embed", "data"),        # FSDP / ZeRO-3 on parameters
    ("embed_act", None),      # activations keep embed replicated
    ("layers", None),
    ("seq", None),
    ("head_dim", None),
    ("image", None),
    ("enc_seq", None),
)


class Mesh:
    """An n-d array of ``torch.device``s with one name per dimension.

    ``devices`` is anything numpy can shape into an object array of
    devices (strings are converted); entries may repeat, and all share
    one device type. ``shape`` maps axis name -> size in order, as a JAX
    mesh's does. Two meshes are equal (and hash equal) when their names,
    sizes and device strings are."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of {arr.ndim} dimension(s) needs as "
                             f"many axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [torch.device(d) for d in arr.flat]
        types = {d.type for d in flat}
        if len(types) != 1:
            raise ValueError(f"a mesh's devices share one type, got "
                             f"{sorted(types)}")
        self.devices = np.array(flat, dtype=object).reshape(arr.shape)
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        """Total device entries (not ``len(devices)``, which counts only
        the first dimension)."""
        return int(self.devices.size)

    def device_at(self, coords: Mapping[str, int]) -> torch.device:
        """The device at mesh coordinates ``{axis: index}``; an axis not
        named is at index 0."""
        for a in coords:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r}; it has "
                                 f"{self.axis_names}")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def _key(self) -> tuple:
        return (self.axis_names, tuple(self.shape.values()),
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return (f"Mesh({dict(self.shape)}, devices={devs}, "
                f"entries={self.size})")


class P(tuple):
    """A partition spec: one entry per dimension, ``None``, a mesh axis
    name or a tuple of names (the stand-in for JAX's ``PartitionSpec``,
    equal to it entry for entry)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


def build_rules(mesh: Mesh,
                overrides: Sequence[Tuple[str, MeshAxes]] = ()
                ) -> Dict[str, MeshAxes]:
    """Instantiate the logical->mesh mapping for a concrete mesh.

    Mesh axes that the mesh does not have (e.g. ``pod`` on the single-pod
    mesh) are removed from every rule.
    """
    present = set(mesh.axis_names)
    rules: Dict[str, MeshAxes] = {}
    merged = list(DEFAULT_LOGICAL_RULES) + list(overrides)
    for name, axes in merged:
        if axes is None:
            rules[name] = None
            continue
        if isinstance(axes, str):
            axes = (axes,)
        kept = tuple(a for a in axes if a in present)
        rules[name] = kept if kept else None
    return rules


def _mesh_axis_size(mesh: Mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def spec_for(logical: Sequence[Optional[str]],
             shape: Sequence[int],
             mesh: Mesh,
             rules: Dict[str, MeshAxes]) -> P:
    """Resolve logical axis names -> partition spec with divisibility
    fallback.

    A logical axis is left unsharded when (a) it has no rule, (b) its mesh
    axes are already used by an earlier dimension of this tensor, or (c)
    the dimension size is not divisible by the mesh-axis product (a prefix
    of the axes is tried first). Mesh axes of size 1 carry no parallelism:
    they resolve to ``None`` without being consumed.
    """
    if len(logical) != len(shape):
        raise ValueError(f"{len(logical)} logical names for a shape of "
                         f"rank {len(shape)}: {logical}, {shape}")
    used: set = set()
    out = []
    for name, dim in zip(logical, shape):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes
                     if a not in used and mesh.shape[a] > 1)
        while axes and dim % _mesh_axis_size(mesh, axes) != 0:
            axes = axes[:-1]
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


class Logical:
    """A leaf marker carrying logical axis names for one array."""
    __slots__ = ("axes",)

    def __init__(self, *axes: Optional[str]):
        self.axes = tuple(axes)

    def __repr__(self):
        return f"Logical{self.axes}"

    def __eq__(self, other):
        return isinstance(other, Logical) and self.axes == other.axes

    def __hash__(self):
        return hash(self.axes)


class NamedSharding:
    """A partition spec on a mesh (the stand-in for JAX's
    ``NamedSharding``): ``shard_shape`` is the block of an array that one
    device holds, and ``shard_bytes`` its size."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def num_shards(self, dim: int) -> int:
        """How many blocks dimension ``dim`` is cut into."""
        if dim >= len(self.spec):
            return 1
        return _mesh_axis_size(self.mesh, self.spec[dim])

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n // self.num_shards(i) for i, n in enumerate(shape))

    def shard_bytes(self, shape: Sequence[int], dtype) -> int:
        return int(np.prod(self.shard_shape(shape), dtype=np.int64)) \
            * dtype.itemsize

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            (self.mesh, self.spec) == (other.mesh, other.spec)

    def __hash__(self):
        return hash((self.mesh, self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def sharding_for(logical, shape, mesh: Mesh, rules) -> NamedSharding:
    return NamedSharding(mesh, spec_for(logical, shape, mesh, rules))


def tree_map(fn, logical_tree, shape_tree):
    """``fn(logical, leaf)`` over two dict trees of the same keys, where
    the first has ``Logical`` leaves."""
    if isinstance(logical_tree, Logical):
        return fn(logical_tree, shape_tree)
    if set(logical_tree) != set(shape_tree):
        raise ValueError(f"trees differ: {sorted(logical_tree)} against "
                         f"{sorted(shape_tree)}")
    return {k: tree_map(fn, v, shape_tree[k])
            for k, v in logical_tree.items()}


def tree_shardings(logical_tree, shape_tree, mesh: Mesh, rules):
    """Zip a logical-axes tree with a tree of tensors (meta tensors serve
    as shapes) -> ``NamedSharding``s."""
    return tree_map(lambda lg, t: sharding_for(lg.axes, t.shape, mesh,
                                                rules),
                     logical_tree, shape_tree)


def tree_specs(logical_tree, shape_tree, mesh: Mesh, rules):
    return tree_map(lambda lg, t: spec_for(lg.axes, t.shape, mesh, rules),
                     logical_tree, shape_tree)


# ---------------------------------------------------------------------------
# Activation-sharding context: the ambient (mesh, rules) that model code's
# ``shard_act`` resolves against
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[Dict[str, MeshAxes]] = None
        self.recorded: Optional[list] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh: Mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = rules if rules is not None else build_rules(mesh)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def current_rules() -> Optional[Dict[str, MeshAxes]]:
    return _CTX.rules


@contextlib.contextmanager
def record_constraints():
    """Collect ``(logical axes, shape, spec)`` of every constraint that
    ``shard_act`` resolves on a mesh of more than one entry, in order."""
    prev = _CTX.recorded
    _CTX.recorded = out = []
    try:
        yield out
    finally:
        _CTX.recorded = prev


def shard_act(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Constrain an activation's placement by logical axis names: the
    identity without an ambient context or on a mesh of one device entry
    (``mesh.size``, the total).

    On a mesh of ``meta`` devices it resolves the spec against the
    context's rules (a rank mismatch raises, as in the reference), records
    it where ``record_constraints`` is active, and returns ``x``: the dry
    run runs the step once at the global shape, and what XLA would
    partition is read from the specs. On a mesh of real devices of more
    than one entry it raises: the port runs one process and has no SPMD
    execution to place an activation over several devices."""
    mesh = _CTX.mesh
    if mesh is None or mesh.size <= 1:
        return x
    if mesh.devices.flat[0].type != "meta":
        raise NotImplementedError(
            "shard_act on a mesh of several real devices: the port has no "
            "SPMD execution (a mesh of meta devices runs the dry run)")
    spec = spec_for(logical, x.shape, mesh, _CTX.rules)
    if _CTX.recorded is not None:
        _CTX.recorded.append((tuple(logical), tuple(x.shape), spec))
    return x


# ---------------------------------------------------------------------------
# Sweep-axis placement: the plan compiler (repro_torch.api) and
# simulate_sweep cut the stacked policy / seed / warp axes of a sweep into
# blocks over the mesh. A size-1 mesh axis never shards, and an axis
# product that does not divide the dimension falls back to replication
# (never an error), so the same Experiment runs unchanged on one device
# and on a mesh.
# ---------------------------------------------------------------------------

def norm_axes(axes: MeshAxes) -> Optional[Tuple[str, ...]]:
    """None | "name" | ("a", "b") -> None | tuple of names."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def resolve_axes(mesh: Optional[Mesh], axes: MeshAxes,
                 dim: int) -> MeshAxes:
    """The mesh axes that actually shard a dimension of size ``dim``:
    size-1 mesh axes are dropped, and if the remaining axis product does
    not divide ``dim`` the whole assignment resolves to ``None``
    (replication fallback)."""
    if mesh is None:
        return None
    axes = norm_axes(axes)
    if axes is None:
        return None
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes or dim % _mesh_axis_size(mesh, axes) != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def block_coords(mesh: Mesh, axes: MeshAxes) -> List[Dict[str, int]]:
    """The mesh coordinates of each block of a dimension cut over
    (resolved) ``axes``, in block order: block ``k`` is ``k`` in the
    mixed radix of the axes' sizes, the first axis most significant, as a
    JAX ``PartitionSpec`` entry ``("a", "b")`` orders its shards. ``None``
    is one block at no coordinates."""
    names = norm_axes(axes) or ()
    coords: List[Dict[str, int]] = [{}]
    for a in names:
        coords = [{**c, a: i} for c in coords for i in range(mesh.shape[a])]
    return coords


def block_device(mesh: Mesh, *coords: Mapping[str, int]) -> torch.device:
    """The device of the block at the union of ``coords`` (one mapping per
    sharded dimension; axes named by none of them at index 0)."""
    merged: Dict[str, int] = {}
    for c in coords:
        merged.update(c)
    return mesh.device_at(merged)


def split_leading(x: torch.Tensor, mesh: Mesh, axes: MeshAxes,
                  at: Optional[Mapping[str, int]] = None
                  ) -> List[torch.Tensor]:
    """``x`` cut on its leading dimension into the contiguous blocks of
    (resolved) ``axes``, block ``k`` moved to the device at ``at`` (the
    coordinates on the other axes; index 0 where not given) with the
    axes' coordinates of block ``k``. ``None`` is no split: ``[x]`` as it
    is. A block already on its device stays a view of ``x``; one that
    moves is made contiguous where it is first, since a strided block
    copied to a card takes a second, temporary copy of itself there."""
    if axes is None:
        return [x]
    coords = block_coords(mesh, axes)
    n = len(coords)
    if x.shape[0] % n:
        raise ValueError(f"a leading dimension of {x.shape[0]} does not "
                         f"split into {n} blocks over {axes!r}")
    out = []
    for blk, c in zip(x.tensor_split(n), coords):
        d = block_device(mesh, at or {}, c)
        out.append(blk if blk.device == d else blk.contiguous().to(d))
    return out


__all__ = [
    "DEFAULT_LOGICAL_RULES", "Logical", "Mesh", "MeshAxes", "NamedSharding",
    "P", "block_coords", "block_device", "build_rules", "current_mesh",
    "current_rules", "norm_axes", "record_constraints", "resolve_axes",
    "shard_act", "sharding_ctx", "sharding_for", "spec_for",
    "split_leading", "tree_map", "tree_shardings", "tree_specs",
]
