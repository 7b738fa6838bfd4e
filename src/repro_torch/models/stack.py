"""The block stack, in torch (port of ``repro.models.stack``).

A model family is a repeated *group pattern* of typed blocks (dense =
("layer",) × L; RecurrentGemma = ("rec", "rec", "attn") × 8 plus a tail
("rec", "rec"); xLSTM = ("mlstm", "slstm") × 6; Llama-3.2-Vision =
("self",) × 4 + ("cross",), × 8; Whisper = ("dec",) × 4 and an encoder
stack ("enc",) × 4). The reference stacks
each pattern position's parameters on a leading ``n_groups`` axis, runs
the groups as one ``lax.scan`` and the tail's blocks after it; here the
layers are ``nn.Module``s in an ``nn.ModuleList`` (groups first, then the
tail) and a plain Python loop takes the place of the scan (and
``torch.utils.checkpoint`` that of ``jax.checkpoint`` in training). The cache keeps
the reference's layout — each pattern position's cache leaves stacked on
a leading layer axis under ``{"scan": {f"{pos}_{kind}": {...}}, "tail":
{f"{i}_{kind}": {...}}}`` — and layer ``l`` reads and updates (in place)
its slice of every leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import Logical


@dataclasses.dataclass(frozen=True)
class BlockDef:
    kind: str
    module: Callable      # cfg -> nn.Module with forward(x, aux, cache);
    #                       its init_fn(generator or None, cfg) draws the
    #                       parameter dict
    init_cache: Optional[Callable] = None  # (cfg, batch, shape_cfg, device) -> cache
    cache_logical: Optional[Callable] = None  # cfg -> the cache's Logical leaves


@dataclasses.dataclass(frozen=True)
class StackDef:
    pattern: Tuple[str, ...]   # block kinds within one group
    n_groups: int
    blocks: Dict[str, BlockDef]
    tail: Tuple[str, ...] = ()  # blocks after the groups (rgemma 26 = 8*3 + 2)


def layer_slots(stack: StackDef) -> List[Tuple[str, str, Optional[int]]]:
    """Per layer, in execution order: ``("scan", f"{pos}_{kind}", group)``
    for the groups, then ``("tail", f"{i}_{kind}", None)`` for the tail —
    where the reference keeps that layer's parameters and cache."""
    slots: List[Tuple[str, str, Optional[int]]] = [
        ("scan", f"{pos}_{kind}", g)
        for g in range(stack.n_groups)
        for pos, kind in enumerate(stack.pattern)]
    slots += [("tail", f"{i}_{kind}", None)
              for i, kind in enumerate(stack.tail)]
    return slots


def layer_kinds(stack: StackDef) -> List[str]:
    """Block kind of each layer, in execution order."""
    return [key.split("_", 1)[1] for _, key, _ in layer_slots(stack)]


def build_layers(cfg, stack: StackDef) -> torch.nn.ModuleList:
    """The stack's modules in execution order (group-major, then tail)."""
    return torch.nn.ModuleList(stack.blocks[kind].module(cfg)
                               for kind in layer_kinds(stack))


def init_stack_cache(cfg, stack: StackDef, batch: int, shape_cfg,
                     device) -> Dict[str, Any]:
    """Each block's own initial cache (zeros, or the mLSTM's -1e30
    stabilizer and the sLSTM's unit normalizer), stacked [n_groups, ...]
    per pattern position, and one per tail block."""
    cache: Dict[str, Any] = {"scan": {}, "tail": {}}
    for pos, kind in enumerate(stack.pattern):
        bd = stack.blocks[kind]
        if bd.init_cache is None:
            continue
        c = bd.init_cache(cfg, batch, shape_cfg, device)
        cache["scan"][f"{pos}_{kind}"] = {
            k: a[None].repeat((stack.n_groups,) + (1,) * a.dim())
            for k, a in c.items()}
    for i, kind in enumerate(stack.tail):
        bd = stack.blocks[kind]
        if bd.init_cache is not None:
            cache["tail"][f"{i}_{kind}"] = bd.init_cache(cfg, batch,
                                                         shape_cfg, device)
    return cache


def stack_cache_logical(cfg, stack: StackDef) -> Dict[str, Any]:
    """``init_stack_cache``'s tree of ``Logical`` leaves: a stacked leaf
    leads with ``"layers"`` (which no mesh axis takes), as the
    reference's."""
    out: Dict[str, Any] = {"scan": {}, "tail": {}}
    for pos, kind in enumerate(stack.pattern):
        bd = stack.blocks[kind]
        if bd.init_cache is not None:
            out["scan"][f"{pos}_{kind}"] = {
                k: Logical("layers", *lg.axes)
                for k, lg in bd.cache_logical(cfg).items()}
    for i, kind in enumerate(stack.tail):
        bd = stack.blocks[kind]
        if bd.init_cache is not None:
            out["tail"][f"{i}_{kind}"] = bd.cache_logical(cfg)
    return out


def apply_stack(cfg, stack: StackDef, layers, x, aux, cache=None):
    """Run the layers in order. Returns (x, cache, aux_loss): the cache
    leaves are updated in place (``cache=None`` runs a stack that keeps
    none: the encoder's, or any stack in training), and ``aux_loss`` is
    the float32 sum of the blocks' aux losses, group by group and then
    the tail, as the reference's scan carries it.

    With ``cfg.remat``, in mode "train" under grad mode, each group runs
    under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its
    activations are recomputed in the backward pass, the counterpart of
    the reference's ``jax.checkpoint(nothing_saveable)`` over a group
    (the tail runs without it, as there)."""
    slots = layer_slots(stack)
    per_group = len(stack.pattern)
    remat = cfg.remat and aux["mode"] == "train" and torch.is_grad_enabled()

    def run(x, lo, hi):
        al = 0.0
        for layer, (sec, key, g) in zip(layers[lo:hi], slots[lo:hi]):
            c = None if cache is None else cache[sec].get(key)
            if c is not None and g is not None:
                c = {k: a[g] for k, a in c.items()}
            x, _, a = layer(x, aux, c)
            al = al + a
        return x, al

    total = 0.0
    n_scan = stack.n_groups * per_group
    for lo in range(0, n_scan, per_group):
        if remat:
            x, al = checkpoint(run, x, lo, lo + per_group,
                               use_reentrant=False)
        else:
            x, al = run(x, lo, lo + per_group)
        total = total + al
    for lo in range(n_scan, len(slots)):
        x, al = run(x, lo, lo + 1)
        total = total + al
    if not torch.is_tensor(total):     # no block had an aux loss
        total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cache, total
