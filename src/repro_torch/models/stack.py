"""The block stack, in torch (port of ``repro.models.stack``).

A model family is a repeated *group pattern* of typed blocks (dense =
("layer",) × L). The reference stacks each pattern position's parameters
on a leading ``n_groups`` axis and runs the stack as one ``lax.scan``;
here the layers are ``nn.Module``s in an ``nn.ModuleList`` and a plain
Python loop takes the place of the scan. The cache keeps the reference's
layout — each pattern position's cache leaves stacked on a leading layer
axis under ``{"scan": {f"{pos}_{kind}": {...}}, "tail": {}}`` — and layer
``l`` reads and updates (in place) slice ``l`` of every leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockDef:
    kind: str
    module: Callable      # cfg -> nn.Module with forward(x, aux, cache)
    init_cache: Optional[Callable] = None  # (cfg, batch, shape_cfg, device) -> cache


@dataclasses.dataclass(frozen=True)
class StackDef:
    pattern: Tuple[str, ...]   # block kinds within one group
    n_groups: int
    blocks: Dict[str, BlockDef]


def build_layers(cfg, stack: StackDef) -> torch.nn.ModuleList:
    """The stack's modules in execution order (group-major)."""
    return torch.nn.ModuleList(
        stack.blocks[kind].module(cfg)
        for _ in range(stack.n_groups) for kind in stack.pattern)


def init_stack_cache(cfg, stack: StackDef, batch: int, shape_cfg,
                     device) -> Dict[str, Any]:
    """Zero caches, stacked [n_groups, ...] per pattern position."""
    cache: Dict[str, Any] = {"scan": {}, "tail": {}}
    for pos, kind in enumerate(stack.pattern):
        bd = stack.blocks[kind]
        if bd.init_cache is None:
            continue
        c = bd.init_cache(cfg, batch, shape_cfg, device)
        cache["scan"][f"{pos}_{kind}"] = {
            k: torch.zeros((stack.n_groups,) + tuple(a.shape), dtype=a.dtype,
                           device=a.device) for k, a in c.items()}
    return cache


def apply_stack(cfg, stack: StackDef, layers, x, aux, cache):
    """Run the layers in order. Returns (x, cache); the cache leaves are
    updated in place."""
    npos = len(stack.pattern)
    for i, layer in enumerate(layers):
        g, pos = divmod(i, npos)
        key = f"{pos}_{stack.pattern[pos]}"
        c = cache["scan"].get(key)
        if c is not None:
            c = {k: a[g] for k, a in c.items()}
        x, _ = layer(x, aux, c)
    return x, cache
