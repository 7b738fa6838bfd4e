"""AdamW + schedule + gradient accumulation + the train-step factory, in
torch (port of ``repro.optim.optimizer``).

The reference's functional form is kept: parameters are a flat
``{name: tensor}`` dict under the names of ``Model.named_parameters()``
(those ``params_from_numpy`` gives), the optimizer state a dict of such
dicts, and ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` returns new tensors and changes none it was given.

  * moments in ``moment_dtype`` (bfloat16 halves their memory);
  * optional int8 gradient compression with error feedback
    (``grad_compression="int8"``): ``quantize_int8`` in the update, and
    ``compressed_psum``, the int8 all-reduce over the members of a
    ``Mesh``;
  * gradient accumulation over equal microbatches, in float32;
  * weight decay on every leaf, as the reference applies it.

The update and the accumulation run as multi-tensor (``torch._foreach_*``)
operations, the reference's elementwise arithmetic in its order: eager
PyTorch pays the host for each operation it queues, and one set of
operations a tensor cost a train step of the ~100M example a sixth of its
time. They go over groups of leaves of at most ``GROUP_ELEMENTS``
elements (``_groups``), so that their float32 temporaries stay a few
hundred MB, not several copies of the whole model.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import OptimizerConfig

F32 = torch.float32

#: the most elements one multi-tensor operation takes (a larger leaf
#: goes alone): 2**27 float32 elements are 512 MB a temporary
GROUP_ELEMENTS = 1 << 27


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to a tenth of it at
    ``total_steps``: a float32 scalar (on ``step``'s device when it is a
    tensor)."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _device_of(params: Mapping[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: OptimizerConfig) -> Dict[str, Any]:
    """Zero moments ``m``, ``v`` in ``cfg.moment_dtype`` (and the float32
    error-feedback buffers ``err`` with int8 compression) beside each
    parameter, and the int32 step ``count``."""
    mdt = getattr(torch, cfg.moment_dtype)
    state = {"m": {k: torch.zeros_like(p, dtype=mdt)
                   for k, p in params.items()},
             "v": {k: torch.zeros_like(p, dtype=mdt)
                   for k, p in params.items()},
             "count": torch.zeros((), dtype=torch.int32,
                                  device=_device_of(params))}
    if cfg.grad_compression == "int8":
        state["err"] = {k: torch.zeros_like(p, dtype=F32)
                        for k, p in params.items()}
    return state


def _global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.to(F32)))
                                   for x in tree.values()]).sum())


def quantize_int8(x: torch.Tensor, err: torch.Tensor):
    """int8 quantize with error feedback. Returns (deq in x's dtype,
    new_err float32): ``x + err`` on 255 levels of its max magnitude."""
    xf = x.to(F32) + err
    scale = torch.clamp_min(torch.amax(torch.abs(xf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.to(F32) * scale
    return deq.to(x.dtype), xf - deq


def compressed_psum(xs: Sequence[torch.Tensor], mesh,
                    axis_name: str = "data") -> List[torch.Tensor]:
    """The int8 all-reduce over ``axis_name`` of a ``Mesh``: ``xs`` holds
    one tensor a member (``mesh.size`` of them, in the order of
    ``mesh.devices.flat``), each on its member's device. Within each group
    of members along the axis, every member quantizes with the group's
    shared max scale, the int32 partials are summed and the sum is
    dequantized; returns one tensor a member, on its device. Traffic is
    1 byte an element and one float32 scale, against 4 bytes."""
    if len(xs) != mesh.size:
        raise ValueError(f"compressed_psum: {len(xs)} tensors for a mesh of "
                         f"{mesh.size} members")
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}; it has "
                         f"{mesh.axis_names}")
    ax = mesh.axis_names.index(axis_name)
    index = np.moveaxis(np.arange(mesh.size).reshape(
        tuple(mesh.shape.values())), ax, -1).reshape(-1, mesh.shape[
            axis_name])
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in index:
        home = xs[group[0]].device
        peak = torch.stack([torch.amax(torch.abs(xs[i])).to(home, F32)
                            for i in group]).amax()
        scale = torch.clamp_min(peak, 1e-12) / 127.0
        total = sum(torch.clamp(torch.round(xs[i].to(F32) / scale.to(
            xs[i].device)), -127, 127).to(torch.int32).to(home)
            for i in group)
        deq = total.to(F32) * scale
        for i in group:
            out[i] = deq.to(xs[i].device)
    return out


def _groups(keys: Sequence[str], tensors: Mapping[str, torch.Tensor]):
    """``keys`` in order, cut into consecutive lists of at most
    ``GROUP_ELEMENTS`` elements (a larger tensor alone)."""
    group, n = [], 0
    for k in keys:
        if group and n + tensors[k].numel() > GROUP_ELEMENTS:
            yield group
            group, n = [], 0
        group.append(k)
        n += tensors[k].numel()
    if group:
        yield group


def adamw_update(grads: Mapping[str, torch.Tensor], state: Mapping[str, Any],
                 params: Mapping[str, torch.Tensor], cfg: OptimizerConfig):
    """One AdamW step: global-norm clip to ``cfg.grad_clip``, (int8 with
    error feedback,) bias-corrected moments, decoupled weight decay on
    every leaf, the scheduled learning rate. Returns (new params, new
    state, {"grad_norm", "lr"})."""
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    gnorm = _global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    c1 = 1 - cfg.b1 ** count.to(F32)
    c2 = 1 - cfg.b2 ** count.to(F32)
    int8 = cfg.grad_compression == "int8"
    new_p, new_m, new_v, new_e = {}, {}, {}, {}
    for keys in _groups(list(params), params):
        g = torch._foreach_mul([grads[k].to(F32) for k in keys], clip)
        if int8:
            g, err = zip(*(quantize_int8(x, state["err"][k])
                           for x, k in zip(g, keys)))
            g = list(g)
            new_e.update(zip(keys, err))
        # m_new = b1 m + (1 - b1) g;  v_new = b2 v + (1 - b2) g g
        m = torch._foreach_mul([state["m"][k].to(F32) for k in keys], cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        v = torch._foreach_mul([state["v"][k].to(F32) for k in keys], cfg.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, 1 - cfg.b2), g))
        del g
        # step = (m_new / c1) / (sqrt(v_new / c2) + eps) + wd p;
        # p_new = p - lr step
        p32 = [params[k].to(F32) for k in keys]
        step = torch._foreach_div(torch._foreach_div(m, c1),
                                  torch._foreach_add(torch._foreach_sqrt(
                                      torch._foreach_div(v, c2)), cfg.eps))
        torch._foreach_add_(step, torch._foreach_mul(p32, cfg.weight_decay))
        step = torch._foreach_sub(p32, torch._foreach_mul(step, lr))
        for k, pk, mk, vk in zip(keys, step, m, v):
            new_p[k] = pk.to(params[k].dtype)
            new_m[k] = mk.to(state["m"][k].dtype)
            new_v[k] = vk.to(state["v"][k].dtype)
        del m, v, p32, step
    new_state = {"m": new_m, "v": new_v, "count": count}
    if int8:
        new_state["err"] = new_e
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# train step factory
# ---------------------------------------------------------------------------

class _LossAndGrads(nn.Module):
    """The model's loss and its gradients with respect to ``leaves``, the
    tensors ``functional_call`` put in place of the parameters: the
    backward pass runs inside the call, so a group that recomputes its
    activations (remat) reads the same tensors."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, leaves):
        total, metrics = self.model.loss(batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads


def batch_to(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.require(v, requirements="C"))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def make_train_step(model: nn.Module, cfg: OptimizerConfig,
                    microbatches: int = 1):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for ``model`` (a ``repro_torch.models.model.Model``).

    ``params`` is the flat ``{name: tensor}`` dict of the model's
    parameters; the loss runs through ``torch.func.functional_call`` with
    them, so the module's own (frozen) parameters are neither read nor
    changed. ``batch`` may hold numpy arrays; it is moved to the
    parameters' device. With ``microbatches`` > 1 the batch splits into
    equal consecutive parts along its first axis, the gradients are
    summed in float32, each divided by ``microbatches``, the loss is
    their mean and the other metrics are the last microbatch's, as the
    reference's scan gives them."""
    lg = _LossAndGrads(model)

    def grads_of(params, batch):
        leaves = {f"model.{k}": v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            total, metrics, grads = torch.func.functional_call(
                lg, leaves, (batch, tuple(leaves.values())))
        return total, metrics, dict(zip(params, grads))

    def step(params, opt_state, batch):
        batch = batch_to(batch, _device_of(params))
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} rows does not split into "
                                 f"{microbatches} microbatches")
            acc = {k: torch.zeros_like(p, dtype=F32)
                   for k, p in params.items()}
            loss = torch.zeros((), dtype=F32, device=_device_of(params))
            for i in range(microbatches):
                part = {k: v.split(b // microbatches)[i]
                        for k, v in batch.items()}
                l_mb, metrics, g_mb = grads_of(params, part)
                for keys in _groups(list(params), params):
                    torch._foreach_add_([acc[k] for k in keys],
                                        torch._foreach_div(
                                            [g_mb[k].to(F32) for k in keys],
                                            microbatches))
                del g_mb
                loss = loss + l_mb / microbatches
            grads = acc
        new_params, new_state, opt_metrics = adamw_update(
            grads, opt_state, params, cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return step
