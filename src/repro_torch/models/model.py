"""The model API, in torch (port of ``repro.models.model``, for every
family: dense, moe, hybrid, ssm, the encoder-decoder and the vlm).

``build_model(cfg, device, backend)`` returns a ``Model`` (an
``nn.Module``) on ``device`` — the card unless the caller asks for
another (``"cpu"``; without a card the default raises) — with:
  init_params(generator)       -> fills the parameters from a
                                  ``torch.Generator``; returns state_dict
  load_params(state)           -> adopts a state dict (no copy)
  loss(batch)                  -> (scalar loss, metrics)          [train]
  prefill(batch, cache)        -> (last-pos logits, cache)        [serve]
                                  (batch: "tokens", and "frames" [B,Se,D]
                                  for encdec or "image_embeds" [B,Ti,D]
                                  for vlm, in the model's dtype)
  decode(tokens, cache, page=) -> (logits, cache)                 [serve]
  init_cache(batch, shape_cfg, filled=False) -> cache dict
  logical_params()             -> {name: Logical} beside named_parameters
  batch_logical / cache_logical-> the inputs' and cache's Logical trees
  input_specs(shape_cfg)       -> the batch as meta tensors (shapes only)
  cache_specs(shape_cfg)       -> the filled cache as meta tensors

The logical trees and the specs are the reference's, leaf for leaf, for
the dry run (``repro_torch.launch.dryrun``). The layers are not stacked
here (``layers.{i}.…``), so a parameter's logical axes are the
reference's without its leading ``"layers"`` entry, which no mesh axis
takes; the cache keeps the reference's stacked layout and its axes.

The cache dict always contains:
  "stack":  per-block-kind stacked caches (KV rings / recurrent states),
            updated in place
  "len":    [B] int32 tokens generated so far
  "kv_pos": [B, W] int32 positions held in self-attn cache slots (-1 empty)
and, for the encoder-decoder, "enc_out": [B, Se, D] the encoder's output.

The parameters are frozen (``requires_grad=False``) as built; training
either makes them trainable with one explicit ``model.requires_grad_(True)``
or, as ``repro_torch.optim.make_train_step`` does, runs ``loss`` through
``torch.func.functional_call`` with a dict of leaf tensors. ``loss`` runs
the plain versions under autograd, never the kernels' gate (the Hopper
kernels have no backward); ``prefill`` and ``decode`` run under
``torch.no_grad``.

``params_from_numpy`` carries the reference's ``Model.init_params`` pytree
(as numpy arrays) into the port's state dict, so both packages can run the
same weights. ``backend`` is the gate of the model's kernels — flash and
paged decode attention (self-attention, the encoder's bidirectional
attention and cross-attention), the RG-LRU scan, the chunkwise mLSTM —
(``"auto"`` | ``"ref"`` | ``"cuda"``). The MoE FFN has no kernel (the
reference's expert products are einsums outside Pallas too).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.stack import (StackDef, apply_stack, build_layers,
                                      init_stack_cache, layer_kinds,
                                      layer_slots, stack_cache_logical)
from repro_torch.sharding import Logical, shard_act

F32 = torch.float32
I32 = torch.int32


def _stackdef(cfg: ModelConfig) -> StackDef:
    fam = cfg.family
    if fam == "dense":
        return StackDef(("layer",), cfg.num_layers, B.BLOCKS)
    if fam == "moe":
        return StackDef(("moe_layer",), cfg.num_layers, B.BLOCKS)
    if fam in ("hybrid", "ssm"):
        pattern = cfg.block_pattern or (("rec", "rec", "attn")
                                        if fam == "hybrid"
                                        else ("mlstm", "slstm"))
        n = cfg.num_layers // len(pattern)
        tail = tuple(pattern[: cfg.num_layers - n * len(pattern)])
        return StackDef(pattern, n, B.BLOCKS, tail=tail)
    if fam == "vlm":
        k = cfg.cross_attn_every
        if k < 1 or cfg.num_layers % k:
            raise ValueError(f"vlm: cross_attn_every={k} does not divide "
                             f"num_layers={cfg.num_layers}")
        pattern = ("self",) * (k - 1) + ("cross",)
        return StackDef(pattern, cfg.num_layers // k, B.BLOCKS)
    if fam == "encdec":
        return StackDef(("dec",), cfg.num_layers, B.BLOCKS)
    raise ValueError(fam)


def _enc_stackdef(cfg: ModelConfig) -> StackDef:
    return StackDef(("enc",), cfg.num_encoder_layers, B.BLOCKS)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, backend: str = "auto"):
        super().__init__()
        if backend not in _build.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from "
                             f"{_build.BACKENDS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = backend
        self.stack = _stackdef(cfg)
        self.enc_stack = _enc_stackdef(cfg) if cfg.family == "encdec" \
            else None
        dtype = getattr(torch, cfg.dtype)
        # parameters start on the meta device (no storage) until
        # init_params / load_params
        self.embed = B._frozen(L.embed_init(
            None, (cfg.padded_vocab, cfg.d_model), dtype))
        self.final_norm = B._frozen(torch.empty((cfg.d_model,), dtype=F32,
                                                device="meta"))
        self.layers = build_layers(cfg, self.stack)
        if not cfg.tie_embeddings:
            self.lm_head = B._frozen(L.dense_init(
                None, (cfg.d_model, cfg.padded_vocab), cfg.d_model, dtype))
        if self.enc_stack is not None:
            self.encoder = build_layers(cfg, self.enc_stack)
            self.enc_norm = B._frozen(torch.empty((cfg.d_model,), dtype=F32,
                                                  device="meta"))

    # -- params ------------------------------------------------------------

    def init_params(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """Draw every parameter from ``gen`` (on this model's device) in a
        fixed order: embedding, then each layer in execution order, then
        an untied head, then each encoder layer (the encoder-decoder).
        Norms, biases and the VLM's gates start at zero and draw
        nothing."""
        cfg = self.cfg
        if torch.device(gen.device).type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        dtype = getattr(torch, cfg.dtype)
        state = {"embed": L.embed_init(gen, (cfg.padded_vocab, cfg.d_model),
                                       dtype),
                 "final_norm": torch.zeros((cfg.d_model,), dtype=F32,
                                           device=gen.device)}
        for i, kind in enumerate(layer_kinds(self.stack)):
            init = self.stack.blocks[kind].module.init_fn
            state.update(_flatten(init(gen, cfg), f"layers.{i}."))
        if not cfg.tie_embeddings:
            state["lm_head"] = L.dense_init(
                gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model, dtype)
        if self.enc_stack is not None:
            for i, kind in enumerate(layer_kinds(self.enc_stack)):
                init = self.enc_stack.blocks[kind].module.init_fn
                state.update(_flatten(init(gen, cfg), f"encoder.{i}."))
            state["enc_norm"] = torch.zeros((cfg.d_model,), dtype=F32,
                                            device=gen.device)
        self.load_params(state)
        return state

    def load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        """Adopt ``state`` as the parameters (no copy; shapes, dtypes and
        device are checked)."""
        own = dict(self.named_parameters())
        if set(own) != set(state):
            raise ValueError(f"state keys differ: missing "
                             f"{sorted(set(own) - set(state))}, unexpected "
                             f"{sorted(set(state) - set(own))}")
        for k, p in own.items():
            t = state[k]
            if t.shape != p.shape or t.dtype != p.dtype or \
                    t.device.type != self.device.type:
                raise ValueError(f"{k}: {t.dtype}{tuple(t.shape)} on "
                                 f"{t.device}, want {p.dtype}"
                                 f"{tuple(p.shape)} on {self.device}")
        self.load_state_dict(dict(state), assign=True)

    def logical_params(self) -> Dict[str, Logical]:
        """The logical axes of every parameter, keyed as
        ``named_parameters``."""
        cfg = self.cfg
        lg: Dict[str, Logical] = {"embed": Logical("vocab", "embed"),
                                  "final_norm": Logical("embed")}
        stacks = [("layers", self.stack)]
        if self.enc_stack is not None:
            stacks.append(("encoder", self.enc_stack))
        for prefix, stack in stacks:
            for i, kind in enumerate(layer_kinds(stack)):
                block = stack.blocks[kind].module
                lg.update(_flatten(block.logical_fn(cfg), f"{prefix}.{i}."))
        if not cfg.tie_embeddings:
            lg["lm_head"] = Logical("embed", "vocab")
        if self.enc_stack is not None:
            lg["enc_norm"] = Logical("embed")
        return lg

    # -- shared forward ----------------------------------------------------

    def _embed(self, tokens):
        return shard_act(self.embed[tokens.long()], "batch", None, None)

    def _head(self, x):
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = (x @ w).to(F32)
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return shard_act(logits, "batch", None, "vocab")

    def _encode(self, frames, mode: str = "encode"):
        """Whisper's encoder over precomputed (stubbed) frame embeddings
        [B, Se, D]: sinusoidal positions added in the frames' dtype, the
        bidirectional layers, then ``enc_norm``. The layers read ``mode``
        from their aux: "encode" (serve) goes through the kernels' gate,
        "train" through ``attention_full`` under autograd, as the
        reference's encoder always does."""
        cfg = self.cfg
        b, se = frames.shape[:2]
        x = frames + _sinusoidal(se, cfg.d_model, frames.dtype,
                                 frames.device)
        aux = {"mode": mode, "backend": self.backend,
               "q_pos": torch.arange(se, dtype=I32, device=frames.device
                                     )[None].expand(b, se)}
        x, _, _ = apply_stack(cfg, self.enc_stack, self.encoder, x, aux)
        return L.rms_norm(x, self.enc_norm, cfg.norm_eps)

    def _aux_for(self, batch, mode, cache=None, tokens=None):
        """The blocks' context for ``mode`` (in mode "train" the blocks
        run the plain versions and do not read ``backend``)."""
        aux: Dict[str, Any] = {"mode": mode, "backend": self.backend}
        if mode in ("train", "prefill"):
            t = tokens if tokens is not None else batch["tokens"]
            bsz, s = t.shape
            aux["q_pos"] = torch.arange(s, dtype=I32,
                                        device=t.device)[None].expand(bsz, s)
        else:
            aux["q_pos"] = cache["len"][:, None]
            aux["kv_pos"] = cache["kv_pos"]
            w = cache["kv_pos"].shape[1]
            aux["write_slot"] = cache["len"] % w
        # the memories of cross-attention; in decode the layers read their
        # cached xk / xv, so the VLM needs no image there
        if self.cfg.family == "encdec":
            aux["enc_out"] = (cache["enc_out"] if mode == "decode" else
                              self._encode(batch["frames"],
                                           "train" if mode == "train"
                                           else "encode"))
        if self.cfg.family == "vlm" and mode != "decode":
            aux["img"] = batch["image_embeds"]
        return aux

    # -- train -------------------------------------------------------------

    def loss(self, batch):
        """Next-token cross-entropy of ``batch["tokens"]`` [B, S] (and
        ``frames`` / ``image_embeds`` for encdec / vlm) with a z-loss and
        the MoE aux loss, as the reference's ``Model.loss``: targets shifted
        left with the last position masked, ``logsumexp`` in float32,
        ``zloss = 1e-4 · Σ(lse·mask)² / Σmask``, total = ce + zloss +
        ``router_aux_coef`` · aux_loss. Returns (total, {"loss", "ce",
        "aux_loss", "zloss"}), all float32 scalars."""
        cfg = self.cfg
        tokens = batch["tokens"]
        aux = self._aux_for(batch, "train")
        x = self._embed(tokens)
        x, _, aux_loss = apply_stack(cfg, self.stack, self.layers, x, aux)
        logits = self._head(x)
        tok = tokens.long()
        targets = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], 1)
        mask = torch.cat([torch.ones_like(tok[:, 1:], dtype=F32),
                          torch.zeros_like(tok[:, :1], dtype=F32)], 1)
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = (lse - tgt_logit) * mask
        denom = torch.clamp_min(torch.sum(mask), 1.0)
        ce = torch.sum(nll) / denom
        zloss = 1e-4 * torch.sum((lse * mask) ** 2) / denom
        total = ce + zloss + cfg.router_aux_coef * aux_loss
        return total, {"loss": total, "ce": ce, "aux_loss": aux_loss,
                       "zloss": zloss}

    # -- serve -------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch, cache):
        """Prefill ``batch["tokens"]`` [B, S] into an empty cache. Returns
        (last-position logits [B, V] float32, cache)."""
        tokens = batch["tokens"]
        aux = self._aux_for(batch, "prefill")
        x = self._embed(tokens)
        x, new_stack, _ = apply_stack(self.cfg, self.stack, self.layers, x,
                                      aux, cache["stack"])
        logits = self._head(x[:, -1:])
        s = tokens.shape[1]
        w = cache["kv_pos"].shape[1]
        kv_pos = _ring_positions(s, w).to(cache["kv_pos"].device)[None]
        new_cache = {
            "stack": new_stack,
            "len": torch.full_like(cache["len"], s),
            "kv_pos": kv_pos.expand(cache["kv_pos"].shape).clone(),
        }
        if self.cfg.family == "encdec":
            new_cache["enc_out"] = aux["enc_out"]
        return logits[:, 0], new_cache

    @torch.no_grad()
    def decode(self, tokens, cache, *, page=None):
        """tokens: [B,1]. Returns (logits [B,V] float32, cache).

        Attention reads the ring through the paged decode kernel with
        pages of ``page`` slots (``None``: the whole ring is one page); W
        must be a multiple of ``page`` (cross-attention reads its cached
        memory as one page a sequence). A windowed attention (dense SWA,
        the hybrid's local window) needs a ring no longer than its window,
        as ``init_cache`` makes it: then the window masks nothing the ring
        holds, and the filled prefix is what the reference attends to.
        """
        cfg = self.cfg
        aux = self._aux_for(None, "decode", cache=cache, tokens=tokens)
        b = tokens.shape[0]
        w = cache["kv_pos"].shape[1]
        page = w if page is None else page
        if page < 1 or w % page:
            raise ValueError(f"ring of {w} slots is not a whole number of "
                             f"pages of {page}")
        if self._window(ShapeConfig("decode", w, b, "decode")) < w:
            raise ValueError(f"ring of {w} slots is longer than the "
                             "attention window")
        slot = aux["write_slot"]
        rows = torch.arange(b, device=slot.device)
        kv_pos = cache["kv_pos"].clone()
        kv_pos[rows, slot.long()] = cache["len"]
        aux["kv_pos"] = kv_pos
        aux["page"] = page
        aux["block_tbl"] = torch.arange(b * (w // page), dtype=I32,
                                        device=slot.device).view(b, -1)
        aux["lengths"] = torch.clamp_max(cache["len"] + 1, w).to(I32)
        x = self._embed(tokens)
        x, new_stack, _ = apply_stack(cfg, self.stack, self.layers, x, aux,
                                      cache["stack"])
        logits = self._head(x)
        new_cache = dict(cache)
        new_cache.update({
            "stack": new_stack,
            "len": cache["len"] + 1,
            "kv_pos": kv_pos,
        })
        return logits[:, 0], new_cache

    # -- caches ------------------------------------------------------------

    def _window(self, shape_cfg: ShapeConfig) -> int:
        cfg = self.cfg
        w = shape_cfg.seq_len
        if cfg.family == "hybrid":
            w = min(w, cfg.local_window)
        elif cfg.sliding_window is not None:
            w = min(w, cfg.sliding_window)
        elif cfg.family == "ssm":
            w = 1  # no attention cache; keep a stub ring of 1
        return w

    def init_cache(self, batch: int, shape_cfg: ShapeConfig,
                   filled: bool = False, device=None):
        """An empty cache on ``device`` (default the model's), or with
        ``filled`` the dry run's decode cache: every row holds
        ``seq_len - 1`` tokens already (``len`` and ``kv_pos`` say so; the
        stack's leaves keep their initial values)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        w = self._window(shape_cfg)
        if filled:
            ln = torch.full((batch,), shape_cfg.seq_len - 1, dtype=I32,
                            device=dev)
            kvp = _ring_positions(shape_cfg.seq_len - 1, w).to(dev)[None]
        else:
            ln = torch.zeros((batch,), dtype=I32, device=dev)
            kvp = torch.full((1, w), -1, dtype=I32, device=dev)
        cache = {"stack": init_stack_cache(cfg, self.stack, batch, shape_cfg,
                                           dev),
                 "len": ln, "kv_pos": kvp.expand(batch, w).clone()}
        if cfg.family == "encdec":
            cache["enc_out"] = torch.zeros(
                (batch, cfg.encoder_seq_len, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=dev)
        return cache

    def cache_logical(self, batch: int, shape_cfg: ShapeConfig):
        """``init_cache``'s tree of ``Logical`` leaves."""
        out = {"stack": stack_cache_logical(self.cfg, self.stack),
               "len": Logical("batch"), "kv_pos": Logical("batch", "kv_seq")}
        if self.cfg.family == "encdec":
            out["enc_out"] = Logical("batch", "enc_seq", None)
        return out

    def input_specs(self, shape_cfg: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The step's batch at ``shape_cfg`` as meta tensors."""
        cfg = self.cfg
        bsz = shape_cfg.global_batch
        dtype = getattr(torch, cfg.dtype)
        seq = shape_cfg.seq_len if shape_cfg.kind in ("train", "prefill") \
            else 1
        specs = {"tokens": torch.empty((bsz, seq), dtype=I32, device="meta")}
        if cfg.family == "encdec" and shape_cfg.kind != "decode":
            specs["frames"] = torch.empty(
                (bsz, cfg.encoder_seq_len, cfg.d_model), dtype=dtype,
                device="meta")
        if cfg.family == "vlm" and shape_cfg.kind != "decode":
            specs["image_embeds"] = torch.empty(
                (bsz, cfg.num_image_tokens, cfg.d_model), dtype=dtype,
                device="meta")
        return specs

    def cache_specs(self, shape_cfg: ShapeConfig):
        """The filled cache at ``shape_cfg`` as meta tensors."""
        return self.init_cache(shape_cfg.global_batch, shape_cfg,
                               filled=True, device="meta")

    def batch_logical(self, shape_cfg: ShapeConfig):
        lg = {"tokens": Logical("batch", None)}
        if self.cfg.family == "encdec" and shape_cfg.kind != "decode":
            lg["frames"] = Logical("batch", "enc_seq", None)
        if self.cfg.family == "vlm" and shape_cfg.kind != "decode":
            lg["image_embeds"] = Logical("batch", None, None)
        return lg


def _ring_positions(filled_len: int, w: int) -> torch.Tensor:
    """Positions stored in each ring slot after `filled_len` writes."""
    slots = np.full((w,), -1, np.int32)
    for p in range(max(0, filled_len - w), filled_len):
        slots[p % w] = p
    return torch.from_numpy(slots)


def _sinusoidal(s: int, d: int, dtype, device) -> torch.Tensor:
    """[1, s, d] sinusoidal positions, computed in float64 (numpy, as the
    reference) and cast to ``dtype``."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None]
    ang = pos / np.power(10000.0, 2 * i / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)[None]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _to_torch(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, as ml_dtypes gives them) as a
    tensor of the same dtype on ``device``, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Mapping, cfg: ModelConfig,
                      device) -> Dict[str, torch.Tensor]:
    """The reference's ``Model.init_params`` pytree (numpy leaves) as the
    port's state dict, every leaf: layer ``i`` takes slice ``g`` of the
    stacked ``[n_groups, ...]`` leaves of ``stack.scan.{pos}_{kind}``, or
    the leaves of ``stack.tail.{j}_{kind}``; encoder layer ``i`` likewise
    from ``enc_stack``, and ``enc_norm``."""
    state = {k: _to_torch(tree[k], device)
             for k in ("embed", "final_norm", "lm_head", "enc_norm")
             if k in tree}
    stacks = [("layers", "stack", _stackdef(cfg))]
    if cfg.family == "encdec":
        stacks.append(("encoder", "enc_stack", _enc_stackdef(cfg)))
    for prefix, name, stack in stacks:
        for i, (sec, key, g) in enumerate(layer_slots(stack)):
            for k, a in _flatten(tree[name][sec][key]).items():
                a = np.asarray(a)
                state[f"{prefix}.{i}.{k}"] = _to_torch(
                    a if g is None else a[g], device)
    return state


def build_model(cfg: ModelConfig, device=None,
                backend: str = "auto") -> Model:
    """A ``Model`` for ``cfg`` whose parameters are not drawn yet (call
    ``init_params`` or ``load_params``). ``device=None`` is the card, and
    raises without one."""
    return Model(cfg, device, backend)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from shapes alone (the model on the meta device).
    With ``active_only`` each MoE expert leaf (``moe.w_gate``,
    ``moe.w_up``, ``moe.w_down``) counts ``k / E`` of its size, summed
    over the layers that the reference stacks into one leaf before the
    fraction is taken, as the reference counts."""
    model = Model(cfg, "meta")
    frac = (cfg.num_experts_per_tok / cfg.num_experts
            if cfg.num_experts else 1.0)
    slots = {"layers": layer_slots(model.stack)}
    if model.enc_stack is not None:
        slots["encoder"] = layer_slots(model.enc_stack)
    stacked: Dict[str, int] = {}
    for name, p in model.named_parameters():
        prefix, *rest = name.split(".")
        key = name
        if prefix in slots:
            sec, slot, _ = slots[prefix][int(rest[0])]
            key = ".".join([prefix, sec, slot] + rest[1:])
        stacked[key] = stacked.get(key, 0) + p.numel()
    total = 0
    for key, n in stacked.items():
        if active_only and cfg.num_experts and ".moe." in key and \
                key.rsplit(".", 1)[1] in ("w_gate", "w_up", "w_down"):
            n = int(n * frac)
        total += n
    return total


def count_params(cfg: ModelConfig) -> int:
    """Parameter count of the port's model (shapes only, no storage)."""
    return count_params_analytic(cfg)
