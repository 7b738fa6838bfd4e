"""Continuous-batching serving engine with MeDiC-managed KV residency, in
torch (port of ``repro.serving.engine``).

The engine runs a *real* decoder LM on the card: admission -> prefill ->
batched decode steps, with the KV cache of every slot physically managed
at block granularity by ``MedicPoolManager``:

  * on eviction a block's K/V payload is read out of the cache with one
    launch of the pool-gather kernel (``kernels/medic_gather``, K and V
    together), copied to a host-side store and ZEROED in the device cache;
  * on fetch it is restored before the decode step runs;
  * sequences whose fetches have not completed (two-queue transfer model)
    skip decode steps (the warp-stall analogue).

Prefill attention runs the flash-attention kernel and every decode step
the paged decode kernel, with the ring cache of ``max_len`` slots viewed
as pages of ``gcd(max_len, block_tokens)`` slots: a pool block is
``block_tokens / page`` pages, the ring's last block fewer when
``max_len`` is not a multiple of ``block_tokens`` (the reference cuts it
short there too). The host-side control flow is the
reference's, line for line — admissions, ``_block_keys``, residency
transactions, ``fetch_pending``, stream-out after the step, ``snapshot`` —
so the pool metrics match the reference's bitwise. They do not depend on
the model's width or weights: decode steps feed zero tokens and discard
the logits, and the control flow reads only the sequence lengths, the pool
and the requests. The engine keeps those lengths in a host mirror
(``lens``) of the cache's ``len`` instead of reading the device each time.

Shared-prefix blocks are accounting-shared across sequences (pseudo-slots);
their payloads are duplicated per-slot and not offloaded (DESIGN.md §8).

``ServeEngine`` and ``run_ab`` run on the card: the default device is
``"cuda"``, and without a CUDA device they raise unless the caller passes
``device="cpu"`` (where the kernels' plain versions run). ``backend``
gates all three kernels (``"auto"`` | ``"ref"`` | ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import spans as SP
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.engine import resolve_device
from repro_torch.kernels.medic_gather.ops import medic_gather_pools
from repro_torch.models.model import build_model
from repro_torch.serving.pool import MedicPoolManager, PoolConfig
from repro_torch.serving.request import Request, ServeWorkload, generate_requests


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_len: int = 512
    seed: int = 0


@dataclasses.dataclass
class EngineCounts:
    """What the engines of this process did, so that a run can check its
    kernel launches: prefills (one flash-attention launch per layer),
    decode steps with an active slot (one paged-decode launch per layer)
    and offloads of real slots' blocks (two gather launches each); and
    restores of offloaded blocks."""
    admissions: int = 0
    decode_steps: int = 0
    offloads: int = 0
    restores: int = 0

    def reset(self) -> None:
        self.admissions = self.decode_steps = self.offloads = 0
        self.restores = 0


COUNTS = EngineCounts()


def offload_table(n_layers: int, n_slots: int, pages: int, slot: int,
                  idx: int, n_pages: int, device) -> torch.Tensor:
    """The offload read's block table, i32[n_layers, n_pages]: every
    layer's cache [L, slots, pages * page, ...] seen as one pool of pages,
    pages ``idx .. idx + n_pages - 1`` of ``slot`` in each layer, built on
    ``device``."""
    stride = n_slots * pages
    start = slot * pages + idx
    first = torch.arange(start, start + n_layers * stride, stride,
                         dtype=torch.int32, device=device).view(n_layers, 1)
    return first + torch.arange(n_pages, dtype=torch.int32, device=device)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """The engine's weights: the model's parameters drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return build_model(cfg, dev).init_params(gen)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 pool_cfg: PoolConfig, *, device=None, backend: str = "auto",
                 params=None):
        if cfg.family != "dense":
            raise NotImplementedError("the serving engine targets dense LMs")
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device, backend)
        if params is None:
            params = init_params(cfg, ecfg.seed, self.device)
        self.model.load_params(params)
        self.backend = backend
        self.shape = ShapeConfig("serve", ecfg.max_len, ecfg.max_slots,
                                 "decode")
        self.cache = self.model.init_cache(ecfg.max_slots, self.shape)
        if self.cache["kv_pos"].shape[1] != ecfg.max_len:
            raise ValueError(
                f"the model's ring holds {self.cache['kv_pos'].shape[1]} "
                f"slots, not max_len {ecfg.max_len}: its sliding window is "
                "shorter (the engine's blocks index a ring of max_len)")
        self.lens = np.zeros(ecfg.max_slots, np.int64)   # host mirror of len
        self.bs = pool_cfg.block_tokens
        # the ring's page: a pool block is a whole number of pages, and
        # the ring too
        self.page = math.gcd(ecfg.max_len, self.bs)
        # pseudo-slots for shared prefixes sit after the real slots
        self.pool = MedicPoolManager(pool_cfg, ecfg.max_slots + 8,
                                     on_evict=self._offload)
        self.host_store: Dict[tuple, torch.Tensor] = {}
        self.slots: List[Optional[Request]] = [None] * ecfg.max_slots

    # -- block data path ------------------------------------------------------

    def _kv_leaves(self):
        sc = self.cache["stack"]["scan"]
        key = next(iter(sc))
        return sc[key]

    def _offload(self, key):
        slot, idx = key
        if slot >= self.ecfg.max_slots:
            return  # shared pseudo-slot: accounting only
        kv = self._kv_leaves()
        n_layers, n_slots = kv["k"].shape[:2]
        pages = self.ecfg.max_len // self.page
        per_block = self.bs // self.page
        first = idx * per_block
        n = min(per_block, pages - first)   # the ring's last block: fewer
        tbl = offload_table(n_layers, n_slots, pages, slot, first, n,
                            self.device)
        pool_shape = (n_layers * n_slots * pages, self.page) + \
            tuple(kv["k"].shape[3:])
        kv_blk = medic_gather_pools((kv["k"].view(pool_shape),
                                     kv["v"].view(pool_shape)), tbl,
                                    backend=self.backend)
        # [K/V, L, n pages, page, ...] -> [K/V, L, n * page tokens, ...]
        self.host_store[key] = kv_blk.flatten(2, 3).cpu()
        lo = idx * self.bs
        kv["k"][:, slot, lo:lo + self.bs] = 0
        kv["v"][:, slot, lo:lo + self.bs] = 0
        COUNTS.offloads += 1

    def _restore(self, key):
        slot, idx = key
        if slot >= self.ecfg.max_slots:
            return
        data = self.host_store.get(key)
        if data is None:
            return  # never offloaded (still physically present)
        with SP.span("serve.restore", self.slots[slot].rid):
            kv = self._kv_leaves()
            lo = idx * self.bs
            kv["k"][:, slot, lo:lo + self.bs] = data[0].to(self.device)
            kv["v"][:, slot, lo:lo + self.bs] = data[1].to(self.device)
            COUNTS.restores += 1

    # -- request lifecycle ----------------------------------------------------

    def _prompt_tokens(self, req: Request) -> np.ndarray:
        toks = []
        if req.shared_prefix_id is not None:
            prng = np.random.default_rng(1000 + req.shared_prefix_id)
            toks.append(prng.integers(1, self.cfg.vocab_size,
                                      req.shared_prefix_len))
        prng = np.random.default_rng(2000 + req.rid)
        toks.append(prng.integers(1, self.cfg.vocab_size, req.prompt_len))
        return np.concatenate(toks).astype(np.int32)

    def _block_keys(self, req: Request, length: int) -> List[tuple]:
        """Residency keys for the first `length` tokens of the sequence.
        Shared-prefix blocks map to the prefix's pseudo-slot."""
        keys = []
        nshared = req.shared_prefix_len // self.bs if req.shared_prefix_id is not None else 0
        nblocks = -(-length // self.bs)
        for i in range(nblocks):
            if i < nshared:
                keys.append((self.ecfg.max_slots + req.shared_prefix_id, i))
            else:
                keys.append((req.slot, i))
        return keys

    def _admit(self, req: Request, slot: int, step: int):
        req.slot = slot
        req.enqueue_step = step
        self.slots[slot] = req
        self.pool.reset_slot(slot)
        for key in list(self.host_store):
            if key[0] == slot:
                del self.host_store[key]
        with SP.span("serve.prefill", req.rid):
            toks = self._prompt_tokens(req)
            # single-sequence prefill merged into the batch cache at `slot`
            one = ShapeConfig("p", len(toks), 1, "prefill")
            c1 = self.model.init_cache(1, one)
            tokens = torch.from_numpy(toks)[None].to(self.device)
            logits, c1 = self.model.prefill({"tokens": tokens}, c1)
            COUNTS.admissions += 1
        with SP.span("serve.merge", req.rid):
            self._merge_slot_cache(c1, slot, len(toks))
        # prefilled blocks enter the pool under the insertion policy,
        # without fetch cost (they were just produced on-device)
        with SP.span("serve.pool_insert", req.rid):
            stype = int(self.pool.seq_type[slot])
            for key in self._block_keys(req, len(toks)):
                self.pool.insert_prefill(key, stype)

    def _merge_slot_cache(self, c1, slot: int, length: int):
        """Write a 1-sequence prefill cache into batch position `slot`."""
        w = self.cache["kv_pos"].shape[1]
        kv = self._kv_leaves()
        src = c1["stack"]["scan"][next(iter(c1["stack"]["scan"]))]
        s = min(length, w)
        kv["k"][:, slot, :s] = src["k"][:, 0, :s]
        kv["v"][:, slot, :s] = src["v"][:, 0, :s]
        self.cache["len"][slot] = length
        self.lens[slot] = length
        kvp = np.full((w,), -1, np.int32)
        for p in range(max(0, length - w), length):
            kvp[p % w] = p
        self.cache["kv_pos"][slot] = torch.from_numpy(kvp).to(self.device)

    def _decode_step(self, active: np.ndarray):
        """One batched decode step (zero tokens, logits discarded),
        committed only for the active slots. The model writes every slot's
        new K/V into the ring in place; the idle slots' overwritten ring
        entries are saved first and put back after (the reference keeps
        their old cache whole)."""
        kv = self._kv_leaves()
        idle = np.nonzero(~active)[0]
        rows = torch.from_numpy(idle).to(self.device)
        cols = torch.from_numpy(self.lens[idle] % self.ecfg.max_len).to(
            self.device)
        keep = {n: kv[n][:, rows, cols].clone() for n in ("k", "v")}
        toks = torch.zeros((self.ecfg.max_slots, 1), dtype=torch.int32,
                           device=self.device)
        old = self.cache
        logits, new = self.model.decode(toks, old, page=self.page)
        mask = torch.from_numpy(active).to(self.device)
        new["len"] = torch.where(mask, new["len"], old["len"])
        new["kv_pos"] = torch.where(mask[:, None], new["kv_pos"],
                                    old["kv_pos"])
        for n in ("k", "v"):
            kv[n][:, rows, cols] = keep[n]
        self.cache = new
        self.lens[active] += 1
        COUNTS.decode_steps += 1

    def _step(self, step: int, pending: List[Request], done: List[Request],
              ready_at: np.ndarray, fetch_pending: np.ndarray) -> int:
        """One engine step: admissions, the residency transactions for
        the upcoming decode, the decode step and the stream-out after it.
        Returns the tokens decoded."""
        now = float(step)
        # admissions
        for i, cur in enumerate(self.slots):
            if cur is None and pending and pending[0].arrival <= now:
                req = pending.pop(0)
                with SP.span("serve.admit", req.rid):
                    self._admit(req, i, step)
                ready_at[i] = now
                fetch_pending[i] = False
        # residency transactions for the upcoming decode
        active = np.zeros(self.ecfg.max_slots, bool)
        with SP.span("serve.residency", step):
            for i, req in enumerate(self.slots):
                if req is None or ready_at[i] > now:
                    if req is not None:
                        req.stall_steps += 1
                    continue
                if fetch_pending[i]:
                    fetch_pending[i] = False
                    active[i] = True
                    continue
                length = int(self.lens[i]) + 1
                keys = self._block_keys(req, min(length, self.ecfg.max_len))
                t_ready = now
                for key in keys:
                    t, fetched = self.pool.access(i, [key[1]], now,
                                                  resident_key=key)
                    # restore data for any fetched (non-resident) block;
                    # bypassed (streamed) blocks are re-offloaded after the
                    # step below
                    if fetched:
                        self._restore(key)
                    t_ready = max(t_ready, t)
                if t_ready > now:
                    ready_at[i] = t_ready
                    fetch_pending[i] = True
                    req.stall_steps += 1
                else:
                    active[i] = True
        if not active.any():
            return 0
        with SP.span("serve.decode", step):
            self._decode_step(active)
        tokens = 0
        for i, req in enumerate(self.slots):
            if req is None or not active[i]:
                continue
            req.generated += 1
            tokens += 1
            if req.first_token_step < 0:
                req.first_token_step = step
            if req.generated >= req.decode_len:
                req.finish_step = step
                done.append(req)
                self.slots[i] = None
        # streamed (bypassed) blocks leave the device again
        with SP.span("serve.stream_out", step):
            for i, req in enumerate(self.slots):
                if req is None or not active[i]:
                    continue
                length = int(self.lens[i])
                for key in self._block_keys(req, min(length, self.ecfg.max_len)):
                    if not self.pool.is_resident(key) and key in self.host_store:
                        self._offload(key)
        return tokens

    # -- main loop --------------------------------------------------------------

    @torch.no_grad()
    def run(self, requests: List[Request], max_steps: int = 2000):
        pending = sorted(requests, key=lambda r: r.arrival)
        done: List[Request] = []
        ready_at = np.zeros(self.ecfg.max_slots)
        # a stalled slot's fetches are in flight: when they land, the
        # delayed decode commits with the streamed data (already restored
        # at access time) instead of re-running the residency transaction
        # — re-accessing would re-miss bypassed blocks forever and
        # livelock every mostly-miss sequence behind its own streaming
        fetch_pending = np.zeros(self.ecfg.max_slots, bool)
        tokens_out = 0
        step = 0
        while (pending or any(self.slots)) and step < max_steps:
            with SP.span("serve.step", step):
                tokens_out += self._step(step, pending, done, ready_at,
                                         fetch_pending)
            step += 1

        snap = self.pool.snapshot()
        in_flight = [r for r in self.slots if r is not None]
        lat = [r.finish_step - r.enqueue_step for r in done]
        ttft = [r.first_token_step - r.enqueue_step for r in done
                if r.first_token_step >= 0]
        # queue wait is its own metric (latency above starts at admission,
        # so it would otherwise vanish); admitted = done + still in flight
        qwait = [r.enqueue_step - r.arrival for r in done + in_flight]
        snap.update({
            "steps": step,
            "completed": len(done),
            "tokens_out": tokens_out,
            "throughput": tokens_out / max(step, 1),
            "mean_latency": float(np.mean(lat)) if lat else float("nan"),
            "p99_latency": float(np.percentile(lat, 99)) if lat else float("nan"),
            "mean_ttft": float(np.mean(ttft)) if ttft else float("nan"),
            "mean_queue_wait": float(np.mean(qwait)) if qwait else float("nan"),
            "p99_queue_wait": float(np.percentile(qwait, 99)) if qwait else float("nan"),
            # in-flight requests stall too — dropping them undercounted
            # exactly the runs where stalls matter (truncated, congested)
            "stall_steps": sum(r.stall_steps for r in done + in_flight),
        })
        return snap


def run_ab(cfg: ModelConfig, wl: ServeWorkload, pool_cfg: PoolConfig,
           ecfg: EngineConfig = EngineConfig(), seed: int = 0, *,
           device=None, backend: str = "auto"):
    """A/B the MeDiC pool manager against LRU on the same workload. Both
    engines run the same weights (drawn once from ``ecfg.seed``)."""
    dev = resolve_device(device)
    params = init_params(cfg, ecfg.seed, dev)
    out = {}
    for policy in ("lru", "medic"):
        pc = dataclasses.replace(pool_cfg, policy=policy)
        eng = ServeEngine(cfg, ecfg, pc, device=dev, backend=backend,
                          params=params)
        reqs = generate_requests(wl, seed=seed)
        out[policy] = eng.run(reqs)
        del eng
    return out
