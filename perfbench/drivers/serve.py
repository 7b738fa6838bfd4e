"""Serving cells: the port's ``ServeEngine`` with its MeDiC pool, driven
by the benchmark's traffic, timed from outside.

Set-up draws the weights on the card from the seed, builds the serving
kernels, warms a throwaway engine on two requests of the mix, and builds
the measured engine. The window is the engine's own ``run`` over the
generated requests. The benchmark wraps the engine *instance*'s
``_admit`` and ``_decode_step`` and its model's ``prefill`` and
``decode`` (attributes set on the objects; the program's files are not
touched): they stamp each admission's start, each decode step's end
(after a synchronise, as reading the tokens back would), the rows that
got a token, the program's greedy token of every row and the logits of
every prefill's last position. When the window has closed, the next
admission or decode step raises ``WindowClosed`` instead of running.

Then, with the program's state freed, the window is judged: a replay of
the engine's control flow on a plain pool (``reference.serve_replay``)
must give the same per-request and pool counters, and a sample of the
finished requests, drawn from the seed and holding the longest, is run
through the float32 reference (``reference.qwen3``): every served
token's reference logit must lie within ``token_gap`` of the
reference's best, and each prefill's logits within
``prefill_logit_err`` (max gap over the reference's RMS).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np

from perfbench.harness.run import (LayerContext, RunContext, RunResult,
                                   WindowClosed)
from perfbench.harness.stats import p95
from perfbench.harness.trace import DeviceTrace, Spans
from perfbench.reference import qwen3 as Q
from perfbench.reference import serve_replay as R
from perfbench.reference import traffic as T

KERNELS = ("flash_attention", "decode_attention", "medic_gather")


def model_config(c: dict):
    """The program's ``ModelConfig`` of a configuration file (keys as in
    the model's published ``config.json``)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=c["name"], family="dense", num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], head_dim=c["head_dim"],
        qkv_bias=c["attention_bias"], qk_norm=True,
        rope_theta=float(c["rope_theta"]),
        tie_embeddings=c["tie_word_embeddings"], norm_eps=c["rms_norm_eps"],
        dtype=c["torch_dtype"], act=c["hidden_act"], remat=False)


class _Recorder:
    """What the wrappers saw."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.admit_t: Dict[int, int] = {}
        self.prefill_len: Dict[int, int] = {}
        self.prefill_logits: Dict[int, object] = {}
        self.steps: List[tuple] = []           # (t0, t1, rows, lens)
        self.argmax: List[object] = []         # device [slots] a step
        self.cur = -1
        self.stop = None
        self.t_stop = 0
        self.n_admit = self.n_decode = 0
        self.pool_calls = 0


def _install(eng, rec: _Recorder, t_end: int, spans: Spans,
             trace: DeviceTrace, t_trace: int, sync, stall_total) -> dict:
    """Wrap the engine instance's admission and decode step and its
    model's prefill and decode. Returns the trace bookkeeping."""
    orig_admit, orig_step = eng._admit, eng._decode_step
    orig_prefill, orig_decode = eng.model.prefill, eng.model.decode
    orig_access = eng.pool.access
    tracing = trace is not None
    mark: dict = {}

    def span(name):
        return spans.span(name) if tracing and trace.running \
            else contextlib.nullcontext()

    def closed(kind: str, n: int) -> None:
        t = time.perf_counter_ns()
        if t >= t_end:
            rec.stop, rec.t_stop = (kind, n), t
            raise WindowClosed
        if tracing and not trace.running and t >= t_trace:
            trace.start()
            mark["steps"], mark["admits"] = rec.n_decode, rec.n_admit
            mark["pool_calls"] = rec.pool_calls
            mark["fetches"] = eng.pool.fetches
            mark["stalls"] = stall_total()

    def admit(req, slot, step):
        closed("admit", rec.n_admit)
        rec.admit_t[req.rid] = time.perf_counter_ns()
        rec.cur = req.rid
        with span("admit (prefill)"):
            orig_admit(req, slot, step)
        rec.n_admit += 1

    def prefill(batch, cache):
        logits, c = orig_prefill(batch, cache)
        rec.prefill_len[rec.cur] = int(batch["tokens"].shape[1])
        rec.prefill_logits[rec.cur] = logits[0].clone()
        return logits, c

    def decode_step(active):
        closed("decode", rec.n_decode)
        t0 = time.perf_counter_ns()
        rows = [eng.slots[i].rid if active[i] else -1
                for i in range(rec.n_slots)]
        lens = eng.lens.copy()
        with span("decode step"):
            orig_step(active)
            sync()
        rec.steps.append((t0, time.perf_counter_ns(), rows, lens))
        rec.n_decode += 1

    def decode(tokens, cache, page=None):
        logits, new = orig_decode(tokens, cache, page=page)
        rec.argmax.append(logits.argmax(-1))
        return logits, new

    def access(*args, **kwargs):
        rec.pool_calls += 1
        with span("pool.access"):
            return orig_access(*args, **kwargs)

    eng._admit, eng._decode_step = admit, decode_step
    eng.model.prefill, eng.model.decode = prefill, decode
    if tracing:
        eng.pool.access = access
    return mark


def window_metrics(steps, admit_t: Dict[int, int], t0: int, t_stop: int):
    """The serving end-to-end metrics of a window [t0, t_stop] (ns):
    tokens decoded over the whole window; the 95th percentile of every
    gap between a request's consecutive tokens; the 95th percentile,
    over every request admitted in the window that got its first token
    in it, of the time from its admission's start to the end of that
    token's decode step. ``steps`` holds (start, end, rows, lens) of each
    decode step, ``rows`` the rid that got a token in each slot (-1:
    none)."""
    tok_t: Dict[int, List[int]] = {}
    for _, t1, rows, _ in steps:
        for rid in rows:
            if rid >= 0:
                tok_t.setdefault(rid, []).append(t1)
    n_tokens = sum(len(v) for v in tok_t.values())
    itl = [(b - a) / 1e6 for ts in tok_t.values() for a, b in zip(ts, ts[1:])]
    ttft = [(ts[0] - admit_t[rid]) / 1e6 for rid, ts in tok_t.items()
            if rid in admit_t]
    window_s = (t_stop - t0) / 1e9
    return ({"serve_tok_s": n_tokens / window_s, "itl_p95_ms": p95(itl),
             "ttft_p95_ms": p95(ttft)},
            {"tokens": n_tokens, "itl_samples": len(itl),
             "ttft_samples": len(ttft)})


def _requests_of(eng_reqs) -> Dict[int, dict]:
    return {r.rid: {f: getattr(r, f) for f in R.REQUEST_FIELDS}
            for r in eng_reqs if r.slot >= 0}


def run(rc: RunContext) -> RunResult:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving import engine as ENG
    from repro_torch.serving.pool import PoolConfig
    from repro_torch.serving.request import Request

    cell, cj = rc.cell, rc.config
    dev = torch.device(rc.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = model_config(cj)
    ecfg = ENG.EngineConfig(**cell["engine"])
    pool_cfg = PoolConfig(**cell["pool"])
    traffic = cell["mix"]

    # ---- set-up ----------------------------------------------------------
    if dev.type == "cuda":
        _build.build_all(list(KERNELS))
    weights = Q.make_weights(cj, rc.seed, dev)
    cards = T.deck(traffic)
    order = np.argsort([c["prompt_len"] + c["shared_prefix_len"]
                        for c in cards])
    warm = [Request(rid=100000 + k, arrival=0.0, **cards[int(j)])
            for k, j in enumerate((order[0], order[-1]))]
    eng = ENG.ServeEngine(cfg, ecfg, pool_cfg, device=dev, params=weights)
    eng.run(warm, max_steps=cell["warm_steps"])
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reqs = T.generate(traffic, rc.seed)
    eng_reqs = [Request(**dataclasses.asdict(r)) for r in reqs]
    eng = ENG.ServeEngine(cfg, ecfg, pool_cfg, device=dev, params=weights)
    trace = DeviceTrace() if rc.trace else None
    if trace is not None:
        trace.warm()
    spans = Spans()
    rec = _Recorder(ecfg.max_slots)
    sync()
    t0 = time.perf_counter_ns()
    t_end = t0 + int(rc.seconds * 1e9)
    t_trace = t_end - int(min(cell["trace_seconds"], rc.seconds) * 1e9)
    mark = _install(eng, rec, t_end, spans, trace, t_trace, sync,
                    lambda: sum(r.stall_steps for r in eng_reqs))
    ENG.COUNTS.reset()
    setup_s = t0 / 1e9 - rc.t_start

    # ---- the window -------------------------------------------------------
    try:
        eng.run(eng_reqs, max_steps=1 << 40)
        raise RuntimeError("the traffic ran out before the window closed; "
                           "raise n_requests")
    except WindowClosed:
        pass
    summary = trace.stop() if trace is not None and trace.running else None
    window_s = (rec.t_stop - t0) / 1e9
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # ---- end-to-end metrics ------------------------------------------------
    e2e, tally = window_metrics(rec.steps, rec.admit_t, t0, rec.t_stop)
    e2e["setup_s"] = setup_s

    # ---- what the program did, read before its state is freed ------------
    program = dict(
        requests=_requests_of(eng_reqs),
        pool=dict(fetches=eng.pool.fetches,
                  bypassed_blocks=eng.pool.bypassed_blocks,
                  evictions_by_type=eng.pool.evictions_by_type.copy(),
                  resident_blocks=int((eng.pool._slot >= 0).sum()),
                  seq_type=eng.pool.seq_type.copy(),
                  hits=eng.pool.hits.copy(),
                  accesses=eng.pool.accesses.copy()),
        counts=dict(admissions=ENG.COUNTS.admissions,
                    decode_steps=ENG.COUNTS.decode_steps,
                    offloads=ENG.COUNTS.offloads,
                    restores=ENG.COUNTS.restores))
    argmax = (torch.stack(rec.argmax).cpu().numpy() if rec.argmax
              else np.zeros((0, ecfg.max_slots), np.int64))
    served: Dict[int, List[int]] = {}
    for k, (_, _, rows, _) in enumerate(rec.steps):
        for i, rid in enumerate(rows):
            if rid >= 0:
                served.setdefault(rid, []).append(int(argmax[k, i]))
    by_rid = {r.rid: r for r in reqs}
    finished = [rid for rid, toks in served.items()
                if len(toks) == by_rid[rid].decode_len]
    if not finished:
        raise RuntimeError("no request finished in the window: nothing to "
                           "judge; lengthen the window")
    rng = np.random.default_rng(rc.seed)
    chk = cell["check"]
    longest = max(finished, key=lambda r: (
        by_rid[r].prompt_len + by_rid[r].shared_prefix_len
        + by_rid[r].decode_len, -r))
    sample = [longest]
    for rid in rng.permutation(sorted(set(finished) - {longest})):
        if (sum(by_rid[r].decode_len for r in sample) >= chk["min_tokens"]
                and len(sample) >= chk["min_requests"]):
            break
        sample.append(int(rid))
    prefill = {rid: rec.prefill_logits[rid].float().cpu() for rid in sample}

    layer = None
    if summary is not None:
        steps = rec.steps[mark["steps"]:]
        admits = [rid for rid in list(rec.admit_t)[mark["admits"]:]
                  if rid in rec.prefill_len]
        stalls = sum(r.stall_steps for r in eng_reqs)
        layer = LayerContext(
            trace=summary, spans=spans,
            counts=dict(
                decode_steps=len(steps),
                admissions=len(admits),
                tokens=sum(sum(1 for r in rows if r >= 0)
                           for _, _, rows, _ in steps),
                pool_accesses=rec.pool_calls - mark["pool_calls"],
                pool_fetches=eng.pool.fetches - mark["fetches"],
                stall_steps=stalls - mark["stalls"]),
            calls=dict(
                decode=[[min(int(n) + 1, ecfg.max_len) for n in lens]
                        for _, _, _, lens in steps],
                decode_active=[[int(n) for n, r in zip(lens, rows) if r >= 0]
                               for _, _, rows, lens in steps],
                prefill=[rec.prefill_len[rid] for rid in admits]),
            config=cj)

    # ---- free the program's state, then judge -----------------------------
    stop, steps_all = rec.stop, rec.steps
    del eng, rec, weights
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = R.replay(reqs, cell["engine"], cell["pool"], stop)
    off = R.compare(program, ref)
    gap, err = _judge(cj, rc.seed, dev, sample, by_rid, served, prefill)
    checks = [("token_gap", gap, chk["limits"]["token_gap"]),
              ("prefill_logit_err", err, chk["limits"]["prefill_logit_err"]),
              ("control_flow_off", float(len(off)),
               chk["limits"]["control_flow_off"])]
    dur = sorted((t1 - t) / 1e6 for t, t1, _, _ in steps_all)
    notes = {"decode_step_ms_p10_p50_p90": [
                 dur[len(dur) // 10], dur[len(dur) // 2],
                 dur[9 * len(dur) // 10]] if dur else None,
             "sample_requests": len(sample),
             "sample_tokens": sum(len(served[r]) for r in sample),
             "window_s": window_s, **tally}
    if off:
        notes["control_flow_diffs"] = off[:5]
    return RunResult(e2e=e2e, checks=checks, attempted=len(program[
        "requests"]), failed=0, memory_peak_bytes=int(peak), layer=layer,
        notes=notes)


def reference_gaps(cj: dict, weights, req: T.Req, tokens: List[int],
                   prefill_logits, fp8: bool = False):
    """The reference's judgement of one request: the gap of each served
    token (the prefill's greedy token first, then each decode step's)
    and the prefill logits' largest error over the reference's RMS. The
    engine feeds token 0 at every decode step, so decode step k reads
    position n + k - 1 of the prompt followed by zeros."""
    import torch
    dev = weights["embed"].device
    toks = T.prompt_tokens(req, cj["vocab_size"])
    n = len(toks)
    seq = torch.from_numpy(np.concatenate(
        [toks, np.zeros(req.decode_len, np.int64)])).to(dev)
    logits = Q.forward_logits(cj, weights, seq,
                              list(range(n - 1, n + req.decode_len)), fp8=fp8)
    first = prefill_logits.to(dev)
    rms = logits[0].pow(2).mean().sqrt()
    err = float((first - logits[0]).abs().max() / rms)
    served = torch.tensor([int(first.argmax())] + list(tokens), device=dev)
    return Q.served_gaps(logits, served), err


def _judge(cj, seed, dev, sample, by_rid, served, prefill):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = {k: v.float() for k, v in Q.make_weights(cj, seed, dev).items()}
    gap = err = 0.0
    with torch.no_grad():
        for rid in sample:
            gaps, e = reference_gaps(cj, weights, by_rid[rid], served[rid],
                                     prefill[rid])
            gap, err = max(gap, max(gaps)), max(err, e)
    return gap, err
