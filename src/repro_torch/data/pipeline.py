"""Deterministic synthetic LM data pipeline (a numpy copy of
``repro.data.pipeline``; its batches are the reference's, bit for bit).

Produces a *learnable* token stream (a noisy affine Markov chain over the
vocabulary) so end-to-end training visibly reduces the loss. Fully
deterministic in (seed, step): the iterator is checkpointed as a single
integer, and a restart resumes with the same batches.

``get_batch`` returns this process's slice of the global batch
(``process_index`` / ``process_count``); batches are host numpy arrays,
which the train step moves to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_noise: float = 0.15   # fraction of uniformly random tokens
    n_chains: int = 8            # distinct affine chains (mixture)


class SyntheticLM:
    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        if cfg.global_batch % process_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {process_count} processes")
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count
        v = cfg.vocab_size
        chain_rng = np.random.default_rng(cfg.seed)
        # affine maps next = (a * prev + c) % V, co-prime multipliers
        self._a = chain_rng.choice(np.arange(3, 1000, 2), cfg.n_chains)
        self._c = chain_rng.integers(1, v, cfg.n_chains)

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        v = cfg.vocab_size
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.process_index)
        b, s = self.local_batch, cfg.seq_len
        chain = rng.integers(0, cfg.n_chains, b)
        a = self._a[chain][:, None]
        c = self._c[chain][:, None]
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.random((b, s)) < cfg.markov_noise
        rand_toks = rng.integers(0, v, (b, s))
        for t in range(1, s):
            nxt = (a[:, 0] * toks[:, t - 1] + c[:, 0]) % v
            toks[:, t] = np.where(noise[:, t], rand_toks[:, t], nxt)
        return {"tokens": toks.astype(np.int32)}

    # -- checkpointable iterator ---------------------------------------------

    def iterator(self, start_step: int = 0) -> "CheckpointableIterator":
        return CheckpointableIterator(self, start_step)


class CheckpointableIterator:
    def __init__(self, ds: SyntheticLM, step: int = 0):
        self.ds = ds
        self.step = step

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.ds.get_batch(self.step)
        self.step += 1
        return batch

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]):
        self.step = int(state["step"])
