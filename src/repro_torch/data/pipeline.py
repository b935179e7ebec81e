"""Deterministic synthetic token pipeline (host-sharded, resumable).

The port's numpy-only copy of `repro.data.pipeline`: the same (seed,
step, host) gives the same batch, bit for bit, in both packages.

Production shape: each host materializes only its slice of the global
batch (``host_id``/``num_hosts``), the stream is a pure function of
(seed, step) so restarts resume exactly (the checkpoint stores `step`),
and a background prefetch thread hides generation latency.

The synthetic distribution is a mixture of Zipf unigrams and a Markov
bigram chain — enough structure that a 100M-param model's loss drops
well below the unigram entropy (the reference's examples/train_lm.py), so
training-loop correctness is visible in the curve.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    markov_order: bool = True


class SyntheticTokens:
    """Deterministic (seed, step) -> batch generator."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        assert cfg.global_batch % num_hosts == 0
        self.local_batch = cfg.global_batch // num_hosts
        root = np.random.default_rng(cfg.seed)
        # fixed unigram (Zipf) and a sparse "grammar" bigram table
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        self.next_tok = root.integers(
            0, cfg.vocab, size=(cfg.vocab, 4)).astype(np.int32)

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len) int32, deterministic in (step, host)."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, step, self.host_id, 0xD0E))
        B, S = self.local_batch, c.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.choice(c.vocab, size=B, p=self.unigram)
        follow = rng.random((B, S)) < 0.75
        branch = rng.integers(0, 4, size=(B, S))
        fresh = rng.choice(c.vocab, size=(B, S), p=self.unigram)
        for t in range(1, S):
            nxt = self.next_tok[toks[:, t - 1], branch[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, fresh[:, t])
        return toks

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded)."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            b = self.source.batch(s)
            try:
                self._q.put((s, b), timeout=1.0)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()


def unigram_entropy(cfg: DataConfig) -> float:
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    p = ranks ** (-cfg.zipf_a)
    p /= p.sum()
    return float(-(p * np.log(p)).sum())
