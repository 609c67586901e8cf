"""Synthetic token data pipeline: deterministic, shard-aware, prefetched.

A copy of ``repro/training/data.py`` (numpy only, so the port keeps its own):
the same seed and step give the same batch as the reference.

Real deployments stream tokenized shards per host; here the source is a
seeded PRNG stream with a Zipf-ish unigram distribution (so the loss curve
is non-trivial), but the *pipeline machinery* is production-shaped:

- per-host sharding (``host_id``/``num_hosts``) so each data-parallel host
  reads a disjoint stream,
- background prefetch thread with a bounded queue,
- deterministic resume: ``state_dict()``/``load_state_dict()`` capture the
  stream position so checkpoint-restore replays no batch twice.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticTokenDataset:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 17, host_id: int = 0, num_hosts: int = 1,
                 zipf_a: float = 1.3):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.zipf_a = zipf_a
        self._step = 0
        # Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._probs = ranks ** (-zipf_a)
        self._probs /= self._probs.sum()

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step * self.num_hosts + self.host_id)
            % (2**63))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng_for(step)
        # next-token structure: tokens shifted by one make the labels
        stream = rng.choice(self.vocab_size, size=(self.batch_size,
                                                   self.seq_len + 1),
                            p=self._probs)
        return {"tokens": stream[:, :-1].astype(np.int32),
                "labels": stream[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self._step)
            self._step += 1

    # -- deterministic resume -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self._step, "seed": self.seed,
                "host_id": self.host_id, "num_hosts": self.num_hosts}

    def load_state_dict(self, state: Dict) -> None:
        assert state["seed"] == self.seed, "resume with a different seed"
        self._step = int(state["step"])


class PrefetchIterator:
    """Background-thread prefetcher with bounded queue."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:      # propagate into consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
