"""Sharded, deterministic, checkpointable token pipeline.

Design constraints for 1000+ node scale:

* **Determinism & restart**: batch contents are a pure function of
  (seed, step, host_id) — the pipeline's full checkpoint state is one
  integer, so restarts resume bit-exact (the checkpoint manifest stores it).
* **Host sharding**: each host materializes only its slice of the global
  batch (global_batch / n_hosts rows); no coordinator.
* **Straggler decoupling**: a bounded background :class:`PrefetchQueue`
  keeps ``depth`` batches in flight; a slow storage fetch stalls the queue,
  not the train step, and a ``timeout`` surfaces persistent stragglers to
  the runtime monitor instead of hanging silently.

Sources: :class:`SyntheticSource` (seeded LCG tokens — used by tests/
examples) and :class:`MemmapSource` (flat uint16/uint32 token files).

A copy of ``repro.data.pipeline`` (NumPy only): the port keeps its own so
that it imports nothing of the reference, and its batches are the
reference's, bit for bit. The trainer moves each batch to its device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


class SyntheticSource:
    """Deterministic pseudo-corpus: tokens = f(seed, step, host)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, host: int, rows: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host]))
        return rng.integers(0, self.vocab_size, (rows, seq + 1),
                            dtype=np.int32)


class MemmapSource:
    """Flat token file (np.memmap); rows strided by (step, host)."""

    def __init__(self, path: str, vocab_size: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size

    def batch(self, step: int, host: int, rows: int, seq: int) -> np.ndarray:
        n = len(self.tokens)
        out = np.empty((rows, seq + 1), np.int32)
        for r in range(rows):
            start = ((step * 1_000_003 + host * 7919 + r) * (seq + 1)) % max(
                1, n - seq - 1)
            out[r] = self.tokens[start:start + seq + 1]
        return out % self.vocab_size


class PrefetchQueue:
    """Bounded background prefetch with timeout-based straggler surfacing."""

    def __init__(self, fn, depth: int = 2, timeout: float = 60.0):
        self.fn = fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.timeout = timeout
        self._stop = threading.Event()
        self._exc: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        i = 0
        while not self._stop.is_set():
            try:
                item = self.fn(i)
            except Exception as e:          # surface in consumer
                self._exc = e
                break
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            i += 1

    def get(self):
        if self._exc:
            raise self._exc
        try:
            return self.q.get(timeout=self.timeout)
        except queue.Empty:
            raise TimeoutError(
                f"data prefetch stalled > {self.timeout}s (straggler?)")

    def stop(self):
        self._stop.set()


@dataclasses.dataclass
class TokenPipeline:
    """step-indexed batches for one host; state = next step index."""

    source: object
    global_batch: int
    seq_len: int
    n_hosts: int = 1
    host_id: int = 0
    step: int = 0                   # checkpointable

    @property
    def rows(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def peek(self, step: int) -> dict:
        toks = self.source.batch(step, self.host_id, self.rows, self.seq_len)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "mask": np.ones((self.rows, self.seq_len), np.float32)}

    def __next__(self) -> dict:
        b = self.peek(self.step)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.step = int(st["step"])


def make_pipeline(vocab_size: int, global_batch: int, seq_len: int,
                  n_hosts: int = 1, host_id: int = 0, seed: int = 0,
                  path: str | None = None) -> TokenPipeline:
    src = (MemmapSource(path, vocab_size) if path
           else SyntheticSource(vocab_size, seed))
    return TokenPipeline(src, global_batch, seq_len, n_hosts, host_id)
