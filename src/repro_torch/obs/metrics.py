"""Counter/histogram registry + the percentile ladder (a copy of
``repro.obs.metrics`` whose span synchronises the CUDA device):

* :func:`percentile_ladder` — p50–p99.9 + avg/max over a sample, with an
  explicit ``n`` field and ``NaN`` (not 0.0) for the empty sample, so "no
  data" can never masquerade as "zero latency" in a downstream report.
* :class:`Registry` — named monotonically increasing counters and
  latency/size histograms; one registry per run, summarized once at the
  end. ``launch/serve.py`` builds its per-request TTFT + token-latency
  report on it.
* :meth:`Registry.span` — wall-clock span timer around device work. CUDA
  launches are asynchronous, so a naive ``perf_counter`` pair times the
  *enqueue*; when the span handle's ``sync`` holds a CUDA tensor (or a
  dict / list of them) the span calls ``torch.cuda.synchronize()`` inside
  the timed window, so the recorded duration covers the device work.

Everything here is host-side Python — nothing in this module is jitted or
traced, and nothing touches the hot data path.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

DEFAULT_QS = (50.0, 90.0, 99.0, 99.9)


def percentile_ladder(samples, qs=DEFAULT_QS) -> dict:
    """``{p50, ..., avg, max, n}`` of a sample; NaNs when ``n == 0``.

    The empty-sample contract is deliberate: an all-zeros ladder is
    indistinguishable from a genuinely zero-latency run, so empty samples
    report ``NaN`` for every statistic plus ``n=0`` — callers that want to
    render something print the ``n`` field or skip the row.
    """
    keys = [f"p{q:g}" for q in qs]
    if samples is None or len(samples) == 0:
        return {k: math.nan for k in keys} | {"avg": math.nan,
                                              "max": math.nan, "n": 0}
    arr = np.asarray(samples, dtype=np.float64)
    out = {k: float(np.percentile(arr, q)) for k, q in zip(keys, qs)}
    out["avg"] = float(arr.mean())
    out["max"] = float(arr.max())
    out["n"] = int(arr.size)
    return out


class Counter:
    """A named monotone counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += int(n)


class Histogram:
    """A named sample accumulator summarized as a percentile ladder."""

    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = name
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def extend(self, vs) -> None:
        self.samples.extend(float(v) for v in vs)

    @property
    def total(self) -> float:
        return float(sum(self.samples))

    def ladder(self, qs=DEFAULT_QS) -> dict:
        return percentile_ladder(self.samples, qs)


def _on_cuda(obj) -> bool:
    """True when ``obj`` is, or holds, a CUDA tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, dict):
        return any(_on_cuda(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_on_cuda(v) for v in obj)
    return False


class _SpanHandle:
    """Mutable box a :meth:`Registry.span` body parks its device result in.

    Setting ``sync`` to a CUDA tensor (or a dict / list of tensors) makes
    the span synchronise the device before stopping the clock, so the
    measured wall time includes the device work rather than its launch.
    """

    __slots__ = ("sync",)

    def __init__(self):
        self.sync = None


class Registry:
    """Named counters + histograms for one run; summarized at the end."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter(name)
        return self._counters[name]

    def histogram(self, name: str) -> Histogram:
        if name not in self._hists:
            self._hists[name] = Histogram(name)
        return self._hists[name]

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a block into histogram ``name`` (seconds), device-sync'd.

        >>> with reg.span("attention") as sp:
        ...     out = attention(...)
        ...     sp.sync = out          # block on the device result
        """
        handle = _SpanHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if _on_cuda(handle.sync):
                torch.cuda.synchronize()
            self.histogram(name).observe(time.perf_counter() - t0)

    def summary(self, qs=DEFAULT_QS) -> dict:
        """``{"counters": {name: int}, "histograms": {name: ladder}}``."""
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "histograms": {n: h.ladder(qs)
                           for n, h in sorted(self._hists.items())},
        }
