"""Trace export: Chrome trace-event (Perfetto-loadable) JSON and JSONL.

The writers of ``repro.obs.export`` that the serving CLI's ``--trace``
uses:

* :func:`write_chrome_trace` — the Chrome trace-event format (the
  ``{"traceEvents": [...]}`` JSON object) that ``chrome://tracing`` and
  https://ui.perfetto.dev load directly. Each stream gets its own track
  (thread) of complete events laid out on the lock-step clock (one step =
  ``STEP_US`` µs of track time), each request its own track in a
  "requests" process, and the per-step link totals counter tracks in a
  "fabric link" process (one series a NIC on a sharded fabric).
* :func:`write_jsonl` / :func:`write_request_jsonl` — one event (or request
  phase) per line, for machine diffing.

Both are lossless over the :class:`repro_torch.obs.trace.Event` fields.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .trace import Event

#: Track-time layout of one lock step: wait/land phase, then demand
#: service, then issue. Fractions of ``STEP_US``.
_PHASE = {"land": 0.0, "defer": 0.05, "migrate": 0.15, "hit": 0.3,
          "partial": 0.3, "miss": 0.3, "invalidate": 0.55, "promote": 0.6,
          "demote": 0.65, "issue": 0.7, "drop": 0.7, "evict": 0.9}
_DUR = {"land": 0.25, "defer": 0.2, "migrate": 0.1, "hit": 0.2,
        "partial": 0.25, "miss": 0.35, "invalidate": 0.1, "promote": 0.05,
        "demote": 0.05, "issue": 0.25, "drop": 0.1, "evict": 0.1}

#: process ids as in the reference's traces
_STREAM_PID = 0
_LINK_PID = 1
_REQUEST_PID = 2

#: track time of one lock step, in µs
STEP_US = 1000.0


def _event_name(e: Event) -> str:
    if e.page >= 0:
        return f"{e.kind} p{e.page}"
    if e.count > 1:
        return f"{e.kind} x{e.count}"
    return e.kind


def write_chrome_trace(path: str, events, counters: dict | None = None,
                       request_phases=None) -> None:
    """Write the Chrome trace-event JSON object of an event stream to
    ``path``.

    ``counters``: optional ``{name: array}`` of per-step link totals —
    ``[T]`` arrays become one counter track, ``[T, G]`` arrays one
    multi-series track (a series a NIC); step ``t`` samples at ``t *
    STEP_US``. ``request_phases``: optional
    :class:`repro_torch.obs.trace.RequestPhase` records, one track per
    request id.
    """
    events = list(events)
    phases = list(request_phases or ())
    max_step = max((e.step for e in events), default=0)
    out = [{"ph": "M", "pid": _STREAM_PID, "name": "process_name",
            "args": {"name": "page streams"}},
           {"ph": "M", "pid": _LINK_PID, "name": "process_name",
            "args": {"name": "fabric link"}}]
    if phases:
        out.append({"ph": "M", "pid": _REQUEST_PID, "name": "process_name",
                    "args": {"name": "requests"}})
        for r in sorted({p.req for p in phases}):
            out.append({"ph": "M", "pid": _REQUEST_PID, "tid": r,
                        "name": "thread_name",
                        "args": {"name": f"request {r}"}})
    for s in sorted({e.stream for e in events}):
        out.append({"ph": "M", "pid": _STREAM_PID, "tid": s,
                    "name": "thread_name", "args": {"name": f"stream {s}"}})

    for p in phases:
        args = {"req": p.req, "slot": p.slot, "tokens": p.tokens,
                "start": p.start, "end": p.end}
        name = f"{p.kind} r{p.req}"
        if p.end > p.start:
            out.append({"ph": "X", "pid": _REQUEST_PID, "tid": p.req,
                        "ts": p.start * STEP_US,
                        "dur": (p.end - p.start) * STEP_US,
                        "name": name, "cat": p.kind, "args": args})
        else:
            out.append({"ph": "i", "s": "t", "pid": _REQUEST_PID,
                        "tid": p.req, "ts": p.start * STEP_US,
                        "name": name, "cat": p.kind, "args": args})

    for e in events:
        step = e.step if e.step >= 0 else max_step + 1   # summaries at end
        ts = step * STEP_US + _PHASE[e.kind] * STEP_US
        args = {"page": e.page, "shard": e.shard, "seq": e.seq,
                "count": e.count, "pref": e.pref, "step": e.step}
        if e.step < 0:
            out.append({"ph": "i", "s": "t", "pid": _STREAM_PID,
                        "tid": e.stream, "ts": ts, "name": _event_name(e),
                        "cat": e.kind, "args": args})
        else:
            out.append({"ph": "X", "pid": _STREAM_PID, "tid": e.stream,
                        "ts": ts, "dur": _DUR[e.kind] * STEP_US,
                        "name": _event_name(e), "cat": e.kind, "args": args})

    for name, arr in (counters or {}).items():
        arr = np.asarray(arr)
        for t in range(arr.shape[0]):
            if arr.ndim == 1:
                series = {"value": int(arr[t])}
            else:
                series = {f"nic{g}": int(arr[t, g])
                          for g in range(arr.shape[1])}
            out.append({"ph": "C", "pid": _LINK_PID, "name": name,
                        "ts": t * STEP_US, "args": series})

    with open(path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)


def write_jsonl(path: str, events) -> None:
    """One ``Event`` per line (its dataclass fields as a JSON object)."""
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(dataclasses.asdict(e)) + "\n")


def write_request_jsonl(path: str, phases) -> None:
    """One :class:`repro_torch.obs.trace.RequestPhase` per line."""
    with open(path, "w") as f:
        for p in phases:
            f.write(json.dumps(dataclasses.asdict(p)) + "\n")
