"""Page-lifecycle event log: schema and the tiered-sweep decoder.

A copy of the framework-neutral parts of ``repro.obs.trace`` the port
needs: :class:`Event`, :class:`RequestPhase`, :func:`summary_events`,
:func:`decode_stream_events` (the page-stream layer's and the sharded
consume's mask-granularity ``info``), :func:`decode_sweep_events` (the
tiered sweep's counts) and :func:`events_to_counts`. Decoding is host-side
and post-hoc over numpy views of the port's tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Every page-lifecycle transition, in rough lifecycle order. The tier
#: lifecycle (DESIGN.md §12) adds ``migrate`` (home re-assignment granted
#: on leftover link capacity), ``demote`` (page compressed into the cold
#: tier) and ``promote`` (compressed page restored to the uncompressed far
#: tier by bytes moving for it).
KINDS = ("issue", "land", "defer", "drop", "hit", "partial", "miss",
         "invalidate", "evict", "migrate", "demote", "promote")

#: Kinds that carry a demand page and are compared page-by-page.
DEMAND_KINDS = ("hit", "partial", "miss", "invalidate")

#: Kinds the jitted decoders can only count per (step, stream).
AGGREGATE_KINDS = ("issue", "land", "defer", "migrate", "demote", "promote")

#: Kinds that cannot be placed in time host-side: per-stream run totals.
SUMMARY_KINDS = ("drop", "evict")


@dataclasses.dataclass(frozen=True)
class Event:
    """One page-lifecycle transition.

    Attributes:
      kind:   one of :data:`KINDS`.
      step:   global step index (``-1`` for end-of-run summary events).
      stream: owning stream.
      page:   page id; ``-1`` when the producer only knows a count
              (aggregate events decoded from jitted info arrays).
      shard:  the page's home shard (``-1`` when unsharded/unknown).
      seq:    global issue-order stamp (``-1`` when unknown).
      count:  multiplicity — aggregate events decoded from count arrays
              carry ``count > 1``; page-level events always ``count = 1``.
      pref:   the access hit a *prefetched* entry (``hit`` events only;
              ``partial`` implies it).
    """
    kind: str
    step: int
    stream: int
    page: int = -1
    shard: int = -1
    seq: int = -1
    count: int = 1
    pref: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; "
                             f"expected one of {KINDS}")


#: Request-lifecycle phase kinds, in lifecycle order (DESIGN.md §10).
REQUEST_PHASES = ("admit", "prefill_chunk", "decode", "evict")


@dataclasses.dataclass(frozen=True)
class RequestPhase:
    """One span of a request's serving lifecycle, keyed by *request id*.

    The page-lifecycle :class:`Event` stream is keyed by stream/slot index,
    which continuous batching recycles across requests; this record is the
    slot-reuse-proof view — ``req`` is the global request id, so a
    request's admit wait, prefill chunks, decode window and eviction stay
    one contiguous track no matter which slots served it.

    Attributes:
      kind:   one of :data:`REQUEST_PHASES`.
      req:    global request id.
      start:  first engine step of the phase (for ``admit``: arrival step).
      end:    engine step the phase completed (exclusive for spans;
              ``end == start`` renders as an instant, e.g. ``evict``).
      slot:   serving slot during the phase (``-1`` while waiting).
      tokens: tokens processed in the phase (prefill chunk size / decoded
              token count; 0 where meaningless).
    """
    kind: str
    req: int
    start: int
    end: int
    slot: int = -1
    tokens: int = 0

    def __post_init__(self):
        if self.kind not in REQUEST_PHASES:
            raise ValueError(f"unknown request phase {self.kind!r}; "
                             f"expected one of {REQUEST_PHASES}")


def home_of_host(page: int, n_pages: int, n_shards: int,
                 placement: str) -> int:
    """Host-side ``page_home`` (same formula, plain ints); ``-1`` on one
    shard."""
    if n_shards <= 1:
        return -1
    p = min(max(int(page), 0), n_pages - 1)
    if placement == "interleave":
        return p % n_shards
    return p // (n_pages // n_shards)


def summary_events(final_stats, step: int = -1) -> list[Event]:
    """End-of-run ``drop``/``evict`` summary events from per-stream stats.

    ``final_stats`` is a list of per-stream counter dicts shaped like
    ``repro.core.pool.pool_stats`` output.
    """
    out = []
    for s, ps in enumerate(final_stats):
        drops = int(ps.get("ring_drops", 0))
        if drops:
            out.append(Event("drop", step, s, count=drops))
        pollution = int(ps.get("pollution", 0))
        if pollution:
            out.append(Event("evict", step, s, count=pollution))
    return out


def decode_stream_events(schedules, info, *, n_pages: int,
                         final_stats=None, n_shards: int = 1,
                         placement: str = "interleave",
                         step_offset: int = 0) -> list[Event]:
    """Expand mask-granularity ``[S, T]`` stream info into events.

    ``schedules`` is the ``[S, T]`` demand page ids (``[T]`` for one
    stream), ``info`` the info of ``stream_consume`` /
    ``multi_stream_consume`` / ``sharded_multi_stream_consume``.
    ``n_pages`` / ``n_shards`` / ``placement`` stamp each demand event's
    home shard. Per step: ``land`` / ``defer`` aggregates (the wait
    phase), ``migrate`` grants, each stream's demand event (``hit`` /
    ``partial`` / ``miss``, page-level), the ``promote`` / ``demote`` tier
    transitions, then ``issue`` aggregates; with ``final_stats`` the
    ``drop`` / ``evict`` run totals follow at ``step = -1``. The tier
    kinds come only from a run that carried the §12 lifecycle's info
    (``info["migrated"]`` and the rest).
    """
    sched = np.asarray(schedules)
    if sched.ndim == 1:
        sched = sched[None]
    S, T = sched.shape
    hit = np.asarray(info["hit"]).reshape(S, T)
    pref = np.asarray(info["pref_hit"]).reshape(S, T)
    part = np.asarray(info["partial_hit"]).reshape(S, T)
    issued = np.asarray(info["issued"]).reshape(S, T)
    landed = np.asarray(info["landed"]).reshape(S, T)
    deferred = np.asarray(info["deferred"]).reshape(S, T)
    migrated = promoted = demoted = None
    if "migrated" in info:
        migrated = np.asarray(info["migrated"]).reshape(S, T)
        promoted = np.asarray(info["promoted"]).reshape(S, T)
        demoted = np.asarray(info["demoted"]).reshape(T)
    home = lambda p: home_of_host(p, n_pages, n_shards, placement)

    events = []
    for t in range(T):
        step = step_offset + t
        for s in range(S):
            if landed[s, t]:
                events.append(Event("land", step, s,
                                    count=int(landed[s, t])))
            if deferred[s, t]:
                events.append(Event("defer", step, s,
                                    count=int(deferred[s, t])))
        if migrated is not None:
            for s in range(S):
                if migrated[s, t]:
                    events.append(Event("migrate", step, s,
                                        count=int(migrated[s, t])))
        for s in range(S):
            p = int(sched[s, t])
            if part[s, t]:
                events.append(Event("partial", step, s, page=p,
                                    shard=home(p), pref=True))
            elif hit[s, t]:
                events.append(Event("hit", step, s, page=p, shard=home(p),
                                    pref=bool(pref[s, t])))
            else:
                events.append(Event("miss", step, s, page=p, shard=home(p)))
        if migrated is not None:
            for s in range(S):
                if promoted[s, t]:
                    events.append(Event("promote", step, s,
                                        count=int(promoted[s, t])))
            if demoted[t]:
                # a pool-wide capacity decision, owned by no stream:
                # attributed to stream 0, as the reference does
                events.append(Event("demote", step, 0,
                                    count=int(demoted[t])))
        for s in range(S):
            if issued[s, t]:
                events.append(Event("issue", step, s,
                                    count=int(issued[s, t])))
    if final_stats is not None:
        events.extend(summary_events(final_stats))
    return events


def decode_sweep_events(info, *, final_stats=None,
                        step_offset: int = 0) -> list[Event]:
    """Expand count-granularity ``[S, n_chunks]`` tiered-sweep info.

    The sweep's info is per-chunk *counts* (a chunk bundles ``geom.chunk``
    demand pages), so every event here is an aggregate (``page = -1``)
    with ``count`` = the chunk's tally; ``step`` is the global chunk step
    ``step_offset + chunk_index`` — pass the stream clock (``ring["now"]``
    before the sweep, = decode_step * n_chunks in the serving loop) to
    stitch successive sweeps onto one time axis. Event-count identities
    are the same as :func:`decode_stream_events` (``#miss = fetched -
    partial``; ``hit`` excludes partials).
    """
    hit = np.asarray(info["hit"])
    pref = np.asarray(info["pref_hit"])
    part = np.asarray(info["partial_hit"])
    fetched = np.asarray(info["fetched"])
    issued = np.asarray(info["issued"])
    landed = np.asarray(info["landed"])
    deferred = np.asarray(info["deferred"])
    S, n_chunks = hit.shape

    events = []
    for c in range(n_chunks):
        step = step_offset + c
        for s in range(S):
            if landed[s, c]:
                events.append(Event("land", step, s, count=int(landed[s, c])))
            if deferred[s, c]:
                events.append(Event("defer", step, s,
                                    count=int(deferred[s, c])))
        for s in range(S):
            n_part = int(part[s, c])
            n_full = int(hit[s, c])          # `hit` excludes partials
            n_miss = int(fetched[s, c]) - n_part
            n_pref = int(pref[s, c])
            if n_part:
                events.append(Event("partial", step, s, count=n_part,
                                    pref=True))
            if n_pref:
                events.append(Event("hit", step, s, count=n_pref, pref=True))
            if n_full - n_pref > 0:
                events.append(Event("hit", step, s, count=n_full - n_pref))
            if n_miss > 0:
                events.append(Event("miss", step, s, count=n_miss))
        for s in range(S):
            if issued[s, c]:
                events.append(Event("issue", step, s, count=int(issued[s, c])))
    if final_stats is not None:
        events.extend(summary_events(final_stats))
    return events


def events_to_counts(events, n_streams: int) -> list[dict]:
    """Fold an event stream back into per-stream counter dicts.

    Returns one dict per stream with the ``pool_stats``-aligned keys
    ``hits`` / ``misses`` / ``partial_hits`` / ``prefetch_hits`` /
    ``prefetch_issued`` / ``landed`` / ``deferred`` / ``ring_drops`` /
    ``pollution`` / ``invalidated`` — the bridge the event↔counter pins in
    ``tests/test_obs.py`` and ``serve.py``'s trace-totals check walk.
    """
    out = [dict(hits=0, misses=0, partial_hits=0, prefetch_hits=0,
                prefetch_issued=0, landed=0, deferred=0, ring_drops=0,
                pollution=0, invalidated=0, migrations=0, demotions=0,
                promotions=0) for _ in range(n_streams)]
    for e in events:
        c = out[e.stream]
        n = e.count
        if e.kind == "hit":
            c["hits"] += n
            if e.pref:
                c["prefetch_hits"] += n
        elif e.kind == "partial":
            c["hits"] += n
            c["prefetch_hits"] += n
            c["partial_hits"] += n
        elif e.kind == "miss":
            c["misses"] += n
        elif e.kind == "issue":
            c["prefetch_issued"] += n
        elif e.kind == "land":
            c["landed"] += n
        elif e.kind == "defer":
            c["deferred"] += n
        elif e.kind == "drop":
            c["ring_drops"] += n
        elif e.kind == "evict":
            c["pollution"] += n
        elif e.kind == "invalidate":
            c["invalidated"] += n
        elif e.kind == "migrate":
            c["migrations"] += n
        elif e.kind == "demote":
            c["demotions"] += n
        elif e.kind == "promote":
            c["promotions"] += n
    return out
