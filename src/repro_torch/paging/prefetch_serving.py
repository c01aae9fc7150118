"""Leap-prefetched page streaming: controller + hot buffer + ring, batched.

Counterpart of ``repro.paging.prefetch_serving``. A stream consumes pages
of a slow tier through a small hot buffer; every access feeds the stream's
Leap controller, whose candidates are fetched ahead of use. Two data paths
move the candidates:

* **sync** (:func:`stream_step`): the demand page and the candidates ride
  one blocking :func:`repro_torch.core.pool.pool_access` batch;
* **async** (:func:`stream_step_async`): :func:`pool_wait` lands due ring
  entries and serves the demand (hit, partial hit or miss), the controller
  runs, and :func:`pool_issue` parks the candidates in the in-flight ring
  with an arrival deadline ``geom.arrival_delay`` steps out. ``ring_size
  = 0`` delegates to the sync step, bit for bit.

Where the reference vmaps one stream's state, every leaf here carries a
leading stream dimension ``[S, ...]`` and one call advances all streams.
:func:`multi_stream_consume` with a finite ``link_budget`` on the async
path shares one link across the streams; it is the one-shard case of
:func:`repro_torch.paging.sharded_pool.sharded_multi_stream_consume` and
delegates there, as the reference does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.leap import DEFAULT_PW_MAX, leap_init, leap_step
from repro_torch.core.pool import (_payload_slots, _tree_map, pool_access,
                                   pool_init, pool_issue, pool_stats,
                                   pool_wait, ring_init)
from repro_torch.device import resolve_device

I32 = torch.int32


def _payload_checksum(data) -> torch.Tensor:
    """Per-stream checksum ``[S]`` of a served payload (a tensor or a dict
    of tensors with leaves ``[S, ...]``): each leaf's sum, summed across
    leaves in key order, as the reference's."""
    leaves = [data] if torch.is_tensor(data) else [data[k]
                                                   for k in sorted(data)]
    sums = [d.reshape(d.shape[0], -1).sum(-1) for d in leaves]
    return sum(sums[1:], sums[0])


@dataclasses.dataclass(frozen=True)
class PrefetchedStream:
    """Static geometry of one prefetched page stream (see the reference):
    slow-tier pages, hot slots (``>= 2 * (1 + pw_max)``), flattened payload
    elements a page, the controller's knobs, the async ring's capacity
    (``0``: the sync path) and the arrival delay in steps."""
    n_pages: int
    n_slots: int
    page_elems: int
    pw_max: int = DEFAULT_PW_MAX
    h_size: int = 32
    n_split: int = 8
    ring_size: int = 8
    arrival_delay: int = 1


def stream_init(geom: PrefetchedStream, dtype=torch.float32,
                payload_like=None, n_streams: int = 1, device=None) -> dict:
    """Fresh state of ``n_streams`` streams: ``leap``, ``pool_meta``,
    ``hot`` and ``ring``, every leaf with a leading stream dim.

    ``hot`` is ``[S, n_slots, page_elems]`` of ``dtype``, or, with
    ``payload_like`` (the slow tier: a tensor or a dict of ``[n_pages,
    ...]`` leaves), the same structure with leaves ``[S, n_slots, ...]``
    of the matching trailing shape and dtype, on the slow tier's device.
    """
    S = n_streams
    if payload_like is None:
        dev = resolve_device(device)
        hot = torch.zeros((S, geom.n_slots, geom.page_elems), dtype=dtype,
                          device=dev)
    else:
        hot = _tree_map(lambda c: torch.zeros(
            (S, geom.n_slots) + tuple(c.shape[1:]), dtype=c.dtype,
            device=c.device), payload_like)
        dev = (payload_like if torch.is_tensor(payload_like)
               else next(iter(payload_like.values()))).device
    return {
        "leap": leap_init(geom.h_size, (S,), dev),
        "pool_meta": pool_init(geom.n_pages, geom.n_slots, S, dev),
        "hot": hot,
        "ring": ring_init(geom.ring_size, S, dev),
    }


def stream_step(state: dict, pool_data, page: torch.Tensor,
                geom: PrefetchedStream):
    """Synchronous step: serve each stream's demand ``page [S]`` and fetch
    the controller's candidates in the same blocking batch.

    Returns ``(state, data, info)``: ``data`` the served payload (leaves
    ``[S, ...]``), ``info`` the ``[S]`` columns ``hit`` / ``pref_hit`` /
    ``partial_hit`` (always False here) / ``fetched`` / ``issued`` /
    ``landed`` (= ``issued``: the batch blocks) / ``deferred`` (0).
    """
    page = page.to(I32)
    meta = state["pool_meta"]
    S = page.shape[0]
    dev = page.device
    slot0 = torch.gather(meta["page_slot"], 1,
                         page.clamp(0, geom.n_pages - 1).long()[:, None])[:, 0]
    s_safe = slot0.clamp(min=0).long()[:, None]
    was_pref = ((slot0 >= 0)
                & torch.gather(meta["slot_prefetched"], 1, s_safe)[:, 0]
                & ~torch.gather(meta["slot_consumed"], 1, s_safe)[:, 0])
    new_leap, cands, valid = leap_step(state["leap"], page, was_pref,
                                       n_split=geom.n_split,
                                       pw_max=geom.pw_max)
    pages = torch.cat([page[:, None], cands], 1)
    is_pf = torch.cat([torch.zeros((S, 1), dtype=torch.bool, device=dev),
                       torch.ones_like(valid)], 1)
    val = torch.cat([torch.ones((S, 1), dtype=torch.bool, device=dev),
                     valid & (cands >= 0) & (cands < geom.n_pages)], 1)
    meta, hot, slots, info = pool_access(meta, state["hot"], pool_data,
                                         pages, is_pf, val)
    data = _payload_slots(hot, slots[:, 0])
    issued = info["fetched"][:, 1:].sum(1, dtype=I32)
    return ({**state, "leap": new_leap, "pool_meta": meta, "hot": hot},
            data, {"hit": info["hit"][:, 0],
                   "pref_hit": info["prefetched_hit"][:, 0],
                   "partial_hit": torch.zeros((S,), dtype=torch.bool,
                                              device=dev),
                   "fetched": info["fetched"][:, 0],
                   "issued": issued,
                   "landed": issued,
                   "deferred": torch.zeros((S,), dtype=I32, device=dev)})


def stream_step_async(state: dict, pool_data, page: torch.Tensor,
                      geom: PrefetchedStream):
    """Asynchronous step: wait (land due entries + serve the demand), run
    the controller (a partial hit counts as a prefetched hit), then issue
    its candidates with deadline ``now + geom.arrival_delay``. Same
    contract as :func:`stream_step`; ``ring_size == 0`` delegates to it."""
    if geom.ring_size == 0:
        new_state, data, info = stream_step(state, pool_data, page, geom)
        ring = dict(new_state["ring"])
        ring["now"] = ring["now"] + 1
        return {**new_state, "ring": ring}, data, info

    page = page.to(I32)
    meta, ring, hot = state["pool_meta"], state["ring"], state["hot"]
    now = ring["now"]
    deferred0 = meta["n_deferred"]
    meta, ring, hot, _, data, winfo = pool_wait(meta, ring, hot, pool_data,
                                                page, now)
    pref_feedback = winfo["prefetched_hit"] | winfo["partial_hit"]
    new_leap, cands, valid = leap_step(state["leap"], page, pref_feedback,
                                       n_split=geom.n_split,
                                       pw_max=geom.pw_max)
    val = valid & (cands >= 0) & (cands < geom.n_pages)
    issued0 = meta["n_prefetch_issued"]
    meta, ring = pool_issue(meta, ring, cands, val, now, geom.arrival_delay)
    ring = dict(ring)
    ring["now"] = now + 1
    return ({**state, "leap": new_leap, "pool_meta": meta, "hot": hot,
             "ring": ring},
            data, {"hit": winfo["hit"], "pref_hit": winfo["prefetched_hit"],
                   "partial_hit": winfo["partial_hit"],
                   "fetched": winfo["fetched"],
                   "issued": meta["n_prefetch_issued"] - issued0,
                   "landed": winfo["landed"].sum(1, dtype=I32),
                   "deferred": meta["n_deferred"] - deferred0})


INFO_KEYS = ("hit", "pref_hit", "partial_hit", "fetched", "issued", "landed",
             "deferred")


def stream_consume(pool_data, schedule: torch.Tensor, geom: PrefetchedStream,
                   state: dict | None = None, async_datapath: bool = False):
    """Run a whole access schedule through the streams.

    ``pool_data`` is the ``[n_pages, page_elems]`` slow tier or a dict of
    ``[n_pages, ...]`` leaves (the hot buffer mirrors it); ``schedule`` is
    ``int32[T]`` (one stream) or ``int32[S, T]``; ``state`` an optional
    state to continue from (default: fresh, on the slow tier's device).

    Returns ``(state, data_sums, info)``: the per-step payload checksums
    and ``info`` columns (:data:`INFO_KEYS`) shaped like ``schedule``;
    ``state`` keeps its leading stream dim. ``info`` is the wire format of
    :func:`repro_torch.obs.trace.decode_stream_events`.
    """
    one = schedule.dim() == 1
    sched = schedule[None] if one else schedule
    if state is None:
        state = (stream_init(geom, pool_data.dtype, n_streams=sched.shape[0],
                             device=pool_data.device)
                 if torch.is_tensor(pool_data) else
                 stream_init(geom, payload_like=pool_data,
                             n_streams=sched.shape[0]))
    step_fn = stream_step_async if async_datapath else stream_step
    sums, cols = [], {k: [] for k in INFO_KEYS}
    for t in range(sched.shape[1]):
        state, data, info = step_fn(state, pool_data, sched[:, t], geom)
        sums.append(_payload_checksum(data))
        for k in INFO_KEYS:
            cols[k].append(info[k])
    out = lambda xs: torch.stack(xs, 1)[0] if one else torch.stack(xs, 1)
    return state, out(sums), {k: out(cols[k]) for k in INFO_KEYS}


def multi_stream_consume(pool_data, schedules: torch.Tensor,
                         geom: PrefetchedStream, async_datapath: bool = False,
                         link_budget: int | None = None):
    """Concurrent streams ``schedules int32[S, T]`` over one slow tier.

    ``link_budget=None``: private infinite links, every stream independent.
    A finite budget on the async path (``ring_size > 0``) shares one link:
    demand fetches first, leftover landings in global issue order, the
    surplus deferred in the rings. On the sync path the budget changes no
    behaviour; the link totals ``link_demand_fetches`` /
    ``link_prefetch_issued`` / ``link_deferred`` ``[T]`` are added to
    ``info`` all the same.
    """
    if link_budget is not None and async_datapath and geom.ring_size > 0:
        return _multi_stream_consume_budgeted(pool_data, schedules, geom,
                                              int(link_budget))
    state, sums, info = stream_consume(pool_data, schedules, geom,
                                       async_datapath=async_datapath)
    if link_budget is not None:
        info = dict(info)
        info["link_demand_fetches"] = info["fetched"].sum(0, dtype=I32)
        info["link_prefetch_issued"] = info["issued"].sum(0, dtype=I32)
        info["link_deferred"] = info["deferred"].sum(0, dtype=I32)
    return state, sums, info


def _multi_stream_consume_budgeted(pool_data, schedules: torch.Tensor,
                                   geom: PrefetchedStream, link_budget: int):
    """The budgeted async path: the one-shard fabric of the sharded
    consume (one NIC carrying the whole budget, every page near)."""
    from repro_torch.paging.sharded_pool import (ShardedPoolCfg,
                                                 sharded_multi_stream_consume)
    delay = max(geom.arrival_delay, 1)
    fabric = ShardedPoolCfg(n_shards=1, placement="interleave",
                            link_budget=int(link_budget),
                            near_delay=delay, far_delay=delay)
    return sharded_multi_stream_consume(pool_data, schedules, geom, fabric)


def stream_stats(state: dict) -> dict:
    """Counter summary of one stream's state (leaves without the stream
    dim), with the issued-prefetch decomposition."""
    return pool_stats(state["pool_meta"], state.get("ring"))


def stream_stats_at(state: dict, i: int) -> dict:
    """:func:`stream_stats` of stream ``i`` of a stacked ``[S, ...]`` state."""
    one = {k: {n: t[i] for n, t in state[k].items()}
           for k in ("pool_meta", "ring") if k in state}
    return stream_stats(one)
