"""MoE expert paging: Leap over the router's expert-id access stream.

Counterpart of ``repro.paging.expert_stream``. For MoE archs the "page" is
an expert's weight block in the slow tier, the access stream the sequence
of expert ids the router emits. Skewed or correlated routing gives the
stream structure Leap can exploit; uniform-random routing is the Memcached
case, where Leap's contribution is *throttling*: it stops prefetching
instead of thrashing the buffer (paper §5.3.4).

:class:`ExpertPrefetcher` tracks one stream per (layer, slot), the
per-process isolation of §4.1, and exposes hit and pollution counters per
stream. With ``async_datapath=True`` the block fetches go through the
issue/wait in-flight ring: blocks speculated at routing step *t* arrive
during step *t+1*'s expert compute instead of stalling step *t*.

Where the reference's state is one stream's (vmapped for several), the
port's carries a leading stream dim ``[S, ...]``, as the stream layer's
(:mod:`repro_torch.paging.prefetch_serving`): :meth:`~ExpertPrefetcher.
fetch` serves ``[S]`` ids in one call, and the trace consumers loop over
time in Python where the reference scans.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.paging.prefetch_serving import (PrefetchedStream,
                                                 multi_stream_consume,
                                                 stream_init, stream_step,
                                                 stream_step_async)


@dataclasses.dataclass(frozen=True)
class ExpertPrefetcher:
    """Leap-managed hot buffer of expert weight blocks.

    Attributes:
      n_experts:   slow-tier size (router ids in ``[0, n_experts)``).
      n_hot:       experts resident at once (hot-buffer slots).
      block_elems: flattened expert weight block size (payload elements).
      pw_max:      prefetch-window cap; experts are big, so keep it tight.
      async_datapath: fetch blocks through the issue/wait ring instead of
                   the blocking batched path.
      ring_size:   in-flight ring capacity for the async path.
      link_budget: expert blocks a step the shared host link moves across
                   all concurrently consumed streams; applies to
                   :meth:`consume_route_traces`. ``None``: private
                   infinite links per stream.
    """
    n_experts: int
    n_hot: int
    block_elems: int
    pw_max: int = 2
    async_datapath: bool = False
    ring_size: int = 4
    link_budget: int | None = None

    def geom(self) -> PrefetchedStream:
        return PrefetchedStream(n_pages=self.n_experts, n_slots=self.n_hot,
                                page_elems=self.block_elems,
                                pw_max=self.pw_max, ring_size=self.ring_size)

    def init(self, dtype=torch.float32, device=None,
             n_streams: int = 1) -> dict:
        """Fresh state of ``n_streams`` streams (controller + hot buffer +
        ring), on ``device`` (``None``: CUDA)."""
        return stream_init(self.geom(), dtype, n_streams=n_streams,
                           device=device)

    def fetch(self, state: dict, expert_weights: torch.Tensor,
              expert_id: torch.Tensor):
        """Serve one routed expert id a stream: ``expert_id [S]`` ->
        ``(state, block [S, block_elems], info)``, ``info`` the ``[S]``
        columns of :func:`~repro_torch.paging.prefetch_serving.stream_step`.
        ``expert_weights`` is ``[n_experts, block_elems]``."""
        step = stream_step_async if self.async_datapath else stream_step
        return step(state, expert_weights, expert_id, self.geom())

    def consume_route_trace(self, state: dict, expert_weights: torch.Tensor,
                            ids: torch.Tensor):
        """Consume an expert-id trace, ``[T]`` (a one-stream state) or
        ``[S, T]``. Returns ``(state, info)``, ``info`` the bool columns
        ``hit`` / ``pref_hit`` / ``partial_hit`` (the last all False on the
        sync path), shaped like ``ids``."""
        one = ids.dim() == 1
        sched = ids[None] if one else ids
        cols = {"hit": [], "pref_hit": [], "partial_hit": []}
        for t in range(sched.shape[1]):
            state, _, info = self.fetch(state, expert_weights, sched[:, t])
            for k, v in cols.items():
                v.append(info[k])
        out = lambda xs: torch.stack(xs, 1)[0] if one else torch.stack(xs, 1)
        return state, {k: out(v) for k, v in cols.items()}

    def consume_route_traces(self, expert_weights: torch.Tensor,
                             ids: torch.Tensor):
        """Consume ``[S, T]`` routing traces of S concurrent streams, one
        per (layer, slot), whose block fetches share the host link: with
        ``link_budget`` set, demand fetches are arbitrated first each
        routing step and surplus speculated blocks arrive late
        (``deferred``); see :func:`~repro_torch.paging.prefetch_serving.
        multi_stream_consume`, whose ``(state, data_sums, info)`` this
        returns (leading ``[S]``)."""
        return multi_stream_consume(expert_weights, ids, self.geom(),
                                    async_datapath=self.async_datapath,
                                    link_budget=self.link_budget)
