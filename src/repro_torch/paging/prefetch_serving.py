"""Stream counter summaries (``paging/prefetch_serving.py::stream_stats``).

The page-stream layer itself (``stream_init`` / ``stream_step`` / the
consume scans) is ported in a later slice.
"""

from __future__ import annotations

from repro_torch.core.pool import pool_stats


def stream_stats(state: dict) -> dict:
    """Counter summary of one stream's state (leaves without the stream
    dim), with the issued-prefetch decomposition."""
    return pool_stats(state["pool_meta"], state.get("ring"))


def stream_stats_at(state: dict, i: int) -> dict:
    """:func:`stream_stats` of stream ``i`` of a stacked ``[S, ...]`` state."""
    one = {k: {n: t[i] for n, t in state[k].items()}
           for k in ("pool_meta", "ring") if k in state}
    return stream_stats(one)
