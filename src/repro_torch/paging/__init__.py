"""Paged KV cache, the tiered hot/cold data path, Leap-prefetched page
streams and expert paging (``repro.paging``)."""

from .expert_stream import ExpertPrefetcher

__all__ = ["ExpertPrefetcher"]
