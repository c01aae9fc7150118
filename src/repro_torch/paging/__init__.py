"""Paged KV cache and the tiered hot/cold data path (``repro.paging``)."""
