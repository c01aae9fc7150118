"""Hand-written Hopper kernels of the port, each beside its plain version.

* :mod:`.gather_pages` — ``gather_pages`` / ``gather_pages_async``.
* :mod:`.paged_attention` — ``paged_attention`` /
  ``paged_attention_hot_slots`` (sync, or ``async_copy=True``).
* :mod:`.flash_attention` — ``flash_attention`` (GQA prefill).
* :mod:`.selective_scan` — ``selective_scan`` (the Mamba S6 forward).

The CUDA sources live in ``csrc/`` and build at first use
(:mod:`._build`); importing this package compiles nothing.
"""

from ._build import COUNTERS, counts, reset_counts

__all__ = ["COUNTERS", "counts", "reset_counts"]
