"""Leap controller and paged-pool metadata (``repro.core`` counterparts)."""
