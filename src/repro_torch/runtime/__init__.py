"""Runtime helpers (``repro.runtime`` counterparts)."""
