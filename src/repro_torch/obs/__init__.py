"""Registry and page-lifecycle event log (copies of ``repro.obs`` pieces)."""
