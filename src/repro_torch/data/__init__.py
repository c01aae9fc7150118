"""Data pipeline: sharded token streams with checkpointable state
(``repro.data``)."""

from .pipeline import (MemmapSource, PrefetchQueue, SyntheticSource,
                       TokenPipeline, make_pipeline)

__all__ = ["MemmapSource", "PrefetchQueue", "SyntheticSource",
           "TokenPipeline", "make_pipeline"]
