"""Continuous-batching serving over the tiered paged-KV data path."""

from .engine import (PINNED_COUNTERS, ServeConfig, ServingEngine,
                     build_executor, serve_continuous)
from .executor import ModelExecutor, SyntheticExecutor
from .request import DECODE, FINISHED, PREFILL, WAITING, Request
from .scheduler import AdmissionQueue, SlotScheduler

__all__ = ["PINNED_COUNTERS", "ServeConfig", "ServingEngine",
           "build_executor", "serve_continuous", "ModelExecutor",
           "SyntheticExecutor",
           "DECODE", "FINISHED", "PREFILL", "WAITING", "Request",
           "AdmissionQueue", "SlotScheduler"]
