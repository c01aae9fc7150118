"""Runtime helpers (``repro.runtime`` counterparts): the step watchdog and
restart-from-checkpoint loop, the straggler monitor, and the int8 codecs
(``runtime.compression``: the error-feedback gradient codec with
``compressed_psum``, and the page codec)."""

from .compression import (compress_int8, compressed_psum, decompress_int8,
                          init_error_feedback)
from .fault_tolerance import Watchdog, run_with_restarts
from .straggler import StepTimeMonitor

__all__ = ["Watchdog", "run_with_restarts", "StepTimeMonitor",
           "compress_int8", "decompress_int8", "init_error_feedback",
           "compressed_psum"]
