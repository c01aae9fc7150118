"""Runtime helpers (``repro.runtime`` counterparts): the step watchdog and
restart-from-checkpoint loop, the straggler monitor, and the page codec
(``runtime.compression``)."""

from .fault_tolerance import Watchdog, run_with_restarts
from .straggler import StepTimeMonitor

__all__ = ["Watchdog", "run_with_restarts", "StepTimeMonitor"]
