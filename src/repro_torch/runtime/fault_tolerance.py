"""Fault tolerance: step watchdog + bounded-retry restart-from-checkpoint.

The contract at 1000+ nodes: any worker can die at any step; the job must
resume from the last committed checkpoint with a bit-exact loss trajectory
(the checkpoint carries the parameters, the optimizer state and the data
state; data batches are pure functions of step). ``run_with_restarts`` is
the single-process harness of that contract and is what the integration
test kills mid-run; the multi-host launcher wraps the same loop per host
with its cluster manager.

A copy of ``repro.runtime.fault_tolerance`` (pure Python): the port keeps
its own so that it imports nothing of the reference.
"""

from __future__ import annotations

import threading
import time


class Watchdog:
    """Fires ``on_stall`` if ``beat()`` isn't called within ``timeout`` s.

    At scale: one watchdog per host; on_stall escalates to the cluster
    manager (kill + reschedule). Here it surfaces hangs in tests.
    """

    def __init__(self, timeout: float, on_stall=None):
        self.timeout = timeout
        self.on_stall = on_stall or (lambda: None)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.stalled = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def _run(self):
        while not self._stop.is_set():
            if time.monotonic() - self._last > self.timeout:
                self.stalled = True
                self.on_stall()
                self._last = time.monotonic()
            time.sleep(min(0.05, self.timeout / 4))

    def stop(self):
        self._stop.set()
        # Join so no stale on_stall can fire after stop() returns (the old
        # daemon-thread leak made teardown racy under rapid test cycles).
        if self._thread.is_alive():
            self._thread.join(timeout=self.timeout + 1.0)


def run_with_restarts(make_state, train_one_step, save_state, restore_state,
                      n_steps: int, save_every: int, max_restarts: int = 3,
                      on_restart=None):
    """Drive training with checkpoint/restart semantics.

    make_state() -> state (fresh); restore_state() -> (state, step) or None;
    train_one_step(state, step) -> state  (may raise = node failure);
    save_state(state, step) -> None (atomic commit expected).

    Returns (state, restarts_used). Raises after ``max_restarts`` failures.
    """
    restarts = 0
    while True:
        restored = restore_state()
        if restored is None:
            state, step = make_state(), 0
        else:
            state, step = restored
        try:
            while step < n_steps:
                state = train_one_step(state, step)
                step += 1
                if step % save_every == 0 or step == n_steps:
                    save_state(state, step)
            return state, restarts
        except Exception:
            restarts += 1
            if on_restart:
                on_restart(restarts)
            if restarts > max_restarts:
                raise
