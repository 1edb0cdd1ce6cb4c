"""Liveness watchdog: a hung step must kill the process, not freeze it (the
port's copy of picotron_tpu/resilience/watchdog.py).

A wedged kernel or a stuck data read leaves the step loop blocked forever
with no signal: the job burns its reservation until a human notices. The
watchdog is a daemon thread that expects the step loop to `beat()` at
each phase (data fetch, step, metric sync, eval, save); when no beat
arrives within the configured timeout it emits a `watchdog_timeout`
event (booked as data_wait when the data phase hung, else other), dumps
the flight recorder's postmortem (telemetry/flightdeck, reason
`reason`: "watchdog" by default, "serve_hang" from the serving engine and
fleet), dumps every thread's Python stack plus the
last-known (phase, step) to stderr and exits `EXIT_WATCHDOG`, so an
external supervisor restarts the job into checkpoint auto_resume.

The driver arms the watchdog only after the first step completes: step 1
includes the kernels' nvcc build and cuBLAS set-up, whose duration is
unbounded. Exit uses os._exit: the whole premise is that the main thread
is stuck, so cleanup handlers cannot be trusted to run.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

from picotron_tpu_torch.telemetry import bus

EXIT_WATCHDOG = 77

# Active instances, so out-of-loop waits (retry backoff sleeps) can
# heartbeat without plumbing a watchdog handle through every layer.
_ACTIVE: list["Watchdog"] = []


def touch(phase: str = "touch", step: Optional[int] = None) -> None:
    """Beat every active watchdog (no-op when none is armed)."""
    for w in list(_ACTIVE):
        w.beat(phase, step)


def active() -> bool:
    """Whether any watchdog is armed (lets a caller skip building a
    phase label for `touch` when none would read it)."""
    return bool(_ACTIVE)


class Watchdog:
    def __init__(self, timeout: float,
                 on_timeout: Optional[Callable[[], None]] = None,
                 poll: Optional[float] = None,
                 reason: str = "watchdog"):
        self.timeout = timeout
        self.enabled = timeout > 0
        self._on_timeout = on_timeout
        # the postmortem's reason: the serving engine and fleet arm with
        # "serve_hang", so a hung decode dispatch reads apart from a
        # wedged training step in the dump
        self.reason = reason
        self._poll = (poll or max(0.05, min(timeout / 4.0, 1.0))
                      if self.enabled else 1.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last = (time.monotonic(), "init", None)

    @property
    def started(self) -> bool:
        return self._thread is not None

    def beat(self, phase: str, step: Optional[int] = None) -> None:
        # A single tuple assignment: atomic under the GIL, so beats from
        # other threads (retry heartbeats) need no lock.
        self._last = (time.monotonic(), phase, step)

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self.beat("armed")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="picotron-watchdog")
        _ACTIVE.append(self)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            t, phase, step = self._last
            age = time.monotonic() - t
            if age > self.timeout:
                self._fire(age, phase, step)
                return

    def _fire(self, age: float, phase: str, step) -> None:
        where = f"phase={phase!r}" + (f" step={step}" if step is not None
                                      else "")
        print(f"[watchdog] no progress for {age:.1f}s (timeout "
              f"{self.timeout:g}s); last {where} — dumping stacks and "
              f"exiting {EXIT_WATCHDOG} for supervisor restart",
              file=sys.stderr, flush=True)
        # The hung phase never completes, so its PhaseTimer booking never
        # happens: this event is the only accounting of the burned time.
        # JSONL flushes per event, so it is durable before the os._exit.
        try:
            bus.emit("watchdog_timeout", secs=age,
                     category=("data_wait" if phase == "data" else "other"),
                     phase=phase, step=step, timeout=self.timeout)
        except Exception:  # noqa: BLE001 — the exit below must still happen
            pass
        # Flight-recorder postmortem: the last-K-steps window, written
        # before the exit below (os._exit runs no cleanup handlers, so
        # this is the only chance).
        try:
            tel = bus.active()
            if tel is not None and getattr(tel, "flight", None) is not None:
                tel.flight.dump(self.reason, step=step, phase=phase,
                                stalled_s=round(age, 3))
        except Exception:  # noqa: BLE001 — the exit below must still happen
            pass
        try:
            faulthandler.dump_traceback(sys.stderr, all_threads=True)
        except Exception:  # noqa: BLE001 — the exit below must still happen
            pass
        sys.stderr.flush()
        if self._on_timeout is not None:
            self._on_timeout()
        else:
            os._exit(EXIT_WATCHDOG)
