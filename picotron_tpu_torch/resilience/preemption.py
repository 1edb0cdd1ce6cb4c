"""Graceful preemption: turn SIGTERM into a durable checkpoint, not a
lost run (the port's copy of picotron_tpu/resilience/preemption.py).

Spot and preemptible cards get SIGTERM with a short grace window before
the machine goes away. The handler only records the request (a signal
handler must not run Python of any consequence: the main thread may be
inside a CUDA call); the step loop polls `triggered` after each step,
finishes the in-flight step, writes an emergency checkpoint including the
dataloader position, and exits `EXIT_PREEMPTED`. A supervisor that
resubmits the same config with `checkpoint.auto_resume` then continues
losslessly: no replayed data, no lost steps.

SIGINT rides the same path so a Ctrl-C during local runs also exits with
durable state; a *second* SIGINT restores the default handlers and raises
KeyboardInterrupt for the impatient.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Optional

from picotron_tpu_torch.telemetry import bus

EXIT_PREEMPTED = 75


class PreemptionHandler:
    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._event = threading.Event()
        self._prev: dict = {}
        self.signum: Optional[int] = None

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def install(self) -> bool:
        """Install handlers; returns False (and stays inert) when not on
        the main thread, where CPython forbids signal.signal."""
        try:
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._on_signal)
        except ValueError:
            self.uninstall()
            return False
        return True

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._prev = {}

    def __enter__(self) -> "PreemptionHandler":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame) -> None:
        if self._event.is_set() and signum == signal.SIGINT:
            # Second Ctrl-C: the user wants out NOW, durable or not.
            self.uninstall()
            raise KeyboardInterrupt
        self.signum = signum
        self._event.set()
        name = signal.Signals(signum).name
        print(f"[preemption] caught {name}; will finish the in-flight step, "
              f"write an emergency checkpoint, and exit {EXIT_PREEMPTED}",
              file=sys.stderr, flush=True)
        bus.emit("preempt_signal", signal=name)
