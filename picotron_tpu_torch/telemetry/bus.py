"""Module-level event bus: how library code reaches telemetry without
plumbing (the port's copy of picotron_tpu/telemetry/bus.py).

Checkpoint and resilience code calls `bus.emit(...)` unconditionally
(`ckpt_commit`, `ckpt_corrupt`, `ckpt_gc`, `ckpt_probe_failed`, `guard`,
`preempt_signal`, `retry`, `watchdog_timeout`); with no sink installed the
call is a None check and nothing else. `install` takes the
`telemetry.Telemetry` facade, or any object with an `emit(kind,
category=, secs=, **fields)` method (tests install a recorder). The
trainer installs none yet: wiring it to the facade is ROADMAP Queue 1
item 12.
"""

from __future__ import annotations

_active = None


def install(telemetry):
    """Make `telemetry` the process-wide event target (None uninstalls).
    Returns it for chaining."""
    global _active
    _active = telemetry
    return telemetry


def active():
    return _active


def emit(kind: str, *, category: str | None = None,
         secs: float | None = None, **fields) -> None:
    """Emit one event. `category` + `secs` book time (e.g. a retry's
    backoff sleep); bare events are record-only."""
    t = _active
    if t is not None:
        t.emit(kind, category=category, secs=secs, **fields)
