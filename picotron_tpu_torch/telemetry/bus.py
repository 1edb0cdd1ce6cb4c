"""Module-level event bus: how library code reaches telemetry without
plumbing (the port's copy of picotron_tpu/telemetry/bus.py).

Checkpoint, data and resilience code calls `bus.emit(...)`
unconditionally (`ckpt_commit`, `ckpt_corrupt`, `ckpt_gc`,
`ckpt_probe_failed`, `chaos`, `guard`, `preempt_signal`, `retry`,
`watchdog_timeout`); with no sink installed the call is a None check and
nothing else. `install` takes the `telemetry.Telemetry` facade, or any
object with an `emit(kind, category=, secs=, **fields)` method (tests
install a recorder). `train.run` installs the run's facade
(`Telemetry.from_config`) before it builds the loader and the state, so
restore retries and chaos events are captured from the first second.
Events from background threads (watchdog fire, retry backoff, the
loader's prefetch thread, the async checkpoint commit) are safe: the
JSONL sink locks, and ledger booking is a dict add under the GIL.
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
