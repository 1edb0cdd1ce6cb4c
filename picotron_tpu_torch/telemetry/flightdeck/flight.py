"""Flight recorder: last-K-steps window dumped on abnormal exits (the
port's copy of picotron_tpu/telemetry/flightdeck/flight.py: pure Python).

A bounded in-memory ring of the most recent steps — per-step phase
timings, the step record's metrics, and (when a tracer is attached) the
step's spans — plus a deque of recent non-phase bus events. ``dump()``
serializes the window to ``flightdeck_postmortem.json`` in the run
directory, atomically, and never raises: it is called from the paths a
run dies on (watchdog ``os._exit(77)``, divergence abort/rollback,
preemption exit 75, the train loop's unhandled-exception path, sentinel
auto-dump) where a second failure must not mask the first.

The top-level ``step`` of a dump is the fault step as reported by the
caller (falling back to the last step the recorder saw) — the number a
chaos scenario asserts against its injected fault step.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

POSTMORTEM_NAME = "flightdeck_postmortem.json"

# Per-step span cap inside the ring: a pipeline step is O(ticks) spans and
# the postmortem must stay readable, not exhaustive.
_MAX_SPANS_PER_STEP = 512
# Fields stripped from recorded bus events: rendered console lines are
# bulk, not signal, in a postmortem.
_EVENT_DROP_FIELDS = ("line",)


class FlightRecorder:
    def __init__(self, dirpath: str, max_steps: int = 8,
                 max_events: int = 64, tracer=None):
        self.path = os.path.join(dirpath, POSTMORTEM_NAME)
        self.max_steps = int(max_steps)
        self.tracer = tracer
        self._ring: deque[dict] = deque(maxlen=self.max_steps)
        self._events: deque[dict] = deque(maxlen=int(max_events))
        self._phases: dict[str, float] = {}
        self._step: int | None = None
        self._mark = tracer.mark() if tracer is not None else 0
        self.dumps = 0

    # -- feeding (facade hooks) --------------------------------------

    def on_phase(self, phase: str, secs: float,
                 step: int | None = None) -> None:
        """Accumulate one phase timing into the in-flight step record."""
        self._phases[phase] = self._phases.get(phase, 0.0) + float(secs)
        if step is not None:
            self._step = int(step)

    def on_event(self, kind: str, fields: dict) -> None:
        """Remember a non-phase bus event (chaos, guard, rollback,
        preemption, watchdog, recompile, ...) in the recent-events
        deque."""
        ev = {"kind": kind}
        for k, v in fields.items():
            if k not in _EVENT_DROP_FIELDS:
                ev[k] = v
        self._events.append(ev)

    def on_step(self, step: int, fields: dict | None = None) -> None:
        """Close the in-flight step record and push it onto the ring."""
        rec: dict = {"step": int(step), "phases": {
            k: round(v, 6) for k, v in self._phases.items()}}
        if fields:
            rec["metrics"] = {
                k: v for k, v in fields.items()
                if k not in _EVENT_DROP_FIELDS
                and isinstance(v, (int, float, str))}
        if self.tracer is not None:
            spans = self.tracer.since(self._mark)
            if len(spans) > _MAX_SPANS_PER_STEP:
                rec["spans_dropped"] = len(spans) - _MAX_SPANS_PER_STEP
                spans = spans[-_MAX_SPANS_PER_STEP:]
            rec["spans"] = spans
            self._mark = self.tracer.mark()
        self._ring.append(rec)
        self._phases = {}
        self._step = int(step)

    # -- dumping -----------------------------------------------------

    def last_step(self) -> int | None:
        """Most recent step the recorder saw (in-flight or completed)."""
        if self._step is not None:
            return self._step
        if self._ring:
            return self._ring[-1]["step"]
        return None

    def snapshot(self, reason: str, step: int | None = None,
                 **extra) -> dict:
        steps = list(self._ring)
        if self._phases:  # the step that was in flight when we died
            partial: dict = {
                "step": self._step, "partial": True,
                "phases": {k: round(v, 6)
                           for k, v in self._phases.items()}}
            if self.tracer is not None:
                spans = self.tracer.since(self._mark)
                partial["spans"] = spans[-_MAX_SPANS_PER_STEP:]
            steps.append(partial)
        doc = {
            "reason": reason,
            "ts": time.time(),
            "step": step if step is not None else self.last_step(),
            "steps": steps,
            "recent_events": list(self._events),
        }
        if extra:
            doc["extra"] = extra
        return doc

    def dump(self, reason: str, step: int | None = None,
             **extra) -> str | None:
        """Write the postmortem; best-effort, returns the path or None.

        Multiple dumps overwrite (last writer wins): a rollback followed
        by a later fatal exit should leave the *later* window.
        """
        try:
            doc = self.snapshot(reason, step=step, **extra)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
            self.dumps += 1
            return self.path
        except Exception:
            return None
