"""Span tracer: an in-process Chrome-trace/Perfetto timeline (the port's
copy of picotron_tpu/telemetry/flightdeck/tracer.py: pure Python).

One ``SpanTracer`` per process records complete spans (``ph="X"``) and
instant events (``ph="i"``) into a bounded in-memory list, exported as
the Chrome trace-event JSON format (the ``{"traceEvents": [...]}``
container Perfetto and chrome://tracing both load). Timestamps are
microseconds on the tracer's own monotonic clock, zeroed at
construction, so one export is one self-consistent timeline.

Thread-lane (``tid``) convention, kept stable so traces from different
runs line up:

* 0            train-loop phases (data/step/sync/eval/save/...)
* 1            serving request lifecycle (queue_wait/prefill/handoff/
               decode spans, tagged with request ids)
* 2            sentinel / flightdeck bookkeeping instants
* 100 + stage  pipeline stage lanes (one per pipeline rank), carrying
               the per-op tick spans named ``stage/tick/op/mb`` — the
               same coordinates the watchdog's last-touch string uses
               (parallel/pp.walk records them while a tracer is
               installed).

The tracer is deliberately dumb: no nesting model, no flow events. A
span is one dict append under a lock; the disabled path (tracer absent)
is a single ``is not None`` check at every call site and allocates
nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time

TID_TRAIN = 0
TID_SERVE = 1
TID_SENTINEL = 2
TID_PP_BASE = 100

_THREAD_NAMES = {
    TID_TRAIN: "train",
    TID_SERVE: "serve",
    TID_SENTINEL: "flightdeck",
}


class SpanTracer:
    """Bounded in-memory trace-event recorder.

    ``max_events`` caps memory on long runs: past the cap new events are
    counted in ``dropped`` instead of recorded (the export notes the
    drop count so a truncated trace is never mistaken for a quiet one).
    """

    def __init__(self, pid: int = 0, clock=time.perf_counter,
                 max_events: int = 500_000):
        self.pid = int(pid)
        self.clock = clock
        self._t0 = clock()
        self._events: list[dict] = []
        self._meta: dict[int, dict] = {}
        self._lock = threading.Lock()
        self.max_events = int(max_events)
        self.dropped = 0

    # -- recording ---------------------------------------------------

    def now(self) -> float:
        """Current time on the tracer's clock (seconds)."""
        return self.clock()

    def complete(self, name: str, tid: int = TID_TRAIN,
                 start_s: float | None = None, dur_s: float = 0.0,
                 **args) -> None:
        """Record a complete span (``ph="X"``).

        ``start_s`` is on the tracer's clock domain (``tracer.now()``);
        when None the span is back-dated ``dur_s`` seconds from now —
        the natural call shape for "phase just finished, took `secs`"
        hooks that only learn the duration after the fact.
        """
        if start_s is None:
            start_s = self.clock() - dur_s
        ev = {"name": name, "ph": "X", "pid": self.pid, "tid": int(tid),
              "ts": (start_s - self._t0) * 1e6,
              "dur": max(dur_s, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self._push(tid, ev)

    def instant(self, name: str, tid: int = TID_TRAIN, **args) -> None:
        """Record an instant event (``ph="i"``, process scope)."""
        ev = {"name": name, "ph": "i", "s": "p", "pid": self.pid,
              "tid": int(tid), "ts": (self.clock() - self._t0) * 1e6}
        if args:
            ev["args"] = args
        self._push(tid, ev)

    def counter(self, name: str, tid: int = TID_SENTINEL,
                **series) -> None:
        """Record a counter sample (``ph="C"``)."""
        self._push(tid, {"name": name, "ph": "C", "pid": self.pid,
                         "tid": int(tid),
                         "ts": (self.clock() - self._t0) * 1e6,
                         "args": dict(series)})

    def thread_name(self, tid: int, name: str) -> None:
        """Label a lane (metadata event, emitted first in the export)."""
        with self._lock:
            self._meta[int(tid)] = {
                "name": "thread_name", "ph": "M", "pid": self.pid,
                "tid": int(tid), "ts": 0, "args": {"name": name}}

    def _push(self, tid: int, ev: dict) -> None:
        with self._lock:
            if int(tid) not in self._meta:
                label = _THREAD_NAMES.get(int(tid))
                if label is None and int(tid) >= TID_PP_BASE:
                    label = f"pp_stage{int(tid) - TID_PP_BASE}"
                if label is not None:
                    self._meta[int(tid)] = {
                        "name": "thread_name", "ph": "M",
                        "pid": self.pid, "tid": int(tid), "ts": 0,
                        "args": {"name": label}}
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- snapshots (flight recorder) ---------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def mark(self) -> int:
        """Watermark for ``since`` — events recorded so far."""
        with self._lock:
            return len(self._events)

    def since(self, mark: int) -> list[dict]:
        """Copy of events recorded after a ``mark()`` watermark."""
        with self._lock:
            return list(self._events[mark:])

    # -- export ------------------------------------------------------

    def to_json(self) -> dict:
        """Chrome-trace document: metadata lanes first, spans sorted by
        timestamp (Perfetto tolerates unsorted input; the validator and
        humans prefer not to)."""
        with self._lock:
            meta = [self._meta[t] for t in sorted(self._meta)]
            events = sorted(self._events, key=lambda e: e["ts"])
            dropped = self.dropped
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if dropped:
            doc["otherData"] = {"dropped_events": dropped}
        return doc

    def export(self, path: str) -> str:
        """Atomically write the trace JSON; returns the path."""
        doc = self.to_json()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
