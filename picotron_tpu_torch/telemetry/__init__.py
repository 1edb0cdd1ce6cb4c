"""Structured telemetry of the port: registry, sinks, phase timing,
goodput ledger (port of picotron_tpu/telemetry/__init__.py, without the
pipeline-bubble carve-out and the wandb attachment, which only the
trainer's wiring would use: ROADMAP Queue 1 item 12).

One `Telemetry` facade owns:

- a `MetricsRegistry` (counters / gauges / p50-p95 histograms),
- the sink fan-out — stdout (the frozen log-line format) and a JSONL
  event stream,
- a `PhaseTimer` that times loop sections AND is the watchdog's
  heartbeat source — timing and liveness share one clock,
- a `GoodputLedger` classifying every accounted second (compute, the
  serving engine's prefill/decode, queue wait, compile, ...), fed by the
  phases and by events library code emits through `telemetry.bus`,
- a `CompileWatch` that books the nvcc builds of `kernels/build.py`
  (the port's only compiles) exactly.

The serving engine (`serve/engine.py`) reports through it; the trainer
does not yet (it refuses the telemetry fields of its config and writes
no `telemetry.jsonl`: ROADMAP Queue 1 item 12, with the flightdeck
attachments `tracer`, `flight` and `sentinel`, which stay None here as
they do in the JAX facade without flightdeck). `tools/telemetry_report.py`
summarizes the JSONL stream; the per-phase category mapping is the JAX
package's, so both packages' streams book alike.

JSONL schema (one object per line; `ts` = time.time()):

  {"ts", "kind": "phase", "phase", "step", "secs", "category"}
  {"ts", "kind": "step",  "step", ...}
  {"ts", "kind": "eval",  "step", "val_loss"}
  {"ts", "kind": <event>, ...}        # serve_request / serve_summary /
                                      # compile / retry / guard ...
  {"ts", "kind": "run_summary", "goodput": {...}, "metrics": {...}}
"""

from __future__ import annotations

import time
from typing import Optional

from picotron_tpu_torch.telemetry import bus
from picotron_tpu_torch.telemetry.goodput import (
    CATEGORIES, GOODPUT_CATEGORIES, PHASE_CATEGORY, GoodputLedger,
)
from picotron_tpu_torch.telemetry.phases import PhaseTimer
from picotron_tpu_torch.telemetry.recompile import CompileWatch
from picotron_tpu_torch.telemetry.registry import (
    Counter, Gauge, Histogram, MetricsRegistry,
)
from picotron_tpu_torch.telemetry.sinks import (
    JsonlSink, Sink, StdoutSink, jsonl_segments, telemetry_jsonl_path,
)

__all__ = [
    "CATEGORIES",
    "GOODPUT_CATEGORIES",
    "PHASE_CATEGORY",
    "CompileWatch",
    "Counter",
    "Gauge",
    "GoodputLedger",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "PhaseTimer",
    "Sink",
    "StdoutSink",
    "Telemetry",
    "bus",
    "jsonl_segments",
    "telemetry_jsonl_path",
]


class Telemetry:
    """Facade wiring registry + sinks + phases + ledger + compile watch.

    Constructed once per run (or per serving engine), installed on the
    bus by a program that wants library events, closed in teardown (writes
    the run_summary event)."""

    def __init__(self, sinks: Optional[list] = None, watchdog=None,
                 compile_watch: Optional[CompileWatch] = None):
        self.registry = MetricsRegistry()
        self.ledger = GoodputLedger()
        self.sinks: list = list(sinks or [])
        self.compile_watch = (compile_watch if compile_watch is not None
                              else CompileWatch().install())
        self.phases = PhaseTimer(self._phase_done, watchdog=watchdog,
                                 on_enter=self._phase_enter,
                                 on_section=self._section_done)
        self._step_phases_done = 0
        # flightdeck attachments (ROADMAP Queue 1 item 12): not ported
        self.tracer = None
        self.flight = None
        self.sentinel = None
        self._closed = False
        # Anchor the stream's wall-clock: builds/setup before the first
        # phase would otherwise make the report's `accounted` exceed its
        # observed `wall`.
        self._fan_out({"ts": time.time(), "kind": "run_start"})

    # -- event plumbing ----------------------------------------------------

    def emit(self, kind: str, *, category: Optional[str] = None,
             secs: Optional[float] = None, book: bool = True,
             **fields) -> None:
        """Emit one event. `category` + `secs` book the time into the
        goodput ledger unless `book=False` (phase events arrive already
        booked by book_phase — re-booking would double-count)."""
        self.registry.counter(f"events/{kind}").inc()
        if book and category is not None and secs is not None:
            self.ledger.book(category, secs)
        event = {"ts": time.time(), "kind": kind, **fields}
        if category is not None:
            event["category"] = category
        if secs is not None:
            event["secs"] = round(secs, 6)
        self._fan_out(event)

    def _fan_out(self, event: dict) -> None:
        for sink in self.sinks:
            try:
                sink.emit(event)
            except Exception:  # noqa: BLE001 — a sick sink must not
                pass           # kill the step

    def _phase_enter(self, name: str, step) -> None:
        """Drain builds that accrued OUTSIDE any phase before this
        phase's clock starts, so they are not clamped against (and eat)
        this phase's wall."""
        n_compiles, compile_secs = self.compile_watch.drain()
        if n_compiles:
            self.registry.counter("compile/count").inc(n_compiles)
            self.emit("compile", category="compile", secs=compile_secs,
                      phase=None, step=step, compiles=n_compiles)

    def _phase_done(self, name: str, secs: float, step) -> None:
        """PhaseTimer callback: drain exact build time, book the ledger,
        feed the histograms, emit the phase event(s). The phase event's
        `secs` carries the non-compile remainder and the compile share
        rides its own category="compile" event, so a post-hoc sum of
        (category, secs) pairs over the JSONL reproduces the ledger."""
        n_compiles, compile_secs = self.compile_watch.drain()
        compile_secs = min(compile_secs, max(secs, 0.0))
        category = self.ledger.book_phase(name, secs, step=step,
                                          compile_secs=compile_secs)
        self.registry.histogram(f"phase/{name}").observe(secs)
        if n_compiles:
            self.registry.counter("compile/count").inc(n_compiles)
            self.emit("compile", category="compile", secs=compile_secs,
                      book=False, phase=name, step=step,
                      compiles=n_compiles)
            if name == "step" and self._step_phases_done > 0:
                # a build after the first step: a kernel first reached
                # mid-run (a new source, or a library deleted under it)
                self.registry.counter("compile/unexpected_recompiles").inc(
                    n_compiles)
                self.emit("recompile", step=step, compiles=n_compiles,
                          compile_secs=round(compile_secs, 6))
        if name == "step":
            self._step_phases_done += 1
        self.emit("phase", category=category, secs=secs - compile_secs,
                  book=False, phase=name, step=step)

    def _section_done(self, name: str, secs: float, step) -> None:
        """PhaseTimer section callback: histogram only (sections never
        touch the ledger: their wall is part of the enclosing phase)."""
        self.registry.histogram(f"section/{name}").observe(secs)

    def observe_section(self, name: str, secs: float) -> None:
        """Record an externally-measured section duration."""
        self.registry.histogram(f"section/{name}").observe(secs)

    # -- step / eval records ----------------------------------------------

    def record_step(self, step: int, line: str, **fields) -> None:
        """One training-log record: the preformatted console `line` goes
        to stdout byte-identically; the structured fields go to JSONL."""
        self._fan_out({"ts": time.time(), "kind": "step", "step": step,
                       "line": line, **fields})

    def record_eval(self, step: int, val_loss: float, line: str) -> None:
        self._fan_out({"ts": time.time(), "kind": "eval", "step": step,
                       "val_loss": val_loss, "line": line})

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._fan_out({"ts": time.time(), "kind": "run_summary",
                       "goodput": self.ledger.summary(),
                       "metrics": self.registry.snapshot()})
        self.compile_watch.uninstall()
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        if bus.active() is self:
            bus.install(None)
