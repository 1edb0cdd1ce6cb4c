"""Structured telemetry of the port: registry, sinks, phase timing,
goodput ledger (port of picotron_tpu/telemetry/__init__.py, without the
wandb attachment: the card's machine has no `wandb`, and the trainer
refuses `logging.use_wandb`).

One `Telemetry` facade owns:

- a `MetricsRegistry` (counters / gauges / p50-p95 histograms),
- the sink fan-out — stdout (the frozen log-line format) and the
  per-process `telemetry.jsonl` event stream next to the checkpoints,
- a `PhaseTimer` that times loop sections AND is the watchdog's
  heartbeat source — timing and liveness share one clock,
- a `GoodputLedger` classifying every accounted second (compute vs
  compile / ckpt I/O / restore+replay / preemption drain / retry backoff
  / data stall / pipeline bubble, and the serving engine's prefill/decode
  and queue wait), fed by the phases and by events library code emits
  through `telemetry.bus`,
- a `CompileWatch` that books the nvcc builds of `kernels/build.py`
  (the port's only compiles) exactly,
- the flightdeck attachments `tracer`, `flight` and `sentinel`
  (telemetry/flightdeck), installed per the config by `from_config`.

The trainer (`train.run`) builds one with `Telemetry.from_config` and
installs it on the bus; the serving engine reports through one too.
`python -m picotron_tpu_torch.tools.telemetry_report` summarizes the JSONL
stream and `python -m picotron_tpu_torch.tools.trace_export` turns it
into a Chrome trace; the per-phase category mapping is the JAX
package's, so both packages' streams book alike. One difference in the
seconds: a retry's backoff sleep that happens on the thread of the open
phase (a batch assembly or a checkpoint save retried in place) is booked
once, as `retry_backoff`, and carved out of that phase's seconds; the
JAX facade books it twice (in its `retry` event and in the enclosing
phase), which lets the report's accounted seconds exceed its wall.

What a phase times on the card: the host's clock around the section. A
CUDA step returns once its kernels are queued, so the `step` phase is
the launch time, and the card's remaining work lands in the phase that
first waits for it: `sync`, which copies the step's metrics to the host
(the guard and the log line read them). Nothing here adds a sync; the
span tracer's pipeline tick spans sync each op while a tracer is
installed (an opt-in perturbation, as in the JAX package).

JSONL schema (one object per line; `ts` = time.time()):

  {"ts", "kind": "phase", "phase", "step", "secs", "category"}
  {"ts", "kind": "step",  "step", ...}
  {"ts", "kind": "eval",  "step", "val_loss"}
  {"ts", "kind": <event>, ...}        # retry / chaos / guard / preempt /
                                      # compile / watchdog_timeout /
                                      # serve_request / serve_summary ...
  {"ts", "kind": "run_summary", "goodput": {...}, "metrics": {...}}
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from picotron_tpu_torch.telemetry import bus
from picotron_tpu_torch.telemetry.flightdeck.tracer import (
    TID_SERVE, TID_TRAIN,
)
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

# Serve-engine request-lifecycle phases: traced on the serve lane with
# their request ids rather than the train lane.
_SERVE_PHASES = frozenset(("queue_wait", "prefill", "decode", "handoff"))
# Resilience/fault event kinds rendered as trace instants so a timeline
# shows the fault next to the phase it interrupted.
_INSTANT_KINDS = frozenset((
    "chaos", "guard", "rollback", "preempted", "preempt_signal",
    "watchdog_timeout", "elastic_resize", "recompile", "retry",
    "sentinel_alert", "slice_lost"))


class Telemetry:
    """Facade wiring registry + sinks + phases + ledger + compile watch.

    Constructed once per run (or per serving engine), installed on the bus
    by a program that wants library events, closed in teardown (writes
    the run_summary event). The watchdog may be attached late (after the
    resilience block); everything else works from the first emitted
    event."""

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
        # Analytic pipeline-bubble share of each step phase (from the
        # schedule table, parallel/mpmd.pipeline_bubble_fraction),
        # installed by the driver once per run; 0.0 when pp is off.
        self.pp_bubble_fraction = 0.0
        # flightdeck attachments (telemetry/flightdeck): all nullable —
        # the hot-path hooks below are a single `is not None` check when
        # a piece is absent, allocating nothing.
        self.tracer = None          # SpanTracer
        self.flight = None          # FlightRecorder
        self.sentinel = None        # DriftSentinel
        self.trace_path = None      # where close() exports the trace
        self._closed = False
        # the open phase's thread and the retry backoff slept on it,
        # carved out of the phase when it ends (booked once)
        self._phase_thread: Optional[int] = None
        self._phase_backoff = 0.0
        # Anchor the stream's wall-clock: builds/setup before the first
        # phase would otherwise make the report's `accounted` exceed its
        # observed `wall`.
        self._fan_out({"ts": time.time(), "kind": "run_start"})

    # -- construction ------------------------------------------------------

    @classmethod
    def from_config(cls, cfg, watchdog=None) -> "Telemetry":
        """The trainer's facade: stdout from rank 0, the JSONL stream of
        this process (`telemetry_jsonl_path`, rotated past
        `logging.telemetry_max_mb`), and the flightdeck pieces the config
        asks for. The process index is the torch.distributed global rank
        (0 without a group), the JAX package's jax.process_index()."""
        rank = process_index()
        sinks: list = [StdoutSink(is_primary=rank == 0)]
        path = telemetry_jsonl_path(cfg, rank)
        if path is not None:
            max_mb = float(getattr(cfg.logging, "telemetry_max_mb", 0.0)
                           or 0.0)
            sinks.append(JsonlSink(
                path,
                max_bytes=int(max_mb * 1e6) if max_mb > 0 else None))
        tel = cls(sinks=sinks, watchdog=watchdog)
        from picotron_tpu_torch.telemetry import flightdeck

        flightdeck.install(tel, cfg, process_index=rank)
        return tel

    def attach_watchdog(self, watchdog) -> None:
        self.phases.watchdog = watchdog

    def set_pp_bubble_fraction(self, fraction: float) -> None:
        """Install the analytic pipeline-bubble share (schedule-table
        fraction of each step's wall spent in fill/drain idle). Every
        subsequent step phase carves this share of its compute into the
        `pp_bubble` ledger category."""
        self.pp_bubble_fraction = min(max(float(fraction), 0.0), 1.0)

    @property
    def jsonl_path(self) -> Optional[str]:
        for s in self.sinks:
            if isinstance(s, JsonlSink):
                return s.path
        return None

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
            if (category == "retry_backoff"
                    and self._phase_thread == threading.get_ident()):
                self._phase_backoff += secs
        event = {"ts": time.time(), "kind": kind, **fields}
        if category is not None:
            event["category"] = category
        if secs is not None:
            event["secs"] = round(secs, 6)
        self._fan_out(event)
        if self.tracer is not None:
            self._trace_event(kind, secs, fields)
        if self.flight is not None:
            if kind == "phase":
                self.flight.on_phase(fields.get("phase") or "?",
                                     secs or 0.0,
                                     step=fields.get("step"))
            elif kind not in ("compile", "pp_bubble"):
                self.flight.on_event(kind, fields)
        if self.sentinel is not None and kind == "phase" \
                and isinstance(secs, (int, float)):
            self.sentinel.observe_phase(fields.get("phase") or "", secs)

    def _trace_event(self, kind: str, secs, fields: dict) -> None:
        """Route one bus event onto the span timeline: phase events
        become complete spans (serve request phases on the serve lane,
        tagged with their request ids; everything else on the train
        lane), resilience/fault kinds become instants."""
        tr = self.tracer
        if kind == "phase":
            if not isinstance(secs, (int, float)):
                return
            phase = fields.get("phase") or "?"
            args = {k: fields[k] for k in ("id", "ids", "tokens", "step")
                    if fields.get(k) is not None}
            tid = TID_SERVE if phase in _SERVE_PHASES else TID_TRAIN
            tr.complete(phase, tid=tid, dur_s=secs, **args)
        elif kind == "compile" and isinstance(secs, (int, float)):
            args = ({"step": fields["step"]}
                    if fields.get("step") is not None else {})
            tr.complete("compile", tid=TID_TRAIN, dur_s=secs, **args)
        elif kind in _INSTANT_KINDS:
            args = {k: v for k, v in fields.items()
                    if isinstance(v, (int, float, str, bool))}
            tr.instant(kind, tid=TID_TRAIN, **args)

    def _fan_out(self, event: dict) -> None:
        for sink in self.sinks:
            try:
                sink.emit(event)
            except Exception:  # noqa: BLE001 — a sick sink must not
                pass           # kill the step

    def _phase_enter(self, name: str, step) -> None:
        """Drain builds that accrued OUTSIDE any phase before this
        phase's clock starts, so they are not clamped against (and eat)
        this phase's wall. Opens the phase's retry-backoff carve-out."""
        self._phase_thread = threading.get_ident()
        self._phase_backoff = 0.0
        n_compiles, compile_secs = self.compile_watch.drain()
        if n_compiles:
            self.registry.counter("compile/count").inc(n_compiles)
            self.emit("compile", category="compile", secs=compile_secs,
                      phase=None, step=step, compiles=n_compiles)

    def _phase_done(self, name: str, secs: float, step) -> None:
        """PhaseTimer callback: drain exact build time, book the ledger,
        feed the histograms, emit the phase event(s). The phase event's
        `secs` carries the non-compile, non-bubble remainder; the compile
        and pipeline-bubble shares ride their own category events, so a
        post-hoc sum of (category, secs) pairs over the JSONL reproduces
        the ledger. A retry's backoff slept inside the phase, already
        booked by its `retry` event, is taken off `secs` first."""
        if self._phase_thread == threading.get_ident():
            secs = max(secs - self._phase_backoff, 0.0)
            self._phase_thread, self._phase_backoff = None, 0.0
        n_compiles, compile_secs = self.compile_watch.drain()
        compile_secs = min(compile_secs, max(secs, 0.0))
        bubble_secs = 0.0
        if name == "step" and self.pp_bubble_fraction > 0.0:
            bubble_secs = self.pp_bubble_fraction * max(
                secs - compile_secs, 0.0)
        category = self.ledger.book_phase(name, secs, step=step,
                                          compile_secs=compile_secs,
                                          bubble_secs=bubble_secs)
        if category != "compute":
            bubble_secs = 0.0  # ledger carves compute only (replay etc.)
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
        if bubble_secs > 0.0:
            self.emit("pp_bubble", category="pp_bubble", secs=bubble_secs,
                      book=False, phase=name, step=step)
        self.emit("phase", category=category,
                  secs=secs - compile_secs - bubble_secs,
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
        to stdout byte-identically; the structured fields go to JSONL,
        the flight recorder's ring and the drift sentinel."""
        self._fan_out({"ts": time.time(), "kind": "step", "step": step,
                       "line": line, **fields})
        if self.flight is not None:
            self.flight.on_step(step, fields)
        if self.sentinel is not None:
            alert = self.sentinel.on_step(step)
            if alert is not None:
                self.emit("sentinel_alert", **alert)
                if self.flight is not None:
                    self.flight.dump("sentinel_alert",
                                     step=alert.get("step", step),
                                     alert=alert)

    def record_eval(self, step: int, val_loss: float, line: str) -> None:
        self._fan_out({"ts": time.time(), "kind": "eval", "step": step,
                       "val_loss": val_loss, "line": line})

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        summary = {"ts": time.time(), "kind": "run_summary",
                   "goodput": self.ledger.summary(),
                   "metrics": self.registry.snapshot()}
        if self.sentinel is not None:
            summary["sentinel"] = self.sentinel.stats()
        self._fan_out(summary)
        if self.tracer is not None and self.trace_path:
            try:
                self.tracer.export(self.trace_path)
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        self.compile_watch.uninstall()
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        if bus.active() is self:
            bus.install(None)


def process_index() -> int:
    """The torch.distributed global rank, 0 without a process group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
