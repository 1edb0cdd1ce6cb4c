"""flightdeck: span tracing, crash flight recorder, drift sentinel (the
port's copy of picotron_tpu/telemetry/flightdeck).

Three composable observability pieces that ride on the telemetry facade
(picotron_tpu_torch/telemetry):

* ``SpanTracer`` (tracer.py): a low-overhead span timeline exported as
  Chrome-trace/Perfetto JSON. PhaseTimer phases, the pipeline's schedule
  ticks and resilience events all land on one timeline.
* ``FlightRecorder`` (flight.py): a bounded ring of the last N steps'
  phase timings + metrics + spans plus recent bus events, dumped to
  ``flightdeck_postmortem.json`` on every abnormal exit path.
* ``DriftSentinel`` (sentinel.py): an online monitor of step time,
  sync-phase share and data-wait share; a sustained breach emits one
  ``sentinel_alert`` event and auto-dumps the flight recorder.

All three are *nullable attributes* on the Telemetry facade
(``tel.tracer`` / ``tel.flight`` / ``tel.sentinel``): when a piece is
not installed the hot-path hooks are a single ``is not None`` check —
no span objects, no dict churn, nothing allocated.
"""

from __future__ import annotations

import os

from .flight import FlightRecorder
from .sentinel import DriftSentinel
from .tracer import (
    SpanTracer,
    TID_PP_BASE,
    TID_SENTINEL,
    TID_SERVE,
    TID_TRAIN,
)

__all__ = [
    "SpanTracer",
    "FlightRecorder",
    "DriftSentinel",
    "TID_TRAIN",
    "TID_SERVE",
    "TID_SENTINEL",
    "TID_PP_BASE",
    "install",
]


def install(tel, cfg=None, *, process_index: int = 0) -> None:
    """Attach flightdeck pieces to a Telemetry facade per its config
    (the JAX `install`'s policy):

    * tracer  — only when ``logging.trace_dir`` is set (span recording
      costs a dict append per phase/tick; opt-in).
    * flight  — whenever the run has a directory to dump into
      (``logging.telemetry_dir`` or ``checkpoint.save_dir``) and
      ``logging.flight_steps > 0``; on by default so abnormal exits
      always leave a postmortem.
    * sentinel — only when ``logging.sentinel`` is true, seeded with the
      cost model's prediction for the config on the h100 tier
      (`analysis/cost_model.py`: its step and exposed-comm seconds, the
      predicted sync share); ``predicted=None`` when the prediction
      raises, as in the JAX `install`: the sentinel then watches its
      rolling baselines alone.
    """
    if cfg is None:
        return
    lg = getattr(cfg, "logging", None)
    if lg is None:
        return

    trace_dir = getattr(lg, "trace_dir", None)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        tel.tracer = SpanTracer(pid=process_index)
        tel.trace_path = os.path.join(
            trace_dir,
            "trace.json" if process_index == 0
            else f"trace.p{process_index}.json")

    flight_steps = int(getattr(lg, "flight_steps", 8) or 0)
    dump_dir = (getattr(lg, "telemetry_dir", None)
                or getattr(getattr(cfg, "checkpoint", None),
                           "save_dir", None))
    if flight_steps > 0 and dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        tel.flight = FlightRecorder(dump_dir, max_steps=flight_steps,
                                    tracer=tel.tracer)

    if getattr(lg, "sentinel", False):
        predicted = None
        try:
            from picotron_tpu_torch.analysis.cost_model import CostModel

            sc = CostModel().predict(cfg)
            predicted = {"total_s": sc.total_s,
                         "exposed_comm_s": sc.exposed_comm_s}
        except Exception:
            predicted = None  # the sentinel still watches its baselines
        tel.sentinel = DriftSentinel(
            window=int(getattr(lg, "sentinel_window", 32)),
            zscore=float(getattr(lg, "sentinel_zscore", 4.0)),
            ratio=float(getattr(lg, "sentinel_ratio", 1.5)),
            patience=int(getattr(lg, "sentinel_patience", 3)),
            predicted=predicted)
