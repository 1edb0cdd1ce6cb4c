"""The port's flightdeck (picotron_tpu_torch/telemetry/flightdeck) against
the JAX package's: `SpanTracer`, `FlightRecorder` and `DriftSentinel`
driven with one injected clock and one call sequence, including a
sustained breach, export equal JSON and raise equal alerts; the facade's
hooks (phase spans, fault instants, the flight ring, the sentinel's
alert and auto-dump, the trace export on close) turn one event sequence
into equal documents in both packages; and `install` attaches the same
pieces per config (each sentinel seeded from its own cost model's
prediction: the port's on the h100 tier, the JAX one's on a v5e)."""

import json

import numpy as np
import pytest

from picotron_tpu import config as jcfg
from picotron_tpu import telemetry as jtel
from picotron_tpu.telemetry import flightdeck as jfd
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import telemetry as ttel
from picotron_tpu_torch.telemetry import flightdeck as fd


class Clock:
    """A deterministic clock: each read advances it by the next step of
    a seeded sequence."""

    def __init__(self, seed=0):
        self.t = 100.0
        self.rng = np.random.default_rng(seed)

    def __call__(self):
        self.t += float(self.rng.uniform(1e-4, 2e-3))
        return self.t


def _tracer_calls(tr, mod):
    tr.thread_name(mod.TID_SERVE, "serve")
    for step in range(1, 6):
        tr.complete("data", dur_s=0.001 * step, step=step)
        t0 = tr.now()
        tr.complete("step", tid=mod.TID_TRAIN, start_s=t0, dur_s=0.01,
                    step=step)
        tr.complete(f"stage{step % 2}/tick{step}/F/mb0",
                    tid=mod.TID_PP_BASE + step % 2, dur_s=0.002,
                    stage=step % 2, tick=step, op="F", mb=0)
        tr.instant("chaos", chaos_kind="sigterm", step=step)
        tr.counter("queue", depth=step)
    return tr.mark(), len(tr)


@pytest.mark.parametrize("max_events", [500_000, 12])
def test_tracer_exports_equal_json(max_events, tmp_path):
    got = fd.SpanTracer(pid=3, clock=Clock(), max_events=max_events)
    want = jfd.SpanTracer(pid=3, clock=Clock(), max_events=max_events)
    assert _tracer_calls(got, fd) == _tracer_calls(want, jfd)
    assert got.to_json() == want.to_json()
    assert got.since(4) == want.since(4)
    assert got.dropped == want.dropped == max(0, 25 - max_events)
    got.export(str(tmp_path / "a.json"))
    want.export(str(tmp_path / "b.json"))
    assert json.loads((tmp_path / "a.json").read_text()) == \
        json.loads((tmp_path / "b.json").read_text())
    assert not list(tmp_path.glob("*.tmp"))
    assert fd.TID_PP_BASE == jfd.TID_PP_BASE and \
        fd.TID_SENTINEL == jfd.TID_SENTINEL


def _flight_calls(rec, tr):
    for step in range(1, 12):
        for phase, secs in (("data", 0.001), ("step", 0.01 * step),
                            ("sync", 0.002)):
            rec.on_phase(phase, secs, step=step)
            if tr is not None:
                tr.complete(phase, dur_s=secs, step=step)
        if step % 4 == 0:
            rec.on_event("retry", {"attempt": 1, "line": "dropped"})
        rec.on_step(step, {"loss": 2.0 / step, "line": "x", "tag": "t",
                           "nested": {"no": 1}})
    rec.on_phase("data", 0.5, step=12)  # the step in flight at the dump
    return rec.last_step()


@pytest.mark.parametrize("traced", [False, True])
def test_flight_recorder_dumps_equal_postmortems(traced, tmp_path):
    docs = []
    for mod, sub in ((fd, "port"), (jfd, "jax")):
        (tmp_path / sub).mkdir()
        tr = mod.SpanTracer(clock=Clock()) if traced else None
        rec = mod.FlightRecorder(str(tmp_path / sub), max_steps=4,
                                 max_events=2, tracer=tr)
        assert _flight_calls(rec, tr) == 12
        path = rec.dump("watchdog", phase="data", stalled_s=1.5)
        assert path.endswith("flightdeck_postmortem.json")
        doc = json.loads(open(path).read())
        doc.pop("ts")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert [s["step"] for s in docs[0]["steps"]] == [8, 9, 10, 11, 12]
    assert docs[0]["steps"][-1]["partial"] is True


def _sentinel_feed(s):
    """A flat warm-up, a transient blip, then a sustained step-time
    regression (and a data-wait one after the latch)."""
    rng = np.random.default_rng(5)
    alerts = []
    for step in range(1, 41):
        step_s = 0.1 + float(rng.uniform(0, 1e-3))
        data_s = 0.005
        if step == 12:
            step_s *= 3  # a blip: one breach, the streak resets
        if step >= 25:
            step_s *= 2.5
        if step >= 33:
            data_s = 0.2
        s.observe_phase("data", data_s)
        s.observe_phase("step", step_s * 0.9)
        s.observe_phase("sync", step_s * 0.1)
        s.observe_phase("eval", 9.0)  # not watched
        alerts.append(s.on_step(step))
    return alerts, s.stats()


@pytest.mark.parametrize("kw", [{}, {"window": 8, "patience": 2},
                                {"zscore": 1.0, "ratio": 1.2}])
def test_sentinel_alerts_equal(kw):
    got = _sentinel_feed(fd.DriftSentinel(**kw))
    want = _sentinel_feed(jfd.DriftSentinel(**kw))
    assert got == want
    fired = [a for a in got[0] if a is not None]
    assert len(fired) == 1 and fired[0]["quantity"] == "step_time"


def _facade(mod, tel_mod, tmp_path, clock):
    """A facade with every flightdeck piece, fed one event sequence."""
    tel = tel_mod.Telemetry(sinks=[])
    tel.tracer = mod.SpanTracer(clock=clock)
    tel.trace_path = str(tmp_path / "trace.json")
    tel.flight = mod.FlightRecorder(str(tmp_path), max_steps=3,
                                    tracer=tel.tracer)
    tel.sentinel = mod.DriftSentinel(window=8, patience=2)
    tel.set_pp_bubble_fraction(0.25)
    for step in range(1, 15):
        slow = 3.0 if step >= 10 else 1.0
        tel.emit("phase", category="data_wait", secs=0.001, book=False,
                 phase="data", step=step)
        tel.emit("phase", category="compute", secs=0.05 * slow, book=False,
                 phase="step", step=step)
        tel.emit("phase", category="host_sync", secs=0.002, book=False,
                 phase="sync", step=step)
        if step == 4:
            tel.emit("chaos", chaos_kind="data_io", point="data_produce",
                     step=step, fired=1, count=1)
            tel.emit("retry", category="retry_backoff", secs=0.01,
                     what="batch assembly", attempt=1)
            tel.emit("phase", category="queue_wait", secs=0.003, book=False,
                     phase="queue_wait", id=7)
        tel.record_step(step, f"[step {step}]", loss=1.0 / step)
    tel.close()
    flight = json.loads((tmp_path / "flightdeck_postmortem.json")
                        .read_text())
    flight.pop("ts")
    trace = json.loads((tmp_path / "trace.json").read_text())
    return tel, flight, trace


def test_facade_hooks_build_equal_documents(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tel, flight, trace = _facade(fd, ttel, tmp_path / "port", Clock(1))
    jt, jflight, jtrace = _facade(jfd, jtel, tmp_path / "jax", Clock(1))
    assert trace == jtrace
    assert flight == jflight
    assert flight["reason"] == "sentinel_alert"
    assert tel.sentinel.alerts == jt.sentinel.alerts
    assert len(tel.sentinel.alerts) == 1
    assert tel.pp_bubble_fraction == jt.pp_bubble_fraction == 0.25
    assert ttel.bus.active() is None


def _cfg(mod, tmp_path, **logging):
    return mod.config_from_dict({
        "checkpoint": {"save_dir": str(tmp_path / "ckpt")},
        "logging": logging})


@pytest.mark.parametrize("logging", [
    {}, {"flight_steps": 0}, {"trace_dir": "<tmp>/trace"},
    {"sentinel": True, "sentinel_window": 16, "sentinel_patience": 2},
    {"telemetry_dir": "<tmp>/tel", "flight_steps": 3},
], ids=["defaults", "no_flight", "trace", "sentinel", "telemetry_dir"])
@pytest.mark.parametrize("rank", [0, 2])
def test_install_attaches_what_jax_does(logging, rank, tmp_path):
    logging = {k: v.replace("<tmp>", str(tmp_path)) if isinstance(v, str)
               else v for k, v in logging.items()}
    got, want = ttel.Telemetry(sinks=[]), jtel.Telemetry(sinks=[])
    fd.install(got, _cfg(tcfg, tmp_path, **logging), process_index=rank)
    jfd.install(want, _cfg(jcfg, tmp_path, **logging), process_index=rank)
    for name in ("tracer", "flight", "sentinel"):
        assert (getattr(got, name) is None) == \
            (getattr(want, name) is None), name
    assert got.trace_path == want.trace_path
    if got.tracer is not None:
        assert got.tracer.pid == want.tracer.pid == rank
    if got.flight is not None:
        assert got.flight.path == want.flight.path
        assert got.flight.max_steps == want.flight.max_steps
    if got.sentinel is not None:
        for key in ("window", "zscore", "ratio", "patience", "warmup"):
            assert getattr(got.sentinel, key) == \
                getattr(want.sentinel, key), key
        # both seeded by their cost model (the port's on the h100 tier)
        assert set(got.sentinel.predicted) == set(want.sentinel.predicted)
        assert 0 <= got.sentinel.predicted["exposed_comm_s"] < \
            got.sentinel.predicted["total_s"]
    got.close()
    want.close()
