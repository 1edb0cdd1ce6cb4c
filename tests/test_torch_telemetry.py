"""The port's telemetry (picotron_tpu_torch/telemetry/) against the JAX
package's: the registry's percentiles, the goodput ledger's
classification and goodput fraction, and the facade's event stream on
the same observations and event sequences; a retry's backoff booked
once, not in its phase too; the JSONL sink's round trip
and rotation; the phase timer's booking through an exception; and the
port's CompileWatch, which books the nvcc builds of kernels/build.py (a
planted build here: a stand-in nvcc script, since this machine has
none); the trainer's half: `Telemetry.from_config` streaming where the
JAX one does (per rank, moved, rotated, off), and the tools on a port
trainer stream with a rollback and retries: `telemetry_report` equal to
the JAX tool's summary and rendering, `trace_export` equal to the JAX
converter, merging ranks' streams and traces, and validating alike."""

import json
import os
import stat
import sys

import numpy as np
import pytest

from picotron_tpu.telemetry import goodput as jgoodput
from picotron_tpu.telemetry import registry as jregistry
from picotron_tpu_torch.kernels import build
from picotron_tpu_torch.telemetry import (
    GoodputLedger, JsonlSink, MetricsRegistry, PhaseTimer, Telemetry,
    goodput, jsonl_segments,
)


def _observations(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.lognormal(0.0, 1.0, n)]


@pytest.mark.parametrize("n,window", [(1, 4096), (7, 4096), (100, 4096),
                                      (5000, 4096), (50, 16)])
def test_registry_matches_jax(n, window):
    xs = _observations(n, n)
    port, jax_reg = MetricsRegistry(), jregistry.MetricsRegistry()
    for reg in (port, jax_reg):
        h = reg.histogram("step", window)
        for x in xs:
            h.observe(x)
        reg.counter("events/retry").inc(3)
        reg.gauge("memory_gb").set(xs[-1])
    ph, jh = port.histogram("step"), jax_reg.histogram("step")
    for q in (0, 1, 25, 50, 90, 95, 99, 100):
        assert ph.percentile(q) == jh.percentile(q)
    assert (ph.p50, ph.p95, ph.count, ph.min, ph.max) == (
        jh.p50, jh.p95, jh.count, jh.min, jh.max)
    assert port.snapshot() == jax_reg.snapshot()


# (phase or category, seconds, step, compile seconds, bubble seconds)
EVENTS = [
    ("phase", "data", 0.05, 1, 0.0, 0.0),
    ("phase", "step", 2.0, 1, 1.5, 0.0),
    ("phase", "step", 0.5, 2, 0.0, 0.1),
    ("phase", "sync", 0.01, 2, 0.0, 0.0),
    ("phase", "save", 0.7, 2, 0.0, 0.0),
    ("phase", "rollback", 0.3, 2, 0.0, 0.0),
    ("phase", "step", 0.5, 2, 0.0, 0.0),   # replay: at the high-water mark
    ("phase", "step", 0.6, 3, 0.7, 0.0),   # compile clamped to the wall
    ("phase", "eval", 0.2, 3, 0.0, 0.0),
    ("phase", "mystery", 0.1, 3, 0.0, 0.0),
    ("book", "retry_backoff", 0.25, None, 0.0, 0.0),
    ("book", "queue_wait", 0.4, None, 0.0, 0.0),
    ("book", "prefill", 0.3, None, 0.0, 0.0),
    ("book", "decode", 0.9, None, 0.0, 0.0),
    ("book", "no_such_category", 0.2, None, 0.0, 0.0),
    ("book", "decode", -1.0, None, 0.0, 0.0),
]


def test_goodput_ledger_matches_jax():
    assert goodput.CATEGORIES == jgoodput.CATEGORIES
    assert goodput.PHASE_CATEGORY == jgoodput.PHASE_CATEGORY
    assert goodput.GOODPUT_CATEGORIES == jgoodput.GOODPUT_CATEGORIES
    port, jax_ledger = GoodputLedger(), jgoodput.GoodputLedger()
    for kind, name, secs, step, comp, bubble in EVENTS:
        if kind == "phase":
            got = port.book_phase(name, secs, step=step, compile_secs=comp,
                                  bubble_secs=bubble)
            want = jax_ledger.book_phase(name, secs, step=step,
                                         compile_secs=comp,
                                         bubble_secs=bubble)
            assert got == want, name
        else:
            port.book(name, secs)
            jax_ledger.book(name, secs)
    assert port.seconds == jax_ledger.seconds
    assert port.goodput_fraction() == jax_ledger.goodput_fraction()
    assert port.summary() == jax_ledger.summary()
    assert port.seconds["replay"] == 0.5
    assert GoodputLedger().goodput_fraction() is None


class _Capture:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass


def test_facade_stream_matches_jax():
    """The same phases and events through both facades give the same
    event kinds and keys, the same (category, secs) bookings and the same
    ledger; the JSONL (category, secs) sum reproduces the ledger."""
    from picotron_tpu import telemetry as jtel

    streams, ledgers, registries = [], [], []
    for facade in (Telemetry, jtel.Telemetry):
        cap = _Capture()
        tel = facade(sinks=[cap])
        for name, step in (("data", 1), ("step", 1), ("sync", 1),
                           ("step", 2)):
            with tel.phases.phase(name, step=step):
                pass
        tel.emit("serve_request", id=3, output_tokens=5)
        tel.emit("phase", phase="decode", category="decode", secs=0.25,
                 tokens=8, ids=[3])
        tel.emit("retry", category="retry_backoff", secs=0.5, what="save")
        tel.observe_section("stage0", 0.125)
        tel.record_step(2, "step line", loss=1.0)
        tel.record_eval(2, 0.9, "eval line")
        tel.close()
        streams.append(cap.events)
        ledgers.append(tel.ledger)
        registries.append(tel.registry)
    port, jax_stream = streams
    assert ([(e["kind"], sorted(e)) for e in port]
            == [(e["kind"], sorted(e)) for e in jax_stream])
    assert ([(e.get("category"), e.get("phase")) for e in port]
            == [(e.get("category"), e.get("phase")) for e in jax_stream])
    assert ledgers[0].seconds.keys() == ledgers[1].seconds.keys()
    assert registries[0].histogram("section/stage0").sum == 0.125
    booked: dict = {}
    for e in port:
        if e.get("category") and "secs" in e:
            booked[e["category"]] = booked.get(e["category"], 0) + e["secs"]
    for cat, secs in ledgers[0].seconds.items():
        assert booked[cat] == pytest.approx(secs, abs=1e-5)


def test_retry_backoff_in_a_phase_is_booked_once():
    """A retry's backoff slept inside a phase on the phase's own thread
    is booked once, as retry_backoff, and taken off the phase's seconds;
    one slept on another thread (a prefetch producer) leaves the phase
    whole."""
    import threading
    import time

    cap = _Capture()
    tel = Telemetry(sinks=[cap])
    t0 = time.perf_counter()
    with tel.phases.phase("save", step=1):
        tel.emit("retry", category="retry_backoff", secs=0.05, what="save")
        time.sleep(0.05)
    outer = time.perf_counter() - t0

    def producer():
        tel.emit("retry", category="retry_backoff", secs=0.05, what="data")

    with tel.phases.phase("data", step=2):
        th = threading.Thread(target=producer)
        th.start()
        th.join()
        time.sleep(0.05)
    tel.close()
    secs = {e["phase"]: e["secs"] for e in cap.events
            if e["kind"] == "phase"}
    assert 0.0 <= secs["save"] <= outer - 0.05 + 1e-6
    assert secs["data"] >= 0.05
    assert tel.ledger.seconds["retry_backoff"] == pytest.approx(0.1)
    assert tel.ledger.seconds["ckpt_io"] == pytest.approx(secs["save"],
                                                          abs=1e-6)


def test_jsonl_sink_round_trip_and_rotation(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    sink = JsonlSink(path, max_bytes=400)
    events = [{"ts": float(i), "kind": "phase", "phase": "decode",
               "secs": 0.125 * i, "ids": [i, i + 1], "line": "console"}
              for i in range(12)]
    for e in events:
        sink.emit(e)
    sink.close()
    sink.emit({"kind": "after_close"})  # dropped, never raises
    segs = jsonl_segments(path)
    assert segs == [path + ".1", path]
    assert os.path.getsize(path + ".1") >= 400
    read = [json.loads(line) for p in segs for line in open(p)]
    # rotation keeps only the last full segment and the open one: the
    # read-back is a suffix of what was written, whole lines, in order
    want = [{k: v for k, v in e.items() if k != "line"} for e in events]
    assert read and read == want[-len(read):]
    # append mode: a second sink continues the same stream
    again = JsonlSink(path)
    again.emit({"kind": "run_start"})
    again.close()
    assert json.loads(open(path).read().splitlines()[-1]) == {
        "kind": "run_start"}


def test_phase_timer_books_on_exception():
    booked, entered = [], []
    beats = []

    class Dog:
        def beat(self, name, step):
            beats.append((name, step))

    timer = PhaseTimer(lambda n, s, st: booked.append((n, s, st)),
                       watchdog=Dog(),
                       on_enter=lambda n, st: entered.append((n, st)))
    with pytest.raises(RuntimeError, match="boom"):
        with timer.phase("step", step=7):
            raise RuntimeError("boom")
    assert entered == [("step", 7)] and beats == [("step", 7)]
    assert len(booked) == 1 and booked[0][0] == "step"
    assert booked[0][1] >= 0.0 and booked[0][2] == 7
    tel = Telemetry(sinks=[])
    with pytest.raises(ValueError):
        with tel.phases.phase("save", step=1):
            raise ValueError("disk")
    assert "ckpt_io" in tel.ledger.seconds
    assert tel.registry.histogram("phase/save").count == 1
    tel.close()


@pytest.fixture
def planted_build(tmp_path, monkeypatch):
    """kernels/build.py over a planted source and a stand-in nvcc that
    writes its -o output after a short sleep."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "planted.cu").write_text("// planted\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\nimport sys, time\ntime.sleep(0.05)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    return out


def test_compile_watch_books_a_planted_build(planted_build):
    cap = _Capture()
    tel = Telemetry(sinks=[cap])
    with tel.phases.phase("step", step=1):
        lib = build.build("planted")
    assert lib.exists() and lib.parent == planted_build
    compiles = [e for e in cap.events if e["kind"] == "compile"]
    assert len(compiles) == 1 and compiles[0]["compiles"] == 1
    assert compiles[0]["secs"] >= 0.05
    assert tel.ledger.seconds["compile"] == pytest.approx(
        compiles[0]["secs"], abs=1e-5)
    assert tel.compile_watch.total_count == 1
    # the library is on disk now: a second build compiles nothing
    with tel.phases.phase("step", step=2):
        build.build("planted")
    assert tel.compile_watch.total_count == 1
    assert tel.compile_watch.drain() == (0, 0.0)
    tel.close()
    # closed: the watch is uninstalled and books no later build
    (planted_build.parent / "csrc" / "planted.cu").write_text("// v2\n")
    build.build("planted")
    assert tel.compile_watch.total_count == 1


# -- the trainer's half: from_config, the tools -----------------------------


def _load_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(os.path.dirname(__file__), "..",
                                    "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("logging", [
    {}, {"telemetry_dir": "<tmp>/tel"}, {"telemetry_jsonl": False},
    {"telemetry_max_mb": 0.0002}], ids=["default", "dir", "off", "rotated"])
@pytest.mark.parametrize("rank", [0, 3])
def test_from_config_streams_where_jax_does(logging, rank, tmp_path,
                                            monkeypatch):
    """`Telemetry.from_config`: the JAX path (`telemetry.jsonl`, or
    `telemetry.p<rank>.jsonl` off rank 0), its rotation past
    telemetry_max_mb, stdout from rank 0 only."""
    from picotron_tpu import config as jcfg
    from picotron_tpu.telemetry import sinks as jsinks
    from picotron_tpu_torch import config as tcfg
    from picotron_tpu_torch import telemetry as ttel

    logging = {k: v.replace("<tmp>", str(tmp_path))
               if isinstance(v, str) else v for k, v in logging.items()}
    raw = {"checkpoint": {"save_dir": str(tmp_path / "ckpt")},
           "logging": {**logging, "flight_steps": 0}}
    want = jsinks.telemetry_jsonl_path(jcfg.config_from_dict(raw), rank)
    monkeypatch.setattr(ttel, "process_index", lambda: rank)
    tel = ttel.Telemetry.from_config(tcfg.config_from_dict(raw))
    assert tel.jsonl_path == want
    assert tel.sinks[0].is_primary == (rank == 0)
    for i in range(6):
        tel.emit("retry", category="retry_backoff", secs=0.01, attempt=i)
    tel.close()
    if want is None:
        return
    segs = jsonl_segments(want)
    assert segs == ([want + ".1", want] if "telemetry_max_mb" in logging
                    else [want])
    kinds = [json.loads(line)["kind"] for p in segs for line in open(p)]
    assert kinds[-1] == "run_summary"


@pytest.fixture(scope="module")
def chaos_stream(tmp_path_factory):
    """A port trainer run with a rollback, a retried save and a data
    retry: a stream with replayed steps and badput in several
    categories."""
    from picotron_tpu_torch import config as tcfg
    from picotron_tpu_torch import train as ttrain

    base = tmp_path_factory.mktemp("stream")
    raw = {"model": {"name": "debug-tiny", "dtype": "float32"},
           "training": {"seq_length": 16, "micro_batch_size": 2,
                        "gradient_accumulation_steps": 2,
                        "total_train_steps": 5, "remat": False,
                        "eval_frequency": 5, "eval_steps": 1},
           "checkpoint": {"save_dir": str(base / "ckpt"),
                          "save_frequency": 2, "async_save": False},
           "resilience": {"chaos": "nan_grad@3,ckpt_io@4,data_io@5",
                          "guard_policy": "rollback",
                          "retry_base_delay": 0.01,
                          "retry_max_delay": 0.01}}
    os.environ.pop("PICOTRON_CHAOS", None)
    ttrain.run(tcfg.config_from_dict(raw), "cpu")
    return str(base / "ckpt")


def test_telemetry_report_matches_the_jax_tool(chaos_stream, capsys):
    """The port's stream books the JAX stream's categories: the JAX tool
    and the port's tool give the same summary and the same rendering."""
    from picotron_tpu_torch.tools import telemetry_report as rep

    jrep = _load_tool("telemetry_report")
    events = rep.load_events(rep.resolve_path(chaos_stream))
    assert events == jrep.load_events(jrep.resolve_path(chaos_stream))
    got, want = rep.summarize(events), jrep.summarize(events)
    assert got == want
    assert got["steps"]["replayed"] >= 1 and got["steps"]["max"] == 5
    for cat in ("compute", "replay", "restore", "retry_backoff", "ckpt_io",
                "data_wait", "host_sync", "eval"):
        assert got["categories"].get(cat, 0.0) > 0.0, cat
    for md in (False, True):
        assert rep.render(got, md) == jrep.render(want, md)
    assert rep.main([chaos_stream, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == got
    # the ledger and the stream agree: accounted time within the wall
    assert got["accounted_s"] <= got["wall_s"] + 1e-3


def test_trace_export_matches_the_jax_tool_and_merges_ranks(chaos_stream,
                                                            tmp_path,
                                                            capsys):
    from picotron_tpu_torch.tools import trace_export as tx

    jtx = _load_tool("trace_export")
    events = tx.load_events(os.path.join(chaos_stream, "telemetry.jsonl"))
    assert tx.convert({0: events}) == jtx.convert(events, pid=0)
    # two ranks' streams: one document, rank r on pid r, one wall clock
    run = tmp_path / "run"
    run.mkdir()
    shifted = [{**e, "ts": e["ts"] + 0.5} for e in events]
    for name, evs in (("telemetry.jsonl", events),
                      ("telemetry.p1.jsonl", shifted)):
        (run / name).write_text("".join(json.dumps(e) + "\n" for e in evs))
    assert tx.main([str(run)]) == 0
    doc = json.loads((run / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert {e["pid"] for e in spans} == {0, 1}
    assert len(spans) == 2 * len(tx.convert({0: events})["traceEvents"][2:])
    assert tx.validate(str(run / "trace.json")) == []
    # per-rank flightdeck traces: merged with their drops summed
    from picotron_tpu_torch.telemetry.flightdeck import SpanTracer

    tdir = tmp_path / "traces"
    tdir.mkdir()
    for rank in (0, 1):
        tr = SpanTracer(pid=rank, max_events=3)
        for i in range(5):
            tr.complete("step", dur_s=0.001, step=i)
        tr.export(str(tdir / ("trace.json" if rank == 0
                              else f"trace.p{rank}.json")))
    assert tx.main(["--merge", str(tdir)]) == 0
    merged = json.loads((tdir / "trace.merged.json").read_text())
    assert merged["otherData"]["dropped_events"] == 4
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    assert tx.main(["--validate", str(tdir / "trace.merged.json")]) == 0
    capsys.readouterr()
    # validation agrees with the JAX tool's on a broken trace
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "X", "pid": 0, "tid": 0, "ts": 5, "dur": -1},
        {"name": "b", "ph": "B", "pid": 0, "tid": 0, "ts": 3},
        {"name": "c", "ph": "E", "pid": "x", "tid": 0, "ts": 4},
        {"name": "d", "ph": "Q", "pid": 0, "tid": 0, "ts": 6}]}))
    assert tx.validate(str(bad)) == jtx.validate(str(bad))
    assert len(tx.validate(str(bad))) >= 3
    assert tx.main(["--validate", str(bad)]) == 1
