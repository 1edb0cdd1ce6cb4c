"""Telemetry -> Chrome trace converter, per-rank merger and trace
self-checker (the port's counterpart of tools/trace_export.py).

Three modes:

* Convert: turn a run's telemetry streams into Chrome trace-event JSON
  loadable by Perfetto / chrome://tracing. Given a run directory, every
  per-process stream in it is read (`telemetry.jsonl` of rank 0 and
  `telemetry.p<rank>.jsonl` of the others, each with its rotated `.1`
  segment first) and merged into one document, rank r on pid r, on one
  wall clock zeroed at the earliest event of any stream. Phase events
  become complete spans (train-loop phases on the train lane, serve
  request phases with their request ids on the serve lane) and
  resilience events (chaos, guard, rollback, preemption, watchdog,
  recompile, sentinel alerts) become instants. The flightdeck tracer
  (logging.trace_dir) exports richer traces (the pipeline's per-op tick
  spans never reach the JSONL); this converter is the fallback for runs
  that kept only their streams.

* Merge (`--merge`): the flightdeck traces of a trace directory
  (`trace.json` of rank 0, `trace.p<rank>.json` of the others, each
  already on pid = rank) into one document: metadata first, spans by
  timestamp, dropped-event counts summed. Each tracer's clock starts at
  its own construction, so the ranks' timelines are aligned at the
  trainer's telemetry set-up, which every rank reaches together.

* Validate (`--validate`): self-check a trace file — monotonic
  timestamps, balanced B/E begin/end events, pid/tid presence and type
  consistency, non-negative X durations — exiting nonzero on any
  violation.

Usage:

  python -m picotron_tpu_torch.tools.trace_export RUN_DIR_OR_JSONL \\
      [-o trace.json]
  python -m picotron_tpu_torch.tools.trace_export --merge TRACE_DIR \\
      [-o merged.json]
  python -m picotron_tpu_torch.tools.trace_export --validate trace.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from picotron_tpu_torch.telemetry import _INSTANT_KINDS, _SERVE_PHASES
from picotron_tpu_torch.telemetry.flightdeck.tracer import (
    TID_SERVE, TID_TRAIN,
)
from picotron_tpu_torch.telemetry.sinks import jsonl_segments

_VALID_PH = frozenset("XBEiICMsnftPNODabevR")


def rank_files(path: str, stem: str, ext: str) -> dict:
    """{rank: file} of a run directory's per-rank files `<stem><ext>`
    (rank 0) and `<stem>.p<rank><ext>`; a file path is rank 0 alone."""
    if not os.path.isdir(path):
        return {0: path}
    pat = re.compile(re.escape(stem) + r"(?:\.p(\d+))?" + re.escape(ext)
                     + "$")
    out = {}
    for name in os.listdir(path):
        m = pat.match(name)
        if m:
            out[int(m.group(1) or 0)] = os.path.join(path, name)
    if not out:
        raise FileNotFoundError(f"no {stem}{ext} under {path}")
    return dict(sorted(out.items()))


def load_events(path: str) -> list[dict]:
    """All events of a possibly-rotated stream, oldest segment first."""
    events = []
    for seg in jsonl_segments(path):
        with open(seg) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a killed run
                if isinstance(ev, dict):
                    events.append(ev)
    return events


def _lanes(pid: int) -> list[dict]:
    return [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "ts": 0, "args": {"name": name}}
            for tid, name in ((TID_TRAIN, "train"), (TID_SERVE, "serve"))]


def convert_spans(events: list[dict], pid: int, ts0: float) -> list[dict]:
    """One stream's events as trace events on `pid`, microseconds after
    the wall-clock `ts0`."""
    spans: list[dict] = []
    for e in events:
        kind = e.get("kind")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if kind in ("phase", "compile", "pp_bubble"):
            secs = e.get("secs")
            if not isinstance(secs, (int, float)):
                continue
            phase = e.get("phase") or kind
            tid = TID_SERVE if phase in _SERVE_PHASES else TID_TRAIN
            args = {k: e[k] for k in ("step", "id", "ids", "tokens")
                    if e.get(k) is not None}
            # the phase event is stamped at phase END; back out the start
            spans.append({"name": phase, "ph": "X", "pid": pid,
                          "tid": tid, "ts": (ts - secs - ts0) * 1e6,
                          "dur": max(secs, 0.0) * 1e6,
                          **({"args": args} if args else {})})
        elif kind in _INSTANT_KINDS:
            args = {k: v for k, v in e.items()
                    if k not in ("ts", "kind")
                    and isinstance(v, (int, float, str, bool))}
            spans.append({"name": kind, "ph": "i", "s": "p", "pid": pid,
                          "tid": TID_TRAIN, "ts": (ts - ts0) * 1e6,
                          **({"args": args} if args else {})})
    return spans


def convert(streams: dict) -> dict:
    """{rank: events} -> one Chrome trace document, rank r on pid r,
    zeroed at the earliest event of any stream."""
    ts0 = min((e["ts"] for evs in streams.values() for e in evs
               if isinstance(e.get("ts"), (int, float))), default=0.0)
    meta: list[dict] = []
    spans: list[dict] = []
    for rank, events in sorted(streams.items()):
        meta += _lanes(rank)
        spans += convert_spans(events, rank, ts0)
    spans.sort(key=lambda ev: ev["ts"])
    return {"traceEvents": meta + spans, "displayTimeUnit": "ms"}


def merge(traces: dict) -> dict:
    """{rank: trace document} -> one document: every trace's metadata
    first, then all spans by timestamp; dropped counts summed."""
    meta: list[dict] = []
    spans: list[dict] = []
    dropped = 0
    for _, doc in sorted(traces.items()):
        for ev in doc.get("traceEvents", []):
            (meta if ev.get("ph") == "M" else spans).append(ev)
        dropped += int((doc.get("otherData") or {}).get("dropped_events", 0))
    spans.sort(key=lambda ev: ev["ts"])
    out = {"traceEvents": meta + spans, "displayTimeUnit": "ms"}
    if dropped:
        out["otherData"] = {"dropped_events": dropped}
    return out


def validate(path: str) -> list[str]:
    """Self-check a Chrome-trace JSON; returns violation strings."""
    errors: list[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace: {e}"]
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        return ["trace has no traceEvents list"]
    last_ts: dict[tuple, float] = {}
    stacks: dict[tuple, list] = {}
    prev_global = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"event {i}: invalid ph {ph!r}")
            continue
        if ph == "M":
            continue
        pid, tid, ts = ev.get("pid"), ev.get("tid"), ev.get("ts")
        if not isinstance(pid, int) or not isinstance(tid, int):
            errors.append(f"event {i} ({ev.get('name')!r}): "
                          f"pid/tid must be integers, got "
                          f"pid={pid!r} tid={tid!r}")
            continue
        if not isinstance(ts, (int, float)):
            errors.append(f"event {i} ({ev.get('name')!r}): missing ts")
            continue
        if prev_global is not None and ts < prev_global - 1e-6:
            errors.append(f"event {i} ({ev.get('name')!r}): ts {ts} "
                          f"not monotonic (prev {prev_global})")
        prev_global = ts
        lane = (pid, tid)
        if ts < last_ts.get(lane, float("-inf")) - 1e-6:
            errors.append(f"event {i}: ts rewinds on lane {lane}")
        last_ts[lane] = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev.get('name')!r}): X event "
                              f"needs dur >= 0, got {dur!r}")
        elif ph == "B":
            stacks.setdefault(lane, []).append((i, ev.get("name")))
        elif ph == "E":
            stack = stacks.get(lane) or []
            if not stack:
                errors.append(f"event {i}: E without matching B on "
                              f"lane {lane}")
            else:
                _, bname = stack.pop()
                ename = ev.get("name")
                if ename is not None and ename != bname:
                    errors.append(f"event {i}: E name {ename!r} does "
                                  f"not match open B {bname!r}")
    for lane, stack in stacks.items():
        for i, name in stack:
            errors.append(f"event {i} ({name!r}): B never closed on "
                          f"lane {lane}")
    return errors


def _write(doc: dict, out: str) -> int:
    with open(out, "w") as f:
        json.dump(doc, f)
    print(f"{len(doc['traceEvents'])} trace events -> {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="telemetry streams -> Chrome trace, --merge per-rank "
                    "traces, or --validate a trace file")
    ap.add_argument("path", help="run dir / telemetry.jsonl (convert), "
                    "trace dir (--merge) or trace JSON (--validate)")
    ap.add_argument("-o", "--output", default=None,
                    help="output trace path (default <dir>/trace.json, "
                         "or <dir>/trace.merged.json with --merge)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--merge", action="store_true",
                      help="merge the flightdeck traces of a directory")
    mode.add_argument("--validate", action="store_true",
                      help="self-check a trace file instead of converting")
    args = ap.parse_args(argv)

    if args.validate:
        errors = validate(args.path)
        if errors:
            for e in errors[:50]:
                print(f"TRACE VIOLATION: {e}", file=sys.stderr)
            print(f"{len(errors)} violation(s) in {args.path}",
                  file=sys.stderr)
            return 1
        with open(args.path) as f:
            doc = json.load(f)
        events = doc.get("traceEvents") if isinstance(doc, dict) else doc
        lanes = {(e.get("pid"), e.get("tid")) for e in events
                 if e.get("ph") != "M"}
        print(f"OK: {len(events)} events across {len(lanes)} lane(s) "
              f"in {args.path}")
        return 0

    base = args.path if os.path.isdir(args.path) else \
        (os.path.dirname(args.path) or ".")
    if args.merge:
        traces = {}
        for rank, p in rank_files(args.path, "trace", ".json").items():
            with open(p) as f:
                traces[rank] = json.load(f)
        return _write(merge(traces), args.output
                      or os.path.join(base, "trace.merged.json"))

    streams = {rank: load_events(p) for rank, p in
               rank_files(args.path, "telemetry", ".jsonl").items()}
    if not any(streams.values()):
        print(f"no events in {args.path}", file=sys.stderr)
        return 1
    return _write(convert(streams),
                  args.output or os.path.join(base, "trace.json"))


if __name__ == "__main__":
    sys.exit(main())
