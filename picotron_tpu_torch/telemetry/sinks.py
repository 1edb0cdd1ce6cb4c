"""Pluggable telemetry sinks: stdout (frozen format) and JSONL (the
port's copy of picotron_tpu/telemetry/sinks.py).

Every sink receives the same event dicts from the Telemetry facade and
serializes what it cares about:

- ``StdoutSink`` — the per-step console line. Its format is a de-facto
  API (tools/extract_metrics.py regex-parses it); the line arrives
  PREFORMATTED (utils.training_log_line), so routing through telemetry
  cannot perturb a byte of it.
- ``JsonlSink`` — one JSON object per line, append-mode (a supervised
  restart into the same save_dir continues the same stream — that is how
  tools/telemetry_report.py sees replayed steps across restarts). Flushed
  per event: the interesting events are exactly the ones right before a
  crash/exit. Thread-safe (the watchdog/retry threads emit too).

The JAX package's ``WandbSink`` is not ported: the card's machine has no
``wandb``, and the port's trainer refuses ``logging.use_wandb``
(train.unsupported), so nothing would attach one.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Optional


class Sink:
    def emit(self, event: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class StdoutSink(Sink):
    """Prints preformatted console lines (events carrying a "line" field)
    from the logging host only — the same process gate utils.log_print
    applies, passed in so this module needs no process group."""

    def __init__(self, is_primary: bool = True):
        self.is_primary = is_primary

    def emit(self, event: dict) -> None:
        line = event.get("line")
        if line is not None and self.is_primary:
            print(line)
            sys.stdout.flush()


class JsonlSink(Sink):
    """Append-mode JSONL writer with optional size-capped rotation.

    With ``max_bytes`` set, a stream that outgrows the cap is rotated
    once: the current file becomes ``<path>.1`` (replacing any previous
    rotation) and a fresh segment starts at ``<path>``. Readers that
    care about the whole saga (tools/telemetry_report.py,
    tools/extract_metrics.py — cross-restart replay counting needs
    event ORDER) read ``<path>.1`` first, then ``<path>``; see
    ``jsonl_segments``. Rotation happens on event boundaries, so no
    line is ever split across segments.
    """

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._f = open(path, "a")

    def emit(self, event: dict) -> None:
        # "line" is stdout presentation, not data — the structured fields
        # carry strictly more information.
        rec = {k: v for k, v in event.items() if k != "line"}
        with self._lock:
            if self._f.closed:
                return
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            if self.max_bytes and self._f.tell() >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        import os

        self._f.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass  # rotation is best-effort; keep appending in place
        self._f = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def jsonl_segments(path: str) -> list:
    """Existing segments of a possibly-rotated JSONL stream, oldest
    first (``<path>.1`` then ``<path>``) — the read order that keeps
    cross-restart replay counting correct after rotation."""
    import os

    return [p for p in (path + ".1", path) if os.path.exists(p)]


def telemetry_jsonl_path(cfg, process_index: int = 0) -> Optional[str]:
    """Resolve the per-host JSONL path for a run config, or None when
    disabled. Process 0 owns the canonical `telemetry.jsonl` (next to the
    checkpoints, so run artifacts travel together); other hosts of a
    multi-process run write `telemetry.p<idx>.jsonl` beside it."""
    import os

    lg = cfg.logging
    if not lg.telemetry_jsonl:
        return None
    base = lg.telemetry_dir or cfg.checkpoint.save_dir
    os.makedirs(base, exist_ok=True)
    name = ("telemetry.jsonl" if process_index == 0
            else f"telemetry.p{process_index}.jsonl")
    return os.path.join(base, name)
