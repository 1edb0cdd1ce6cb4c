"""Metrics registry: counters, gauges, and windowed histograms (the
port's copy of picotron_tpu/telemetry/registry.py: pure Python).

The in-process metric store every sink reads from. Three instrument kinds,
deliberately tiny (this is a trainer, not a metrics platform):

- ``Counter`` — monotonically increasing event count (guard trips, retries,
  recompiles).
- ``Gauge`` — last-written scalar (trained_tokens, memory_gb).
- ``Histogram`` — distribution over a bounded retention window with
  p50/p95 percentiles (step time, per-phase durations). The window is the
  last `window` observations: for step-time triage the *recent*
  distribution is the one that matters (a straggler 40k steps ago should
  not dilute today's p95), and it bounds memory for million-step runs.
  Lifetime count/sum/min/max are kept exactly alongside.

All mutation is a single attribute assignment or deque append — atomic
under the GIL — so instruments can be fed from the retry/watchdog threads
without locks (same argument as Watchdog.beat).
"""

from __future__ import annotations

from collections import deque
from typing import Optional


class Counter:
    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    def __init__(self, window: int = 4096) -> None:
        self._window: deque[float] = deque(maxlen=window)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self._window.append(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100], over the retention window (nearest-rank on the
        sorted window — the conventional definition; no interpolation so
        every reported percentile is an actually-observed value)."""
        if not self._window:
            return None
        xs = sorted(self._window)
        # nearest-rank: ceil(q/100 * n), 1-based; clamp for q=0
        rank = max(1, -(-int(q * len(xs)) // 100)) if q > 0 else 1
        return xs[min(rank, len(xs)) - 1]

    @property
    def p50(self) -> Optional[float]:
        return self.percentile(50)

    @property
    def p95(self) -> Optional[float]:
        return self.percentile(95)


class MetricsRegistry:
    """Named instrument factory: `registry.counter("events/retry").inc()`.
    Instruments are created on first touch and live for the process."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._histograms.setdefault(name, Histogram(window))

    def snapshot(self) -> dict:
        """Plain-dict view of every instrument — what the run_summary
        event and bench.py serialize."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, c in sorted(self._counters.items()):
            out["counters"][name] = c.value
        for name, g in sorted(self._gauges.items()):
            out["gauges"][name] = g.value
        for name, h in sorted(self._histograms.items()):
            out["histograms"][name] = {
                "count": h.count, "sum": round(h.sum, 6),
                "min": h.min, "max": h.max, "mean": h.mean,
                "p50": h.p50, "p95": h.p95,
            }
        return out
