"""Drift sentinel: online step-time/comm/data-wait regression watch (the
port's copy of picotron_tpu/telemetry/flightdeck/sentinel.py: pure Python).

Fed each step's phase timings by the telemetry facade, the sentinel
tracks three quantities:

* ``step_time``       — step + sync wall seconds, vs its own rolling
                        median (p50/p95 kept for reporting),
* ``sync_share``      — sync / step_time, vs a cost model's predicted
                        exposed-comm share for the active config when a
                        prediction was supplied (`flightdeck.install`
                        seeds it from `analysis/cost_model.py` on the
                        h100 tier), falling back to its rolling median
                        otherwise,
* ``data_wait_share`` — data / (data + step_time), vs rolling median.

A quantity breaches when it exceeds ``ratio`` x its baseline (and, when
the rolling window has variance, ``zscore`` sigmas above it — the
z-test suppresses ratio trips on noisy-but-wide baselines; a flat
baseline falls through on ratio alone). ``patience`` consecutive
breaches of the same quantity raise one alert; the sentinel then
latches — a drifting run produces exactly one ``sentinel_alert``, not
one per step. Breaching samples are kept out of the rolling window so a
sustained regression cannot vote itself into the baseline before the
patience runs out.
"""

from __future__ import annotations

from collections import deque

_ROLLING = ("step_time", "sync_share", "data_wait_share")
# Share baselines below this are noise floors, not baselines — a ratio
# against ~0 would trip on the first nonzero sample.
_MIN_SHARE_BASELINE = 1e-3


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _pctile(xs: list[float], q: float) -> float:
    s = sorted(xs)
    rank = max(1, -(-int(q * len(s)) // 100)) if q > 0 else 1
    return s[min(rank, len(s)) - 1]


def _std(xs: list[float]) -> float:
    n = len(xs)
    if n < 2:
        return 0.0
    m = sum(xs) / n
    return (sum((x - m) ** 2 for x in xs) / (n - 1)) ** 0.5


class DriftSentinel:
    def __init__(self, window: int = 32, zscore: float = 4.0,
                 ratio: float = 1.5, patience: int = 3,
                 predicted: dict | None = None):
        self.window = max(int(window), 4)
        self.zscore = float(zscore)
        self.ratio = float(ratio)
        self.patience = max(int(patience), 1)
        self.predicted = predicted
        self.warmup = max(4, self.window // 4)
        self._hist: dict[str, deque] = {
            q: deque(maxlen=self.window) for q in _ROLLING}
        self._cur: dict[str, float] = {}
        self._streak: dict[str, int] = {q: 0 for q in _ROLLING}
        self.alerted = False
        self.alerts: list[dict] = []

    # -- feeding -----------------------------------------------------

    def observe_phase(self, phase: str, secs: float) -> None:
        if phase in ("data", "step", "sync"):
            self._cur[phase] = self._cur.get(phase, 0.0) + float(secs)

    def predicted_sync_share(self) -> float | None:
        p = self.predicted
        if not p:
            return None
        total = float(p.get("total_s") or 0.0)
        exposed = float(p.get("exposed_comm_s") or 0.0)
        if total <= 0.0:
            return None
        return exposed / total

    # -- judging -----------------------------------------------------

    def on_step(self, step: int) -> dict | None:
        """Fold the accumulated phases into the rolling windows; returns
        an alert dict exactly once when a sustained breach is found."""
        cur, self._cur = self._cur, {}
        step_s = cur.get("step", 0.0) + cur.get("sync", 0.0)
        if step_s <= 0.0:
            return None  # eval-only / phaseless iteration
        data_s = cur.get("data", 0.0)
        values = {
            "step_time": step_s,
            "sync_share": cur.get("sync", 0.0) / step_s,
            "data_wait_share": data_s / (data_s + step_s),
        }

        alert = None
        for q, val in values.items():
            hist = self._hist[q]
            baseline, z = self._baseline(q, hist)
            breach = self._is_breach(q, val, baseline, z)
            if breach:
                self._streak[q] += 1
            else:
                self._streak[q] = 0
                hist.append(val)
                continue
            if (self._streak[q] >= self.patience and not self.alerted
                    and alert is None):
                alert = {
                    "quantity": q,
                    "value": round(val, 6),
                    "baseline": round(baseline, 6),
                    "ratio": round(val / baseline, 4),
                    "streak": self._streak[q],
                    "step": int(step),
                    "window": len(hist),
                    "step_time_p50_s": round(
                        _pctile(list(self._hist["step_time"]), 50), 6)
                    if self._hist["step_time"] else None,
                    "step_time_p95_s": round(
                        _pctile(list(self._hist["step_time"]), 95), 6)
                    if self._hist["step_time"] else None,
                }
        if alert is not None:
            self.alerted = True
            self.alerts.append(alert)
        return alert

    def _baseline(self, q: str, hist: deque) -> tuple[float, float]:
        """(baseline, z-denominator std). Predicted baseline for
        sync_share when available; rolling median otherwise (0.0 while
        the window is still warming up — never judged)."""
        if q == "sync_share":
            pred = self.predicted_sync_share()
            if pred is not None:
                return pred, 0.0
        if len(hist) < self.warmup:
            return 0.0, 0.0
        xs = list(hist)
        return _median(xs), _std(xs)

    def _is_breach(self, q: str, val: float, baseline: float,
                   std: float) -> bool:
        if baseline <= 0.0:
            return False
        if q != "step_time" and baseline < _MIN_SHARE_BASELINE:
            return False
        if val < self.ratio * baseline:
            return False
        if std > 0.0 and (val - baseline) / std < self.zscore:
            return False
        return True

    # -- reporting ---------------------------------------------------

    def stats(self) -> dict:
        xs = list(self._hist["step_time"])
        out: dict = {"alerts": len(self.alerts),
                     "window": len(xs)}
        if xs:
            out["step_time_p50_s"] = round(_pctile(xs, 50), 6)
            out["step_time_p95_s"] = round(_pctile(xs, 95), 6)
        pred = self.predicted_sync_share()
        if pred is not None:
            out["predicted_sync_share"] = round(pred, 6)
        return out
