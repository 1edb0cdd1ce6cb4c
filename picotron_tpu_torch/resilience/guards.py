"""Divergence guards: decide what to do when a step goes bad (the port's
copy of picotron_tpu/resilience/guards.py; the decisions are the same).

Two detectors over the per-step metrics:

- **non-finite**: NaN/Inf loss or gradient norm (the step returns both as
  metrics when guards are enabled — train_step.make_train_step).
- **loss spike**: rolling z-score of the loss against the last
  `spike_window` healthy steps; a z above `spike_zscore` trips (0
  disables). Bad steps are excluded from the window so a NaN cannot
  poison the statistics it is judged against.

The response is the configured `resilience.guard_policy`:

- ``skip`` — drop the batch, keep optimizer state. For non-finite steps
  the update suppression happens *inside* the step (the AdamW update's
  `ok` flag on params and moments, and the count), so the guard only
  reports. A spike under ``skip`` can only be
  quarantined from the window — its update is already applied; use
  ``rollback`` when spikes must not touch the weights.
- ``rollback`` — restore the last known-good checkpoint (durable AND
  manifest-verified: checkpoint.latest_valid_step walks past a corrupt
  newest step) and skip past the poison data range (the driver
  repositions the dataloader to the cursor *after* the bad batch).
- ``abort`` — exit `EXIT_DIVERGED` and let a human look.

`max_guard_trips` consecutive trips escalate to abort regardless of
policy: a guard that keeps tripping is not recovering, and an unbounded
skip/rollback loop would burn the reservation re-living the same failure.
"""

from __future__ import annotations

import enum
import math
from collections import deque
from typing import Optional

EXIT_DIVERGED = 76


class GuardAction(enum.Enum):
    OK = "ok"
    SKIP = "skip"
    ROLLBACK = "rollback"
    ABORT = "abort"


class DivergenceGuard:
    def __init__(self, policy: str, spike_zscore: float = 0.0,
                 spike_window: int = 32, max_trips: int = 3):
        assert policy in ("skip", "rollback", "abort"), policy
        self.policy = policy
        self.spike_zscore = spike_zscore
        self.max_trips = max_trips
        self._window: deque[float] = deque(maxlen=spike_window)
        self._trips = 0

    @classmethod
    def from_config(cls, rcfg) -> "DivergenceGuard":
        return cls(rcfg.guard_policy, spike_zscore=rcfg.spike_zscore,
                   spike_window=rcfg.spike_window,
                   max_trips=rcfg.max_guard_trips)

    def _spike(self, loss: float) -> Optional[float]:
        """z-score of `loss` against the window when it trips, else None.
        Requires a full window: early-training losses move fast and a
        short window would flag ordinary descent noise."""
        if (self.spike_zscore <= 0
                or len(self._window) < self._window.maxlen):
            return None
        n = len(self._window)
        mean = sum(self._window) / n
        var = sum((x - mean) ** 2 for x in self._window) / (n - 1)
        # Floor the std so a flat window (constant loss) cannot turn an
        # epsilon wiggle into an infinite z.
        std = max(math.sqrt(var), 1e-6 * max(abs(mean), 1.0))
        z = (loss - mean) / std
        return z if z >= self.spike_zscore else None

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None,
                nonfinite: Optional[float] = None
                ) -> tuple[GuardAction, str]:
        """Feed one step's metrics; returns (action, reason). `nonfinite`
        is the step's own verdict (covers per-leaf grad Inf the
        norm could mask by overflowing); loss/grad_norm are re-checked
        host-side so the guard also works with plain metrics."""
        why = None
        if not math.isfinite(loss):
            why = f"non-finite loss ({loss})"
        elif grad_norm is not None and not math.isfinite(grad_norm):
            why = f"non-finite grad norm ({grad_norm})"
        elif nonfinite is not None and nonfinite > 0.5:
            why = "non-finite loss/gradients (in-step detector)"
        else:
            z = self._spike(loss)
            if z is not None:
                why = (f"loss spike (z={z:.1f} >= {self.spike_zscore:g} "
                       f"over {len(self._window)} steps)")
        if why is None:
            self._window.append(loss)
            self._trips = 0
            return GuardAction.OK, ""
        self._trips += 1
        if self._trips >= self.max_trips and self.policy != "abort":
            return GuardAction.ABORT, (
                f"{why}; {self._trips} consecutive guard trips "
                f"(max {self.max_trips}) — policy {self.policy!r} is not "
                f"recovering")
        if self.policy == "abort":
            return GuardAction.ABORT, why
        if self.policy == "skip":
            return GuardAction.SKIP, why
        return GuardAction.ROLLBACK, why
