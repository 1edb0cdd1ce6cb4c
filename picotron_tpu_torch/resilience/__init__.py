"""Runtime resilience of the port (counterpart of picotron_tpu/resilience):

- **preemption**: `PreemptionHandler` turns SIGTERM/SIGINT into a finished
  step, an emergency checkpoint and exit `EXIT_PREEMPTED` (75);
- **divergence**: `DivergenceGuard` answers NaN/Inf and loss spikes with
  skip / rollback / abort (`EXIT_DIVERGED`, 76); the in-step half of skip
  is the AdamW update's `ok` flag (`optimizer.adamw_update`: the kernel
  writes nothing, the plain version selects with `guard_nonfinite`);
- **flaky I/O**: `retry_call` wraps checkpoint writes and reads;
- **hangs**: `Watchdog` dumps every thread's stack, dumps the flight
  recorder's postmortem and exits `EXIT_WATCHDOG` (77);
- **testability**: `chaos` injects each of these failures
  deterministically by step (`PICOTRON_CHAOS` / `resilience.chaos`), so
  every recovery path above runs on the CPU in the tests.

Elastic resize is not ported yet (ROADMAP Queue 1 item 12).
"""

from picotron_tpu_torch.resilience import chaos
from picotron_tpu_torch.resilience.guards import (
    EXIT_DIVERGED, DivergenceGuard, GuardAction,
)
from picotron_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED, PreemptionHandler,
)
from picotron_tpu_torch.resilience.retry import (
    RetryPolicy, backoff_delays, retry_call,
)
from picotron_tpu_torch.resilience.watchdog import EXIT_WATCHDOG, Watchdog

__all__ = [
    "EXIT_DIVERGED", "EXIT_PREEMPTED", "EXIT_WATCHDOG", "DivergenceGuard",
    "GuardAction", "PreemptionHandler", "RetryPolicy", "Watchdog",
    "backoff_delays", "chaos", "retry_call",
]
