"""Retry with exponential backoff + jitter for flaky I/O (the port's copy
of picotron_tpu/resilience/retry.py).

Checkpoint saves and restores against network or shared filesystems fail
transiently in long runs, and a single attempt turns a 2-second blip into
a dead job. `retry_call` retries a bounded number of times with doubling,
jittered delays.

`retry_on` defaults to OSError only: programming errors must not be
retried into a 3x-slower crash. Backoff sleeps longer than 1 s are chunked
and heartbeat the active watchdog, so a legitimate retry window is not
misread as a hang.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from picotron_tpu_torch.resilience import watchdog as _watchdog
from picotron_tpu_torch.telemetry import bus as _telemetry


@dataclass(frozen=True)
class RetryPolicy:
    attempts: int = 3        # total tries (1 = no retry)
    base_delay: float = 0.5  # delay before the first retry (seconds)
    max_delay: float = 30.0  # cap on any single delay
    jitter: float = 0.25     # each delay is scaled by 1 + U(0, jitter)

    @classmethod
    def from_config(cls, rcfg) -> "RetryPolicy":
        """Policy from a config ResilienceConfig block."""
        return cls(attempts=rcfg.retry_attempts,
                   base_delay=rcfg.retry_base_delay,
                   max_delay=rcfg.retry_max_delay)


def backoff_delays(policy: RetryPolicy,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Delays before retries 1..attempts-1: min(max, base * 2^i), each
    scaled by 1 + U(0, jitter). Pass a seeded rng for determinism."""
    rand = rng.random if rng is not None else random.random
    for i in range(max(0, policy.attempts - 1)):
        d = min(policy.max_delay, policy.base_delay * (2.0 ** i))
        if policy.jitter > 0:
            d = min(policy.max_delay, d * (1.0 + policy.jitter * rand()))
        yield d


def _heartbeat_sleep(seconds: float) -> None:
    """Sleep in <=1 s chunks, beating the active watchdog between chunks:
    a 30 s checkpoint-retry backoff must not trip a 10 s watchdog."""
    deadline = time.monotonic() + seconds
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        time.sleep(min(1.0, remaining))
        _watchdog.touch("retry-backoff")


def retry_call(fn: Callable, *args,
               policy: RetryPolicy = RetryPolicy(),
               retry_on: tuple = (OSError,),
               describe: str = "",
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               **kwargs):
    """Call fn(*args, **kwargs), retrying `retry_on` exceptions up to
    policy.attempts total tries. Re-raises the last failure. Exceptions
    outside `retry_on` propagate immediately."""
    delays = backoff_delays(policy, rng)
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt == policy.attempts:
                raise
            delay = next(delays)
            target = describe or getattr(fn, "__name__", "call")
            print(f"[retry] {target}: attempt {attempt}/{policy.attempts} "
                  f"failed ({e!r}); retrying in {delay:.2f}s",
                  file=sys.stderr, flush=True)
            _telemetry.emit("retry", category="retry_backoff", secs=delay,
                            target=target, attempt=attempt,
                            attempts=policy.attempts, error=repr(e))
            if sleep is time.sleep:
                _heartbeat_sleep(delay)
            else:  # injected sleep (tests): hand over the whole delay
                sleep(delay)
