"""Retention policy: which checkpoint steps survive GC (the port's copy of
picotron_tpu/ckpt_integrity/retention.py).

Pure set arithmetic, no I/O: `CheckpointManager.gc` calls it after each
durable commit.
"""

from __future__ import annotations

from typing import Iterable


def retention_plan(steps: Iterable[int], keep_last: int = 0,
                   keep_every: int = 0,
                   protect: Iterable[int] = ()) -> tuple[list, list]:
    """(keep, delete) over `steps` under the retention policy.

    - ``keep_last`` — the N newest steps always survive. 0 disables GC
      entirely (everything is kept; the pre-lineage behavior).
    - ``keep_every`` — steps divisible by this survive forever (sparse
      long-horizon anchors under an aggressive keep_last). 0 disables.
    - ``protect`` — steps that must survive regardless of policy. The
      caller passes at least the last *verified* step: a retention sweep
      must never delete the only checkpoint restore could fall back to,
      even when keep_last=1 and the newest step is corrupt.

    Both outputs are sorted ascending and partition the input set.
    """
    steps = sorted(set(int(s) for s in steps))
    if keep_last <= 0:
        return steps, []
    keep = set(steps[-keep_last:])
    if keep_every > 0:
        keep.update(s for s in steps if s % keep_every == 0)
    keep.update(s for s in protect if s in set(steps))
    delete = [s for s in steps if s not in keep]
    return sorted(keep), delete
