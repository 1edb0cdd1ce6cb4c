"""The trainer's `logging.profile_dir` capture (counterpart of the JAX
trainer's jax.profiler window, picotron_tpu/train.py): a torch.profiler
trace with CPU and, on the card, CUDA activity over the run-relative
steps [profile_start_step, profile_start_step + profile_num_steps).

`begin(step)` at the top of a step starts the profiler at the window's
first step and opens the step's annotation (`STEP_PREFIX` + step: a host
range, mirrored on the device track, that `tools/trace_summary` reads
the window's steps from); `end(step)` after the step's metrics reached
the host closes it, and at the window's last step syncs the device once
and writes the Chrome trace `<profile_dir>/trace.rank<R>.steps<A>-<B>.
pt.trace.json`. `close()` stops an open window on any other exit (the
JAX `finally`). A profiler that fails to start raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

STEP_PREFIX = "train_step#"
TRACE_SUFFIX = ".pt.trace.json"


class ProfileWindow:
    def __init__(self, logging_cfg, start_step: int, device: torch.device,
                 rank: int = 0):
        self.dir = logging_cfg.profile_dir
        self.first = start_step + logging_cfg.profile_start_step
        self.last = self.first + logging_cfg.profile_num_steps - 1
        self.device = device
        self.rank = rank
        self._prof = None
        self._step = None  # the open step annotation
        self.path: Optional[str] = None

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def begin(self, step: int) -> None:
        if self.dir and self._prof is None and step == self.first:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.dir, exist_ok=True)
            prof = profile(activities=acts)
            prof.start()
            self._prof = prof
        if self._prof is not None:
            self._step = torch.profiler.record_function(
                f"{STEP_PREFIX}{step}")
            self._step.__enter__()

    def end(self, step: int) -> Optional[str]:
        """Close the step's annotation; at the window's last step stop and
        export (returns the trace's path then)."""
        return self._stop(step) if step >= self.last else self._close_step()

    def close(self, step: int) -> Optional[str]:
        """Stop an open window (an exit inside it)."""
        return self._stop(step)

    def _close_step(self) -> None:
        if self._step is not None:
            self._step.__exit__(None, None, None)
            self._step = None

    def _stop(self, step: int) -> Optional[str]:
        self._close_step()
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        self.path = os.path.join(
            self.dir, f"trace.rank{self.rank}.steps{self.first}-{step}"
            f"{TRACE_SUFFIX}")
        prof.export_chrome_trace(self.path)
        return self.path
