"""Checkpoint save-dir preflight: fail at startup, not at the first save
(the port's copy of picotron_tpu/ckpt_integrity/preflight.py).

The trainer's first periodic save can land hours into a run; an
unwritable `save_dir` (typo'd path, read-only mount, a file where the
directory should be) or a nearly-full disk turns that into a lost run.
The trainer runs this probe before the first step and raises with the
story.
"""

from __future__ import annotations

import os
import shutil

from picotron_tpu_torch.config import Config, num_params


def checkpoint_nbytes(cfg: Config) -> int:
    """Estimated on-disk bytes of ONE training checkpoint of the port:
    fp32 master params + both AdamW moments at their configured dtype +
    the bf16 compute copy that optimizer_offload saves as params.
    torch.save adds only per-tensor records on top, so this is a tight
    lower bound."""
    n = num_params(cfg.model)
    moment_bytes = 2 if cfg.training.adam_moments_dtype == "bfloat16" else 4
    total = 4 * n + 2 * moment_bytes * n
    if cfg.training.optimizer_offload:
        total += 2 * n
    return total


def preflight_save_dir(cfg: Config) -> int:
    """Validate that `checkpoint.save_dir` can take one checkpoint;
    returns the estimated bytes per checkpoint. Raises RuntimeError with
    a fix-it message when the directory cannot be created/written or the
    filesystem lacks headroom (estimate + 10% slack, x(keep_last or 1)
    retained steps)."""
    save_dir = cfg.checkpoint.save_dir
    est = checkpoint_nbytes(cfg)
    try:
        os.makedirs(save_dir, exist_ok=True)
    except OSError as e:
        raise RuntimeError(
            f"checkpoint preflight: save_dir {save_dir!r} cannot be "
            f"created ({e}); fix checkpoint.save_dir before the run "
            f"starts") from e
    probe = os.path.join(save_dir, f".picotron_writecheck.{os.getpid()}")
    try:
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
    except OSError as e:
        raise RuntimeError(
            f"checkpoint preflight: save_dir {save_dir!r} is not writable "
            f"({e}); the first save would die after the run warmed up"
        ) from e
    retained = max(1, cfg.checkpoint.keep_last)
    need = int(est * 1.1) * retained
    free = shutil.disk_usage(save_dir).free
    if free < need:
        raise RuntimeError(
            f"checkpoint preflight: save_dir {save_dir!r} has "
            f"{free / 1e9:.2f} GB free but one checkpoint is "
            f"~{est / 1e9:.2f} GB ({retained} retained step(s) + 10% "
            f"slack = {need / 1e9:.2f} GB needed); free space or lower "
            f"checkpoint.keep_last")
    return est
