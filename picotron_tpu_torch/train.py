"""Single-device trainer of the PyTorch port (counterpart of
picotron_tpu/train.py):

    python -m picotron_tpu_torch.train --config cfg.json [--device cpu]

Flow: load the config -> fresh init from training.seed -> synthetic loader
-> step loop -> one `training_log_line` per logged step. Runs on CUDA
unless `--device cpu` or config `distributed.use_cpu: true` asks for the
CPU; with no GPU and no such request it raises. MFU is printed as 0.00% on
the CPU: it is a device metric and is not measured there.

What this slice does not run is refused up front, naming the ROADMAP item
that ports it (see `unsupported`).
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Callable, Optional

import torch

from picotron_tpu_torch.config import Config, load_config
from picotron_tpu_torch.data import MicroBatchDataLoader
from picotron_tpu_torch.models.llama import LlamaModel, init_params
from picotron_tpu_torch.train_step import init_train_state, make_train_step
from picotron_tpu_torch.utils import (
    StepTimer, device_memory_gb, device_peak_flops, log_print, mfu,
    training_log_line,
)

EXIT_DIVERGED = 76


def unsupported(cfg: Config) -> list[str]:
    """What the config asks for that this slice lacks, each with its
    ROADMAP item (an empty list means the run is supported)."""
    d, m, t, ck = cfg.distributed, cfg.model, cfg.training, cfg.checkpoint
    out = []
    for name in ("dp_size", "tp_size", "pp_size", "cp_size", "ep_size"):
        if getattr(d, name) > 1:
            out.append(f"distributed.{name} > 1 (parallel layouts: ROADMAP "
                       "Queue 1 item 9)")
    if m.num_experts:
        out.append("MoE models (ROADMAP Queue 1 item 10)")
    if m.attn_impl not in ("auto", "flash", "reference"):
        out.append(f"attn_impl={m.attn_impl!r} (context parallelism: "
                   "ROADMAP Queue 1 item 9)")
    if t.optimizer_offload:
        out.append("training.optimizer_offload (ROADMAP Queue 1 item 4, "
                   "offload half)")
    if t.remat:
        out.append("training.remat (remat policies as torch.utils."
                   "checkpoint: ROADMAP Queue 1 item 7); set remat: false")
    if t.grad_engine == "fused":
        out.append("training.grad_engine='fused' (ROADMAP Queue 1 item 7)")
    if t.ce_chunk_size:
        out.append("training.ce_chunk_size (chunked CE: ROADMAP Queue 1 "
                   "item 7)")
    if t.eval_frequency:
        out.append("training.eval_frequency (eval loop: ROADMAP Queue 1 "
                   "item 6)")
    if ck.save_frequency or ck.load_path or ck.auto_resume or ck.init_from_hf:
        out.append("checkpoint save/load/auto_resume/init_from_hf "
                   "(ROADMAP Queue 1 item 6)")
    if cfg.dataset.name != "synthetic":
        out.append(f"dataset {cfg.dataset.name!r} (HF datasets: ROADMAP "
                   "Queue 1 item 5)")
    if cfg.resilience.chaos or cfg.resilience.guard_policy in ("skip",
                                                               "rollback"):
        out.append("resilience chaos / guard skip|rollback (ROADMAP Queue 1 "
                   "item 12)")
    if cfg.logging.use_wandb or cfg.logging.profile_dir:
        out.append("logging.use_wandb / profile_dir (telemetry: ROADMAP "
                   "Queue 1 item 12)")
    return out


def resolve_device(cfg: Config, device: Optional[str] = None) -> torch.device:
    """CUDA unless the caller asks for the CPU; never a silent fallback."""
    if device is None:
        device = "cpu" if cfg.distributed.use_cpu else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu (or set "
            "distributed.use_cpu) to run on the CPU")
    return dev


def run(cfg: Config, device: Optional[str] = None,
        on_step: Optional[Callable[[int], None]] = None) -> dict:
    """Train per the config; returns {"losses", "step_seconds",
    "tokens_per_step", "peak_memory_gb", "device", "state"} (state: the
    trained TrainState). `on_step(step)` runs after each step, once its
    loss has reached the host."""
    bad = unsupported(cfg)
    if bad:
        raise NotImplementedError(
            "not supported by this slice of the PyTorch port: "
            + "; ".join(bad))
    dev = resolve_device(cfg, device)
    t = cfg.training
    gen = torch.Generator(device=dev).manual_seed(t.seed)
    model = init_params(LlamaModel(cfg.model, device=dev), gen)
    state = init_train_state(cfg, model)
    step_fn = make_train_step(cfg)
    dl = MicroBatchDataLoader(cfg, dev)
    peak = device_peak_flops(dev) if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    total_steps = t.total_train_steps
    if t.max_tokens is not None:
        total_steps = min(total_steps, -(-t.max_tokens // cfg.tokens_per_step))
    losses, step_seconds = [], []
    trained_tokens = 0
    timer = StepTimer()
    for step in range(1, total_steps + 1):
        batch = next(dl)
        loss = float(step_fn(state, batch))  # syncs the device
        dt = max(timer.lap(), 1e-9)
        trained_tokens += cfg.tokens_per_step
        losses.append(loss)
        step_seconds.append(dt)
        if not math.isfinite(loss) and cfg.resilience.guard_policy == "abort":
            log_print(f"[guard {step:06d}] non-finite loss {loss}; aborting "
                      f"(exit {EXIT_DIVERGED})")
            raise SystemExit(EXIT_DIVERGED)
        if step % cfg.logging.log_frequency == 0 or step == total_steps:
            tps = cfg.tokens_per_step / dt
            mfu_frac = (mfu(tps, cfg.model, t.seq_length, 1, peak)
                        if peak else 0.0)
            log_print(training_log_line(step, loss, tps, tps, mfu_frac,
                                        trained_tokens,
                                        device_memory_gb(dev)))
        if on_step is not None:
            on_step(step)
    return {"losses": losses, "step_seconds": step_seconds,
            "tokens_per_step": cfg.tokens_per_step,
            "peak_memory_gb": device_memory_gb(dev), "device": str(dev),
            "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="picotron-tpu PyTorch trainer")
    ap.add_argument("--config", required=True, help="config JSON path")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run(load_config(args.config), args.device)
    log_print("training done")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
