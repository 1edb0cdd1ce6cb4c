"""Shared utilities (port of picotron_tpu/utils.py): MFU accounting at the
H100's bf16 peak, the per-step log line, a step timer, peak device memory.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import torch

from picotron_tpu_torch.config import ModelConfig, num_params

# NVIDIA's dense bf16 peak of one H100 SXM, the reference's own constant
H100_BF16_PEAK = 989.5e12


def cuda_or_cpu(device: str, cpu_hint: str = "pass --device cpu"
                ) -> torch.device:
    """`device` as a torch.device; a CUDA one must exist (no silent
    fallback to the CPU: `cpu_hint` says how to ask for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available; {cpu_hint} to run on "
                           "the CPU")
    return dev


def device_peak_flops(device=None) -> float:
    """bf16 peak FLOP/s of a CUDA device. Raises for a card it does not
    know rather than guessing, and for a non-CUDA device."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise ValueError(f"no peak FLOP/s for device {device}: MFU is a "
                         "device metric and needs a CUDA card")
    name = torch.cuda.get_device_name(device)
    if "H100" in name:
        return H100_BF16_PEAK
    raise ValueError(f"unknown card {name!r}: add its bf16 peak to "
                     "utils.device_peak_flops")


def flops_per_token(m: ModelConfig, seq_length: int) -> float:
    """Training FLOPs per token: 6N + 12 L h s (the reference's formula)."""
    n = num_params(m, active_only=True, include_tied_head=True)
    return 6.0 * n + 12.0 * m.num_hidden_layers * m.hidden_size * seq_length


def mfu(tokens_per_second: float, m: ModelConfig, seq_length: int,
        num_chips: int, peak_flops_per_chip: float) -> float:
    """Model FLOPs utilization in [0, 1]."""
    achieved = tokens_per_second * flops_per_token(m, seq_length)
    return achieved / (peak_flops_per_chip * num_chips)


def human_format(num: float) -> str:
    """1234567 -> '1.23M'."""
    num = float(f"{num:.3g}")
    magnitude = 0
    while abs(num) >= 1000:
        magnitude += 1
        num /= 1000.0
    suffix = ["", "K", "M", "B", "T", "P"][magnitude]
    return f"{num:f}".rstrip("0").rstrip(".") + suffix


_QUIET = [False]


def set_log_quiet(quiet: bool) -> None:
    """Silence `log_print` in this process (the ranks of a layout other
    than rank 0)."""
    _QUIET[0] = quiet


def log_print(*args, **kwargs) -> None:
    if _QUIET[0]:
        return
    print(*args, **kwargs)
    sys.stdout.flush()


class StepTimer:
    """Wall-clock per-step timing; callers synchronise the device first."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt


def training_log_line(step: int, loss: float, tokens_per_sec: float,
                      tokens_per_sec_per_chip: float, mfu_frac: float,
                      trained_tokens: int, memory_gb: float = 0.0,
                      extras: Optional[dict] = None) -> str:
    """The per-step console line, byte-compatible with the JAX package's
    (the metrics harvester parses these field names)."""
    line = (
        f"[step {step:06d}] loss: {loss:.4f} | "
        f"tokens/s: {human_format(tokens_per_sec)} | "
        f"tokens/s/chip: {human_format(tokens_per_sec_per_chip)} | "
        f"MFU: {100.0 * mfu_frac:.2f}% | "
        f"tokens: {human_format(trained_tokens)} | "
        f"mem: {memory_gb:.1f}GB"
    )
    for k, v in (extras or {}).items():
        line += f" | {k}: {v:.4f}"
    return line


def device_memory_gb(device) -> float:
    """Peak allocated memory of a CUDA device in GiB (0.0 on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / (1024 ** 3)
