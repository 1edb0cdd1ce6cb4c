"""Rotary position embeddings (port of picotron_tpu/ops/rope.py).

Non-interleaved "rotate-half" RoPE with HF-compatible frequencies. Tables
are fp32 half tables [max_seq, head_dim // 2]; the rotation runs in fp32
and is cast back to the input dtype. One table pair serves all layers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def llama3_scale_freqs(inv_freq: torch.Tensor, factor: float = 8.0,
                       low_freq_factor: float = 1.0,
                       high_freq_factor: float = 4.0,
                       original_max_position: int = 8192) -> torch.Tensor:
    """Llama-3.1-style frequency scaling (`rope_scaling: {"rope_type":
    "llama3"}`): long wavelengths are divided by `factor`, short ones kept,
    and the band between interpolates smoothly."""
    wavelen = 2.0 * math.pi / inv_freq
    low_wl = original_max_position / low_freq_factor
    high_wl = original_max_position / high_freq_factor
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    smooth = smooth.clamp(0.0, 1.0)
    return torch.where(
        wavelen > low_wl, inv_freq / factor,
        torch.where(wavelen < high_wl, inv_freq,
                    (1 - smooth) * inv_freq / factor + smooth * inv_freq))


def rope_tables(max_seq_len: int, head_dim: int, base: float = 10000.0,
                rope_scaling: Optional[dict] = None, device=None):
    """cos/sin tables, each [max_seq_len, head_dim // 2] fp32.

    `rope_scaling`: optional HF-style dict with `rope_type` "llama3" or
    "linear"."""
    assert head_dim % 2 == 0, "head_dim must be even for RoPE"
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (base ** exponent)
    if rope_scaling:
        kind = rope_scaling.get("rope_type", rope_scaling.get("type"))
        if kind == "llama3":
            inv_freq = llama3_scale_freqs(
                inv_freq,
                factor=rope_scaling.get("factor", 8.0),
                low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
                high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
                original_max_position=rope_scaling.get(
                    "original_max_position_embeddings", 8192))
        elif kind == "linear":
            inv_freq = inv_freq / rope_scaling.get("factor", 1.0)
        else:
            raise ValueError(
                f"unsupported rope_scaling type {kind!r} (supported: "
                f"'llama3', 'linear')")
    positions = torch.arange(max_seq_len, dtype=torch.float32,
                             device=device)[:, None]
    angles = positions * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate-half RoPE on x [batch, seq, heads, head_dim] with the half
    tables; `positions` [seq] are the tokens' global positions (default
    0..seq-1)."""
    seq_len = x.shape[1]
    if positions is None:
        if seq_len > cos.shape[0]:
            raise ValueError(
                f"sequence length {seq_len} exceeds the RoPE table length "
                f"{cos.shape[0]} (max_position_embeddings)")
        c, s = cos[:seq_len], sin[:seq_len]
    else:
        pmax = int(positions.max())
        if pmax >= cos.shape[0]:
            raise ValueError(
                f"position {pmax} exceeds the RoPE table length "
                f"{cos.shape[0]}")
        positions = positions.to(device=cos.device, dtype=torch.long)
        c, s = cos[positions], sin[positions]
    c = c[None, :, None, :]
    s = s[None, :, None, :]
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
