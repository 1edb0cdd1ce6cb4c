"""Plain scaled-dot-product attention with GQA (port of
picotron_tpu/ops/attention.py).

The plain versions that the flash-attention kernels are held against, and
what `ops.flash_attention` runs for tensors on the CPU. Scores, softmax
statistics and products are fp32 whatever the input dtype (the JAX code's
`preferred_element_type=float32`); the log-sum-exp can be returned for
LSE merges. Never `F.scaled_dot_product_attention`.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_BIG = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: [B, S, Hkv, D] -> [B, S, Hkv * n_rep, D], each kv head repeated
    for its n_rep consecutive q heads."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def _causal_mask(sq: int, sk: int, q_positions, kv_positions, device):
    qp = (q_positions if q_positions is not None
          else torch.arange(sq, device=device))
    kp = (kv_positions if kv_positions is not None
          else torch.arange(sk, device=device))
    return qp.to(device)[:, None] >= kp.to(device)[None, :]


def sdpa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   q_positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   return_lse: bool = False,
                   sm_scale: Optional[float] = None):
    """q [B, Sq, Hq, D]; k/v [B, Sk, Hkv, D] (GQA unexpanded); the causal
    mask is `q_pos >= kv_pos` on the position vectors. Returns out
    [B, Sq, Hq, D] (and lse [B, Hq, Sq] fp32 when return_lse). Fully masked
    rows give out = 0 and lse = -inf."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape[2] != h:
        k = repeat_kv(k, h // k.shape[2])
        v = repeat_kv(v, h // v.shape[2])
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = _causal_mask(sq, sk, q_positions, kv_positions, q.device)
        scores = scores.masked_fill(~mask[None, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = m.clamp(min=_NEG_BIG)
    p = torch.exp(scores - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    probs = (p / l_safe).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    if return_lse:
        lse = torch.where(l == 0.0, torch.full_like(l, float("-inf")),
                          m_safe + torch.log(l_safe)).squeeze(-1)
        return out, lse
    return out


def sdpa_attention_bwd_from_saved(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    dlse: Optional[torch.Tensor] = None,
):
    """(dq, dk, dv) from the forward's saved (out, lse), the flash-attn-2
    backward identity written out:

        p  = exp(s - lse)        (normalised by the SAVED lse)
        dv = p^T @ dout
        ds = p * (dout @ v^T - delta),  delta = rowsum(dout * out) - dlse
        dq = ds @ k * scale,  dk = ds^T @ q * scale

    Because p is normalised by the passed lse, calling this on one K/V
    block of a larger attention with the global (out, lse, dout) gives that
    block's additive share of the gradients. Shapes as sdpa_attention; lse
    [B, Hq, Sq] fp32; `dlse` (same shape, default zero) is the LSE
    cotangent, an addition of the port for autograd through return_lse.
    Rows with lse = -inf contribute zero."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    kx = repeat_kv(k, n_rep).float()
    vx = repeat_kv(v, n_rep).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * sm_scale
    if causal:
        mask = _causal_mask(sq, sk, q_positions, kv_positions, q.device)
        scores = scores.masked_fill(~mask[None, None], _NEG_BIG)
    lse_f = lse.float()[..., None]
    p = torch.exp(scores - lse_f.clamp(min=_NEG_BIG))
    p = torch.where(torch.isneginf(lse_f), torch.zeros_like(p), p)
    do32 = dout.float()
    delta = (do32 * out.float()).sum(dim=-1).transpose(1, 2)[..., None]
    if dlse is not None:
        delta = delta - dlse.float()[..., None]
    dv_x = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, vx)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx) * sm_scale
    dk_x = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    if n_rep > 1:
        dk_x = dk_x.reshape(b, sk, h // n_rep, n_rep, d).sum(dim=3)
        dv_x = dv_x.reshape(b, sk, h // n_rep, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), dk_x.to(k.dtype), dv_x.to(v.dtype)
