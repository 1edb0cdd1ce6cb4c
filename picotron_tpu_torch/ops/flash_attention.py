"""Flash attention: the wrapper around the hand-written Hopper kernels in
`csrc/flash_attention.cu`, with their plain PyTorch versions beside them.

Port of picotron_tpu/ops/flash_attention.py. The three Pallas TPU kernels
there (`_fwd_kernel` :139, `_bwd_dq_kernel` :327, `_bwd_dkv_kernel` :412)
become CUDA kernels for sm_90a (all three on the tensor cores for bf16,
on CUDA cores for fp32; the bf16 dq and dk/dv at D 64 on Hopper's wgmma,
fed by TMA, reading q and k that one pre-pass rotates once per backward
call); the source note at the top of the .cu file says what bounds them
on the card (operations: causal attention at S = 2048 is far above the
card's FLOP/byte ridge) and what their design does about it. The public
contract is the JAX one:

    flash_attention(q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D], causal=, q_positions=,
                    kv_positions=, return_lse=, sm_scale=, rope=)
      -> out [B,Sq,Hq,D] (, lse [B,Hq,Sq] fp32)

with the gradient through a `torch.autograd.Function` whose backward runs
the dq and dk/dv kernels, and `flash_attention_bwd_from_saved` on the
same two kernels.

Device dispatch, by the tensors' device only: CUDA tensors launch the
kernel (or raise: wrong dtype, head dim, or a failed build — no fallback);
CPU tensors run the plain version, RoPE in fp32 + `sdpa_attention` /
`sdpa_attention_bwd_from_saved` on the same [B,H,S,D] layout, so the CPU
tests drive everything around the kernels (the sm_scale fold, the layout
moves, the RoPE tables, delta and the LSE cotangent). `launches` counts
kernel launches per kernel, `fwd_launches`, `dq_launches` and
`dkv_launches` each kernel's by variant (bf16 on the tensor cores, fp32
on CUDA cores; dq's and dk/dv's bf16 D 64 on wgmma), and
`prepass_launches` the rotation pre-pass of the wgmma kernels; plain runs
never count. Meta tensors (the shapes-only step that `analysis/trace.py`
records) take the plain version too: it launches nothing.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from picotron_tpu_torch.ops.attention import (
    sdpa_attention, sdpa_attention_bwd_from_saved,
)

# launches of each kernel since the last reset (plain integers, counted
# under a lock so that threads launching at once lose no count)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# the forward's launches by the kernel that ran: `fwd_mma_kernel` (bf16,
# tensor cores) or `fwd_kernel` (fp32, CUDA cores)
fwd_launches = {"tensor_core": 0, "cuda_core": 0}
# the same for dq: `bwd_dq_wgmma_kernel` (bf16, D 64), `bwd_dq_mma_kernel`
# (bf16, D 128) or `bwd_dq_kernel` (fp32)
dq_launches = {"wgmma": 0, "tensor_core": 0, "cuda_core": 0}
# the same for dk/dv: `bwd_dkv_wgmma_kernel` (bf16, D 64), `bwd_dkv_mma_kernel`
# (bf16, D 128) or `bwd_dkv_kernel` (fp32)
dkv_launches = {"wgmma": 0, "tensor_core": 0, "cuda_core": 0}
# the wgmma kernels' rotation pre-pass (`rope_rows_kernel`): once for q
# and once for k in each bf16 D-64 backward call with RoPE, shared by dq
# and dk/dv (and in each call of either wrapper alone that is not handed
# rotated operands)
prepass_launches = {"rope_rows": 0}

SUPPORTED_HEAD_DIMS = (64, 128)
# the head dims whose bf16 dq and dk/dv run `bwd_dq_wgmma_kernel` and
# `bwd_dkv_wgmma_kernel` on pre-rotated q and k (a static dispatch on D in
# `pt_flash_bwd_dq` and `pt_flash_bwd_dkv`; D 128 runs the mma.sync
# kernels: dk/dv's four accumulators would not fit the registers, and
# dq's 256-byte rows would span two swizzle atoms)
WGMMA_HEAD_DIMS = (64,)
_SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)


_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for counts in (launches, fwd_launches, dq_launches, dkv_launches,
                       prepass_launches):
            for key in counts:
                counts[key] = 0


def _count(name: str, variants: dict, dtype,
           variant: Optional[str] = None) -> None:
    """One launch of kernel `name` (its variant `variant`, else by dtype)."""
    with _COUNT_LOCK:
        launches[name] += 1
        variants[variant or ("tensor_core" if dtype == torch.bfloat16
                             else "cuda_core")] += 1


# ---------------------------------------------------------------------------
# The CUDA library
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from picotron_tpu_torch.kernels.build import load

    lib = load("flash_attention")
    if not getattr(lib, "_pt_typed", False):
        lib.pt_flash_fwd.argtypes = [_P] * 11 + [_I] * 9 + [_P]
        lib.pt_flash_bwd_dq.argtypes = [_P] * 13 + [_I] * 9 + [_P]
        lib.pt_flash_bwd_dkv.argtypes = [_P] * 14 + [_I] * 9 + [_P]
        lib.pt_rope_rows.argtypes = [_P] * 4 + [_I] * 4 + [_P]
        lib.pt_dkv_wgmma_smem.argtypes = []
        lib.pt_dq_wgmma_smem.argtypes = []
        for fn in (lib.pt_flash_fwd, lib.pt_flash_bwd_dq, lib.pt_flash_bwd_dkv,
                   lib.pt_rope_rows, lib.pt_dkv_wgmma_smem,
                   lib.pt_dq_wgmma_smem):
            fn.restype = _I
        lib._pt_typed = True
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dtype not in _SUPPORTED_DTYPES:
        raise TypeError(f"{name}: CUDA kernel takes bf16 or fp32, got {q.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: CUDA kernel takes head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {q.shape[-1]}")
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: all operands must share device and "
                             f"dtype ({q.device}, {q.dtype})")


def _operands(name, q4, k4, v4, qpos, kpos, tabs, *rows, do4=None):
    """Validate the kernel operands and make them contiguous: q4/do4
    [B,Hq,Sq,D], k4/v4 [B,Hkv,Sk,D] (Hq a multiple of Hkv), positions int32
    [Sq]/[Sk], tables fp32 [Sq or Sk, D/2], rows (lse, delta) fp32
    [B,Hq,Sq]. Returns them in order, `tabs` as a 4-tuple (of Nones
    without RoPE)."""
    ts = (q4, k4, v4) if do4 is None else (q4, k4, v4, do4)
    _check_cuda(name, *ts)
    b, hq, sq, d = q4.shape
    hkv, sk = k4.shape[1], k4.shape[2]
    if (k4.dim() != 4 or k4.shape != v4.shape or k4.shape[0] != b
            or k4.shape[3] != d or hq % hkv != 0
            or (do4 is not None and do4.shape != q4.shape)):
        raise ValueError(f"{name}: bad shapes q {tuple(q4.shape)} k "
                         f"{tuple(k4.shape)} v {tuple(v4.shape)}")

    def exact(t, shape, dtype, what):
        if (t.shape != shape or t.dtype != dtype
                or t.device != q4.device):
            raise ValueError(f"{name}: {what} must be {dtype} {tuple(shape)} "
                             f"on {q4.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        return t.contiguous()

    qpos = exact(qpos, (sq,), torch.int32, "q positions")
    kpos = exact(kpos, (sk,), torch.int32, "kv positions")
    if tabs is None:
        tabs = (None,) * 4
    else:
        tabs = tuple(exact(t, (n, d // 2), torch.float32, "rope table")
                     for t, n in zip(tabs, (sq, sq, sk, sk)))
    rows = tuple(exact(r, (b, hq, sq), torch.float32, "lse/delta")
                 for r in rows)
    ts = tuple(t.contiguous() for t in ts)
    return (*ts, qpos, kpos, tabs, *rows)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_kernel(q4, k4, v4, qpos, kpos, tabs, causal, static_causal):
    """Launch the forward kernel: q4 [B,Hq,Sq,D] (already scaled), k4/v4
    [B,Hkv,Sk,D], qpos/kpos int32, tabs None or the gathered fp32 tables
    (cq, sq, ck, sk). -> out4 [B,Hq,Sq,D], lse [B,Hq,Sq] fp32.

    `pt_flash_fwd` dispatches by dtype: bf16 (the training path) always
    runs `fwd_mma_kernel` on the tensor cores, fp32 runs the CUDA-core
    `fwd_kernel`; `fwd_launches` records which."""
    q4, k4, v4, qpos, kpos, tabs = _operands(
        "flash_fwd", q4, k4, v4, qpos, kpos, tabs)
    b, hq, sq, d = q4.shape
    hkv, sk = k4.shape[1], k4.shape[2]
    out = torch.empty_like(q4)
    lse = torch.empty((b, hq, sq), device=q4.device, dtype=torch.float32)
    rc = _lib().pt_flash_fwd(
        _ptr(q4), _ptr(k4), _ptr(v4), _ptr(out), _ptr(lse), _ptr(qpos),
        _ptr(kpos), *map(_ptr, tabs), b, hq, hkv, sq, sk, d, int(causal),
        int(static_causal), int(q4.dtype == torch.bfloat16), _stream(q4))
    _raise_on(rc, "flash_fwd")
    _count("flash_fwd", fwd_launches, q4.dtype)
    return out, lse


def _wgmma(q4) -> bool:
    """Whether bf16 q4's dq and dk/dv run the wgmma kernels (on q and k
    rotated beforehand)."""
    return q4.dtype == torch.bfloat16 and q4.shape[-1] in WGMMA_HEAD_DIMS


def _prerotate(q4, k4, tabs, rotated):
    """(q4, k4) for a wgmma kernel: rotated by the pre-pass, unless the
    caller did (`rotated`) or there is no RoPE."""
    if tabs[0] is None or rotated:
        return q4, k4
    return (rope_rows_kernel(q4, tabs[0], tabs[1]),
            rope_rows_kernel(k4, tabs[2], tabs[3]))


def _aligned16(*ts):
    """The tensors, each copied if it does not start on 16 bytes (TMA
    reads from 16-byte aligned addresses)."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def _check_rotated(name, q4, rotated):
    if rotated and not _wgmma(q4):
        raise ValueError(f"{name}: rotated q and k are for the wgmma kernels "
                         f"(bf16, head_dim in {WGMMA_HEAD_DIMS}), got "
                         f"{q4.dtype} {q4.shape[-1]}")


def bwd_dq_kernel(q4, k4, v4, do4, lse, delta, qpos, kpos, tabs, causal,
                  static_causal, rotated=False):
    """Launch the dq kernel -> dq4 [B,Hq,Sq,D] (w.r.t. the scaled q).

    `pt_flash_bwd_dq` dispatches by dtype and head dim: bf16 (the
    training path) at D 64 runs `bwd_dq_wgmma_kernel` (wgmma fed by TMA)
    on q and k rotated beforehand by `rope_rows_kernel` (two launches of
    the pre-pass, unless `rotated` says that q4 and k4 come rotated, as
    `_bwd` hands them to dq and dk/dv alike; only dq's inverse rotation
    stays in the kernel); bf16 at D 128 runs `bwd_dq_mma_kernel`
    (mma.sync, RoPE per tile); fp32 runs the CUDA-core `bwd_dq_kernel`.
    `dq_launches` records which."""
    _check_rotated("flash_bwd_dq", q4, rotated)
    q4, k4, v4, do4, qpos, kpos, tabs, lse, delta = _operands(
        "flash_bwd_dq", q4, k4, v4, qpos, kpos, tabs, lse, delta, do4=do4)
    b, hq, sq, d = q4.shape
    hkv, sk = k4.shape[1], k4.shape[2]
    wgmma = _wgmma(q4)
    if wgmma:
        (kpos,) = _aligned16(kpos)
        q4, k4 = _prerotate(q4, k4, tabs, rotated)
        tabs = (*tabs[:2], None, None)  # dq's inverse rotation alone
    dq = torch.empty_like(q4)
    rc = _lib().pt_flash_bwd_dq(
        _ptr(q4), _ptr(k4), _ptr(v4), _ptr(do4), _ptr(lse), _ptr(delta),
        _ptr(dq), _ptr(qpos), _ptr(kpos), *map(_ptr, tabs), b, hq, hkv, sq,
        sk, d, int(causal), int(static_causal),
        int(q4.dtype == torch.bfloat16), _stream(q4))
    _raise_on(rc, "flash_bwd_dq")
    _count("flash_bwd_dq", dq_launches, q4.dtype, "wgmma" if wgmma else None)
    return dq


def bwd_dkv_kernel(q4, k4, v4, do4, lse, delta, qpos, kpos, tabs, causal,
                   static_causal, rotated=False):
    """Launch the dk/dv kernel -> dk4, dv4 [B,Hkv,Sk,D].

    `pt_flash_bwd_dkv` dispatches by dtype and head dim: bf16 (the
    training path) at D 64 runs `bwd_dkv_wgmma_kernel` (wgmma fed by TMA)
    on q and k rotated beforehand by `rope_rows_kernel` (two launches of
    the pre-pass, unless `rotated` says that q4 and k4 come rotated; only
    dk's inverse rotation stays in the kernel); bf16 at D 128 runs
    `bwd_dkv_mma_kernel` (mma.sync, RoPE per tile); fp32 runs the
    CUDA-core `bwd_dkv_kernel`. `dkv_launches` records which."""
    _check_rotated("flash_bwd_dkv", q4, rotated)
    q4, k4, v4, do4, qpos, kpos, tabs, lse, delta = _operands(
        "flash_bwd_dkv", q4, k4, v4, qpos, kpos, tabs, lse, delta, do4=do4)
    b, hq, sq, d = q4.shape
    hkv, sk = k4.shape[1], k4.shape[2]
    wgmma = _wgmma(q4)
    if wgmma:
        lse, delta, qpos = _aligned16(lse, delta, qpos)
        q4, k4 = _prerotate(q4, k4, tabs, rotated)
        tabs = (None, None, *tabs[2:])  # dk's inverse rotation alone
    dk = torch.empty_like(k4)
    dv = torch.empty_like(v4)
    rc = _lib().pt_flash_bwd_dkv(
        _ptr(q4), _ptr(k4), _ptr(v4), _ptr(do4), _ptr(lse), _ptr(delta),
        _ptr(dk), _ptr(dv), _ptr(qpos), _ptr(kpos), *map(_ptr, tabs), b, hq,
        hkv, sq, sk, d, int(causal), int(static_causal),
        int(q4.dtype == torch.bfloat16), _stream(q4))
    _raise_on(rc, "flash_bwd_dkv")
    _count("flash_bwd_dkv", dkv_launches, q4.dtype, "wgmma" if wgmma else None)
    return dk, dv


def rope_rows_kernel(x4, c, s):
    """Launch the wgmma kernels' rotation pre-pass: x4 [B,H,S,D] bf16 (D
    in WGMMA_HEAD_DIMS) rotated by the gathered tables c, s [S, D/2] fp32
    -> a new [B,H,S,D] bf16 tensor, bit for bit `_rot(x4, c, s, 1.0)`."""
    b, h, sq, d = x4.shape
    if x4.dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"rope_rows: CUDA kernel takes bf16 with head_dim "
                         f"in {WGMMA_HEAD_DIMS}, got {x4.dtype} {d}")
    for t in (c, s):
        if (t.shape != (sq, d // 2) or t.dtype != torch.float32
                or t.device != x4.device):
            raise ValueError(f"rope_rows: tables must be float32 "
                             f"{(sq, d // 2)} on {x4.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    x4, c, s = x4.contiguous(), c.contiguous(), s.contiguous()
    y = torch.empty_like(x4)
    rc = _lib().pt_rope_rows(_ptr(x4), _ptr(c), _ptr(s), _ptr(y), b, h, sq,
                             d, _stream(x4))
    _raise_on(rc, "rope_rows")
    with _COUNT_LOCK:
        prepass_launches["rope_rows"] += 1
    return y


def rope_rows(x4, c, s):
    """x4 [B,H,S,D] rotated by the gathered tables c, s [S, D/2]: the
    pre-pass kernel on CUDA tensors, `_rot` (its plain version) on the
    CPU."""
    if x4.is_cuda:
        return rope_rows_kernel(x4, c, s)
    return _rot(x4, c, s, 1.0)


# ---------------------------------------------------------------------------
# Plain versions (same [B,H,S,D] layout and arguments as the kernels)
# ---------------------------------------------------------------------------


def _rot(x4, c, s, sign: float):
    """Rotate-half on [B,H,S,D] with gathered half tables c/s [S, D/2] in
    fp32, cast back to x4's dtype; sign=-1 is the inverse (transpose)."""
    half = x4.shape[-1] // 2
    xf = x4.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    s = s * sign
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x4.dtype)


def fwd_plain(q4, k4, v4, qpos, kpos, tabs, causal):
    """Plain forward: RoPE in fp32, then sdpa_attention with sm_scale 1."""
    if tabs is not None:
        q4 = _rot(q4, tabs[0], tabs[1], 1.0)
        k4 = _rot(k4, tabs[2], tabs[3], 1.0)
    out, lse = sdpa_attention(
        q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2),
        causal=causal, q_positions=qpos, kv_positions=kpos, return_lse=True,
        sm_scale=1.0)
    return out.transpose(1, 2), lse


def bwd_plain(q4, k4, v4, o4, lse, do4, dlse, qpos, kpos, tabs, causal):
    """Plain backward from the saved (out, lse): the dq and dk/dv kernels'
    function, with the inverse rotation of dq and dk."""
    if tabs is not None:
        q4 = _rot(q4, tabs[0], tabs[1], 1.0)
        k4 = _rot(k4, tabs[2], tabs[3], 1.0)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    dq, dk, dv = sdpa_attention_bwd_from_saved(
        t(q4), t(k4), t(v4), t(o4), lse, t(do4), causal=causal,
        q_positions=qpos, kv_positions=kpos, sm_scale=1.0, dlse=dlse)
    dq, dk, dv = t(dq), t(dk), t(dv)
    if tabs is not None:
        dq = _rot(dq.float(), tabs[0], tabs[1], -1.0).to(q4.dtype)
        dk = _rot(dk.float(), tabs[2], tabs[3], -1.0).to(k4.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Dispatch and autograd
# ---------------------------------------------------------------------------


def _fwd(q4, k4, v4, qpos, kpos, tabs, causal, static_causal):
    if q4.is_cuda:
        return fwd_kernel(q4, k4, v4, qpos, kpos, tabs, causal, static_causal)
    if q4.device.type not in ("cpu", "meta"):
        raise RuntimeError(f"flash_attention: no kernel for {q4.device}")
    return fwd_plain(q4, k4, v4, qpos, kpos, tabs, causal)


def _delta(do4, o4, dlse):
    """delta = rowsum(dO * O) - dlse [B,H,Sq] fp32 (flash-attn 2's D term
    with the LSE cotangent folded in, as the JAX `_bwd` computes it)."""
    delta = (do4.float() * o4.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _bwd(q4, k4, v4, o4, lse, do4, dlse, qpos, kpos, tabs, causal,
         static_causal):
    if q4.is_cuda:
        delta = _delta(do4, o4, dlse)
        # the wgmma dq and dk/dv read one rotation of q and k: two launches
        # of the pre-pass per call
        rotated = tabs is not None and _wgmma(q4)
        if rotated:
            q4 = rope_rows_kernel(q4, tabs[0], tabs[1])
            k4 = rope_rows_kernel(k4, tabs[2], tabs[3])
        dq = bwd_dq_kernel(q4, k4, v4, do4, lse, delta, qpos, kpos, tabs,
                           causal, static_causal, rotated)
        dk, dv = bwd_dkv_kernel(q4, k4, v4, do4, lse, delta, qpos, kpos,
                                tabs, causal, static_causal, rotated)
        return dq, dk, dv
    if q4.device.type not in ("cpu", "meta"):
        raise RuntimeError(f"flash_attention: no kernel for {q4.device}")
    return bwd_plain(q4, k4, v4, o4, lse, do4, dlse, qpos, kpos, tabs, causal)


class _FlashCore(torch.autograd.Function):
    """(out4, lse) of the forward kernel; the backward launches the dq and
    dk/dv kernels on the saved (q, k, v, out, lse). The RoPE tables and
    positions are constants and get no gradient."""

    @staticmethod
    def forward(ctx, q4, k4, v4, qpos, kpos, cq, sq, ck, sk, causal,
                static_causal):
        tabs = None if cq is None else (cq, sq, ck, sk)
        out, lse = _fwd(q4, k4, v4, qpos, kpos, tabs, causal, static_causal)
        ctx.save_for_backward(q4, k4, v4, out, lse, qpos, kpos,
                              *(tabs or ()))
        ctx.causal, ctx.static_causal = causal, static_causal
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q4, k4, v4, out, lse, qpos, kpos, *tabs = ctx.saved_tensors
        dq, dk, dv = _bwd(q4, k4, v4, out, lse, dout, dlse, qpos, kpos,
                          tuple(tabs) or None, ctx.causal, ctx.static_causal)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def _positions(pos, n, device):
    if pos is None:
        return torch.arange(n, device=device, dtype=torch.int32)
    return pos.to(device=device, dtype=torch.int32).reshape(n).contiguous()


def _tables(rope, qpos, kpos):
    """Gather the (cos, sin) half tables at the q and k positions (the JAX
    `_rot_tables` step, done outside the kernels there too)."""
    if rope is None:
        return None
    cos, sin = rope
    qi, ki = qpos.long(), kpos.long()
    return tuple(t.float().contiguous() for t in
                 (cos[qi], sin[qi], cos[ki], sin[ki]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    return_lse: bool = False,
                    sm_scale: Optional[float] = None,
                    rope: Optional[tuple] = None):
    """Flash counterpart of `sdpa_attention`: q [B, Sq, Hq, D]; k/v
    [B, Sk, Hkv, D] (GQA unexpanded); optional position vectors for the
    causal mask `q_pos >= kv_pos`. `rope` = (cos, sin) half tables
    [maxS, D/2]: q/k arrive unrotated and are rotated inside the kernels at
    their positions. Returns out (and the fp32 scaled-score lse
    [B, Hq, Sq])."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    # positions None = plain 0..S-1: the kernels' static-causal loop bounds
    static_causal = causal and q_positions is None and kv_positions is None
    qpos = _positions(q_positions, sq, q.device)
    kpos = _positions(kv_positions, sk, q.device)
    tabs = _tables(rope, qpos, kpos)
    # fold sm_scale into q once, in the input dtype (as the JAX wrapper
    # does, so d = 128 rounds the same way); autograd carries the factor
    # into dq
    # (a 0-dim host tensor reaches the kernel as a value: no copy)
    scale = torch.tensor(sm_scale, dtype=q.dtype)  # shardcheck: ok
    q4 = (q * scale).transpose(1, 2)
    out4, lse = _FlashCore.apply(
        q4, k.transpose(1, 2), v.transpose(1, 2), qpos, kpos,
        *(tabs or (None,) * 4), causal, static_causal)
    out = out4.transpose(1, 2)
    return (out, lse) if return_lse else out


def flash_attention_bwd_from_saved(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None, rope: Optional[tuple] = None,
):
    """(dq, dk, dv) from the forward's saved tensors, on the dq and dk/dv
    kernels: q [B, Sq, Hq, D] unrotated and unscaled, out/dout like q, lse
    [B, Hq, Sq] fp32. The gradients are normalised by the passed (out,
    lse), so one K/V block's call gives its additive share of the global
    gradients. The LSE cotangent is zero."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    static_causal = causal and q_positions is None and kv_positions is None
    qpos = _positions(q_positions, sq, q.device)
    kpos = _positions(kv_positions, sk, q.device)
    tabs = _tables(rope, qpos, kpos)
    scale = torch.tensor(sm_scale, dtype=q.dtype)  # shardcheck: ok (0-dim)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    dq4, dk4, dv4 = _bwd(t(q * scale), t(k), t(v), t(out), lse, t(dout),
                         None, qpos, kpos, tabs, causal, static_causal)
    # chain rule through the q * sm_scale fold
    return t(dq4) * scale, t(dk4), t(dv4)
