"""The port's flash_attention on the CPU against the JAX package's Pallas
kernels in interpreter mode (as tests/test_flash_attention.py runs them).

On the CPU the port's wrapper runs the kernels' plain version, so these
tests pin everything around the CUDA kernels: the sm_scale fold, the
[B,S,H,D] <-> [B,H,S,D] moves, the gathered RoPE tables, the custom
autograd backward with delta and the LSE cotangent, and
flash_attention_bwd_from_saved. fp32, rtol 1e-5 / atol 1e-5 (the kernels
accumulate in another order than the einsum path; 1e-5 covers fp32
round-off at these sizes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu.ops.flash_attention import (
    flash_attention as jflash,
    flash_attention_bwd_from_saved as jflash_bwd,
)
from picotron_tpu.ops.rope import rope_tables as jrope_tables
from picotron_tpu_torch.ops import flash_attention as tfa
from picotron_tpu_torch.ops.rope import rope_tables as trope_tables

TOL = dict(rtol=1e-5, atol=1e-5)

# (hq, hkv, causal, sq, sk, positions, rope, block)
CASES = [
    (4, 4, True, 32, 32, None, False, 16),
    (4, 2, True, 64, 64, None, True, 32),      # GQA, fused RoPE, static causal
    (8, 2, False, 32, 48, None, False, 16),    # non-causal, sk > sq
    (4, 2, True, 32, 64, "shifted", True, 16),  # ring-style later q shard
    (4, 1, True, 32, 32, "zigzag", True, 16),  # permuted positions
    (4, 2, True, 32, 64, None, False, 32),     # static causal, sk > sq
]


def _inputs(case, seed=0):
    hq, hkv, causal, sq, sk, positions, rope, block = case
    rng = np.random.default_rng(seed)
    d = 16
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(1, sq, hq, d), f(1, sk, hkv, d), f(1, sk, hkv, d)
    qp = kp = None
    if positions == "shifted":
        qp, kp = np.arange(sk - sq, sk), np.arange(sk)
    elif positions == "zigzag":
        half = sq // 4
        order = np.concatenate([np.arange(0, half), np.arange(3 * half, 4 * half),
                                np.arange(half, 2 * half),
                                np.arange(2 * half, 3 * half)])
        qp = kp = order
    return q, k, v, qp, kp, d


def _jax_rope(rope, d):
    return jrope_tables(128, d) if rope else None


def _torch_rope(rope, d):
    return trope_tables(128, d) if rope else None


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_forward_and_grads_with_lse_cotangent(case):
    hq, hkv, causal, sq, sk, positions, rope, block = case
    q, k, v, qp, kp, d = _inputs(case)
    rng = np.random.default_rng(1)
    w_o = rng.standard_normal((1, sq, hq, d)).astype(np.float32)
    w_l = rng.standard_normal((1, hq, sq)).astype(np.float32)
    jr, tr = _jax_rope(rope, d), _torch_rope(rope, d)

    def jloss(q, k, v):
        o, lse = jflash(q, k, v, causal=causal, q_positions=_j(qp),
                        kv_positions=_j(kp), return_lse=True, rope=jr,
                        block_q=block, block_k=block, interpret=True)
        # finite lse only: fully masked rows carry -inf by contract
        lse_f = jnp.where(jnp.isfinite(lse), lse, 0.0)
        return jnp.sum(o * w_o) + jnp.sum(lse_f * w_l), (o, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to, tl = tfa.flash_attention(tq, tk, tv, causal=causal,
                                 q_positions=_t(qp), kv_positions=_t(kp),
                                 return_lse=True, rope=tr)
    tl_f = torch.where(torch.isfinite(tl), tl, torch.zeros_like(tl))
    ((to * torch.from_numpy(w_o)).sum()
     + (tl_f * torch.from_numpy(w_l)).sum()).backward()

    close(to, jo)
    close(tl, jl)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        close(got, want)


@pytest.mark.parametrize("case", [CASES[1], CASES[3]], ids=["static", "shifted"])
def test_bwd_from_saved(case):
    hq, hkv, causal, sq, sk, positions, rope, block = case
    q, k, v, qp, kp, d = _inputs(case, seed=2)
    jr, tr = _jax_rope(rope, d), _torch_rope(rope, d)
    jo, jl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, q_positions=_j(qp), kv_positions=_j(kp),
                    return_lse=True, rope=jr, block_q=block, block_k=block,
                    interpret=True)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    jg = jflash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl,
                    jnp.asarray(do), causal=causal, q_positions=_j(qp),
                    kv_positions=_j(kp), rope=jr, block_q=block,
                    block_k=block, interpret=True)
    tg = tfa.flash_attention_bwd_from_saved(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl)),
        torch.from_numpy(do), causal=causal, q_positions=_t(qp),
        kv_positions=_t(kp), rope=tr)
    for got, want in zip(tg, jg):
        close(got, want)


def test_plain_path_never_counts_launches():
    tfa.reset_launch_counts()
    q, k, v, *_ = _inputs(CASES[0])
    out = tfa.flash_attention(*(torch.from_numpy(x).requires_grad_()
                                for x in (q, k, v)))
    out.sum().backward()
    assert tfa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}
    assert tfa.fwd_launches == {"tensor_core": 0, "cuda_core": 0}
    assert tfa.dq_launches == tfa.dkv_launches == {
        "wgmma": 0, "tensor_core": 0, "cuda_core": 0}
    assert tfa.prepass_launches == {"rope_rows": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rows_matches_the_pallas_rotation(dtype):
    """The wgmma kernels' rotation pre-pass (its plain version on the CPU)
    against the JAX kernels' `_rot` with `_rot_tables` at shifted
    positions: fp32 at 1e-6 (the same products, summed in another order),
    bf16 within one bf16 rounding step (XLA may contract a product into a
    fused multiply-add before the cast)."""
    from picotron_tpu.ops.flash_attention import _rot, _rot_tables

    rng = np.random.default_rng(5)
    b, h, s, d = 2, 3, 40, 64
    x = rng.standard_normal((b, h, s, d)).astype(np.float32)
    pos = np.arange(7, 7 + s)
    jcos, jsin = jrope_tables(64, d)
    jc, js = _rot_tables(jcos, jsin, jnp.asarray(pos)[None])
    jdt = getattr(jnp, dtype)
    want = np.stack([np.stack([np.asarray(
        _rot(jnp.asarray(x[i, j]).astype(jdt), jc, js, 1.0), np.float32)
        for j in range(h)]) for i in range(b)])
    tpos = torch.from_numpy(pos)
    c, sn, _, _ = tfa._tables(trope_tables(64, d), tpos, tpos)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tfa.reset_launch_counts()
    got = tfa.rope_rows(tx, c, sn).float().numpy()
    assert tfa.prepass_launches == {"rope_rows": 0}  # plain: no launch
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 2, 48)  # head_dim 48 is not a kernel variant
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_cuda("flash_fwd", q)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tfa._check_cuda("flash_fwd", q.half())
    q4, k4 = torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64)
    pos = torch.arange(8, dtype=torch.int32)
    ops = tfa._operands("flash_fwd", q4, k4, k4, pos, pos, None)
    assert ops[-1] == (None,) * 4
    with pytest.raises(ValueError, match="bad shapes"):
        tfa._operands("flash_fwd", q4, torch.zeros(1, 3, 8, 64),
                      torch.zeros(1, 3, 8, 64), pos, pos, None)
    with pytest.raises(ValueError, match="q positions"):
        tfa._operands("flash_fwd", q4, k4, k4, pos.long(), pos, None)
    with pytest.raises(ValueError, match="rope table"):
        tfa._operands("flash_fwd", q4, k4, k4, pos, pos,
                      (torch.zeros(8, 16),) * 4)
    with pytest.raises(ValueError, match="lse/delta"):
        tfa._operands("flash_bwd_dq", q4, k4, k4, pos, pos, None,
                      torch.zeros(1, 4, 7), torch.zeros(1, 4, 8), do4=q4)
    # a device with neither the kernel nor the plain version (a fake xpu
    # tensor stands in for one)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.zeros(q.shape, device="xpu")
        with pytest.raises(RuntimeError, match="no kernel"):
            tfa._fwd(x, x, x, None, None, None, True, True)
    # meta (the shapes-only step analysis/trace.py records) takes the plain
    # version and launches nothing
    launches = dict(tfa.launches)
    qm = q.to("meta")
    out4, lse = tfa._fwd(qm, qm, qm, None, None, None, True, True)
    assert out4.shape == qm.shape and out4.device.type == "meta"
    assert tfa.launches == launches
