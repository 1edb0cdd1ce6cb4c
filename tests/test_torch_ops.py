"""The port's plain ops against the JAX package's, in fp32 on the CPU.

Inputs are made with numpy from a seed and fed to both; the tolerance is
fp32 round-off (rtol 1e-5, atol 1e-5) unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu.ops import attention as jatt
from picotron_tpu.ops import losses as jloss
from picotron_tpu.ops import rmsnorm as jnorm
from picotron_tpu.ops import rope as jrope
from picotron_tpu_torch.ops import attention as tatt
from picotron_tpu_torch.ops import losses as tloss
from picotron_tpu_torch.ops import rmsnorm as tnorm
from picotron_tpu_torch.ops import rope as trope

TOL = dict(rtol=1e-5, atol=1e-5)


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), **(kw or TOL))


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
    {"rope_type": "linear", "factor": 4.0},
])
def test_rope_tables(scaling):
    jc, js = jrope.rope_tables(256, 32, 500000.0, rope_scaling=scaling)
    tc, ts = trope.rope_tables(256, 32, 500000.0, rope_scaling=scaling)
    close(tc, jc)
    close(ts, js)


def test_llama3_scale_freqs():
    inv = (1.0 / (10000.0 ** (np.arange(0, 64, 2) / 64))).astype(np.float32)
    close(trope.llama3_scale_freqs(torch.from_numpy(inv), factor=32.0,
                                   original_max_position=128),
          jrope.llama3_scale_freqs(jnp.asarray(inv), factor=32.0,
                                   original_max_position=128))


@pytest.mark.parametrize("positions", [None, "shifted", "permuted"])
def test_apply_rope(positions):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    pos = {None: None, "shifted": np.arange(16, 32),
           "permuted": rng.permutation(32)[:16]}[positions]
    jc, js = jrope.rope_tables(64, 8)
    tc, ts = trope.rope_tables(64, 8)
    got = trope.apply_rope(torch.from_numpy(x), tc, ts,
                           None if pos is None else torch.from_numpy(pos))
    want = jrope.apply_rope(jnp.asarray(x), jc, js,
                            None if pos is None else jnp.asarray(pos))
    close(got, want)


def test_apply_rope_bf16_rounds_once():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    jc, js = jrope.rope_tables(8, 16)
    tc, ts = trope.rope_tables(8, 16)
    got = trope.apply_rope(torch.from_numpy(x).bfloat16(), tc, ts)
    want = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jc, js)
    assert got.dtype == torch.bfloat16
    # both compute in fp32 and round once to bf16: equal bit for bit
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_apply_rope_out_of_table_raises():
    tc, ts = trope.rope_tables(8, 4)
    with pytest.raises(ValueError):
        trope.apply_rope(torch.zeros(1, 16, 1, 4), tc, ts)
    with pytest.raises(ValueError):
        trope.apply_rope(torch.zeros(1, 2, 1, 4), tc, ts, torch.tensor([3, 8]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 64)) * 4).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    jt = jnp.asarray(x, dtype)
    tt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tnorm.rms_norm(tt, torch.from_numpy(w), 1e-5)
    want = jnorm.rms_norm(jt, jnp.asarray(w), 1e-5)
    assert got.dtype == tt.dtype
    if dtype == "float32":
        close(got, want)
    else:  # fp32 math, one bf16 rounding; sums may differ by an ulp
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=8e-3, atol=8e-3)


def test_cross_entropy_sum_count_ignore_index():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    tgt = rng.integers(0, 50, (2, 7))
    tgt[0, 2] = tgt[1, 5] = tgt[1, 6] = jloss.IGNORE_INDEX
    assert tloss.IGNORE_INDEX == jloss.IGNORE_INDEX == -100
    jt, jn = jloss.cross_entropy_sum_count(jnp.asarray(logits),
                                           jnp.asarray(tgt))
    tt, tn = tloss.cross_entropy_sum_count(torch.from_numpy(logits),
                                           torch.from_numpy(tgt))
    close(tt, jt)
    assert int(tn) == int(jn) == 11
    close(tloss.cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt)),
          jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt)))


def test_repeat_kv():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    close(tatt.repeat_kv(torch.from_numpy(x), 3),
          jatt.repeat_kv(jnp.asarray(x), 3))


def _qkv(rng, b, sq, sk, hq, hkv, d):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, hq, d), f(b, sk, hkv, d), f(b, sk, hkv, d)


SDPA_CASES = [
    # (hq, hkv, causal, sq, sk, positions)
    (4, 4, True, 16, 16, None),
    (4, 2, True, 16, 16, None),
    (4, 2, False, 16, 24, None),
    (4, 1, True, 8, 16, "shifted"),
    (4, 2, True, 16, 16, "disjoint"),  # all rows masked -> lse = -inf
]


@pytest.mark.parametrize("case", SDPA_CASES, ids=range(len(SDPA_CASES)))
def test_sdpa_attention_and_bwd_from_saved(case):
    hq, hkv, causal, sq, sk, positions = case
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, sq, sk, hq, hkv, 8)
    qp = kp = None
    if positions == "shifted":
        qp, kp = np.arange(sk - sq, sk), np.arange(sk)
    elif positions == "disjoint":
        qp, kp = np.arange(sq), np.arange(sq, sq + sk)
    jpos = lambda p: None if p is None else jnp.asarray(p)  # noqa: E731
    tpos = lambda p: None if p is None else torch.from_numpy(p)  # noqa: E731
    jo, jl = jatt.sdpa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_positions=jpos(qp), kv_positions=jpos(kp), return_lse=True)
    to, tl = tatt.sdpa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_positions=tpos(qp), kv_positions=tpos(kp),
        return_lse=True)
    close(to, jo)
    np.testing.assert_array_equal(np.isneginf(tl.numpy()),
                                  np.isneginf(np.asarray(jl)))
    finite = np.isfinite(np.asarray(jl))
    close(tl.numpy()[finite], np.asarray(jl)[finite])

    do = rng.standard_normal(q.shape).astype(np.float32)
    jg = jatt.sdpa_attention_bwd_from_saved(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl,
        jnp.asarray(do), causal=causal, q_positions=jpos(qp),
        kv_positions=jpos(kp))
    tg = tatt.sdpa_attention_bwd_from_saved(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), to, tl,
        torch.from_numpy(do), causal=causal, q_positions=tpos(qp),
        kv_positions=tpos(kp))
    for a, b in zip(tg, jg):
        close(a, b)
