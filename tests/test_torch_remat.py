"""The port's remat policies and chunked cross-entropy on the CPU at fp32.

Every remat policy's grads equal the no-remat grads (the recompute runs
the same ops), and the tensors one layer keeps for its backward, counted
through `torch.autograd.graph.saved_tensors_hooks`, are the policy's
documented saved set (`models/llama.py` docstring). The chunked CE holds
to the JAX package's `vocab_parallel_ce_sum_count(chunk_size=...)` and to
the port's unchunked CE, loss and grads on hidden and head, with
IGNORE_INDEX targets."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu.models import llama as jllama
from picotron_tpu.parallel.tp import vocab_parallel_ce_sum_count
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.ops.losses import (
    IGNORE_INDEX, chunked_cross_entropy_sum_count, cross_entropy_sum_count,
)

POLICIES = ["full", "dots", "dots_attn", "dots_lean", "dots_norms"]
# the saved-set sizes of the models/llama.py docstring's table
SAVED_PER_LAYER = {"full": 1, "dots_attn": 6, "dots_lean": 8, "dots": 9,
                   "dots_norms": 11}
MODEL = dict(num_attention_heads=8, num_key_value_heads=4,
             num_hidden_layers=3, hidden_size=64, intermediate_size=96,
             vocab_size=256, max_position_embeddings=64, dtype="float32")


@functools.lru_cache(maxsize=None)
def _tree(preset: str):
    jc = jcfg.config_from_dict({"model": {"name": preset, **MODEL},
                                "training": {"seq_length": 64}})
    tree = jax.tree.map(np.asarray, jllama.init_params(jc.model,
                                                       jax.random.key(5)))
    rng = np.random.default_rng(5)
    for name in ("b_q", "b_k", "b_v"):  # zero-init biases made to count
        if name in tree["layers"]:
            tree["layers"][name] = (0.1 * rng.standard_normal(
                tree["layers"][name].shape)).astype(np.float32)
    return tree


def _model(preset="debug-tiny", attn_impl="auto"):
    tc = tcfg.config_from_dict({"model": {"name": preset, **MODEL,
                                          "attn_impl": attn_impl},
                                "training": {"seq_length": 64}})
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(_tree(preset), tc.model))
    return model


def _batch(vocab=256, b=2, s=64, seed=1):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, vocab, (b, s)))
    tgt = torch.from_numpy(rng.integers(0, vocab, (b, s)))
    tgt[0, :5] = IGNORE_INDEX
    return ids, tgt


def _grads(model, ids, tgt, remat):
    model.zero_grad(set_to_none=True)
    total, _, _ = tllama.loss_sum_count(model, ids, tgt, remat)
    total.backward()
    return float(total.detach()), {n: p.grad.clone() for n, p in
                          model.named_parameters()}


@pytest.mark.parametrize("attn_impl", ["auto", "reference"])
@pytest.mark.parametrize("preset", ["debug-tiny", "debug-tiny-qwen"])
def test_every_policy_matches_no_remat(preset, attn_impl):
    model = _model(preset, attn_impl)
    ids, tgt = _batch()
    loss0, g0 = _grads(model, ids, tgt, None)
    for policy in POLICIES:
        loss, g = _grads(model, ids, tgt, policy)
        assert loss == loss0, policy
        for name, want in g0.items():
            err = float((g[name] - want).abs().max())
            assert err <= 1e-6 * float(want.abs().max()), (policy, name, err)


def saved_per_layer(policy, layer_fn=None) -> int:
    """Distinct activation tensors (by storage) one layer keeps for its
    backward: what the autograd nodes and checkpoint segments pack,
    without weights, RoPE tables, positions and scalars."""
    model = _model()
    b, s, h = 2, 64, MODEL["hidden_size"]
    x = torch.randn(b, s, h, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    storages = set()

    def pack(t):
        # [B, ...] activations and their [B * S, ...] matmul views
        if t.dim() >= 2 and t.shape[0] in (b, b * s):
            storages.add(t.untyped_storage().data_ptr())
        return t

    rope = (model.rope_cos, model.rope_sin)
    fn = layer_fn or tllama.remat_layer
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = fn(x, model.layers[0], model.cfg, rope, policy)
    y.sum().backward()  # the saved set is enough for the backward
    return len(storages)


@pytest.mark.parametrize("policy", POLICIES)
def test_saved_tensors_per_layer_match_the_table(policy):
    assert saved_per_layer(policy) == SAVED_PER_LAYER[policy]


def test_count_catches_dots_attn_saving_the_mlp():
    """A planted edit: "dots_attn" with the MLP out of its segment keeps
    the MLP's activations, and the count test sees it."""
    def planted(x, lp, cfg, rope, policy):
        q, k, v = tllama._segment(tllama._qkv_block, x, lp, cfg)
        a = x + tllama._segment(tllama._o_proj,
                                tllama._attention(q, k, v, cfg, rope), lp)
        return a + tllama._mlp_block(a, lp, cfg)

    assert saved_per_layer("dots_attn", planted) > SAVED_PER_LAYER[
        "dots_attn"]


def test_dots_offload_is_refused():
    model = _model()
    x = torch.zeros(2, 64, MODEL["hidden_size"], requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
        tllama.remat_layer(x, model.layers[0], model.cfg,
                           (model.rope_cos, model.rope_sin), "dots_offload")


def _ce_case(dtype=torch.float32, n=(2, 24), hdim=16, vocab=64, seed=3):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((*n, hdim)).astype(np.float32)
    head = (0.3 * rng.standard_normal((vocab, hdim))).astype(np.float32)
    tgt = rng.integers(0, vocab, n)
    tgt[0, :4] = IGNORE_INDEX
    tgt[1, -1] = IGNORE_INDEX
    return hidden, head, tgt


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_ce_matches_jax_and_unchunked(chunk):
    hidden, head, tgt = _ce_case()
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(head).requires_grad_()
    total, count = chunked_cross_entropy_sum_count(th, tw,
                                                   torch.from_numpy(tgt), chunk)
    total.backward()

    uh = torch.from_numpy(hidden).requires_grad_()
    uw = torch.from_numpy(head).requires_grad_()
    utotal, ucount = cross_entropy_sum_count(uh @ uw.t(), torch.from_numpy(tgt))
    utotal.backward()

    def jloss(h, w):
        from jax.sharding import Mesh, PartitionSpec as P
        from picotron_tpu import compat

        mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
        fn = compat.shard_map(
            lambda h_, w_: vocab_parallel_ce_sum_count(
                h_, w_, jnp.asarray(tgt), chunk_size=chunk)[0],
            mesh=mesh, in_specs=(P(), P()), out_specs=P())
        return fn(h, w.T)

    jtotal, (jdh, jdw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(hidden), jnp.asarray(head))
    assert int(count) == int(ucount) == int((tgt != IGNORE_INDEX).sum())
    for want, what in ((float(utotal.detach()), "unchunked"),
                       (float(jtotal), "jax")):
        np.testing.assert_allclose(float(total.detach()), want, rtol=1e-6,
                                   err_msg=what)
    for got, want in ((th.grad, uh.grad), (tw.grad, uw.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-6)


def test_chunked_ce_rejects_a_chunk_that_does_not_divide():
    hidden, head, tgt = _ce_case()
    with pytest.raises(ValueError, match="divide"):
        chunked_cross_entropy_sum_count(torch.from_numpy(hidden),
                                        torch.from_numpy(head),
                                        torch.from_numpy(tgt), 24)


def test_loss_sum_count_takes_ce_chunk_size():
    model = _model()
    ids, tgt = _batch()
    loss0, g0 = _grads(model, ids, tgt, None)
    model.zero_grad(set_to_none=True)
    total, count, _ = tllama.loss_sum_count(model, ids, tgt, "dots_attn",
                                            ce_chunk_size=64)
    total.backward()
    np.testing.assert_allclose(float(total), loss0, rtol=1e-6)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g0[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
