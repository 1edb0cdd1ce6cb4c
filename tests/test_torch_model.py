"""The port's model against the JAX package's: weights carried across with
`weights.params_from_jax`, the same numpy batch, fp32 on the CPU. Logits,
loss and the grad of every param leaf, for debug-tiny (GQA 4/2) and
debug-tiny-qwen (qkv bias + tied head), through both attention impls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu.models import llama as jllama
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(preset, attn_impl="auto"):
    raw = {"model": {"name": preset, "dtype": "float32",
                     "attn_impl": attn_impl}}
    return jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)


def _params(jc, seed=0):
    """JAX init, with the zero-init biases made nonzero so they count."""
    tree = jax.tree.map(np.asarray, jllama.init_params(jc.model,
                                                       jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for name in ("b_q", "b_k", "b_v"):
        if name in tree["layers"]:
            tree["layers"][name] = (0.1 * rng.standard_normal(
                tree["layers"][name].shape)).astype(np.float32)
    tree["layers"]["input_norm"] = (1 + 0.1 * rng.standard_normal(
        tree["layers"]["input_norm"].shape)).astype(np.float32)
    return tree


def _port_model(tc, tree):
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(tree, tc.model))
    return model


def _batch(vocab, seed=1, b=2, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    tgt = rng.integers(0, vocab, (b, s))
    tgt[0, :3] = -100
    return ids, tgt


@pytest.mark.parametrize("preset", ["debug-tiny", "debug-tiny-qwen"])
def test_weights_roundtrip(preset):
    jc, tc = _configs(preset)
    tree = _params(jc)
    back = weights.params_to_numpy(_port_model(tc, tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert ("lm_head" in tree) == (not tc.model.tie_word_embeddings)


@pytest.mark.parametrize("attn_impl", ["auto", "reference"])
@pytest.mark.parametrize("preset", ["debug-tiny", "debug-tiny-qwen"])
def test_logits_loss_and_every_grad_leaf(preset, attn_impl):
    jc, tc = _configs(preset, attn_impl)
    tree = _params(jc)
    ids, tgt = _batch(jc.model.vocab_size)
    jparams = jax.tree.map(jnp.asarray, tree)

    jlogits = jllama.forward(jparams, jnp.asarray(ids), jc.model)
    jloss, jgrads = jax.value_and_grad(jllama.loss_fn)(
        jparams, jnp.asarray(ids), jnp.asarray(tgt), jc.model)

    model = _port_model(tc, tree)
    tids, ttgt = torch.from_numpy(ids), torch.from_numpy(tgt)
    with torch.no_grad():
        tlogits = tllama.forward(model, tids)
    tloss = tllama.loss_fn(model, tids, ttgt)
    tloss.backward()

    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    tgrads = weights.params_to_numpy(model, grads=True)
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        got = dict(jax.tree_util.tree_leaves_with_path(tgrads))[path]
        np.testing.assert_allclose(got, np.asarray(want), err_msg=str(path),
                                   **TOL)


def test_bf16_compute_keeps_fp32_params_and_grads():
    raw = {"model": {"name": "debug-tiny"}}
    tc = tcfg.config_from_dict(raw)
    assert tc.model.dtype == "bfloat16"
    model = tllama.init_params(tllama.LlamaModel(tc.model, device="cpu"),
                               torch.Generator().manual_seed(0))
    ids, tgt = _batch(tc.model.vocab_size)
    assert tllama.embed(model, torch.from_numpy(ids)).dtype == torch.bfloat16
    tllama.loss_fn(model, torch.from_numpy(ids), torch.from_numpy(tgt)).backward()
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


def test_init_distributions():
    tc = tcfg.config_from_dict({"model": {"name": "debug-tiny"}})
    model = tllama.init_params(tllama.LlamaModel(tc.model, device="cpu"),
                               torch.Generator().manual_seed(0))
    bound = (1.0 / tc.model.hidden_size) ** 0.5
    q = model.layers[0].q
    assert float(q.abs().max()) <= bound and float(q.abs().max()) > 0.9 * bound
    assert abs(float(model.embedding.std()) - 1.0) < 0.05
    assert torch.equal(model.final_norm, torch.ones_like(model.final_norm))
    assert tllama.param_count(model) == tcfg.num_params(tc.model)


@pytest.mark.parametrize("bad", [
    {"name": "debug-tiny-moe"},
    {"name": "debug-tiny", "attn_impl": "ring"},
])
def test_unported_model_features_raise(bad):
    tc = tcfg.config_from_dict({"model": bad, "distributed": {"cp_size": 2}}
                               if bad.get("attn_impl") else {"model": bad})
    if bad.get("attn_impl"):
        # a cp schedule is ported; without its cp context the model cannot
        # run it (the JAX make_parallel_ctx's cp_size check)
        with pytest.raises(ValueError, match="cp context"):
            tllama.LlamaModel(tc.model, device="cpu")
        return
    # MoE is ported: the model builds with the router and the expert banks
    # in place of the dense MLP (tests/test_torch_moe.py holds its numbers)
    m = tc.model
    lp = tllama.LlamaModel(m, device="cpu").layers[0]
    assert tuple(lp.router.shape) == (m.hidden_size, m.num_experts)
    assert tuple(lp.w_gate.shape) == (m.num_experts, m.hidden_size,
                                      m.expert_ffn_size)
    assert tuple(lp.w_down.shape) == (m.num_experts, m.expert_ffn_size,
                                      m.hidden_size)
    assert not hasattr(lp, "gate")
