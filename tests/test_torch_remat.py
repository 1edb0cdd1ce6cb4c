"""The port's remat policies and chunked cross-entropy on the CPU at fp32.

Every remat policy's grads equal the no-remat grads (the recompute runs
the same ops), and the tensors one layer keeps for its backward, counted
through `torch.autograd.graph.saved_tensors_hooks`, are the policy's
documented saved set (`models/llama.py` docstring). The chunked CE holds
to the JAX package's `vocab_parallel_ce_sum_count(chunk_size=...)` and to
the port's unchunked CE, loss and grads on hidden and head, with
IGNORE_INDEX targets. "dots_offload" equals "dots" bit for bit and the
JAX package's dots_offload, and parks every saved tensor but the lse."""

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
from picotron_tpu_torch.models import act_offload
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


def _jax_grads(policy, ids, tgt):
    """The JAX model's (NLL sum, grads) under `policy` on _model()'s
    params."""
    jc = jcfg.config_from_dict({"model": {"name": "debug-tiny", **MODEL},
                                "training": {"seq_length": 64}})
    ctx = jllama.ParallelCtx(remat=True, remat_policy=policy)
    fn = jax.jit(jax.value_and_grad(lambda p: jllama.loss_sum_count(
        p, jnp.asarray(ids.numpy()), jnp.asarray(tgt.numpy()), jc.model,
        ctx)[0]))
    total, grads = fn(jax.tree.map(jnp.asarray, _tree("debug-tiny")))
    return float(total), weights.params_from_jax(
        jax.tree.map(np.asarray, grads), _model().cfg)


def _copying_parker():
    """A CPU parker that copies every save out and back, as the card's
    does, through plain host buffers (the restore path, the views, the
    pool)."""
    parker = act_offload.ActivationParker("cpu")
    parker._copies = lambda t: True
    return parker


def test_dots_offload_is_refused():
    """(Named when the policy was refused.) "dots_offload" runs: its loss
    and grads equal the JAX package's dots_offload within 1e-6 relative,
    and the port's "dots" bit for bit, with the CPU's no-op placement and
    with the saves copied out and back (`_copying_parker`)."""
    model = _model()
    ids, tgt = _batch()
    loss0, g0 = _grads(model, ids, tgt, "dots")
    jloss, jgrads = _jax_grads("dots_offload", ids, tgt)
    for copy in (False, True):
        model._parker = (_copying_parker() if copy
                         else act_offload.ActivationParker("cpu"))
        loss, g = _grads(model, ids, tgt, "dots_offload")
        assert loss == loss0, copy
        for name, want in g0.items():
            assert torch.equal(g[name], want), (copy, name)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    for name, want in jgrads.items():
        err = float((g[name] - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), (name, err)


def test_dots_offload_layer_needs_the_models_parker():
    """A "dots_offload" layer called without a parker is refused: a parker
    of its own per call would pin its pool anew each time and fetch
    nothing ahead (`run_layers` passes the model's)."""
    model = _model()
    x = torch.zeros(1, 8, MODEL["hidden_size"])
    with pytest.raises(ValueError, match="parker_of"):
        tllama.remat_layer(x, model.layers[0], model.cfg,
                           (model.rope_cos, model.rope_sin), "dots_offload")


def test_dots_offload_parks_every_save_but_the_lse():
    """The saved-tensor accounting: per layer the lse [B, Hq, S] alone
    stays on the device; every other tensor the layer saves is parked
    (x twice, attn_out, attn_proj_out, mlp_gate, mlp_up as segment
    inputs; the kernel's q, k, v, out, positions, RoPE tables and scale),
    none of them a parameter, each storage copied once and fetched once."""
    model = _model()
    ids, tgt = _batch()
    parker = model._parker = _copying_parker()
    seen, pack_of = [], parker._pack

    def pack(t):
        seen.append((t.requires_grad and t.is_leaf, t.dtype, tuple(t.shape)))
        return pack_of(t)

    parker._pack = pack
    act_offload.reset_counts()
    _grads(model, ids, tgt, "dots_offload")
    c = dict(act_offload.counts)
    n_layers, (b, s) = MODEL["num_hidden_layers"], ids.shape
    assert c["kept"] == n_layers
    assert c["parked"] == 17 * n_layers
    assert not any(param for param, _, _ in seen)
    lse = [k for k in seen if k[1:] == (torch.float32, (
        b, MODEL["num_attention_heads"], s))]
    assert len(lse) == n_layers
    # 15 storages a layer: out is shared by the kernel and the o-proj
    # segment, x by two segments
    assert c["storages"] == 15 * n_layers
    assert c["d2h_bytes"] == c["h2d_bytes"] == parker.pinned_bytes > 0
    # a second pass reuses the pool: nothing more is allocated
    _grads(model, ids, tgt, "dots_offload")
    assert parker.pinned_bytes == c["d2h_bytes"]


def test_dots_offload_stale_buffer_is_caught(monkeypatch):
    """A planted fault: one parked storage restored with the bytes another
    microbatch parked (the first storage of the second forward gets the
    first forward's) changes the grads, so the bit-for-bit comparison
    with "dots" sees it."""
    model = _model()
    ids, tgt = _batch()
    model._parker = _copying_parker()
    init, first = act_offload._Stored.__init__, []

    def stale(self, group, t):
        init(self, group, t)
        if group.prev is None and not group.stored:   # a forward's first
            if first:
                self.buf.copy_(first[0])
            else:
                first.append(self.buf.clone())

    monkeypatch.setattr(act_offload._Stored, "__init__", stale)
    _grads(model, *_batch(seed=7), "dots_offload")
    loss0, g0 = _grads(model, ids, tgt, "dots")
    loss, g = _grads(model, ids, tgt, "dots_offload")
    assert loss == loss0  # the forward reads nothing parked
    assert not all(torch.equal(g[n], g0[n]) for n in g0)


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
