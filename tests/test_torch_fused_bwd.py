"""The port's fused grad engine (`parallel/fused_bwd.py`) on the CPU at
fp32 and debug size (3 layers, hidden 64, heads 8/4, seq 64, ga 2):
against the JAX package's fused engine (`parallel/api._device_grads` on a
1-device mesh, its flash kernel in interpret mode) and against the port's
AD engine, loss at rtol 1e-5 and each grad leaf at 1e-5 of the leaf's
largest value; 3 training steps against the JAX step built by
`parallel/api.make_train_step`; engine resolution against the JAX
package's; the per-step compute weights; and a save/resume under the
fused engine equal to the uninterrupted run bit for bit."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from picotron_tpu import compat
from picotron_tpu import config as jcfg
from picotron_tpu.analysis.collectives import resolved_grad_engine as jresolve
from picotron_tpu.mesh import MeshEnv
from picotron_tpu.parallel import api as japi
from picotron_tpu.parallel.sharding import batch_spec, param_specs
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import data as tdata
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.ops.losses import IGNORE_INDEX
from picotron_tpu_torch.parallel import fused_bwd

MODEL = dict(num_attention_heads=8, num_key_value_heads=4,
             num_hidden_layers=3, hidden_size=64, intermediate_size=96,
             vocab_size=256, max_position_embeddings=64)


def _raw(engine="fused", preset="debug-tiny", attn_impl="auto", **training):
    t = dict(seq_length=64, micro_batch_size=2, gradient_accumulation_steps=2,
             remat=True, remat_policy="dots_attn", grad_engine=engine)
    t.update(training)
    return {"model": {"name": preset, **MODEL, "dtype": "float32",
                      "attn_impl": attn_impl},
            "training": t, "distributed": {"use_cpu": True}}


def _batch(cfg, seed=2):
    t = cfg.training
    rng = np.random.default_rng(seed)
    shape = (t.gradient_accumulation_steps, t.micro_batch_size, t.seq_length)
    ids = rng.integers(0, cfg.model.vocab_size, shape)
    tgt = rng.integers(0, cfg.model.vocab_size, shape)
    tgt[0, 0, :7] = IGNORE_INDEX
    tgt[1, 1, -3:] = IGNORE_INDEX
    return ids, tgt


def _jax_state(jc):
    menv = MeshEnv.from_config(jc)
    return japi.init_sharded_state(jc, menv, jax.random.key(0)), menv


def _port_model(tc, np_params):
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(np_params, tc.model))
    return model


def _port_grads(tc, model, ids, tgt):
    """The loss and the token-mean grads (the engine's sums times its
    scale), as the JAX package's `_device_grads` returns them."""
    loss, scale = tstep.make_grads_fn(tc)(model, (torch.from_numpy(ids),
                                                  torch.from_numpy(tgt)))
    with torch.no_grad():
        for p in model.parameters():
            p.grad.mul_(scale)
    return float(loss), weights.params_to_numpy(model, grads=True)


def _assert_leaves_close(got, want, rel=1e-5):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        w = np.asarray(w)
        err = np.abs(flat[path] - w).max() / (np.abs(w).max() + 1e-12)
        assert err <= rel, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("preset,attn_impl", [
    ("debug-tiny", "auto"), ("debug-tiny-qwen", "auto"),
    ("debug-tiny", "reference")])
def test_port_fused_matches_jax_fused_and_port_ad(preset, attn_impl):
    raw = _raw("fused", preset, attn_impl)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    state, menv = _jax_state(jc)
    ids, tgt = _batch(jc)
    sh = menv.batch_sharding()
    fn = jax.jit(compat.shard_map(
        partial(japi._device_grads, cfg=jc), mesh=menv.mesh,
        in_specs=(param_specs(jc), (batch_spec(), batch_spec())),
        out_specs=(param_specs(jc), P(), P())))
    jgrads, jloss, _ = fn(state.params, (jax.device_put(jnp.asarray(ids), sh),
                                         jax.device_put(jnp.asarray(tgt), sh)))
    np_params = jax.tree.map(np.asarray, state.params)

    assert tstep.resolved_grad_engine(tc) == "fused"
    loss, grads = _port_grads(tc, _port_model(tc, np_params), ids, tgt)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _assert_leaves_close(grads, jgrads)

    ad = tcfg.config_from_dict(_raw("ad", preset, attn_impl))
    assert tstep.resolved_grad_engine(ad) == "ad"
    ad_loss, ad_grads = _port_grads(ad, _port_model(ad, np_params), ids, tgt)
    np.testing.assert_allclose(loss, ad_loss, rtol=1e-5)
    _assert_leaves_close(grads, ad_grads)


@pytest.mark.parametrize("chunk", [0, 64])
def test_three_steps_match_jax_fused_step(chunk):
    """test_torch_train.py's 3-step setup (bf16 moments, clipping, cosine
    with warmup) under the fused engine, against the JAX step of
    parallel/api.make_train_step with the same engine."""
    raw = _raw("fused", seq_length=16, total_train_steps=3,
               lr_schedule="cosine", lr_warmup_steps=1, learning_rate=1e-3,
               weight_decay=0.1, grad_clip_norm=0.05,
               adam_moments_dtype="bfloat16", num_samples=10,
               ce_chunk_size=chunk)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    jstate, menv = _jax_state(jc)
    jstep = japi.make_train_step(jc, menv)
    model = _port_model(tc, jax.tree.map(np.asarray, jstate.params))
    state = tstep.init_train_state(tc, model)
    step_fn = tstep.make_train_step(tc)
    loader = tdata.MicroBatchDataLoader(tc, "cpu")
    sh = menv.batch_sharding()
    for _ in range(3):
        ids, tgt = next(loader)
        metrics = step_fn(state, (ids, tgt))
        jstate, jm = jstep(jstate, (jax.device_put(jnp.asarray(ids.numpy()), sh),
                                    jax.device_put(jnp.asarray(tgt.numpy()), sh)))
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   atol=1e-5)
    got = weights.params_to_numpy(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        np.testing.assert_allclose(flat[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("engine", ["auto", "ad", "fused"])
@pytest.mark.parametrize("remat,policy", [
    (True, "dots_attn"), (True, "dots"), (True, "full"), (False, "dots")])
@pytest.mark.parametrize("ga,pp", [(1, 1), (2, 1), (4, 2)])
def test_engine_resolution_matches_jax(engine, remat, policy, ga, pp):
    raw = {"model": {"name": "debug-tiny"},
           "training": {"grad_engine": engine, "remat": remat,
                        "remat_policy": policy,
                        "gradient_accumulation_steps": ga},
           "distributed": {"pp_size": pp}}
    try:
        jc = jcfg.config_from_dict(raw)
    except ValueError:
        with pytest.raises(ValueError):
            tcfg.config_from_dict(raw)
        return
    tc = tcfg.config_from_dict(raw)
    assert tstep.resolved_grad_engine(tc) == jresolve(jc)
    assert fused_bwd.fused_bwd_supported(tc) == (
        pp == 1 and remat and policy == "dots_attn")


def test_compute_weights_equal_per_use_casts():
    """Logits through the per-step bf16 copies equal the model's logits
    (a cast at each use) bit for bit; after the masters move, a refresh
    makes them equal again."""
    raw = _raw()
    raw["model"]["dtype"] = "bfloat16"
    tc = tcfg.config_from_dict(raw)
    model = tllama.init_params(tllama.LlamaModel(tc.model, device="cpu"),
                               torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_batch(tc)[0][0])
    w = fused_bwd.ComputeWeights(model)

    def logits():
        x, _ = fused_bwd.forward_saved(model, w, ids)
        return tllama.logits_from_hidden(model, tllama.final_hidden(model, x))

    w.refresh()
    want = tllama.forward(model, ids).detach()
    assert logits().dtype == torch.bfloat16
    assert torch.equal(logits(), want)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)
    want = tllama.forward(model, ids).detach()
    assert not torch.equal(logits(), want)  # stale until refreshed
    w.refresh()
    assert torch.equal(logits(), want)


def test_bf16_fused_grads_equal_ad_bit_for_bit_on_the_cpu():
    """In bf16 on the CPU (the plain weight-grad form) the fused engine
    runs autograd's products, roundings and sums in autograd's order: its
    loss and every grad equal the AD engine's bit for bit."""
    raw = _raw("fused")
    raw["model"]["dtype"] = "bfloat16"
    tc = tcfg.config_from_dict(raw)
    ad = tcfg.config_from_dict({**raw, "training": {
        **raw["training"], "grad_engine": "ad", "remat": False}})
    model = tllama.init_params(tllama.LlamaModel(tc.model, device="cpu"),
                               torch.Generator().manual_seed(0))
    ids, tgt = (torch.from_numpy(a) for a in _batch(tc))
    loss_ad, scale_ad = tstep.make_grads_fn(ad)(model, (ids, tgt))
    g_ad = {n: p.grad.clone() for n, p in model.named_parameters()}
    loss, scale = tstep.make_grads_fn(tc)(model, (ids, tgt))
    assert torch.equal(loss, loss_ad) and torch.equal(scale, scale_ad)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, g_ad[n]), n


def test_weight_grad_forms_on_the_cpu():
    """The plain form is the CPU's; both forms agree on fp32 inputs."""
    g = torch.Generator().manual_seed(0)
    dy, x = torch.randn(2, 5, 3, generator=g), torch.randn(2, 5, 4, generator=g)
    acc = torch.randn(3, 4, generator=g)
    want = acc + dy.reshape(-1, 3).t() @ x.reshape(-1, 4)
    fused_bwd.accumulate_weight_grad(acc, dy, x)
    torch.testing.assert_close(acc, want, rtol=1e-6, atol=1e-6)
    # a device with no path (a fake xpu tensor stands in for one); meta,
    # the shapes-only step analysis/trace.py records, takes the CPU's
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        with pytest.raises(RuntimeError, match="no path"):
            fused_bwd.accumulate_weight_grad(
                torch.zeros(3, 4, device="xpu"),
                torch.zeros(2, 5, 3, device="xpu"),
                torch.zeros(2, 5, 4, device="xpu"))
    meta = acc.to("meta")
    fused_bwd.accumulate_weight_grad(meta, dy.to("meta"), x.to("meta"))
    assert meta.shape == acc.shape


@pytest.mark.parametrize("bad,match", [
    # the tp strategies' hooks and the MoE branch are ported: their cases
    # keep their ids and check that the engine builds for them (match
    # None); tests/test_torch_tp_strategies.py runs the strategies' fused
    # grads against AD's in a gloo world
    pytest.param({"distributed": {"tp_size": 2, "tp_strategy": "row"}},
                 None, id="bad0-item 9"),
    pytest.param({"model": {"name": "debug-tiny-moe"}}, None,
                 id="bad1-item 10"),
])
def test_unported_branches_are_refused(bad, match):
    from picotron_tpu_torch import train_step as tstep

    raw = {"model": {"name": "debug-tiny"},
           "training": {"remat": True, "remat_policy": "dots_attn",
                        "grad_engine": "fused"}}
    for section, vals in bad.items():
        raw.setdefault(section, {}).update(vals)
    cfg = tcfg.config_from_dict(raw)
    assert match is None
    assert tstep.resolved_grad_engine(cfg) == "fused"
    assert callable(tstep.make_grads_fn(cfg))


def test_fused_save_resume_is_bit_identical(tmp_path, monkeypatch):
    """2 steps + save + auto_resume to 4 under the fused engine equal the
    uninterrupted 4 steps bit for bit (tests/test_torch_checkpoint.py's
    harness)."""
    from tests.test_torch_checkpoint import _raw as ckpt_raw

    monkeypatch.setenv("PICOTRON_PREFLIGHT", "0")
    fused = dict(remat=True, remat_policy="dots_attn", grad_engine="auto")
    port = ckpt_raw(tmp_path / "port", training=fused, checkpoint={
        "save_frequency": 2, "auto_resume": True})
    first = ttrain.run(tcfg.config_from_dict(
        {**port, "training": {**port["training"], "max_tokens": 2 * 64}}))
    second = ttrain.run(tcfg.config_from_dict(port))
    assert second["start_step"] == 2
    whole = ttrain.run(tcfg.config_from_dict(
        ckpt_raw(tmp_path / "whole", training=fused)))
    assert tstep.resolved_grad_engine(tcfg.config_from_dict(port)) == "fused"
    assert first["losses"] + second["losses"] == whole["losses"]
    for (n, p), q in zip(second["state"].model.named_parameters(),
                         whole["state"].model.parameters()):
        assert torch.equal(p, q), n
