"""The port's mixture of experts against the JAX package's, one process,
fp32 on the CPU. Inputs are made from numpy seeds and the params are
carried across with `weights.params_from_jax`.

- `route_topk`: expert_idx and slot equal, including rows of exact ties
  (`lax.top_k` puts the lower index first; the port's stable sort must
  too); gates, the balance loss and the z-loss at 1e-6.
- `moe_mlp`: output, aux, drop fraction and the grads of x and the four
  weights at 1e-5, drop-free (capacity factor 8) and with drops
  (capacity factor 1.0: the drop fraction equal and strictly between 0
  and 1).
- The debug-tiny-moe model (z-loss on): loss, extras and every grad leaf
  against the JAX `loss_sum_count` under remat off, "dots" and
  "dots_attn" at 1e-5, the other policies equal to no remat; each
  policy's saved tensors per layer counted as the `models/llama.py`
  table says.
- Three training steps against the JAX `make_train_step` (losses and
  final params at 1e-5), and `moe_drop_frac` on the trainer's log line.
- The fused engine against the AD engine: fp32 grads at 1e-5, and equal
  bit for bit in bf16, as for the dense model.
- optimizer_offload takes the banks (their fp32 masters move; the step-1
  loss within 1e-3 of the resident run's in bf16).
- Greedy `generate` tokens equal to the JAX `generate`'s.
- HF Mixtral safetensors written by the port read by the JAX
  `load_hf_safetensors` (and by the port) equal to the params.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu import checkpoint as jckpt
from picotron_tpu import config as jcfg
from picotron_tpu import generate as jgen
from picotron_tpu import train_step as jstep
from picotron_tpu.models import llama as jllama
from picotron_tpu.ops import moe as jmoe
from picotron_tpu_torch import checkpoint as tckpt
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import data as tdata
from picotron_tpu_torch import generate as tgen
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.ops import moe as tmoe
from picotron_tpu_torch.ops.losses import IGNORE_INDEX
from picotron_tpu_torch.parallel import fused_bwd

TOL = dict(rtol=1e-5, atol=1e-5)
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL = {"name": "debug-tiny-moe", "dtype": "float32",
         "router_z_coef": 1e-3, "num_hidden_layers": 2}


def _raw(**training):
    t = dict(seq_length=16, micro_batch_size=2, gradient_accumulation_steps=2,
             total_train_steps=3, learning_rate=1e-3, weight_decay=0.1,
             grad_clip_norm=1.0, remat=False, num_samples=64)
    t.update(training)
    return {"model": dict(MODEL), "training": t,
            "distributed": {"use_cpu": True}}


@functools.lru_cache(maxsize=None)
def _tree(seed: int = 3):
    jc = jcfg.config_from_dict(_raw())
    return jax.tree.map(np.asarray, jllama.init_params(jc.model,
                                                       jax.random.key(seed)))


def _model(raw=None, tree=None):
    tc = tcfg.config_from_dict(raw or _raw())
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(
        _tree() if tree is None else tree, tc.model))
    return tc, model


def _batch(vocab=256, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    tgt = rng.integers(0, vocab, (b, s))
    tgt[0, :3] = IGNORE_INDEX
    return ids, tgt


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees(got, want, tol=TOL):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


def _logits(n=40, e=8, seed=0):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((n, e)).astype(np.float32)
    lg[3] = 0.5                       # every expert tied
    lg[7] = [2.0, 1.0, 2.0, 0.0, 2.0, -1.0, 0.5, 0.0]  # a three-way top tie
    lg[11, [1, 6]] = 3.0              # the top two tied
    return lg


@pytest.mark.parametrize("k", [1, 2])
def test_route_topk_equals_jax_with_exact_ties(k):
    lg = _logits()
    want = jmoe.route_topk(jnp.asarray(lg), k)
    got = tmoe.route_topk(torch.from_numpy(lg), k)
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    # the tie rows take the lower indices first
    assert got.expert_idx[3].tolist() == list(range(k))
    assert got.expert_idx[7].tolist() == [0, 2][:k]
    assert got.expert_idx[11].tolist() == [1, 6][:k]
    for name in ("gate", "aux_loss", "z_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **ROUTE_TOL)


def _op_inputs(b=2, s=24, h=16, e=4, f=32, seed=0):
    """x, the four weights and an output cotangent; the router leans to
    expert 0 (x has a positive mean and router column 0 positive
    weights), so that capacity 1.0 drops some of its assignments."""
    rng = np.random.default_rng(seed)
    x = (0.25 + rng.standard_normal((b, s, h))).astype(np.float32)
    ws = [(0.3 * rng.standard_normal(sh)).astype(np.float32)
          for sh in ((h, e), (e, h, f), (e, h, f), (e, f, h))]
    ws[0][:, 0] += 0.5
    dout = rng.standard_normal((b, s, h)).astype(np.float32)
    return x, ws, dout


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_mlp_output_and_grads_equal_jax(cf):
    x, ws, dout = _op_inputs()
    kw = dict(num_experts=4, top_k=2, capacity_factor=cf,
              router_aux_coef=0.01, router_z_coef=1e-3)

    def jloss(x, *w):
        out, aux, drop = jmoe.moe_mlp(x, *w, **kw)
        return jnp.sum(out * dout) + aux, (out, aux, drop)

    (_, (jout, jaux, jdrop)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            jnp.asarray(x), *map(jnp.asarray, ws))
    tx = torch.from_numpy(x).requires_grad_()
    tws = [torch.from_numpy(w).requires_grad_() for w in ws]
    out, aux, drop = tmoe.moe_mlp(tx, *tws, **kw)
    ((out * torch.from_numpy(dout)).sum() + aux).backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(drop) == pytest.approx(float(jdrop), abs=1e-7)
    if cf == 8.0:
        assert float(drop) == 0.0
    else:
        assert 0.0 < float(drop) < 1.0, float(drop)
    for name, got, want in zip(("x", "router", "w_gate", "w_up", "w_down"),
                               (tx, *tws), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)


def test_capacity_rule_and_dispatch_without_host_sync():
    assert tmoe.capacity(1.25, 2, 4096, 8) == 1288
    assert tmoe.capacity(8.0, 2, 16, 8) == 40
    x, ws, _ = _op_inputs()
    # under "error" a host sync raises; the CPU reports none, so this pins
    # the ops' shapes: nothing in the dispatch depends on the data
    out, _, _ = tmoe.moe_mlp(torch.from_numpy(x), *map(torch.from_numpy, ws),
                             num_experts=4, top_k=2, capacity_factor=0.5)
    assert out.shape == x.shape and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _jax_loss_grads(tree, ids, tgt, policy=None, model_raw=None):
    jc = jcfg.config_from_dict({"model": model_raw or dict(MODEL)})
    ctx = jllama.ParallelCtx(remat=policy is not None,
                             remat_policy=policy or "dots")

    def f(p):
        total, count, extras = jllama.loss_sum_count(
            p, jnp.asarray(ids), jnp.asarray(tgt), jc.model, ctx)
        return total, (count, extras)

    (total, (count, extras)), grads = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    return float(total), int(count), float(extras["moe_drop_weighted"]), grads


@pytest.mark.parametrize("policy", [None, "dots", "dots_attn"])
def test_model_loss_extras_and_grads_equal_jax(policy):
    tree = _tree()
    ids, tgt = _batch()
    want_total, want_count, want_drop, jgrads = _jax_loss_grads(
        tree, ids, tgt, policy)
    _, model = _model()
    total, count, extras = tllama.loss_sum_count(
        model, torch.from_numpy(ids), torch.from_numpy(tgt), policy)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), want_total, **TOL)
    assert int(count) == want_count
    np.testing.assert_allclose(float(extras["moe_drop_weighted"]), want_drop,
                               **TOL)
    _assert_trees(weights.params_to_numpy(model, grads=True), jgrads)


@pytest.mark.parametrize("policy", ["full", "dots_lean", "dots_norms"])
def test_other_policies_equal_no_remat(policy):
    """The policies the JAX comparison above leaves out: the same loss,
    drop sum and grads as no remat (the segments recompute the same ops,
    the routing bit for bit)."""
    ids, tgt = (torch.from_numpy(a) for a in _batch())
    _, model = _model()
    want_t, _, want_ex = tllama.loss_sum_count(model, ids, tgt)
    want_t.backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    total, _, ex = tllama.loss_sum_count(model, ids, tgt, policy)
    total.backward()
    assert float(total) == float(want_t)
    assert float(ex["moe_drop_weighted"]) == float(
        want_ex["moe_drop_weighted"])
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[n], rtol=1e-6, atol=1e-7)


# saved tensors per MoE layer (the models/llama.py table's MoE rows)
MOE_SAVED = {"full": 1, "dots_attn": 6, "dots_lean": 6, "dots": 8,
             "dots_norms": 10}


@pytest.mark.parametrize("policy", sorted(MOE_SAVED))
def test_moe_saved_tensors_per_layer_match_the_table(policy):
    """The activations one MoE layer keeps for its backward, counted as
    tests/test_torch_remat.py counts the dense layer's: none of the
    expert block's ([E, cap, H] slots, the expert products) under any
    policy."""
    _, model = _model()
    b, s = 2, 16
    x = torch.randn(b, s, model.cfg.hidden_size,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    storages = set()

    def pack(t):
        if t.dim() >= 2 and t.shape[0] in (b, b * s):
            storages.add(t.untyped_storage().data_ptr())
        return t

    rope = (model.rope_cos, model.rope_sin)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, aux = tllama.remat_layer(x, model.layers[0], model.cfg, rope,
                                    policy)
    (y.sum() + aux[0]).backward()
    assert len(storages) == MOE_SAVED[policy]


def test_three_steps_equal_jax_and_drop_frac_on_the_log_line(capsys):
    raw = _raw()
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    tree = _tree()
    _, model = _model(raw, tree)
    state = tstep.init_train_state(tc, model)
    step_fn = tstep.make_train_step(tc)
    loader = tdata.MicroBatchDataLoader(tc, "cpu")
    jstate = jstep.init_train_state(jc, jax.tree.map(jnp.asarray, tree))
    jstep_fn = jax.jit(jstep.make_train_step(jc))
    for _ in range(3):
        ids, tgt = next(loader)
        metrics = step_fn(state, (ids, tgt))
        jstate, jloss = jstep_fn(jstate, (jnp.asarray(ids.numpy()),
                                          jnp.asarray(tgt.numpy())))
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                                   **TOL)
        assert 0.0 <= float(metrics["moe_drop_frac"]) < 1.0
    _assert_trees(weights.params_to_numpy(model), jstate.params)

    # the trainer prints the drop fraction on its log line (the JAX
    # training_log_line's extras)
    capsys.readouterr()
    ttrain.run(tcfg.config_from_dict(_raw(total_train_steps=1)), "cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[step ")]
    assert len(lines) == 1 and "| moe_drop_frac: " in lines[0], lines


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_engine_equals_ad(dtype):
    raw = _raw(remat=True, remat_policy="dots_attn", grad_engine="fused")
    raw["model"]["dtype"] = dtype
    tc, model = _model(raw)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 256, (2, 2, 16)))
    tgt = torch.from_numpy(rng.integers(0, 256, (2, 2, 16)))
    tgt[0, 0, :4] = IGNORE_INDEX
    ad_extras, fused_extras = {}, {}
    loss_ad, scale_ad = tstep.accumulate_grads(model, (ids, tgt),
                                               "dots_attn",
                                               extras=ad_extras)
    g_ad = {n: p.grad.clone() for n, p in model.named_parameters()}
    w = fused_bwd.ComputeWeights(model)
    w.refresh()
    loss_f, scale_f = fused_bwd.fused_accumulate_grads(
        model, w, (ids, tgt), extras=fused_extras)
    g_f = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert float(scale_ad) == float(scale_f)
    assert set(ad_extras) == set(fused_extras) == {"moe_drop_frac"}
    if dtype == "bfloat16":
        assert float(loss_ad) == float(loss_f)
        assert float(ad_extras["moe_drop_frac"]) == float(
            fused_extras["moe_drop_frac"])
        for n, g in g_ad.items():
            assert torch.equal(g_f[n], g), n
        return
    np.testing.assert_allclose(float(loss_f), float(loss_ad), **TOL)
    for n, g in g_ad.items():
        np.testing.assert_allclose(g_f[n].numpy(), g.numpy(), err_msg=n,
                                   **TOL)


def test_offload_takes_the_banks():
    """optimizer_offload over the MoE model (bf16 compute): the banks'
    fp32 masters live in the host state and move with each update; the
    step-1 loss is the resident run's (the same bf16 products; the norms
    enter as their bf16 cast under offload) and both stay finite."""
    losses = {}
    for offload in (False, True):
        raw = _raw(optimizer_offload=offload, total_train_steps=2)
        raw["model"]["dtype"] = "bfloat16"
        tc, model = _model(raw)
        state = tstep.init_train_state(tc, model)
        step_fn = tstep.make_train_step(tc)
        loader = tdata.MicroBatchDataLoader(tc, "cpu")
        opt = state.optimizer
        before = {n: t.clone() for n, t in zip(
            opt.names, opt.master if offload else opt.params)}
        losses[offload] = [float(step_fn(state, next(loader))["loss"])
                           for _ in range(2)]
        if offload:
            after = dict(zip(opt.names, opt.master))
            assert opt.master[0].dtype == torch.float32
            for n in ("layers.0.w_gate", "layers.1.w_down",
                      "layers.0.router"):
                assert not torch.equal(after[n], before[n]), n
    assert all(np.isfinite(losses[True] + losses[False]))
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-3)


def test_greedy_generate_equals_jax():
    jc = jcfg.config_from_dict({"model": dict(MODEL)})
    _, model = _model()
    prompt = np.random.default_rng(2).integers(0, 256, (2, 7))
    want = np.asarray(jgen.generate(jax.tree.map(jnp.asarray, _tree()),
                                    jc.model, jnp.asarray(prompt), 10))
    got = tgen.generate(model, prompt, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hf_mixtral_round_trip_equals_jax(tmp_path):
    jc, tc = jcfg.config_from_dict(_raw()), tcfg.config_from_dict(_raw())
    tree = _tree()
    _, model = _model()
    tckpt.save_hf_safetensors(model, str(tmp_path))
    raw = tckpt.read_safetensors(str(tmp_path / "model.safetensors"))
    assert "model.layers.1.block_sparse_moe.experts.7.w3.weight" in raw
    assert tuple(raw["model.layers.0.block_sparse_moe.gate.weight"].shape) \
        == (tc.model.num_experts, tc.model.hidden_size)
    _assert_trees(jckpt.load_hf_safetensors(str(tmp_path), jc.model), tree,
                  dict(rtol=0, atol=0))
    sd = tckpt.load_hf_safetensors(str(tmp_path), tc.model)
    for n, p in model.state_dict().items():
        assert torch.equal(sd[n], p), n
    # and the JAX export read by the port
    jdir = tmp_path / "jax"
    jckpt.save_hf_safetensors(tree, str(jdir))
    sd = tckpt.load_hf_safetensors(str(jdir), tc.model)
    for n, p in model.state_dict().items():
        assert torch.equal(sd[n], p), n
