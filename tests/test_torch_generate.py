"""The port's generation (picotron_tpu_torch/generate.py) against the JAX
package's on the CPU, fp32, with the JAX params transplanted
(`weights.params_from_jax`) and token ids made with numpy from a seed:

- teacher-forced cache logits (prefill one token, then decode each given
  token) against the JAX `_decode_layers` path and against the JAX full
  forward, rtol/atol 1e-5, on debug-tiny (GQA 4/2) and debug-tiny-qwen
  (qkv bias, tied head), and the per-sequence [B, s] positions form;
- greedy `generate` tokens equal to the JAX `generate`, with and without
  EOS (early exit, EOS padding), and the single-token case;
- cache shapes, MoE decode (once refused, now run; its tokens are held
  to the JAX package's in tests/test_torch_moe.py), sampling
  determinism under a fixed generator;
- the CLI (`python -m picotron_tpu_torch.generate`) on --prompt-ids from
  a port checkpoint against `generate`, its --load-dtype bfloat16 load,
  and its --prompt refusal without a tokenizer directory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu import generate as jgen
from picotron_tpu.models import llama as jllama
from picotron_tpu_torch import checkpoint as tckpt
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import generate as tgen
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models run many small ops: one intra-op thread each, so that
    the suite's parallel workers do not oversubscribe the host's cores
    (which slows such ops by two orders of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_raw(preset: str = "debug-tiny") -> dict:
    return {"model": {"name": preset, "dtype": "float32",
                      "max_position_embeddings": 64},
            "training": {"seq_length": 32}}


def jax_tree(jc, seed: int = 0) -> dict:
    """JAX init, with the zero-init biases made nonzero so they count."""
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jc.model, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for name in ("b_q", "b_k", "b_v"):
        if name in tree["layers"]:
            tree["layers"][name] = (0.1 * rng.standard_normal(
                tree["layers"][name].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=["debug-tiny", "debug-tiny-qwen"])
def pair(request):
    """(JAX model config, JAX params, the port's model) on one preset."""
    raw = tiny_raw(request.param)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    tree = jax_tree(jc)
    model = tgen.load_for_decode(weights.params_from_jax(tree, tc.model),
                                 tc.model, "cpu")
    return jc.model, jax.tree.map(jnp.asarray, tree), model


@pytest.fixture(scope="module")
def tiny():
    raw = tiny_raw()
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    tree = jax_tree(jc)
    model = tgen.load_for_decode(weights.params_from_jax(tree, tc.model),
                                 tc.model, "cpu")
    return jc.model, jax.tree.map(jnp.asarray, tree), model, tree


def ids_of(seed: int, shape, vocab: int = 256) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


def jax_teacher_forced(params, cfg, ids) -> np.ndarray:
    """tests/test_generate.py's teacher-forced cache logits [B, N, V]."""
    b, n = ids.shape
    cos, sin = jllama.model_rope_tables(cfg)
    cache = jgen.init_cache(cfg, b, n)
    outs = []
    for t in range(n):
        x = params["embedding"][ids[:, t:t + 1]].astype(jnp.float32)
        x, cache = jgen._decode_layers(params, x, cache, jnp.array([t]),
                                       cfg, cos, sin)
        outs.append(jgen._logits_last(params, x, cfg))
    return np.asarray(jnp.stack(outs, axis=1))


@torch.no_grad()
def port_teacher_forced(model, ids, per_sequence: bool = False):
    """The port's teacher-forced cache logits; `per_sequence` feeds the
    [B, s] positions form through the paged cache instead of the [s]
    form through the contiguous one."""
    from picotron_tpu_torch.serve.paged_cache import init_paged_cache

    b, n = ids.shape
    cfg = model.cfg
    cos, sin = tllama.model_rope_tables(cfg)
    if per_sequence:
        cache = init_paged_cache(cfg, b * n, 1, b, n)
        cache.tables[:] = torch.arange(b * n).reshape(b, n)
    else:
        cache = tgen.init_cache(cfg, b, n)
    ids = torch.as_tensor(ids)
    outs = []
    for t in range(n):
        x = tllama.embed(model, ids[:, t:t + 1])
        pos = torch.tensor([t])
        if per_sequence:
            pos = pos.expand(b, 1)
        x = tgen._decode_layers(model, x, cache, pos, cos, sin)
        outs.append(tgen._logits_last(model, x))
    return torch.stack(outs, dim=1).numpy()


def test_teacher_forced_logits_match_jax(pair):
    jmodel_cfg, jparams, model = pair
    ids = ids_of(1, (2, 12))
    got = port_teacher_forced(model, ids)
    np.testing.assert_allclose(got, jax_teacher_forced(jparams, jmodel_cfg,
                                                       jnp.asarray(ids)),
                               **TOL)
    full = np.asarray(jllama.forward(jparams, jnp.asarray(ids), jmodel_cfg))
    np.testing.assert_allclose(got, full, **TOL)
    np.testing.assert_allclose(port_teacher_forced(model, ids, True), got,
                               **TOL)


def test_greedy_generate_matches_jax(pair):
    jmodel_cfg, jparams, model = pair
    prompt = ids_of(2, (2, 7))
    want = np.asarray(jgen.generate(jparams, jmodel_cfg,
                                    jnp.asarray(prompt), 10))
    got = tgen.generate(model, prompt, 10)
    assert got.dtype == torch.long and got.shape == (2, 17)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_early_exit_and_padding_match_jax(tiny):
    jmodel_cfg, jparams, model, _ = tiny
    prompt = ids_of(3, (3, 5))
    free = np.asarray(jgen.generate(jparams, jmodel_cfg, jnp.asarray(prompt),
                                    20))
    for eos in (int(free[0, 6]), int(free[1, 5])):
        want = np.asarray(jgen.generate(jparams, jmodel_cfg,
                                        jnp.asarray(prompt), 20,
                                        eos_token_id=eos))
        got = tgen.generate(model, prompt, 20, eos_token_id=eos).numpy()
        np.testing.assert_array_equal(got, want)
        for row in got[:, 5:]:
            hits = np.where(row == eos)[0]
            if hits.size:
                assert (row[hits[0]:] == eos).all()
    one = tgen.generate(model, prompt, 1, eos_token_id=0)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jgen.generate(jparams, jmodel_cfg,
                                              jnp.asarray(prompt), 1,
                                              eos_token_id=0)))
    with pytest.raises(ValueError, match="max_new_tokens"):
        tgen.generate(model, prompt, 0)


def test_every_row_done_exits_early(tiny, monkeypatch):
    """With every row at EOS the loop stops at the next check: the decode
    steps run stop there, and the output is the full EOS-padded one."""
    _, _, model, _ = tiny
    prompt = ids_of(4, (2, 4))
    eos = int(tgen.generate(model, prompt, 1)[0, 4])
    prompt[1] = prompt[0]  # both rows emit eos first
    calls = []
    real = tgen._decode_layers

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tgen, "_decode_layers", counting)
    out = tgen.generate(model, prompt, 40, eos_token_id=eos)
    assert (out[:, 4:] == eos).all()
    # the prefill, then steps 1 .. EOS_CHECK_EVERY - 1
    assert len(calls) == tgen.EOS_CHECK_EVERY


def test_cache_shapes(tiny):
    _, _, model, _ = tiny
    cfg = model.cfg
    cache = tgen.init_cache(cfg, 2, 16)
    assert cache.k.shape == cache.v.shape == (
        cfg.num_hidden_layers, 2, 16, cfg.num_key_value_heads, cfg.head_dim)
    assert cache.k.dtype == torch.float32 and cache.num_layers == 4
    half = tgen.init_cache(dataclasses.replace(cfg, dtype="bfloat16"), 1, 8,
                           heads=1)
    assert half.k.shape[3] == 1 and half.k.dtype == torch.bfloat16
    assert tgen.kv_heads(model) == cfg.num_key_value_heads


def test_moe_refused_naming_item_10(tiny):
    """Once the MoE refusal naming ROADMAP item 10; MoE decode is ported
    now, so the test keeps its name and checks that `place_for_decode`
    and `generate` take an MoE model (tests/test_torch_moe.py holds the
    tokens to the JAX package's)."""
    moe = tcfg.config_from_dict({"model": {"name": "debug-tiny-moe"}}).model
    params = tllama.init_params(tllama.LlamaModel(moe, device="cpu"),
                                torch.Generator().manual_seed(0))
    model_moe = tgen.place_for_decode(
        {n: p.detach() for n, p in params.named_parameters()}, moe,
        device="cpu")
    out = tgen.generate(model_moe, [[1, 2]], 2)
    assert out.shape == (1, 4) and out[0, :2].tolist() == [1, 2]


def test_sampling_deterministic_under_a_generator(tiny):
    _, _, model, _ = tiny
    prompt = np.zeros((3, 4), np.int64)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tgen.generate(model, prompt, 6, temperature=0.8, top_k=10,
                             generator=gen)

    a, b, c = draw(7), draw(7), draw(8)
    assert a.shape == (3, 10)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # top-k 1 is greedy at any temperature
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(
        tgen.generate(model, prompt, 6, temperature=2.0, top_k=1,
                      generator=gen),
        tgen.generate(model, prompt, 6))


@pytest.fixture(scope="module")
def checkpoint(tiny, tmp_path_factory):
    """A port checkpoint (step 0) holding the transplanted params, and its
    config file."""
    _, _, _, tree = tiny
    tmp = tmp_path_factory.mktemp("gen_ckpt")
    raw = tiny_raw()
    raw["distributed"] = {"use_cpu": True}
    raw["checkpoint"] = {"save_dir": str(tmp / "ckpt")}
    cfg = tcfg.config_from_dict(raw)
    model = tllama.LlamaModel(cfg.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(tree, cfg.model))
    mgr = tckpt.CheckpointManager(cfg)
    mgr.save(tstep.init_train_state(cfg, model), 0, None)
    mgr.wait_until_finished()
    path = str(tmp / "config.json")
    tcfg.save_config(cfg, path)
    return path, cfg.checkpoint.save_dir


def test_cli_prompt_ids_matches_generate(tiny, checkpoint, capsys):
    jmodel_cfg, jparams, model, _ = tiny
    path, ckpt = checkpoint
    argv = ["--config", path, "--ckpt-dir", ckpt, "--prompt-ids", "5,12,7",
            "--max-new-tokens", "8", "--device", "cpu"]
    out = tgen.main(argv)
    assert capsys.readouterr().out.strip() == ",".join(map(str, out))
    assert out == tgen.generate(model, [[5, 12, 7]], 8)[0].tolist()
    want = jgen.generate(jparams, jmodel_cfg, jnp.asarray([[5, 12, 7]]), 8)
    assert out == np.asarray(want)[0].tolist()
    sampled = tgen.main(argv + ["--temperature", "0.9", "--seed", "3"])
    gen = torch.Generator().manual_seed(3)
    assert sampled == tgen.generate(model, [[5, 12, 7]], 8, temperature=0.9,
                                    generator=gen)[0].tolist()


def test_cli_bf16_load(tiny, checkpoint, monkeypatch):
    _, _, model, _ = tiny
    path, ckpt = checkpoint
    seen = {}
    real = tgen.place_for_decode

    def spy(params, *a, **k):
        seen["dtypes"] = {t.dtype for t in params.values()}
        seen["model"] = real(params, *a, **k)
        return seen["model"]

    monkeypatch.setattr(tgen, "place_for_decode", spy)
    out = tgen.main(["--config", path, "--ckpt-dir", ckpt, "--prompt-ids",
                     "5,12,7", "--max-new-tokens", "6", "--device", "cpu",
                     "--load-dtype", "bfloat16"])
    assert seen["dtypes"] == {torch.bfloat16}
    assert {p.dtype for p in seen["model"].parameters()} == {torch.bfloat16}
    half = tgen.load_for_decode(
        {n: p.detach().to(torch.bfloat16)
         for n, p in model.named_parameters()}, model.cfg, "cpu")
    assert out == tgen.generate(half, [[5, 12, 7]], 6)[0].tolist()


def test_cli_refuses_prompt_without_tokenizer_dir(checkpoint, capsys):
    path, ckpt = checkpoint
    with pytest.raises(SystemExit):
        tgen.main(["--config", path, "--ckpt-dir", ckpt, "--prompt", "hi",
                   "--device", "cpu"])
    assert "--prompt-ids" in capsys.readouterr().err
