"""The port's training path against the JAX package's single-device step:
the same SyntheticSource batches, weights carried across, 3 steps with
grad accumulation 2, fp32 compute on the CPU. Per-step losses and final
params at rtol 1e-5 / atol 1e-5; loader batches and cursors token-exact.
Plus the optimizer's lr schedules and one CLI run with --device cpu."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu import data as jdata
from picotron_tpu import optimizer as joptim
from picotron_tpu import train_step as jstep
from picotron_tpu.mesh import MeshEnv
from picotron_tpu.models import llama as jllama
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import data as tdata
from picotron_tpu_torch import optimizer as toptim
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import act_offload
from picotron_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-5, atol=1e-5)


def _raw(moments, preset="debug-tiny", **training):
    t = dict(seq_length=16, micro_batch_size=2, gradient_accumulation_steps=2,
             total_train_steps=3, lr_schedule="cosine", lr_warmup_steps=1,
             learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
             adam_moments_dtype=moments, remat=False, num_samples=10)
    t.update(training)
    return {"model": {"name": preset, "dtype": "float32"}, "training": t,
            "distributed": {"use_cpu": True}}


@pytest.mark.parametrize("moments,preset,clip", [
    ("float32", "debug-tiny", 1.0),
    ("bfloat16", "debug-tiny", 0.0),
    ("bfloat16", "debug-tiny-qwen", 0.05),
])
def test_three_steps_match_jax(moments, preset, clip):
    raw = _raw(moments, preset, grad_clip_norm=clip)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    tree = jax.tree.map(np.asarray, jllama.init_params(jc.model,
                                                       jax.random.key(3)))

    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(tree, tc.model))
    state = tstep.init_train_state(tc, model)
    step_fn = tstep.make_train_step(tc)
    loader = tdata.MicroBatchDataLoader(tc, "cpu")

    jstate = jstep.init_train_state(jc, jax.tree.map(jnp.asarray, tree))
    jstep_fn = jax.jit(jstep.make_train_step(jc))
    jgrads_fn = jax.jit(lambda p, b: jstep.accumulate_grads(
        p, b, jc, jstep.DEFAULT_CTX)[0])

    for _ in range(3):
        ids, tgt = next(loader)
        metrics = step_fn(state, (ids, tgt))
        jbatch = (jnp.asarray(ids.numpy()), jnp.asarray(tgt.numpy()))
        # the guard's grad norm (default policy "abort") is optax's
        want_norm = float(optax.global_norm(jgrads_fn(jstate.params, jbatch)))
        jstate, jloss = jstep_fn(jstate, jbatch)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), **TOL)
        np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm,
                                   **TOL)
        assert float(metrics["nonfinite"]) == 0.0
    # 3 steps over 10 samples at 4 per step: the last one wrapped the epoch
    assert loader.state == {"epoch": 1, "cursor": 4}
    got = weights.params_to_numpy(model)
    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        np.testing.assert_allclose(
            dict(jax.tree_util.tree_leaves_with_path(got))[path],
            np.asarray(want), err_msg=str(path), **TOL)


def test_dots_offload_steps_match_jax():
    """Three steps under remat "dots_offload" (the port's saves parked,
    a no-op placement on the CPU) against the JAX train step under the
    same policy (its trainer's ParallelCtx): losses at rtol 1e-6, final
    params at the file's tolerance, and the port's losses equal to its
    "dots" run's bit for bit."""
    raw = _raw("float32", remat=True, remat_policy="dots_offload")
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    tree = jax.tree.map(np.asarray, jllama.init_params(jc.model,
                                                       jax.random.key(3)))
    ctx = jllama.ParallelCtx(remat=True, remat_policy="dots_offload")
    jstate = jstep.init_train_state(jc, jax.tree.map(jnp.asarray, tree))
    jstep_fn = jax.jit(jstep.make_train_step(jc, ctx))
    runs = {}
    for policy in ("dots_offload", "dots"):
        cfg = tcfg.config_from_dict({**raw, "training": {
            **raw["training"], "remat_policy": policy}})
        model = tllama.LlamaModel(cfg.model, device="cpu")
        model.load_state_dict(weights.params_from_jax(tree, cfg.model))
        state = tstep.init_train_state(cfg, model)
        step_fn = tstep.make_train_step(cfg)
        loader = tdata.MicroBatchDataLoader(cfg, "cpu")
        runs[policy] = [float(step_fn(state, next(loader))["loss"])
                        for _ in range(3)]
        if policy == "dots_offload":
            got = weights.params_to_numpy(model)
    assert runs["dots_offload"] == runs["dots"]
    loader = tdata.MicroBatchDataLoader(tc, "cpu")
    for want in runs["dots_offload"]:
        ids, tgt = next(loader)
        jstate, jloss = jstep_fn(jstate, (jnp.asarray(ids.numpy()),
                                          jnp.asarray(tgt.numpy())))
        np.testing.assert_allclose(want, float(jloss), rtol=1e-6)
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, want in jax.tree_util.tree_leaves_with_path(jstate.params):
        np.testing.assert_allclose(got[path], np.asarray(want),
                                   err_msg=str(path), **TOL)


def test_loader_batches_and_cursors_token_exact():
    raw = _raw("float32", num_samples=10)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    jl = jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
    tl = tdata.MicroBatchDataLoader(tc, "cpu")
    for _ in range(4):
        (ji, jt), (ti, tt) = next(jl), next(tl)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert ti.shape == (2, 2, 16) and ti.dtype == torch.int64
        assert tl.state == jl.state
    st = tl.state
    tl2 = tdata.MicroBatchDataLoader(tc, "cpu")
    tl2.set_state(st)
    jl.set_state(st)
    np.testing.assert_array_equal(next(tl2)[0].numpy(), np.asarray(next(jl)[0]))
    tl2.reset({"epoch": 0, "cursor": 0})
    np.testing.assert_array_equal(
        next(tl2)[0].numpy(),
        jdata.SyntheticSource(256, 16, seed=42).get_rows(0, 0, 4)
        .reshape(2, 2, 17)[..., :-1])


@pytest.mark.parametrize("schedule,warmup", [
    ("constant", 0), ("constant", 2), ("cosine", 0), ("cosine", 3),
    ("linear", 2),
])
def test_lr_schedule_matches_optax(schedule, warmup):
    t = tcfg.TrainingConfig(lr_schedule=schedule, lr_warmup_steps=warmup,
                            total_train_steps=10, learning_rate=2e-3,
                            lr_min_ratio=0.1)
    jt = jcfg.TrainingConfig(lr_schedule=schedule, lr_warmup_steps=warmup,
                             total_train_steps=10, learning_rate=2e-3,
                             lr_min_ratio=0.1)
    tl, jl = toptim.make_lr(t), joptim.make_lr(jt)
    for count in range(12):
        want = float(jl(count)) if callable(jl) else jl
        got = tl(count) if callable(tl) else tl
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    if warmup:
        assert tl(0) == 0.0  # the first update uses lr = 0


def test_guard_nonfinite_keeps_old_tensors():
    new, old = [torch.ones(3)], [torch.zeros(3)]
    tstep.guard_nonfinite(torch.tensor(False), new, old)
    assert torch.equal(new[0], torch.zeros(3))
    new = [torch.ones(3)]
    tstep.guard_nonfinite(torch.tensor(True), new, old)
    assert torch.equal(new[0], torch.ones(3))


def test_cli_runs_on_cpu_and_prints_log_lines(tmp_path, capsys):
    raw = _raw("bfloat16", total_train_steps=2, lr_warmup_steps=0)
    raw["model"]["dtype"] = "bfloat16"
    raw["distributed"] = {}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    result = ttrain.main(["--config", str(path), "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[step ")]
    assert [l[:13] for l in lines] == ["[step 000001]", "[step 000002]"]
    assert "| tokens/s: " in lines[0] and "| MFU: 0.00% |" in lines[0]
    assert len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    assert result["device"] == "cpu"


def _placeholders(obj, tmp_path, corpus):
    """`obj` with "<tmp>" and "<corpus>" filled in."""
    if isinstance(obj, dict):
        return {k: _placeholders(v, tmp_path, corpus) for k, v in obj.items()}
    if isinstance(obj, str):
        return obj.replace("<corpus>", corpus).replace("<tmp>", str(tmp_path))
    return obj


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _check_chaos(tmp_path, result):
    """sigterm@2: the preemption path (exit 75, emergency checkpoint),
    with the chaos firing and the preemption in the stream."""
    assert result == 75
    kinds = [e["kind"] for e in _events(tmp_path / "ckpt/telemetry.jsonl")]
    assert {"chaos", "preempt_signal", "preempted"} <= set(kinds)
    assert (tmp_path / "ckpt/step_00000002/state").is_dir()


def _check_dataset(tmp_path, result):
    """A save_to_disk corpus of pre-chunked rows trains (its batches are
    held to the JAX loader's in test_torch_data.py)."""
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))


def _check_trace(tmp_path, result):
    doc = json.loads((tmp_path / "trace/trace.json").read_text())
    steps = [e for e in doc["traceEvents"] if e.get("name") == "step"
             and e.get("ph") == "X"]
    assert [e["args"]["step"] for e in steps] == [1, 2, 3]


def _check_sentinel(tmp_path, result):
    summary = _events(tmp_path / "ckpt/telemetry.jsonl")[-1]
    assert summary["kind"] == "run_summary"
    assert summary["sentinel"]["window"] == 3


def _check_telemetry_dir(tmp_path, result):
    kinds = [e["kind"] for e in _events(tmp_path / "tel/telemetry.jsonl")]
    assert kinds[0] == "run_start" and kinds[-1] == "run_summary"
    assert not (tmp_path / "ckpt/telemetry.jsonl").exists()


def _check_rotation(tmp_path, result):
    """A 500-byte cap rotates the stream: the rotated `.1` segment holds
    the run's last event (run_summary outgrows the cap alone) and the
    live file is the fresh segment after it."""
    rotated = _events(tmp_path / "ckpt/telemetry.jsonl.1")
    assert rotated and rotated[-1]["kind"] == "run_summary"
    assert (tmp_path / "ckpt/telemetry.jsonl").exists()


def _check_no_flight(tmp_path, result):
    """flight_steps 0: a divergence abort (nan_grad@2 under the default
    'abort') leaves no postmortem."""
    assert result == 76
    assert not (tmp_path / "ckpt/flightdeck_postmortem.json").exists()
    kinds = [e["kind"] for e in _events(tmp_path / "ckpt/telemetry.jsonl")]
    assert "guard" in kinds


def _check_offload(tmp_path, result):
    """remat "dots_offload": the trainer's losses equal a "dots" run's bit
    for bit (which parks nothing)."""
    raw = _raw("float32")
    raw["training"].update(remat=True, remat_policy="dots")
    raw["checkpoint"] = {"save_dir": str(tmp_path / "dots")}
    act_offload.reset_counts()
    want = ttrain.run(tcfg.config_from_dict(raw), "cpu")
    assert act_offload.counts["parked"] == 0
    assert result["losses"] == want["losses"]
    assert all(np.isfinite(result["losses"]))


@pytest.mark.parametrize("override,match", [
    # pp is ported: not refused, the run stops at the world-size check
    pytest.param({"distributed": {"pp_size": 2}}, None,
                 id="override0-pp_size"),
    # dots_offload is ported: the run parks its saves (`_check_offload`)
    pytest.param({"training": {"remat": True, "remat_policy":
                               "dots_offload"}}, _check_offload,
                 id="override1-dots_offload"),
    pytest.param({"logging": {"use_wandb": True}}, "use_wandb",
                 id="override2-use_wandb"),
    # chaos, HF datasets and the telemetry fields are ported: each run
    # exercises its feature (`check`)
    pytest.param({"resilience": {"chaos": "sigterm@2"}}, _check_chaos,
                 id="override3-chaos"),
    pytest.param({"dataset": {"name": "<corpus>"}}, _check_dataset,
                 id="override4-HF datasets"),
    # MoE is ported: not refused, the run trains
    pytest.param({"model": {"name": "debug-tiny-moe"}}, None,
                 id="override5-MoE"),
    pytest.param({"logging": {"trace_dir": "<tmp>/trace"}}, _check_trace,
                 id="override6-logging.trace_dir"),
    pytest.param({"logging": {"sentinel": True}}, _check_sentinel,
                 id="override7-logging.sentinel"),
    pytest.param({"logging": {"telemetry_dir": "<tmp>/tel"}},
                 _check_telemetry_dir, id="override8-logging.telemetry_dir"),
    pytest.param({"logging": {"telemetry_max_mb": 0.0005}}, _check_rotation,
                 id="override9-logging.telemetry_max_mb"),
    pytest.param({"logging": {"flight_steps": 0},
                  "resilience": {"chaos": "nan_grad@2"}}, _check_no_flight,
                 id="override10-logging.flight_steps"),
])
def test_trainer_refuses_what_the_slice_lacks(override, match, tmp_path):
    raw = _raw("float32")
    raw["checkpoint"] = {"save_dir": str(tmp_path / "ckpt")}
    corpus = ""
    if "dataset" in override:
        corpus = str(tmp_path / "corpus")
        _save_corpus(corpus, rows=24, block=17, vocab=256)
    for section, vals in _placeholders(override, tmp_path, corpus).items():
        raw.setdefault(section, {}).update(vals)
    cfg = tcfg.config_from_dict(raw)
    if isinstance(match, str):
        with pytest.raises(NotImplementedError, match=match):
            ttrain.run(cfg, "cpu")
        return
    assert ttrain.unsupported(cfg) == []
    if cfg.distributed.world_size > 1:
        with pytest.raises(ValueError, match="world size 1"):
            ttrain.run(cfg, "cpu")
        return
    try:
        result = ttrain.run(cfg, "cpu")
    except SystemExit as e:
        result = e.code
    if match is None:
        assert len(result["losses"]) == cfg.training.total_train_steps
        assert all(np.isfinite(result["losses"]))
    else:
        match(tmp_path, result)


def _save_corpus(path, rows, block, vocab, seed=0):
    """A pre-chunked `save_to_disk` corpus of `rows` random blocks."""
    import datasets

    ids = np.random.default_rng(seed).integers(0, vocab, (rows, block))
    datasets.Dataset.from_dict({"input_ids": ids.tolist()}).save_to_disk(
        path)


def test_trainer_says_what_it_does_not_write(tmp_path, capsys):
    """The JAX trainer's default stream: `telemetry.jsonl` next to the
    checkpoints, said once at the start, with a run_start, each step's
    phases and its step record, and a run_summary; none under
    telemetry_jsonl: false. dataset.num_workers now runs the prefetch
    thread and is not said to be ignored."""
    raw = _raw("float32", total_train_steps=1)
    raw["dataset"] = {"num_workers": 2}
    raw["checkpoint"] = {"save_dir": str(tmp_path / "on")}
    ttrain.run(tcfg.config_from_dict(raw), "cpu")
    out = capsys.readouterr().out
    path = tmp_path / "on" / "telemetry.jsonl"
    assert out.count(f"telemetry -> {path}") == 1
    assert "ignored" not in out
    kinds = [e["kind"] for e in _events(path)]
    assert kinds == ["run_start", "phase", "phase", "phase", "step",
                     "run_summary"]
    raw["logging"] = {"telemetry_jsonl": False}
    raw["checkpoint"] = {"save_dir": str(tmp_path / "off")}
    ttrain.run(tcfg.config_from_dict(raw), "cpu")
    out = capsys.readouterr().out
    assert "telemetry" not in out
    assert not (tmp_path / "off" / "telemetry.jsonl").exists()


def test_pp_configs_are_supported():
    """The four pipeline configs of runs/ pass the refusals (pp is the
    port's now); each needs its world (dp*pp*ep*cp*tp ranks)."""
    import os

    runs = os.path.join(os.path.dirname(__file__), "..", "runs")
    for name in ("llama2-7b-dp4tp2pp2-1f1b", "llama3-8b-4d-v5p64",
                 "smollm17-cpu-dp2tp2pp2", "smollm17-cpu-pp2-mpmd"):
        cfg = tcfg.load_config(os.path.join(runs, name, "config.json"))
        assert cfg.distributed.pp_size == 2
        assert ttrain.unsupported(cfg) == [], name
        assert tstep.resolved_grad_engine(cfg) == cfg.distributed.pp_engine


def test_smoke_config_is_the_supported_main_path():
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "picotron_tpu_torch",
                        "configs", "smollm17-1gpu-seq2048.json")
    cfg = tcfg.load_config(path)
    assert ttrain.unsupported(cfg) == []
    m, t = cfg.model, cfg.training
    assert (m.num_hidden_layers, m.hidden_size, m.num_attention_heads,
            m.num_key_value_heads, m.head_dim, m.intermediate_size,
            m.vocab_size) == (24, 2048, 32, 32, 64, 8192, 49152)
    assert (t.seq_length, t.micro_batch_size, t.gradient_accumulation_steps,
            t.total_train_steps, t.learning_rate, t.lr_warmup_steps) == (
        2048, 2, 2, 4, 3e-4, 0)


def test_fused_smoke_config_resolves_to_the_fused_engine():
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "picotron_tpu_torch",
                        "configs", "smollm17-1gpu-seq2048-fused.json")
    cfg = tcfg.load_config(path)
    assert ttrain.unsupported(cfg) == []
    assert tstep.resolved_grad_engine(cfg) == "fused"
    base = tcfg.load_config(os.path.join(os.path.dirname(path),
                                         "smollm17-1gpu-seq2048.json"))
    assert tstep.resolved_grad_engine(base) == "ad"
    assert cfg.model == base.model
    t = cfg.training
    assert (t.remat, t.remat_policy, t.grad_engine) == (True, "dots_attn",
                                                        "auto")


@pytest.mark.parametrize("training", [
    {"remat": True, "remat_policy": "dots"},
    {"remat": True, "remat_policy": "full", "ce_chunk_size": 128},
    {"remat": True, "remat_policy": "dots_attn", "grad_engine": "fused"},
])
def test_trainer_takes_remat_engines_and_chunked_ce(training):
    cfg = tcfg.config_from_dict(_raw("float32", total_train_steps=2,
                                     **training))
    result = ttrain.run(cfg, "cpu")
    plain = ttrain.run(tcfg.config_from_dict(_raw("float32",
                                                  total_train_steps=2)),
                       "cpu")
    np.testing.assert_allclose(result["losses"], plain["losses"], **TOL)


def test_seen_batch_loss_falls():
    """What chip_smoke checks on the card, at debug size: after training,
    the loss on the first step's batch is below that step's loss."""
    raw = _raw("bfloat16", lr_schedule="constant", lr_warmup_steps=0,
               total_train_steps=3, grad_clip_norm=0.0)
    cfg = tcfg.config_from_dict(raw)
    result = ttrain.run(cfg, "cpu")
    ids, tgt = next(tdata.MicroBatchDataLoader(cfg, "cpu"))
    with torch.no_grad():
        total = sum(float(tllama.loss_sum_count(result["state"].model,
                                                ids[i], tgt[i])[0])
                    for i in range(ids.shape[0]))
    assert total / ids[0].numel() / ids.shape[0] < result["losses"][0]


def test_run_calls_on_step_after_each_step():
    """The hook profile_step drives the trainer through."""
    cfg = tcfg.config_from_dict(_raw("float32", total_train_steps=3))
    seen = []
    result = ttrain.run(cfg, "cpu", on_step=lambda s, m: seen.append(s))
    assert seen == [1, 2, 3]
    assert len(result["losses"]) == 3


def test_profile_step_kernel_classes():
    from picotron_tpu_torch.profile_step import kernel_class

    assert kernel_class("void {anon}::fwd_kernel<float, 64>(...)") == (
        "flash:fwd_kernel")
    assert kernel_class("void {anon}::fwd_mma_kernel<128>(...)") == (
        "flash:fwd_kernel")
    assert kernel_class("void {anon}::fwd_wgmma_kernel(CUtensorMap_st, "
                        "...)") == "flash:fwd_kernel"
    assert kernel_class("bwd_dq_kernel<float, 64>") == "flash:bwd_dq_kernel"
    assert kernel_class("void {anon}::bwd_dq_mma_kernel<128>(...)") == (
        "flash:bwd_dq_kernel")
    assert kernel_class("void {anon}::bwd_dq_wgmma_kernel(CUtensorMap_st, "
                        "...)") == "flash:bwd_dq_kernel"
    assert kernel_class("bwd_dkv_kernel<float, 128>") == "flash:bwd_dkv_kernel"
    assert kernel_class("void {anon}::bwd_dkv_mma_kernel<64>(...)") == (
        "flash:bwd_dkv_kernel")
    assert kernel_class("void {anon}::bwd_dkv_wgmma_kernel(CUtensorMap_st, "
                        "...)") == "flash:bwd_dkv_kernel"
    assert kernel_class("void {anon}::rope_rows_kernel<64>(...)") == (
        "flash:rope_rows")
    assert kernel_class("nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT") == "gemm"
    assert kernel_class("void at::native::vectorized_elementwise_kernel") == (
        "other")
    assert kernel_class("void {anon}::adamw_kernel<true, false>(...)") == (
        "adamw")
    assert kernel_class("Memcpy HtoD (Pinned -> Device)") == "memcpy"


@pytest.mark.parametrize("preset", ["SmolLM-1.7B", "Llama-3.2-1B",
                                    "debug-tiny-qwen"])
def test_flops_mfu_and_log_line_match_jax(preset):
    from picotron_tpu import utils as jutils
    from picotron_tpu_torch import utils as tutils

    raw = {"model": {"name": preset}}
    jm = jcfg.config_from_dict(raw).model
    tm = tcfg.config_from_dict(raw).model
    assert tutils.flops_per_token(tm, 2048) == jutils.flops_per_token(jm, 2048)
    assert (tutils.mfu(1e4, tm, 2048, 1, tutils.H100_BF16_PEAK)
            == jutils.mfu(1e4, jm, 2048, 1, jutils.H100_BF16_PEAK))
    args = (7, 10.9674, 10329.3, 10329.3, 0.1261, 32768, 38.99)
    assert (tutils.training_log_line(*args, extras={"x": 1.5})
            == jutils.training_log_line(*args, extras={"x": 1.5}))
