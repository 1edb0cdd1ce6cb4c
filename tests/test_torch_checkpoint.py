"""The port's checkpointing and eval against the JAX package on the CPU at
debug size: the save/restore round trip bit for bit (params, fp32 and bf16
moments, count, step, tokens, cursor), async saves snapshotting the step
they were taken at, lineage fallback past corrupt steps, explicit-step
validation, retention, HF safetensors in both directions, params-only
restore, eval against `make_eval_step`, both drivers end to end from
one locally written HF file (fp32 rtol/atol 1e-5 across frameworks), and
the chaos points of a save (`ckpt_save` retried, the corruption kinds at
`ckpt_committed` caught by the manifest and the lineage fallback)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from picotron_tpu import checkpoint as jckpt
from picotron_tpu import config as jcfg
from picotron_tpu import train as jtrain
from picotron_tpu.mesh import MeshEnv
from picotron_tpu.models import llama as jllama
from picotron_tpu.parallel import api as japi
from picotron_tpu_torch import checkpoint as tckpt
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.data import MicroBatchDataLoader, build_eval_source
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.telemetry import bus

TOL = dict(rtol=1e-5, atol=1e-5)


def _raw(tmp_path, moments="float32", preset="debug-tiny", **sections):
    raw = {"model": {"name": preset, "dtype": "float32"},
           "training": dict(seq_length=16, micro_batch_size=2,
                            gradient_accumulation_steps=2,
                            total_train_steps=4, lr_schedule="cosine",
                            lr_warmup_steps=1, learning_rate=1e-3,
                            weight_decay=0.1, grad_clip_norm=1.0,
                            adam_moments_dtype=moments, remat=False,
                            seed=3),
           "distributed": {"use_cpu": True},
           "checkpoint": {"save_dir": str(tmp_path / "ckpt")},
           "logging": {"log_frequency": 1}}
    for section, vals in sections.items():
        raw.setdefault(section, {}).update(vals)
    return raw


def _trained(cfg, steps=2, seed=0):
    """A port TrainState after `steps` steps, and its loader."""
    gen = torch.Generator().manual_seed(seed)
    model = tllama.init_params(tllama.LlamaModel(cfg.model, device="cpu"),
                               gen)
    state = tstep.init_train_state(cfg, model)
    dl = MicroBatchDataLoader(cfg, "cpu")
    step_fn = tstep.make_train_step(cfg)
    for _ in range(steps):
        step_fn(state, next(dl))
    return state, dl


def _fresh(cfg, seed=1):
    gen = torch.Generator().manual_seed(seed)
    model = tllama.init_params(tllama.LlamaModel(cfg.model, device="cpu"),
                               gen)
    return tstep.init_train_state(cfg, model)


def _tensors(state):
    out = {}
    for n, p in state.model.named_parameters():
        st = state.optimizer.moments(p)
        out[n] = p.detach().clone()
        out["mu." + n] = st["mu"].clone()
        out["nu." + n] = st["nu"].clone()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_save_restore_round_trip_bit_for_bit(tmp_path, moments):
    cfg = tcfg.config_from_dict(_raw(tmp_path, moments))
    state, dl = _trained(cfg)
    want = _tensors(state)
    mgr = tckpt.CheckpointManager(cfg)
    path = mgr.save(state, trained_tokens=128, dataloader_state=dl.state)
    mgr.wait_until_finished()
    assert mgr.verify_step(2).status == "verified"
    assert set(os.listdir(path)) == {"state", "meta.json", "manifest.json"}
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert set(man["files"]) == {"meta.json", "state/params.pt",
                                 "state/opt_state.pt"}
    assert man["topology"] == {"dp": 1, "pp": 1, "ep": 1, "cp": 1, "tp": 1,
                               "world_size": 1, "process_count": 1}

    other = _fresh(cfg)
    restored, meta = tckpt.CheckpointManager(cfg).restore(other)
    _assert_same(_tensors(restored), want)
    if moments == "bfloat16":
        assert want["mu.embedding"].dtype == torch.bfloat16
    assert restored.step == 2 and restored.optimizer.count == 2
    assert meta["trained_tokens"] == 128
    assert meta["dataloader"] == dl.state == {"epoch": 0, "cursor": 8}
    assert meta["config"]["training"]["adam_moments_dtype"] == moments


def test_async_save_holds_the_step_it_was_taken_at(tmp_path):
    cfg = tcfg.config_from_dict(_raw(tmp_path))
    assert cfg.checkpoint.async_save
    state, dl = _trained(cfg)
    want = _tensors(state)
    mgr = tckpt.CheckpointManager(cfg)
    mgr.save(state, 128, dl.state)
    # the trainer updates in place right after save() returns
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
            st = state.optimizer.moments(p)
            st["mu"].add_(1.0)
            st["nu"].add_(1.0)
    state.optimizer.count += 1
    mgr.wait_until_finished()
    restored, _ = mgr.restore(_fresh(cfg))
    _assert_same(_tensors(restored), want)
    assert restored.optimizer.count == 2


def _corrupt(step_dir, how):
    if how == "unfinished_payload":
        # a save that died before its rename: no state/, a staging dir
        os.rename(os.path.join(step_dir, "state"),
                  os.path.join(step_dir, "state.tmp.1"))
    elif how == "torn_meta":
        with open(os.path.join(step_dir, "meta.json"), "w") as f:
            f.write('{"step": 4, "trained_')
    elif how == "flipped_byte":
        path = os.path.join(step_dir, "state", "params.pt")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x40]))
    elif how == "deleted_file":
        os.remove(os.path.join(step_dir, "meta.json"))


class _Recorder:
    def __init__(self):
        self.events = []

    def emit(self, kind, category=None, secs=None, **fields):
        self.events.append((kind, fields))


@pytest.mark.parametrize("how", ["unfinished_payload", "torn_meta",
                                 "flipped_byte", "deleted_file"])
def test_lineage_falls_back_past_a_corrupt_newest_step(tmp_path, how):
    cfg = tcfg.config_from_dict(_raw(tmp_path))
    state, dl = _trained(cfg, steps=2)
    mgr = tckpt.CheckpointManager(cfg)
    mgr.save(state, 128, dl.state)
    want = _tensors(state)
    step_fn = tstep.make_train_step(cfg)
    for _ in range(2):
        step_fn(state, next(dl))
    mgr.save(state, 256, dl.state)
    mgr.wait_until_finished()
    _corrupt(mgr._step_dir(4), how)
    rec = bus.install(_Recorder())
    try:
        assert mgr.latest_valid_step() == 2
        restored, meta = mgr.restore(_fresh(cfg))
    finally:
        bus.install(None)
    _assert_same(_tensors(restored), want)
    assert restored.step == 2 and meta["trained_tokens"] == 128
    if how != "unfinished_payload":  # a corrupt, durable step is reported
        assert ("ckpt_corrupt", ) == tuple(
            {k for k, f in rec.events if f.get("step") == 4})
        assert mgr.durable_steps() == [2, 4]
    else:
        assert mgr.durable_steps() == [2]
    assert mgr.valid_steps() == [2]


@pytest.mark.parametrize("kind", ["ckpt_corrupt_bitflip", "ckpt_truncate",
                                  "ckpt_torn_meta"])
def test_chaos_corrupts_the_committed_step_and_lineage_falls_back(
        tmp_path, kind):
    """The corruption kinds fire at the `ckpt_committed` point (after
    the manifest commits) on the port's own files: the largest payload
    under state/ (opt_state.pt: both moments) or meta.json. The
    manifest then fails the step, `latest_valid_step` emits
    ckpt_corrupt and falls back to step 2, and restore reads step 2."""
    from picotron_tpu_torch.resilience import chaos

    cfg = tcfg.config_from_dict(_raw(tmp_path,
                                     checkpoint={"async_save": False}))
    state, dl = _trained(cfg, steps=2)
    mgr = tckpt.CheckpointManager(cfg)
    want = _tensors(state)
    rec = bus.install(_Recorder())
    try:
        chaos.install(f"{kind}@4")
        mgr.save(state, 128, dl.state)
        step_fn = tstep.make_train_step(cfg)
        for _ in range(2):
            step_fn(state, next(dl))
        # step 2's twin of the payload step 4's corruptor targets
        size = os.path.getsize(os.path.join(mgr._step_dir(2), "state",
                                            "opt_state.pt"))
        mgr.save(state, 256, dl.state)
        chaos.uninstall()
        assert mgr.latest_valid_step() == 2
        restored, meta = mgr.restore(_fresh(cfg))
    finally:
        chaos.uninstall()
        bus.install(None)
    kinds = [k for k, _ in rec.events]
    assert kinds[:3] == ["ckpt_commit", "ckpt_commit", "chaos"]
    assert ("ckpt_corrupt", 4) in [(k, f.get("step")) for k, f in rec.events]
    _assert_same(_tensors(restored), want)
    assert restored.step == 2 and meta["trained_tokens"] == 128
    if kind == "ckpt_truncate":
        assert os.path.getsize(os.path.join(
            mgr._step_dir(4), "state", "opt_state.pt")) == size // 2
    assert mgr.valid_steps() == [2]


def test_chaos_ckpt_io_is_retried_then_surfaces(tmp_path):
    """`ckpt_io` raises inside the retried payload write: two failures
    fit the default 3 attempts (two `retry` events, the step commits),
    a budget-outlasting one surfaces and leaves the step not durable."""
    from picotron_tpu_torch.resilience import chaos

    cfg = tcfg.config_from_dict(_raw(tmp_path, checkpoint={
        "async_save": False}, resilience={"retry_base_delay": 0.01,
                                          "retry_max_delay": 0.01}))
    state, dl = _trained(cfg, steps=2)
    mgr = tckpt.CheckpointManager(cfg)
    rec = bus.install(_Recorder())
    try:
        chaos.install("ckpt_io@2x2")
        mgr.save(state, 128, dl.state)
        assert [k for k, _ in rec.events] == [
            "chaos", "retry", "chaos", "retry", "ckpt_commit"]
        assert mgr.latest_valid_step() == 2
        state.step = 3
        chaos.install("ckpt_io@3x99")
        with pytest.raises(OSError, match="chaos-injected ckpt_io"):
            mgr.save(state, 192, dl.state)
    finally:
        chaos.uninstall()
        bus.install(None)
    assert mgr.durable_steps() == [2]


@pytest.mark.parametrize("algo", ["xxh64", "crc32"])
def test_manifest_digests_match_jax_and_catch_a_flip(tmp_path, monkeypatch,
                                                     algo):
    """Both digests (crc32 runs where xxhash is absent) equal the JAX
    package's, and a manifest built under each catches a flipped byte."""
    from picotron_tpu.ckpt_integrity import manifest as jman
    from picotron_tpu_torch.ckpt_integrity import manifest as tman

    monkeypatch.setattr(tman, "digest_algo", lambda: algo)
    cfg = tcfg.config_from_dict(_raw(tmp_path))
    state, dl = _trained(cfg, steps=1)
    mgr = tckpt.CheckpointManager(cfg)
    path = mgr.save(state, 64, dl.state)
    mgr.wait_until_finished()
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["algo"] == algo
    for rel, entry in man["files"].items():
        assert jman.file_digest(os.path.join(path, rel), algo) == (
            entry["digest"], entry["bytes"])
    assert mgr.verify_step(1).status == "verified"
    _corrupt(path, "flipped_byte")
    res = mgr.verify_step(1)
    assert res.status == "corrupt" and f"{algo} digest" in res.failures[0]
    assert mgr.verify_step(1, deep=False).status == "verified"  # sizes only


def test_explicit_step_restore_is_validated(tmp_path):
    cfg = tcfg.config_from_dict(_raw(tmp_path))
    state, dl = _trained(cfg, steps=2)
    mgr = tckpt.CheckpointManager(cfg)
    mgr.save(state, 128, dl.state)
    state.step = 4
    mgr.save(state, 256, dl.state)
    mgr.wait_until_finished()
    _corrupt(mgr._step_dir(4), "flipped_byte")
    with pytest.raises(FileNotFoundError, match=r"step 4 .*failed "
                       r"verification.*valid steps: \[2\]"):
        mgr.restore(_fresh(cfg), step=4)
    with pytest.raises(FileNotFoundError, match=r"step 9 .*not durable"):
        mgr.restore(_fresh(cfg), step=9)
    assert mgr.restore(_fresh(cfg), step=2)[0].step == 2
    # another model shape or topology is refused, naming both sides
    wide = tcfg.config_from_dict(_raw(tmp_path, preset="debug-tiny-qwen"))
    with pytest.raises(ValueError, match="saved .* vs this run's"):
        tckpt.CheckpointManager(wide).restore(_fresh(wide), step=2)
    man_path = os.path.join(mgr._step_dir(2), "manifest.json")
    man = json.load(open(man_path))
    man["topology"]["dp"] = 2
    json.dump(man, open(man_path, "w"))
    with pytest.raises(RuntimeError, match=r"topology \[dp2 pp1 ep1 cp1 "
                       r"tp1\] but this run's mesh is \[dp1 pp1"):
        mgr.load_step(_fresh(cfg), 2)


def test_keep_last_1_keeps_the_last_verified_step(tmp_path):
    cfg = tcfg.config_from_dict(_raw(tmp_path))
    state, dl = _trained(cfg, steps=1)
    mgr = tckpt.CheckpointManager(cfg)  # keep_last 0: keeps everything
    for step in (2, 4):
        state.step = step
        mgr.save(state, 0, dl.state)
    mgr.wait_until_finished()
    _corrupt(mgr._step_dir(4), "flipped_byte")
    keep1 = tcfg.config_from_dict(_raw(tmp_path, checkpoint={"keep_last": 1}))
    gc_mgr = tckpt.CheckpointManager(keep1)
    # the newest (4) is kept by policy, the last verified (2) by protection
    assert gc_mgr.gc() == {"kept": [2, 4], "deleted": []}
    state.step = 6
    gc_mgr.save(state, 0, dl.state)
    gc_mgr.wait_until_finished()
    assert gc_mgr.steps() == [6] and gc_mgr.latest_valid_step() == 6


@pytest.mark.parametrize("preset", ["debug-tiny", "debug-tiny-qwen"])
def test_hf_safetensors_both_directions_match_jax(tmp_path, preset):
    jc = jcfg.config_from_dict({"model": {"name": preset}})
    tc = tcfg.config_from_dict({"model": {"name": preset}})
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jc.model, jax.random.key(5)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_hf_safetensors(tree, jdir)

    # the port reads the JAX package's file
    sd = tckpt.load_hf_safetensors(jdir, tc.model)
    want = weights.params_from_jax(tree, tc.model)
    _assert_same(sd, want)
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(sd)

    # safetensors reads the port's file: same names, dtypes, shapes, bytes
    tckpt.save_hf_safetensors(model, tdir)
    mine = load_file(os.path.join(tdir, "model.safetensors"))
    ref = load_file(os.path.join(jdir, "model.safetensors"))
    assert mine.keys() == ref.keys()
    assert ("lm_head.weight" in mine) == (not tc.model.tie_word_embeddings)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and mine[k].shape == ref[k].shape
        assert mine[k].tobytes() == ref[k].tobytes(), k
    # and the JAX package reads it back to the same tree
    back = jckpt.load_hf_safetensors(tdir, jc.model)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        np.testing.assert_array_equal(np.asarray(got), leaf)
    # a bf16 file round-trips through the port's own reader and writer
    bf = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tckpt.write_safetensors(bf, str(tmp_path / "bf16.safetensors"))
    _assert_same(tckpt.read_safetensors(str(tmp_path / "bf16.safetensors")),
                 bf)


def test_restore_params_only(tmp_path):
    cfg = tcfg.config_from_dict(_raw(tmp_path, "bfloat16"))
    state, dl = _trained(cfg)
    mgr = tckpt.CheckpointManager(cfg)
    mgr.save(state, 128, dl.state)
    mgr.wait_until_finished()
    params, step = tckpt.restore_params_only(cfg, cfg.checkpoint.save_dir)
    assert step == 2
    _assert_same(params, {n: p.detach() for n, p in
                          state.model.named_parameters()})
    half, _ = tckpt.restore_params_only(cfg, cfg.checkpoint.save_dir, step=2,
                                        dtype=torch.bfloat16)
    assert half["embedding"].dtype == torch.bfloat16
    assert torch.equal(half["embedding"],
                       state.model.embedding.detach().to(torch.bfloat16))


def test_eval_loss_matches_make_eval_step(tmp_path):
    raw = _raw(tmp_path, training={"eval_frequency": 1, "eval_steps": 2})
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jc.model, jax.random.key(3)))
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(tree, tc.model))
    src = build_eval_source(tc)
    assert src.seed == tc.training.seed + 104729
    eval_dl = MicroBatchDataLoader(tc, "cpu", source=src)
    jeval = japi.make_eval_step(jc, MeshEnv.from_config(jc))
    params = jax.tree.map(jnp.asarray, tree)
    eval_fn = tstep.make_eval_step(tc)
    for _ in range(2):
        ids, tgt = next(eval_dl)
        got = eval_fn(model, (ids, tgt))
        assert got.grad_fn is None and got.dtype == torch.float32
        want = jeval(params, (jnp.asarray(ids.numpy()),
                              jnp.asarray(tgt.numpy())))
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_drivers_end_to_end_save_resume_match_jax(tmp_path, monkeypatch,
                                                  capsys):
    """Both drivers from one HF file: the JAX driver's 4 steps, the port's
    2 steps + save + auto_resume to 4, and the port's uninterrupted 4."""
    hf = str(tmp_path / "hf")
    jc0 = jcfg.config_from_dict({"model": {"name": "debug-tiny"}})
    jckpt.save_hf_safetensors(
        jax.tree.map(np.asarray,
                     jllama.init_params(jc0.model, jax.random.key(11))), hf)

    raw = _raw(tmp_path / "jax", checkpoint={"init_from_hf": hf})
    cfg_path = tmp_path / "jax.json"
    cfg_path.write_text(json.dumps(raw))
    monkeypatch.setenv("PICOTRON_PREFLIGHT", "0")
    jtrain.main(["--config", str(cfg_path)])
    events = [json.loads(line) for line in
              open(tmp_path / "jax" / "ckpt" / "telemetry.jsonl")]
    jax_losses = [e["loss"] for e in events if e["kind"] == "step"]
    assert len(jax_losses) == 4

    port = _raw(tmp_path / "port", checkpoint={
        "init_from_hf": hf, "save_frequency": 2, "auto_resume": True})
    first = ttrain.run(tcfg.config_from_dict(
        {**port, "training": {**port["training"], "max_tokens": 2 * 64}}))
    assert first["losses"] and len(first["losses"]) == 2
    second = ttrain.run(tcfg.config_from_dict(port))
    assert second["start_step"] == 2
    resumed = first["losses"] + second["losses"]
    np.testing.assert_allclose(resumed, jax_losses, **TOL)
    whole = ttrain.run(tcfg.config_from_dict(
        _raw(tmp_path / "whole", checkpoint={"init_from_hf": hf})))
    assert resumed == whole["losses"]  # bit for bit
    out = capsys.readouterr().out
    assert "resumed from " in out and "initialized weights from" in out
