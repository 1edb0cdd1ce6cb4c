"""The port's checkpoint and run tools (python -m
picotron_tpu_torch.tools.<name>) against the JAX package's tools/, on the
CPU:

- `ckpt_doctor`: on a store with one bit-flipped step, the per-step
  verdicts, the markdown row and the exit code (1) equal the JAX doctor's
  on a JAX store with the same corruption; `--gc` dry run and apply.
- `extract_metrics`: `metrics.csv` and `global_metrics.csv` byte for byte
  the JAX tool's on the same run directories (one with a telemetry.jsonl
  written by the port's trainer, one with its console log only).
- `create_config`: the same JSON as the JAX tool's from the same flags.
- `trace_summary` on a CPU `logging.profile_dir` capture (steps 3-4 of
  5) covers exactly the window's steps.
- `export_hf`: the exported file read back equals `restore_params_only`.
- `elastic_resize`: dry run touches nothing; a corrupt store, a slice
  count that does not divide dp x pp and an uneven pp split are refused
  (the store untouched); a re-stamp re-verifies and restores without
  checkpoint.elastic.
- `chaos`: `--list` names every JAX scenario as runnable (none refused)
  and a multi-rank one asked of a machine short of cards exits 2;
  `nan_skip` recovers in tier 1 (four gloo
  ranks, ~10 s). The other scenarios spawn 6 to 16 trainer processes
  each and are marked slow, as the JAX package's scenario tests are.
"""

import importlib.util
import json
import os
import shutil
import sys

import pytest
import torch

from picotron_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _raw(save_dir, steps=4, **sections):
    raw = {"model": {"name": "debug-tiny", "dtype": "float32"},
           "training": dict(seq_length=16, micro_batch_size=2,
                            gradient_accumulation_steps=2,
                            total_train_steps=steps, learning_rate=1e-3,
                            remat=False),
           "distributed": {"use_cpu": True},
           "checkpoint": {"save_dir": str(save_dir), "async_save": False},
           "logging": {"log_frequency": 1}}
    for section, vals in sections.items():
        raw.setdefault(section, {}).update(vals)
    return raw


def _train(raw):
    from picotron_tpu_torch import train as ttrain

    os.environ.pop("PICOTRON_CHAOS", None)
    return ttrain.run(tcfg.config_from_dict(raw), "cpu")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A port store with steps 2, 4 and 6 (debug-tiny, 6 steps)."""
    d = tmp_path_factory.mktemp("store")
    raw = _raw(d / "ckpt", steps=6, checkpoint={"save_frequency": 2})
    res = _train(raw)
    return {"raw": raw, "dir": str(d / "ckpt"), "result": res}


def _flip_largest(step_dir):
    files = [os.path.join(r, f)
             for r, _d, fs in os.walk(os.path.join(step_dir, "state"))
             for f in fs]
    victim = max(files, key=os.path.getsize)
    with open(victim, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))


# -- ckpt_doctor ------------------------------------------------------------


def _jax_store(root):
    """The JAX doctor test's store: toy states at steps 2, 4, 6."""
    import jax.numpy as jnp

    from picotron_tpu.checkpoint import CheckpointManager
    from picotron_tpu.config import config_from_dict
    from picotron_tpu.train_step import TrainState

    cfg = config_from_dict({
        "model": {"name": "debug-tiny"},
        "checkpoint": {"save_dir": str(root), "save_frequency": 1,
                       "async_save": False},
        "resilience": {"retry_base_delay": 0.01, "retry_max_delay": 0.02}})
    mgr = CheckpointManager(cfg)
    for s in (2, 4, 6):
        mgr.save(TrainState(params={"w": jnp.arange(512.0) + s},
                            opt_state={"m": jnp.zeros(512)},
                            step=jnp.asarray(s, jnp.int32)),
                 trained_tokens=s)
    return mgr.directory


def _doctor_view(doctor, save_dir, capsys):
    rows = doctor.scan(save_dir)
    code = doctor.main([save_dir, "--json"])
    out = json.loads(capsys.readouterr().out)
    md_code = doctor.main([save_dir, "--markdown"])
    md = capsys.readouterr().out
    return ([(r["step"], r["verdict"]) for r in rows], code,
            [r["verdict"] for r in out["steps"]], md_code,
            [line.split("|")[1:3] for line in md.splitlines()
             if line.startswith("| ") and "corrupt" in line])


def test_ckpt_doctor_verdicts_match_jax(tmp_path, store, capsys):
    from picotron_tpu_torch.tools import ckpt_doctor

    port = str(tmp_path / "port")
    shutil.copytree(store["dir"], port)
    _flip_largest(os.path.join(port, "step_00000004"))
    jax_dir = _jax_store(tmp_path / "jax")
    _flip_largest(os.path.join(jax_dir, "step_00000004"))
    got = _doctor_view(ckpt_doctor, port, capsys)
    want = _doctor_view(jax_tool("ckpt_doctor"), jax_dir, capsys)
    assert got == want
    assert got[0] == [(2, "verified"), (4, "corrupt"), (6, "verified")]
    assert got[1] == 1
    rows = ckpt_doctor.scan(port)
    assert rows[1]["failures"] and "state/" in rows[1]["failures"][0]
    assert rows[0]["topology"]["dp"] == 1


def test_ckpt_doctor_gc_dry_run_then_apply(tmp_path, store, capsys):
    from picotron_tpu_torch.tools import ckpt_doctor

    port = str(tmp_path / "port")
    shutil.copytree(store["dir"], port)
    steps = lambda: sorted(d for d in os.listdir(port)  # noqa: E731
                           if d.startswith("step_"))
    assert ckpt_doctor.main([port, "--gc", "--keep-last", "2",
                             "--dry-run"]) == 0
    assert len(steps()) == 3
    assert "would delete [2]" in capsys.readouterr().out
    assert ckpt_doctor.main([port, "--gc", "--keep-last", "2"]) == 0
    assert steps() == ["step_00000004", "step_00000006"]
    assert ckpt_doctor.main([str(tmp_path / "absent")]) == 2


# -- extract_metrics --------------------------------------------------------


def test_extract_metrics_csvs_are_the_jax_tools(tmp_path, store,
                                                monkeypatch):
    from picotron_tpu_torch.tools import extract_metrics
    from picotron_tpu_torch.utils import training_log_line

    exp = tmp_path / "exp"
    tel = exp / "dp1_tp1_pp1_cp1_tel"
    shutil.copytree(store["dir"], tel / "ckpt",
                    ignore=shutil.ignore_patterns("step_*"))
    log = exp / "dp4_tp2_pp1_cp1"
    log.mkdir(parents=True)
    lines = [training_log_line(s, 5.0 - 0.1 * s, 12345.0 + s, 1543.1,
                               0.1854, s * 512, 1.5,
                               extras={"grad_norm": 0.5 + s / 10})
             for s in range(1, 9)]
    lines.append("[eval  000008] val_loss: 4.1234 (8 batches)")
    (log / "train.log").write_text("\n".join(lines) + "\n")
    csvs = {}
    for side, tool in (("jax", jax_tool("extract_metrics")),
                       ("port", extract_metrics)):
        d = tmp_path / side
        shutil.copytree(exp, d)
        rows = tool.aggregate(str(d), skip_steps=1)
        assert len(rows) == 2
        if side == "port":
            extract_metrics.main([str(d), "--skip-steps", "1"])
        else:
            monkeypatch.setattr(sys, "argv", ["extract_metrics", str(d),
                                              "--skip-steps", "1"])
            tool.main()
        csvs[side] = {p: open(os.path.join(d, p)).read() for p in (
            "global_metrics.csv", "dp1_tp1_pp1_cp1_tel/metrics.csv",
            "dp4_tp2_pp1_cp1/metrics.csv")}
    assert csvs["port"] == csvs["jax"]
    assert "goodput_pct" in csvs["port"]["global_metrics.csv"]
    assert "mean_grad_norm" in csvs["port"]["dp4_tp2_pp1_cp1/metrics.csv"]


# -- create_config ----------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--dp", "2", "--tp", "2", "--model", "debug-tiny", "--seq-len", "64",
     "--zero1", "--use-cpu"],
    ["--pp", "2", "--pp-engine", "afab", "--model", "SmolLM-1.7B",
     "--mbs", "3", "--grad-acc", "4", "--no-remat", "--save-frequency",
     "10", "--auto-resume", "--num-hidden-layers", "4"],
    ["--cp", "4", "--cp-flavor", "ulysses", "--model", "Llama-2-7B",
     "--sequence-parallel", "--tp", "2", "--lr-schedule", "cosine",
     "--lr-warmup-steps", "5", "--optimizer-offload"],
    ["--ep", "2", "--model", "debug-tiny-moe", "--serve-slots", "4",
     "--serve-block-size", "8", "--dtype", "float32"],
    ["--model", "debug-tiny", "--serve-disagg", "--serve-prefill-slots",
     "2", "--serve-prefill-num-blocks", "32", "--serve-decode-device", "0"],
])
def test_create_config_writes_the_jax_tools_json(tmp_path, flags):
    from picotron_tpu_torch.tools import create_config

    jtool = jax_tool("create_config")
    out = {}
    for side in ("jax", "port"):
        argv = ["--exp-name", "dp2_run", "--out-dir", str(tmp_path / side),
                *flags]
        if side == "jax":
            path = jtool.create_single_config(
                jtool.build_parser().parse_args(argv))
        else:
            path = create_config.main(argv)
        text = open(path).read().replace(str(tmp_path / side), "OUT")
        out[side] = text
    assert out["port"] == out["jax"]
    cfg = tcfg.load_config(path)
    assert cfg.global_batch_size > 0


# -- trace_summary ----------------------------------------------------------


def test_trace_summary_covers_the_profile_window(tmp_path, capsys):
    from picotron_tpu_torch.tools import trace_summary

    prof = tmp_path / "prof"
    res = _train(_raw(tmp_path / "ckpt", steps=5, logging={
        "profile_dir": str(prof), "profile_start_step": 3,
        "profile_num_steps": 2}))
    assert res["profile_path"].endswith("steps3-4.pt.trace.json")
    s = trace_summary.summarize(trace_summary.load_events(
        trace_summary.newest_trace(str(prof))))
    assert s["steps"] == [3, 4]
    assert s["device"] == "cpu"
    # the flash kernels' plain path under its autograd node, 4 layers x
    # ga 2 x 2 steps
    assert s["kernels"]["_FlashCore"]["launches"] == 4 * 2 * 2
    assert trace_summary.main([str(prof), "--top", "5", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "steps: [3, 4]" in out and "ms/step" in out


# -- export_hf --------------------------------------------------------------


def test_export_hf_round_trip(tmp_path, store):
    from picotron_tpu_torch.checkpoint import (
        load_hf_safetensors, restore_params_only,
    )
    from picotron_tpu_torch.tools import export_hf

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(store["raw"]))
    assert export_hf.main(["--config", str(cfg_path), "--ckpt-dir",
                           store["dir"], "--out", str(tmp_path / "hf")]) == 0
    cfg = tcfg.load_config(str(cfg_path))
    want, step = restore_params_only(cfg, store["dir"])
    got = load_hf_safetensors(str(tmp_path / "hf"), cfg.model)
    assert step == 6 and sorted(got) == sorted(want)
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert all(torch.equal(want[n], p) for n, p in
               store["result"]["state"].model.named_parameters())


# -- elastic_resize ---------------------------------------------------------


def _meta(step_dir):
    with open(os.path.join(step_dir, "meta.json")) as f:
        return json.load(f)


def test_elastic_resize_refuses_a_corrupt_store(tmp_path, store):
    from picotron_tpu_torch.tools import elastic_resize

    port = str(tmp_path / "port")
    shutil.copytree(store["dir"], port)
    step_dir = os.path.join(port, "step_00000004")
    _flip_largest(step_dir)
    before = open(os.path.join(step_dir, "meta.json")).read()
    assert elastic_resize.main([port, "--step", "4", "--dp", "2"]) == 1
    assert open(os.path.join(step_dir, "meta.json")).read() == before
    assert "elastic_restamp" not in _meta(step_dir)


def test_elastic_resize_refusals_and_dry_run(tmp_path, store, capsys):
    from picotron_tpu_torch.tools import elastic_resize

    port = str(tmp_path / "port")
    shutil.copytree(store["dir"], port)
    step_dir = os.path.join(port, "step_00000006")
    state = os.path.join(step_dir, "state")
    snap = lambda: {f: open(os.path.join(state, f), "rb").read()  # noqa: E731
                    for f in os.listdir(state)}
    before, meta = snap(), open(os.path.join(step_dir, "meta.json")).read()
    assert elastic_resize.main([port, "--dp", "2", "--dry-run"]) == 0
    assert "dry run: store not modified" in capsys.readouterr().out
    # two slices cannot split dp 1 x pp 1 (the JAX tool's check)
    assert elastic_resize.main([port, "--slices", "2"]) == 1
    assert "slices must divide dp*pp = 1" in capsys.readouterr().err
    assert elastic_resize.main([port, "--pp", "3"]) == 1  # 4 layers on 3
    assert "different slots" in capsys.readouterr().err
    assert elastic_resize.main([port, "--dp", "3"]) == 1  # gbs 4 over 3
    assert snap() == before
    assert open(os.path.join(step_dir, "meta.json")).read() == meta


def test_elastic_resize_restamp_restores_without_elastic(tmp_path, store):
    """dp 1 -> 2 re-stamp: the step re-verifies, records dp 2 at constant
    global batch (mbs 2, ga 1), and a dp 2 config then refuses nothing;
    back at dp 1 the params restore bit for bit."""
    from picotron_tpu_torch.checkpoint import CheckpointManager
    from picotron_tpu_torch.ckpt_integrity import verify_step_dir
    from picotron_tpu_torch.tools import elastic_resize
    from picotron_tpu_torch.train import build_state

    port = str(tmp_path / "port")
    shutil.copytree(store["dir"], port)
    step_dir = os.path.join(port, "step_00000006")
    assert elastic_resize.main([port, "--dp", "2"]) == 0
    meta = _meta(step_dir)
    assert meta["config"]["distributed"]["dp_size"] == 2
    assert meta["config"]["training"]["micro_batch_size"] == 2
    assert meta["config"]["training"]["gradient_accumulation_steps"] == 1
    assert verify_step_dir(step_dir).status == "verified"
    assert sorted(os.listdir(os.path.join(step_dir, "state"))) == [
        "opt_state.rank00000.pt", "params.rank00000.pt"]
    # a dp 1 run without checkpoint.elastic names the re-stamp back
    raw = dict(store["raw"], checkpoint={"save_dir": port})
    cfg = tcfg.config_from_dict(raw)
    state = build_state(cfg, torch.device("cpu"))[0]
    with pytest.raises(RuntimeError, match=r"elastic_resize .* --dp 1"):
        CheckpointManager(cfg).restore(state)
    assert elastic_resize.main([port, "--dp", "1"]) == 0
    restored, _ = CheckpointManager(cfg).restore(state)
    assert all(torch.equal(p, q) for p, q in zip(
        restored.model.parameters(),
        store["result"]["state"].model.parameters()))


# -- chaos ------------------------------------------------------------------


def test_chaos_lists_and_refuses_what_the_port_lacks(capsys):
    from picotron_tpu_torch.tools import chaos

    assert chaos.main(["--list"]) == 0
    out = capsys.readouterr().out
    # nothing is refused now: slice_lost runs (tests/test_torch_chaos.py)
    assert chaos.REFUSED == {}
    for name in ("serve_engine_dead", "serve_overload", "slice_lost"):
        line = next(ln for ln in out.splitlines() if ln.startswith(name))
        assert "refused" not in line and name in chaos.CUSTOM_SCENARIOS
    jaxs = jax_tool("chaos")
    assert (set(chaos.SCENARIOS) | set(chaos.CUSTOM_SCENARIOS)
            | set(chaos.REFUSED)) == (set(jaxs.SCENARIOS)
                                      | set(jaxs.CUSTOM_SCENARIOS))
    assert {n: s.chaos for n, s in chaos.SCENARIOS.items()} == {
        n: s.chaos for n, s in jaxs.SCENARIOS.items()}
    # a multi-rank scenario on a machine with fewer cards: refused, naming
    # the CPU run
    if not torch.cuda.is_available():
        assert chaos.main(["--scenario", "slice_lost"]) == 2
        assert "--device cpu" in capsys.readouterr().err


def test_chaos_nan_skip_recovers(tmp_path, capsys):
    from picotron_tpu_torch.tools import chaos

    assert chaos.main(["--scenario", "nan_skip", "--device", "cpu",
                       "--workdir", str(tmp_path)]) == 0
    assert "nan_skip: OK" in capsys.readouterr().out


@pytest.mark.slow
@pytest.mark.parametrize("name", ["sigterm", "ckpt_io", "nan_rollback",
                                  "data_stall", "ckpt_corrupt_bitflip",
                                  "dp_resize", "pp_resize", "mpmd_sigterm"])
def test_chaos_scenario_recovers(tmp_path, name, capsys):
    from picotron_tpu_torch.tools import chaos

    assert chaos.main(["--scenario", name, "--device", "cpu",
                       "--workdir", str(tmp_path)]) == 0
    assert f"{name}: OK" in capsys.readouterr().out
