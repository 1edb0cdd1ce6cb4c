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
- `submit_jobs` (tests/test_tools.py's cases): the status.txt machine
  with the port's OOM and time-out greps, the slurm render (one torchrun
  per node), the dry run, the squeue watcher, and the local launcher
  running a dp 2 debug-tiny job under torchrun on the CPU; `data_bench`
  on a small table, and its refusal without `datasets`.
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


# -- submit_jobs and data_bench (tests/test_tools.py's cases) ---------------


def _run_dir(root, name="run_a", dist=None):
    d = root / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"distributed": dist or {}}))
    return d


def test_job_status_machine(tmp_path):
    from picotron_tpu_torch.tools import submit_jobs as sj

    run = _run_dir(tmp_path)
    jobs = sj.discover_jobs(str(tmp_path))
    assert len(jobs) == 1
    job = jobs[0]
    assert job.status == "init"
    job.set_status("running")
    assert job.status == "running"
    # the post-mortem greps (the reference picotron's): torch's OOM and an
    # illegal memory access are oom; a store or collective time-out is
    # timeout
    for text, want in (
            ("torch.OutOfMemoryError: CUDA out of memory. Tried to "
             "allocate 2.00 GiB", "oom"),
            ("RuntimeError: CUDA error: an illegal memory access was "
             "encountered", "oom"),
            ("torch.distributed.DistStoreError: Timed out after 901 "
             "seconds", "timeout"),
            ("some other crash", "fail")):
        (run / "train.log").write_text(f"... {text} ...")
        assert job.classify(returncode=1) == want, text
    assert job.classify(returncode=0) == "completed"


def test_slurm_render_golden(tmp_path):
    """The sbatch render: the #SBATCH directives, one torchrun per node
    over world / nodes GPUs, the status.txt transitions and greps built
    from the pattern constants the local launcher classifies with."""
    from picotron_tpu_torch.tools import submit_jobs as sj

    run = _run_dir(tmp_path, "llama-dp8", {"dp_size": 4, "tp_size": 2})
    job = sj.discover_jobs(str(tmp_path))[0]
    script = sj.render_slurm(job, nodes=2, time_limit="03:30:00")
    assert script == str(run / "job.slurm")
    text = open(script).read()
    assert text == sj.SLURM_TEMPLATE.format(
        name="llama-dp8", nodes=2, gpus=4, run_dir=str(run),
        time_limit="03:30:00", repo_root=sj.REPO_ROOT,
        oom_re="|".join(sj.OOM_PATTERNS),
        timeout_re="|".join(sj.TIMEOUT_PATTERNS))
    for line in ("#SBATCH --job-name=llama-dp8", "#SBATCH --nodes=2",
                 "#SBATCH --gpus-per-node=4", "#SBATCH --time=03:30:00",
                 "srun --ntasks-per-node=1 python -m torch.distributed.run",
                 "--nnodes 2 --nproc_per_node 4",
                 f"-m picotron_tpu_torch.train --config {run}/config.json"):
        assert line in text, line
    for state in ("running", "completed", "oom", "timeout", "fail"):
        assert f"echo {state} > " in text
    assert "OutOfMemoryError|CUDA out of memory|illegal memory access" in text
    with pytest.raises(ValueError, match="divide"):
        sj.render_slurm(job, nodes=3, time_limit="01:00:00")


def test_slurm_dry_run_renders_without_submitting(tmp_path, capsys,
                                                  monkeypatch):
    import subprocess as sp

    from picotron_tpu_torch.tools import submit_jobs as sj

    run = _run_dir(tmp_path)

    def boom(*a, **k):
        raise AssertionError("dry run must not invoke subprocess")

    monkeypatch.setattr(sp, "run", boom)
    assert sj.main([str(tmp_path), "--launcher", "slurm", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "rendered" in out and "-m picotron_tpu_torch.train" in out
    assert (run / "job.slurm").exists()
    assert (run / "status.txt").read_text().strip() == "init"


def test_watch_queue_flips_pending_to_running_and_catches_dead(tmp_path,
                                                               monkeypatch):
    import subprocess as sp

    from picotron_tpu_torch.tools import submit_jobs as sj

    for name in ("run_a", "run_b"):
        _run_dir(tmp_path, name)
    job_a, job_b = sj.discover_jobs(str(tmp_path))
    job_a.set_status("pending")
    job_b.set_status("pending")
    polls = iter(["1001 PENDING\n1002 RUNNING\n", ""])

    class R:
        def __init__(self, out):
            self.stdout, self.returncode = out, 0

    def fake_run(cmd, **kw):
        assert cmd[0] == "squeue"
        return R(next(polls))

    monkeypatch.setattr(sp, "run", fake_run)
    monkeypatch.setattr(sj.time, "sleep", lambda s: None)
    sj.watch_queue(str(tmp_path), {"run_a": "1001", "run_b": "1002"},
                   interval=0, max_polls=2)
    assert job_a.status == "fail"      # left the queue while pending
    assert job_b.status == "running"   # started; its epilogue owns the rest


def test_dry_run_requires_slurm_launcher(tmp_path):
    from picotron_tpu_torch.tools import submit_jobs as sj

    with pytest.raises(SystemExit):
        sj.main([str(tmp_path), "--dry-run"])


def test_local_launcher_runs_the_trainer_under_torchrun(tmp_path, capsys):
    """--launcher local: torchrun with one process per rank of the run's
    layout (a dp 2 job's command), and a debug-tiny run on the CPU under
    torchrun (one rank) completes, its status and log say so, and --only
    completed finds it."""
    from picotron_tpu_torch.tools import submit_jobs as sj

    for name, dp in (("dp2", 2), ("dp1", 1)):
        run = tmp_path / name / "run"
        run.mkdir(parents=True)
        raw = _raw(tmp_path / "ckpt", steps=2, distributed={"dp_size": dp})
        (run / "config.json").write_text(json.dumps(raw))
        job = sj.discover_jobs(str(tmp_path / name))[0]
        assert sj.local_command(job)[1:6] == [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(dp)]
    assert sj.main([str(tmp_path / "dp1"), "--job-timeout", "240"]) == 0
    assert job.status == "completed", (run / "train.log").read_text()[-2000:]
    assert "training done" in (run / "train.log").read_text()
    capsys.readouterr()
    sj.main([str(tmp_path / "dp1"), "--status"])
    assert "completed:1" in capsys.readouterr().out


def test_data_bench_runs_and_names_a_missing_datasets(capsys, monkeypatch):
    from picotron_tpu_torch.tools import data_bench

    assert data_bench.main(["--blocks", "128", "--seq", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["epoch_view_s"] >= 0
    for key in ("read_lazy_tok_s", "read_flat_tok_s", "read_seq_tok_s",
                "preproc_tok_s"):
        assert out[key] > 0, key
    assert out["vs_card_margin"] == round(out["read_lazy_tok_s"]
                                          / data_bench.CARD_TOKENS_PER_S, 1)
    monkeypatch.setitem(sys.modules, "datasets", None)
    assert data_bench.main(["--blocks", "8", "--seq", "8"]) == 2
    assert "datasets" in capsys.readouterr().err
