"""The port's chaos harness against the JAX package's
(picotron_tpu/resilience/chaos.py), and the port's trainer under each
chaos kind the JAX trainer fires against the JAX trainer, on the CPU.

- Grammar: `parse_spec` gives equal events, and equal error messages, on
  a corpus of good and bad specs; `describe` and the PICOTRON_CHAOS
  override agree.
- Controller: the same spec driven through one call sequence of
  `fire` / `poison_step` (signals and sleeps recorded, not delivered)
  decides alike at every call.
- Trainer: debug-tiny at fp32 (seq 16, mbs 2, ga 2, 4 steps) under
  sigterm@2, nan_grad@2 (abort, skip, rollback), data_io@2x2 with
  ckpt_io@2x1 and ckpt_corrupt_bitflip@4 in one run with a restart, and, in child
  processes, hang (77) and kill (SIGKILL), each through both trainers:
  equal exit codes and equal sequences of telemetry event kinds
  (timings excluded). Two differences are normalized, each named where it
  is applied: the JAX stream's `compile` and `recompile` events (XLA
  compiles, the poisoned step twin's at its first use among them; the
  port on the CPU builds nothing), and the JAX restart's second `ckpt_corrupt`
  for the same step (its restore re-verifies the lineage that its probe
  just verified; the port loads the step its probe verified). Without
  chaos the stream has the JAX stream's kinds and keys, and the losses
  are unchanged by telemetry, tracing and prefetch (1e-5, and equal to
  the JAX trainer's at 1e-5).

The JAX runs are in process, each shared through a module-scoped
fixture, except the kinds that end the process, which run in a child
for both trainers. The tick kinds (`#TICK`) run in the port's pp world
of tests/test_torch_pipeline.py; their controller decisions are held
to the JAX controller's here.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from picotron_tpu.resilience import chaos as jchaos
from picotron_tpu_torch.resilience import chaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GOOD = ["", "sigterm@3", "sigterm@3, ckpt_io@2x2,data_stall@4~1.5",
        "sigterm@3#2,hang@4~120#1,kill@5", "nan_grad@4x2",
        "ckpt_corrupt_bitflip@4,kill@5", "ckpt_truncate@2,ckpt_torn_meta@6",
        "engine_dead@4,decode_hang@2~5,shed_storm@6x3", "slice_lost@7",
        "data_io@2x2", "sigint@1#0", "hang@2~0.25"]
BAD = ["sigterm", "bogus@3", "hang@3", "data_stall@2", "decode_hang@1",
       "ckpt_io@2#1", "nan_grad@2#3", "sigterm@x", "sigterm@3x", "@3",
       "Sigterm@3", "sigterm@3~", "kill@-1"]


def _fields(events):
    return [(e.kind, e.step, e.count, e.secs, e.tick) for e in events]


@pytest.mark.parametrize("spec", GOOD)
def test_parse_spec_matches_jax(spec):
    got, want = chaos.parse_spec(spec), jchaos.parse_spec(spec)
    assert _fields(got) == _fields(want)
    assert chaos.ChaosController(got).describe() == \
        jchaos.ChaosController(want).describe()
    assert chaos.KINDS == jchaos.KINDS


@pytest.mark.parametrize("spec", BAD)
def test_parse_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jchaos.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        chaos.parse_spec(spec)
    assert str(got.value) == str(want.value)


def test_config_load_reports_chaos_errors_as_jax_does():
    from picotron_tpu import config as jcfg
    from picotron_tpu_torch import config as tcfg

    for spec in BAD:
        raw = {"resilience": {"chaos": spec}}
        with pytest.raises(ValueError) as want:
            jcfg.config_from_dict(raw)
        with pytest.raises(ValueError) as got:
            tcfg.config_from_dict(raw)
        assert str(got.value) == str(want.value)


# the call sequence both controllers are driven through: (point, step,
# ctx) for fire, ("poison", step) for poison_step
CALLS = ([("step_begin", s, {}) for s in range(1, 6)]
         + [("data_produce", 2, {}), ("data_produce", 2, {}),
            ("data_produce", 2, {}), ("data_produce", 3, {})]
         + [("ckpt_save", 2, {}), ("ckpt_save", 2, {}), ("ckpt_save", 4, {})]
         + [("schedule_tick", 3, {"tick": t, "stage": t % 2, "op": "F",
                                  "mb": t // 2}) for t in range(4)]
         + [("poison", s) for s in (1, 2, 4, 4, 5, 6, 4)]
         + [("serve_route", r, {"engine": r % 2}) for r in range(1, 9)]
         + [("serve_dispatch", 2, {"engine": 0}),
            ("serve_dispatch", 4, {"engine": 1})])
SPECS = ["sigterm@3", "sigterm@3#2,hang@2~0.5#1,kill@5", "ckpt_io@2x2",
         "data_io@2x2,data_stall@3~0.25", "nan_grad@4x2", "hang@4~2",
         "shed_storm@6x3,engine_dead@3", "decode_hang@2~1,engine_dead@4",
         "slice_lost@2", "sigint@1,ckpt_io@4"]


def _drive(mod, spec, monkeypatch):
    """Each call's decision under `spec`: the signal delivered, the sleep
    taken, the exception raised, or the poison decision."""
    acts = []
    monkeypatch.setattr(mod.os, "kill",
                        lambda pid, sig: acts.append(("kill", int(sig))))
    monkeypatch.setattr(mod.time, "sleep",
                        lambda s: acts.append(("sleep", s)))
    ctrl = mod.ChaosController(mod.parse_spec(spec))
    out = []
    for call in CALLS:
        acts.clear()
        if call[0] == "poison":
            out.append(("poison", ctrl.poison_step(call[1])))
            continue
        point, step, ctx = call
        try:
            ctrl.fire(point, step, **ctx)
            out.append((point, step, list(acts)))
        except Exception as e:  # noqa: BLE001 — the decision itself
            out.append((point, step, list(acts), type(e).__name__, str(e)))
    return out, ctrl.has_tick_events(), ctrl.has_nan_grad(), ctrl.active


@pytest.mark.parametrize("spec", SPECS)
def test_controller_decisions_match_jax(spec, monkeypatch):
    assert _drive(chaos, spec, monkeypatch) == \
        _drive(jchaos, spec, monkeypatch)


def test_install_honours_picotron_chaos_even_when_empty(monkeypatch):
    monkeypatch.setenv("PICOTRON_CHAOS", "")
    try:
        assert not chaos.install("sigterm@3").active
        monkeypatch.setenv("PICOTRON_CHAOS", "ckpt_io@2x2")
        assert chaos.install("").describe() == "ckpt_io@2x2"
        assert chaos.controller().describe() == \
            jchaos.install("").describe()
        monkeypatch.delenv("PICOTRON_CHAOS")
        assert chaos.install("nan_grad@4").has_nan_grad()
    finally:
        monkeypatch.delenv("PICOTRON_CHAOS", raising=False)
        chaos.install("")
        jchaos.install("")
    chaos.uninstall()
    assert not chaos.controller().active


# -- the trainers -----------------------------------------------------------


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """One HF safetensors init both trainers start from (their own inits
    draw from different generators)."""
    import jax

    from picotron_tpu import checkpoint as jckpt
    from picotron_tpu import config as jcfg
    from picotron_tpu.models import llama as jllama

    path = str(tmp_path_factory.mktemp("hf"))
    cfg = jcfg.config_from_dict({"model": {"name": "debug-tiny"}})
    jckpt.save_hf_safetensors(
        jax.tree.map(np.asarray,
                     jllama.init_params(cfg.model, jax.random.key(11))), path)
    return path


def _raw(save_dir, hf, steps=4, **sections):
    raw = {"model": {"name": "debug-tiny", "dtype": "float32"},
           "training": dict(seq_length=16, micro_batch_size=2,
                            gradient_accumulation_steps=2,
                            total_train_steps=steps, lr_warmup_steps=1,
                            learning_rate=1e-3, remat=False),
           "distributed": {"use_cpu": True},
           "checkpoint": {"save_dir": str(save_dir), "async_save": False,
                          "init_from_hf": hf},
           "resilience": {"retry_base_delay": 0.01, "retry_max_delay": 0.02},
           "logging": {"log_frequency": 1}}
    for section, vals in sections.items():
        raw.setdefault(section, {}).update(vals)
    return raw


def _events(save_dir):
    path = os.path.join(save_dir, "telemetry.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _jax_run(raw, path, env=None):
    """One JAX trainer run in process: its exit code (0 when it returns)."""
    from picotron_tpu import train as jtrain

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(raw, f)
    saved = {k: os.environ.get(k) for k in ("PICOTRON_CHAOS",
                                            "PICOTRON_PREFLIGHT")}
    os.environ["PICOTRON_PREFLIGHT"] = "0"
    os.environ.pop("PICOTRON_CHAOS", None)
    os.environ.update(env or {})
    try:
        jtrain.main(["--config", path])
        return 0
    except SystemExit as e:
        return e.code
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jchaos.install("")  # the JAX trainer leaves its controller


def _port_run(raw, env=None):
    """One run of the port's trainer in process: (exit code, result)."""
    from picotron_tpu_torch import config as tcfg
    from picotron_tpu_torch import train as ttrain

    saved = os.environ.get("PICOTRON_CHAOS")
    os.environ.pop("PICOTRON_CHAOS", None)
    os.environ.update(env or {})
    try:
        return 0, ttrain.run(tcfg.config_from_dict(raw), "cpu")
    except SystemExit as e:
        return e.code, None
    finally:
        if saved is None:
            os.environ.pop("PICOTRON_CHAOS", None)
        else:
            os.environ["PICOTRON_CHAOS"] = saved


def _kinds(events):
    """The stream's kinds, timings excluded; the JAX stream's `compile`
    and `recompile` events dropped (XLA compiles: the port's CPU run
    builds nothing), and
    a `ckpt_corrupt` repeated for the step just reported kept once (the
    JAX restore re-verifies what its probe verified)."""
    out, last = [], None
    for e in events:
        if e["kind"] in ("compile", "recompile"):
            continue
        key = (e["kind"], e.get("step")) if e["kind"] == "ckpt_corrupt" \
            else None
        if key is not None and key == last:
            continue
        last = key
        out.append(e["kind"] if e["kind"] != "phase"
                   else f"phase:{e['phase']}")
    return out


SCENARIOS = {
    # name: ([(sections, env) per run], exit codes)
    "sigterm": ([({"resilience": {"chaos": "sigterm@2"}}, None)], [75]),
    "nan_abort": ([({"resilience": {"chaos": "nan_grad@2"}}, None)], [76]),
    "nan_skip": ([({"resilience": {"chaos": "nan_grad@2",
                                   "guard_policy": "skip"}}, None)], [0]),
    "nan_rollback": ([({"resilience": {"chaos": "nan_grad@2",
                                       "guard_policy": "rollback"},
                        "checkpoint": {"save_frequency": 1}}, None)], [0]),
    # the two retried I/O kinds and a corruption in one run, then a
    # restart: the batch-2 assembly fails twice, the step-2 save once, the
    # step-4 commit is corrupted; the restart (PICOTRON_CHAOS="", as a
    # supervisor restarts) falls back to step 2
    "io_bitflip": ([({"resilience": {"chaos": "data_io@2x2,ckpt_io@2x1,"
                                              "ckpt_corrupt_bitflip@4"},
                      "checkpoint": {"save_frequency": 2}}, None),
                    ({"resilience": {"chaos": "ckpt_corrupt_bitflip@4"},
                      "checkpoint": {"save_frequency": 2,
                                     "auto_resume": True}},
                     {"PICOTRON_CHAOS": ""})], [0, 0]),
}

# the test's cases, each reading one scenario: "io" (the retries) and
# "bitflip" (the corruption and the fallback) share a run
CASES = {**{name: name for name in SCENARIOS if name != "io_bitflip"},
         "io": "io_bitflip", "bitflip": "io_bitflip"}


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory, hf):
    """Every scenario through both trainers: {name: {"jax"|"port":
    (exit codes, the stream's events, the last run's result)}}."""
    out = {}
    for name, (runs, _) in SCENARIOS.items():
        out[name] = {}
        for side in ("jax", "port"):
            base = tmp_path_factory.mktemp(f"{name}_{side}")
            codes, result = [], None
            for i, (sections, env) in enumerate(runs):
                raw = _raw(base / "ckpt", hf, **sections)
                if side == "jax":
                    codes.append(_jax_run(raw, str(base / f"cfg{i}.json"),
                                          env))
                else:
                    code, result = _port_run(raw, env)
                    codes.append(code)
            out[name][side] = (codes, _events(base / "ckpt"), result,
                               str(base / "ckpt"))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_chaos_matches_jax(scenarios, name):
    run = CASES[name]
    (jcodes, jev, _, _), (codes, ev, _, save_dir) = (
        scenarios[run]["jax"], scenarios[run]["port"])
    assert codes == jcodes == SCENARIOS[run][1]
    assert _kinds(ev) == _kinds(jev)
    assert ev[-1]["kind"] == "run_summary"
    kinds = [e["kind"] for e in ev]
    fired = [e for e in ev if e["kind"] == "chaos"]
    assert fired, kinds
    if name == "io":
        points = [e["point"] for e in fired]
        assert points == ["data_produce"] * 2 + ["ckpt_save",
                                                 "ckpt_committed"]
        assert kinds.count("retry") == 3
    if name == "bitflip":
        corrupt = [e for e in ev if e["kind"] == "ckpt_corrupt"]
        assert corrupt and all(e["step"] == 4 for e in corrupt)
        summary = [e for e in ev if e["kind"] == "run_summary"][-1]
        assert summary["goodput"]["high_water_step"] == 4
    if name in ("sigterm", "nan_abort", "nan_rollback"):
        with open(os.path.join(save_dir,
                               "flightdeck_postmortem.json")) as f:
            pm = json.load(f)
        assert pm["reason"] == {"sigterm": "preempted",
                                "nan_abort": "divergence_abort",
                                "nan_rollback": "rollback"}[name]
        assert pm["step"] == 2


def test_poisoned_step_takes_the_nonfinite_path(scenarios):
    """nan_grad@2 under "skip": step 2's loss is NaN and its update is
    suppressed (the AdamW `ok` flag), so the run goes on from step 1's
    state; the guard reports the in-step flag, as in the JAX run."""
    _, ev, result, _ = scenarios["nan_skip"]["port"]
    losses = result["losses"]
    assert np.isnan(losses[1]) and np.isfinite(losses[2:]).all()
    guard = [e for e in ev if e["kind"] == "guard"]
    assert [(g["step"], g["action"]) for g in guard] == [(2, "skip")]
    _, jev, _, _ = scenarios["nan_skip"]["jax"]
    jguard = [e for e in jev if e["kind"] == "guard"]
    assert [g["why"] for g in guard] == [g["why"] for g in jguard]
    # skip leaves the optimizer where step 1 left it: the steps after
    # the poison train on as a run whose step 2 never happened would
    jloss = [e["loss"] for e in jev if e["kind"] == "step"]
    np.testing.assert_allclose(np.array(losses)[[0, 2, 3]],
                               np.array(jloss)[[0, 2, 3]], rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def clean(tmp_path_factory, hf):
    """Both trainers without chaos, the port's also with telemetry off,
    and with tracing, the sentinel and prefetch on."""
    base = tmp_path_factory.mktemp("clean")
    out = {"jax": _jax_run(_raw(base / "jax", hf), str(base / "jax.json"))}
    out["jax_events"] = _events(base / "jax")
    out["port"] = _port_run(_raw(base / "port", hf))[1]
    out["port_events"] = _events(base / "port")
    out["off"] = _port_run(_raw(base / "off", hf, logging={
        "telemetry_jsonl": False, "flight_steps": 0}))[1]
    out["traced"] = _port_run(_raw(base / "traced", hf, logging={
        "trace_dir": str(base / "trace"), "sentinel": True},
        dataset={"num_workers": 2}))[1]
    out["trace"] = str(base / "trace" / "trace.json")
    return out


def test_stream_has_the_jax_kinds_and_keys(clean):
    assert clean["jax"] == 0
    jev = [e for e in clean["jax_events"] if e["kind"] != "compile"]
    ev = clean["port_events"]
    assert _kinds(ev) == _kinds(jev)
    for got, want in zip(ev, jev):
        assert sorted(got) == sorted(want), (got, want)
    assert sorted(ev[-1]["goodput"]) == sorted(jev[-1]["goodput"])
    by_cat = "seconds_by_category"
    assert sorted(ev[-1]["goodput"][by_cat]) \
        == sorted(c for c in jev[-1]["goodput"][by_cat] if c != "compile")


def test_losses_unchanged_by_telemetry_tracing_and_prefetch(clean):
    base = clean["port"]["losses"]
    for key in ("off", "traced"):
        np.testing.assert_allclose(clean[key]["losses"], base, rtol=1e-5,
                                   atol=1e-5)
    jloss = [e["loss"] for e in clean["jax_events"] if e["kind"] == "step"]
    np.testing.assert_allclose(base, jloss, rtol=1e-5, atol=1e-5)
    with open(clean["trace"]) as f:
        doc = json.load(f)
    steps = [e["args"]["step"] for e in doc["traceEvents"]
             if e.get("name") == "step" and e.get("ph") == "X"]
    assert steps == [1, 2, 3, 4]


def _child(side, tmp, hf, spec, watchdog):
    """`spec` under a `watchdog` s watchdog (0: none) in a child process
    of either trainer, started: (the process, its save dir)."""
    raw = _raw(tmp / "ckpt", hf, resilience={"chaos": spec,
                                             "watchdog_timeout": watchdog})
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps(raw))
    env = {k: v for k, v in os.environ.items() if k != "PICOTRON_CHAOS"}
    env.update(PYTHONPATH=ROOT, PICOTRON_PREFLIGHT="0", JAX_PLATFORMS="cpu")
    if side == "jax":
        code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
                "from picotron_tpu import train; "
                f"train.main(['--config', {str(cfg)!r}])")
    else:
        code = ("from picotron_tpu_torch import train; "
                f"train.main(['--config', {str(cfg)!r}, '--device', 'cpu'])")
    return (subprocess.Popen([sys.executable, "-c", code], env=env,
                             cwd=ROOT, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL),
            tmp / "ckpt")


# kinds that end the process: (spec, exit code, the watchdog's phase and
# booked category, or None for a SIGKILL, which runs without a watchdog).
# The watchdog's 10 s is far above a step of this model, even with every
# child started at once on a loaded host.
ENDING = {"hang": ("hang@3~120", 77, ("sync", "other")),
          "kill": ("kill@3", -9, None)}


@pytest.fixture(scope="module")
def ending(tmp_path_factory, hf):
    """Every ENDING kind through both trainers, the children all started
    at once: {name: {side: (exit code, events, postmortem or None)}}."""
    procs = {}
    for name, (spec, _, watched) in ENDING.items():
        for side in ("jax", "port"):
            procs[name, side] = _child(
                side, tmp_path_factory.mktemp(f"{name}_{side}"), hf, spec,
                10.0 if watched else 0.0)
    out = {}
    try:
        for (name, side), (proc, save_dir) in procs.items():
            code = proc.wait(timeout=240)
            pm = save_dir / "flightdeck_postmortem.json"
            out.setdefault(name, {})[side] = (
                code, _events(save_dir),
                json.loads(pm.read_text()) if pm.exists() else None)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("name", list(ENDING))
def test_process_ending_kinds_match_jax(ending, name):
    """hang under a watchdog exits 77 with a watchdog postmortem and the
    hung phase's category; kill ends the process by SIGKILL, leaving no
    postmortem and no run_summary."""
    _, want_code, watched = ENDING[name]
    (jcode, jev, jpm), (code, ev, pm) = (ending[name]["jax"],
                                         ending[name]["port"])
    assert code == jcode == want_code
    assert _kinds(ev) == _kinds(jev)
    if watched is None:
        assert pm is None and jpm is None
        assert ev[-1]["kind"] == "chaos"
        return
    last = ev[-1]
    assert last["kind"] == "watchdog_timeout"
    assert (last["phase"], last["category"]) == watched == (
        jev[-1]["phase"], jev[-1]["category"])
    assert (pm["reason"], pm["step"]) == (jpm["reason"], jpm["step"]) \
        == ("watchdog", 2)
