"""Does the port's trainer survive the failure you fear? Scenario runs
(the port's copy of tools/chaos.py).

Each named scenario runs a short training job under a chaos spec
(`resilience/chaos.py`) as child processes of `python -m
picotron_tpu_torch.train`, plays the external supervisor (restarts on
the resilience exit codes with the fault disabled, `PICOTRON_CHAOS=""`,
as a resubmission does not re-live a preemption), and verifies recovery:
exit 0 within the restart budget, the mechanism's marker in the log, and
the final checkpoint's step and trained_tokens equal to a fault-free
baseline run of the same config; the resize scenarios also hold the
per-step loss trajectory to the baseline at the JAX tool's rtol 1e-3,
atol 1e-4 and require the `resize` goodput booking.

Scenarios (`--list`):

  sigterm, ckpt_io, nan_skip, nan_rollback, data_stall,
  ckpt_corrupt_bitflip (ckpt_doctor must flag exactly the injected step),
  dp_resize   dp 2 killed, re-stamped to dp 1 offline
              (`tools.elastic_resize`), killed again, finished at dp 4
              via checkpoint.elastic
  pp_resize   pp 2 mpmd killed, re-stamped to pp 1, killed again,
              finished at pp 2 mpmd via checkpoint.elastic (the JAX
              tool's compile-once prover has no counterpart: the port
              compiles nothing per stage)
  mpmd_sigterm  SIGTERM at a named (stage, tick, op) of a pp 2 mpmd walk
              drains to the step boundary (exit 75, no replayed step); a
              forced mid-schedule hang is named by the watchdog (77)
  slice_lost  dp 2 x tp 2 x slices 2 (dcn_axes dp: the hierarchical dp
              reduction live) loses a slice at step 3 (SIGKILL, the
              slice named in the log), is re-stamped with --slices 1
              offline, and finishes at dp 1 via checkpoint.elastic

Serving scenarios run `python -m picotron_tpu_torch.tools.serve_bench
--fleet N` legs as child processes at the JAX tool's tiny shape
(debug-tiny, prompt 16, 8 new tokens, 3 slots, block 4, chunk 4,
temperature 0.7, seed 7; one card or the CPU):

  serve_engine_dead  a replica of 2 killed mid-burst (engine_dead@2):
              every request finishes with token digests equal to a fleet
              of 1's, 0 leaked blocks, a serve_engine_dead postmortem,
              the same digests on a repeat
  serve_overload  a 10-request burst into 1 slot under a 6 ms deadline:
              the shed set non-empty and the same on a repeat, admitted
              digests equal to the no-deadline leg's, queue wait within
              the deadline, shed seconds booked and rendered

The scenario layout is the JAX tool's dp 2 x tp 2 on four ranks: four
gloo processes with `--device cpu`; with `--device cuda` (the default)
four NCCL ranks when the machine has four cards, else one rank (dp 1,
tp 1, mbs 2 x ga 2: the same global batch), one attention head of 64
(the flash kernels take head_dim 64 or 128). The ranks are launched as
processes with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR/PORT on localhost), so each rank's own exit code reaches the
supervisor. The dp/pp resize, slice_lost and mpmd scenarios need 2 to 8
ranks and run on the CPU (or on a machine with that many cards).

    python -m picotron_tpu_torch.tools.chaos --list
    python -m picotron_tpu_torch.tools.chaos --scenario nan_skip \
        --device cpu
    python -m picotron_tpu_torch.tools.chaos --all --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Optional

from picotron_tpu_torch.resilience.preemption import EXIT_PREEMPTED
from picotron_tpu_torch.resilience.watchdog import EXIT_WATCHDOG

STEPS = 6  # total_train_steps of every scenario (the fault lands mid-run)
LOSS_TOL = dict(rtol=1e-3, atol=1e-4)  # the JAX tool's loss parity
RUN_TIMEOUT_S = 600

# scenarios the port refuses, each naming its ROADMAP item: none now
REFUSED: dict = {}


@dataclass
class Scenario:
    chaos: str                      # resilience.chaos spec of the first run
    marker: str                     # log regex proving the mechanism engaged
    note: str
    expect_exits: tuple = ()        # nonzero exits the supervisor restarts on
    max_restarts: int = 0
    overrides: dict = field(default_factory=dict)
    # over save_dir right after the FIRST exit (before a restart repairs
    # anything): an error string or None
    check_after_fault: Optional[Callable] = None


def _postmortem_matches(save_dir: str, reason: str, fault_step: int):
    """The flight recorder's postmortem next to the checkpoints must name
    the injected fault's reason and step."""
    path = os.path.join(save_dir, "flightdeck_postmortem.json")
    if not os.path.exists(path):
        return f"no flightdeck_postmortem.json under {save_dir}"
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable postmortem {path}: {e}"
    if doc.get("reason") != reason:
        return (f"postmortem reason {doc.get('reason')!r} != expected "
                f"{reason!r}")
    if doc.get("step") != fault_step:
        return (f"postmortem last recorded step {doc.get('step')!r} != "
                f"fault step {fault_step}")
    if not doc.get("steps"):
        return "postmortem carries an empty last-K-steps window"
    return None


def _doctor_flags_exactly(save_dir: str, corrupt_step: int):
    """`tools.ckpt_doctor` over the faulted store flags exactly the
    injected step and passes another."""
    from picotron_tpu_torch.tools import ckpt_doctor

    rows = ckpt_doctor.scan(save_dir)
    bad = [r["step"] for r in rows if r["verdict"] == "corrupt"]
    good = [r["step"] for r in rows
            if r["verdict"] in ("verified", "legacy")]
    if bad != [corrupt_step]:
        return (f"ckpt_doctor flagged corrupt steps {bad}, expected "
                f"exactly [{corrupt_step}] (rows: {rows})")
    if not good:
        return "ckpt_doctor found no restorable step besides the corrupt one"
    return None


SCENARIOS: dict[str, Scenario] = {
    "sigterm": Scenario(
        chaos=f"sigterm@{STEPS // 2}",
        expect_exits=(EXIT_PREEMPTED,), max_restarts=2,
        marker=r"emergency checkpoint ->",
        note="preemption mid-run: finish step, emergency ckpt, exit "
             f"{EXIT_PREEMPTED}, auto_resume",
        check_after_fault=lambda d: _postmortem_matches(
            d, reason="preempted", fault_step=STEPS // 2)),
    "ckpt_io": Scenario(
        chaos="ckpt_io@2x2",
        marker=r"\[retry\] checkpoint save",
        note="transient checkpoint-write I/O errors absorbed by "
             "retry-with-backoff"),
    "nan_skip": Scenario(
        chaos=f"nan_grad@{STEPS // 2}",
        overrides={"resilience": {"guard_policy": "skip"}},
        marker=r"batch skipped",
        note="NaN gradients dropped in-step (optimizer state preserved), "
             "run continues"),
    "nan_rollback": Scenario(
        chaos=f"nan_grad@{STEPS - 2}",
        overrides={"resilience": {"guard_policy": "rollback"}},
        marker=r"rolled back to step",
        note="NaN gradients: restore last durable ckpt, skip the poison "
             "data range, re-train",
        check_after_fault=lambda d: _postmortem_matches(
            d, reason="rollback", fault_step=STEPS - 2)),
    "data_stall": Scenario(
        chaos=f"data_stall@{STEPS // 2}~120",
        expect_exits=(EXIT_WATCHDOG,), max_restarts=2,
        overrides={"dataset": {"num_workers": 2},
                   "resilience": {"watchdog_timeout": 5.0}},
        marker=r"\[watchdog\] no progress",
        note="stalled data producer: watchdog stack-dump + exit "
             f"{EXIT_WATCHDOG}, supervisor restart, auto_resume",
        check_after_fault=lambda d: _postmortem_matches(
            d, reason="watchdog", fault_step=STEPS // 2)),
    "ckpt_corrupt_bitflip": Scenario(
        # the step-4 save commits, a byte of its largest payload flips on
        # disk, SIGKILL at step 5: the restart must verify, fall back to
        # the step-2 save and re-train to the baseline's final step
        chaos=f"ckpt_corrupt_bitflip@{STEPS - 2},kill@{STEPS - 1}",
        expect_exits=(-signal.SIGKILL,), max_restarts=2,
        overrides={"checkpoint": {"async_save": False}},
        marker=r"failed verification",
        note="newest committed checkpoint bit-flipped, then SIGKILL: "
             "restart verifies, falls back to the prior verified step, "
             "re-trains to the baseline's final step",
        check_after_fault=lambda d: _doctor_flags_exactly(
            d, corrupt_step=STEPS - 2)),
}


# ---------------------------------------------------------------------------
# the layout, the config and the trainer's child processes
# ---------------------------------------------------------------------------


def scenario_world(device: str) -> int:
    """Ranks of the scenario layout: 4 (dp 2 x tp 2) on the CPU or on a
    machine with four cards, else 1."""
    if device == "cpu":
        return 4
    import torch

    return 4 if torch.cuda.device_count() >= 4 else 1


def scenario_config(workdir: str, chaos_spec: str, overrides: dict,
                    device: str = "cpu") -> dict:
    world = scenario_world(device)
    dist = ({"dp_size": 2, "tp_size": 2} if world == 4
            else {"dp_size": 1, "tp_size": 1})
    model = {"name": "debug-tiny", "dtype": "float32"}
    if device != "cpu":
        # the flash kernels take head_dim 64 or 128
        model.update(num_attention_heads=1, num_key_value_heads=1)
    cfg = {
        "distributed": {**dist, "use_cpu": device == "cpu"},
        "model": model,
        "training": {"total_train_steps": STEPS, "seq_length": 32,
                     "micro_batch_size": 2,
                     "gradient_accumulation_steps": 1 if world == 4 else 2,
                     "remat": False, "seed": 5},
        "dataset": {"name": "synthetic", "num_workers": 0},
        "checkpoint": {"save_dir": os.path.join(workdir, "ckpt"),
                       "save_frequency": 2, "auto_resume": True},
        "logging": {"log_frequency": 1},
        "resilience": {"chaos": chaos_spec,
                       "retry_base_delay": 0.05, "retry_max_delay": 0.2},
    }
    for section, vals in overrides.items():
        cfg.setdefault(section, {}).update(vals)
    return cfg


def world_of(cfg: dict) -> int:
    d = cfg["distributed"]
    n = 1
    for ax in ("dp", "pp", "ep", "cp", "tp"):
        n *= int(d.get(f"{ax}_size", 1))
    return n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_trainer(cfg_path: str, log_path: str, extra_env: dict,
                 device: str = "cpu") -> int:
    """The trainer on `cfg_path` as one process per rank (torchrun's
    environment when the layout has more than one), their output appended
    to `log_path`; the exit code: 0 when every rank exits 0, else the
    first rank's nonzero code (a SIGKILL is -9)."""
    with open(cfg_path) as f:
        world = world_of(json.load(f))
    env = dict(os.environ)
    env.update(extra_env)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    if device == "cpu" and world > 1:
        # one intra-op thread per rank: the ranks share the host's cores
        env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "picotron_tpu_torch.train", "--config",
           cfg_path, "--device", device]
    port = _free_port()
    procs = []
    with open(log_path, "ab") as log:
        for rank in range(world):
            renv = dict(env)
            if world > 1:
                renv.update(RANK=str(rank), WORLD_SIZE=str(world),
                            LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=renv,
                start_new_session=True))
        codes = []
        try:
            for p in procs:
                codes.append(p.wait(timeout=RUN_TIMEOUT_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
    bad = [c for c in codes if c != 0]
    return bad[0] if bad else 0


def _final_meta(save_dir: str) -> dict:
    """meta.json of the newest step dir with a committed state/."""
    steps = sorted(
        int(m.group(1)) for d in os.listdir(save_dir)
        if (m := re.fullmatch(r"step_(\d+)", d))
        and os.path.isdir(os.path.join(save_dir, d, "state")))
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {save_dir}")
    with open(os.path.join(save_dir, f"step_{steps[-1]:08d}",
                           "meta.json")) as f:
        return json.load(f)


def _step_losses(jsonl_path: str) -> dict:
    losses = {}
    with open(jsonl_path) as f:
        for line in f:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn final line of a killed leg
            if ev.get("kind") == "step" and "loss" in ev:
                losses[ev["step"]] = ev["loss"]  # last wins (replay)
    return losses


def _write(cfg: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_scenario(name: str, workdir: str, verbose: bool = False,
                 device: str = "cpu") -> bool:
    sc = SCENARIOS[name]
    fail = lambda msg: (print(f"[chaos-cli] {name}: FAIL — {msg}"),  # noqa: E731
                        False)[1]

    base_dir = os.path.join(workdir, "baseline")
    os.makedirs(base_dir, exist_ok=True)
    base_cfg = scenario_config(base_dir, "", sc.overrides, device)
    rc = _run_trainer(_write(base_cfg, os.path.join(base_dir, "config.json")),
                      os.path.join(base_dir, "run.log"), {}, device)
    if rc != 0:
        return fail(f"baseline run exited {rc}")
    base_meta = _final_meta(base_cfg["checkpoint"]["save_dir"])

    fault_dir = os.path.join(workdir, "fault")
    os.makedirs(fault_dir, exist_ok=True)
    cfg = scenario_config(fault_dir, sc.chaos, sc.overrides, device)
    cfg_path = _write(cfg, os.path.join(fault_dir, "config.json"))
    log_path = os.path.join(fault_dir, "run.log")
    exits = []
    for attempt in range(sc.max_restarts + 1):
        extra = {} if attempt == 0 else {"PICOTRON_CHAOS": ""}
        rc = _run_trainer(cfg_path, log_path, extra, device)
        exits.append(rc)
        if attempt == 0 and sc.check_after_fault is not None:
            err = sc.check_after_fault(cfg["checkpoint"]["save_dir"])
            if err:
                return fail(err)
        if rc == 0:
            break
        if rc not in sc.expect_exits:
            return fail(f"unexpected exit {rc} (allowed: 0 or "
                        f"{sc.expect_exits}); exits so far {exits}")
    if exits[-1] != 0:
        return fail(f"did not recover within {sc.max_restarts} restarts "
                    f"(exits {exits})")
    with open(log_path) as f:
        log_text = f.read()
    if verbose:
        print(log_text)
    if not re.search(sc.marker, log_text):
        return fail(f"recovery marker /{sc.marker}/ absent from {log_path}")
    meta = _final_meta(cfg["checkpoint"]["save_dir"])
    for key in ("step", "trained_tokens"):
        if meta[key] != base_meta[key]:
            return fail(f"final {key} {meta[key]} != fault-free baseline "
                        f"{base_meta[key]}")
    print(f"[chaos-cli] {name}: OK — exits {exits}, final step "
          f"{meta['step']} / {meta['trained_tokens']} tokens match "
          f"baseline")
    return True


# ---------------------------------------------------------------------------
# the elastic and mpmd scenarios
# ---------------------------------------------------------------------------


def _restamp(ckpt_dir: str, log_path: str, *flags: str) -> int:
    from picotron_tpu_torch.tools import elastic_resize

    with open(log_path, "a") as log:
        old = sys.stdout, sys.stderr
        sys.stdout = sys.stderr = log
        try:
            return elastic_resize.main([ckpt_dir, *flags])
        finally:
            sys.stdout, sys.stderr = old


def _resize_saga(name: str, workdir: str, legs: list, restamp: tuple,
                 verbose: bool, device: str) -> bool:
    """baseline (legs[0]'s layout, fault-free) -> leg 1 killed at step
    STEPS // 2 -> the offline re-stamp -> leg 2 killed at step STEPS - 1
    -> leg 3 under checkpoint.elastic to the end; the final step, tokens
    and per-step losses held to the baseline, the resize booked."""
    import numpy as np

    from picotron_tpu_torch.tools import telemetry_report

    fail = lambda msg: (print(f"[chaos-cli] {name}: FAIL — {msg}"),  # noqa: E731
                        False)[1]

    def leg(ckpt_dir, sections, chaos_spec="", elastic=False):
        cfg = scenario_config(os.path.dirname(ckpt_dir), chaos_spec,
                              {"checkpoint": {"async_save": False}}, device)
        for section, vals in sections.items():
            cfg.setdefault(section, {}).update(vals)
        cfg["checkpoint"]["save_dir"] = ckpt_dir
        if elastic:
            cfg["checkpoint"]["elastic"] = True
        return cfg

    base_dir = os.path.join(workdir, "baseline")
    os.makedirs(base_dir, exist_ok=True)
    base_ckpt = os.path.join(base_dir, "ckpt")
    rc = _run_trainer(_write(leg(base_ckpt, legs[0]),
                             os.path.join(base_dir, "config.json")),
                      os.path.join(base_dir, "run.log"), {}, device)
    if rc != 0:
        return fail(f"baseline run exited {rc}")
    base_meta = _final_meta(base_ckpt)

    fault_dir = os.path.join(workdir, "fault")
    os.makedirs(fault_dir, exist_ok=True)
    ckpt_dir = os.path.join(fault_dir, "ckpt")
    log_path = os.path.join(fault_dir, "run.log")
    rc = _run_trainer(_write(leg(ckpt_dir, legs[0], f"kill@{STEPS // 2}"),
                             os.path.join(fault_dir, "config_leg1.json")),
                      log_path, {}, device)
    if rc != -signal.SIGKILL:
        return fail(f"leg 1 exited {rc}, expected {-signal.SIGKILL}")
    resize_log = os.path.join(fault_dir, "resize.log")
    rc = _restamp(ckpt_dir, resize_log, *restamp)
    if rc != 0:
        return fail(f"elastic_resize {' '.join(restamp)} exited {rc} (see "
                    f"{resize_log})")
    rc = _run_trainer(_write(leg(ckpt_dir, legs[1], f"kill@{STEPS - 1}"),
                             os.path.join(fault_dir, "config_leg2.json")),
                      log_path, {}, device)
    if rc != -signal.SIGKILL:
        return fail(f"leg 2 exited {rc}, expected {-signal.SIGKILL}")
    rc = _run_trainer(_write(leg(ckpt_dir, legs[2], elastic=True),
                             os.path.join(fault_dir, "config_leg3.json")),
                      log_path, {}, device)
    if rc != 0:
        return fail(f"leg 3 (checkpoint.elastic) exited {rc}, expected 0")
    with open(log_path) as f:
        log_text = f.read()
    if verbose:
        print(log_text)
    if not re.search(r"elastic resize:", log_text):
        return fail("marker /elastic resize:/ absent from the leg-3 log")
    meta = _final_meta(ckpt_dir)
    for key in ("step", "trained_tokens"):
        if meta[key] != base_meta[key]:
            return fail(f"final {key} {meta[key]} != fault-free baseline "
                        f"{base_meta[key]}")
    base_losses = _step_losses(os.path.join(base_ckpt, "telemetry.jsonl"))
    fault_losses = _step_losses(os.path.join(ckpt_dir, "telemetry.jsonl"))
    if set(fault_losses) != set(base_losses):
        return fail(f"step sets differ: fault {sorted(fault_losses)} vs "
                    f"baseline {sorted(base_losses)}")
    steps = sorted(base_losses)
    bl = np.array([base_losses[s] for s in steps])
    fl = np.array([fault_losses[s] for s in steps])
    if not np.allclose(fl, bl, **LOSS_TOL):
        return fail(f"loss trajectory diverged from baseline: "
                    f"{list(zip(steps, fl.tolist(), bl.tolist()))}")
    summary = telemetry_report.summarize(telemetry_report.load_events(
        os.path.join(ckpt_dir, "telemetry.jsonl")))
    if summary["categories"].get("resize", 0.0) <= 0.0:
        return fail(f"no `resize` seconds in the goodput categories "
                    f"({summary['categories']})")
    if not summary.get("resize", {}).get("events"):
        return fail("no elastic_resize event in the telemetry stream")
    print(f"[chaos-cli] {name}: OK — {' '.join(restamp)} offline, then "
          f"checkpoint.elastic; final step {meta['step']} / "
          f"{meta['trained_tokens']} tokens and loss trajectory match "
          f"baseline; resize booked {summary['categories']['resize']:.3f}s")
    return True


def run_dp_resize(workdir: str, verbose: bool = False,
                  device: str = "cpu") -> bool:
    """dp 2 (mbs 2, ga 1) killed at step 3, re-stamped to dp 1 (mbs 2,
    ga 2), killed at step 5, finished at dp 4 (mbs 1, ga 1) under
    checkpoint.elastic: global batch 4 throughout, tp 2 as the scenario
    layout."""
    return _resize_saga("dp_resize", workdir, [
        {"distributed": {"dp_size": 2},
         "training": {"micro_batch_size": 2,
                      "gradient_accumulation_steps": 1}},
        {"distributed": {"dp_size": 1},
         "training": {"micro_batch_size": 2,
                      "gradient_accumulation_steps": 2}},
        {"distributed": {"dp_size": 4},
         "training": {"micro_batch_size": 1,
                      "gradient_accumulation_steps": 1}}],
        ("--dp", "1"), verbose, device)


def _pp(pp: int) -> dict:
    out = {"distributed": {"dp_size": 1, "tp_size": 1, "pp_size": pp},
           "training": {"micro_batch_size": 2,
                        "gradient_accumulation_steps": 2}}
    if pp > 1:
        out["pipeline"] = {"executor": "mpmd"}
    return out


def run_pp_resize(workdir: str, verbose: bool = False,
                  device: str = "cpu") -> bool:
    """pp 2 mpmd killed at step 3, re-stamped to pp 1 (the stages' layers
    re-bucketed), killed at step 5, finished at pp 2 mpmd under
    checkpoint.elastic."""
    return _resize_saga("pp_resize", workdir, [_pp(2), _pp(1), _pp(2)],
                        ("--pp", "1"), verbose, device)


def run_slice_lost(workdir: str, verbose: bool = False,
                   device: str = "cpu") -> bool:
    """Whole-slice loss on a 2-slice job (the JAX tool's scenario):

      baseline  dp 2 x tp 2, one slice, fault-free, steps 1-6
      leg 1     dp 2 x tp 2 x slices 2, dcn_axes dp (the hierarchical dp
                reduction live), slice_lost@3: SIGKILL with the slice
                named in the log; the sync save at step 2 is durable and
                records slices 2 in its manifest topology
      re-stamp  `tools.elastic_resize --slices 1` (placement only; dp
                untouched)
      leg 2     dp 1 x tp 2 (one surviving slice's ranks) under
                checkpoint.elastic: the dp 2 -> 1 change rides the runtime
                resize at constant global batch, booked as `resize`

    The final step, tokens and per-step losses are held to the baseline
    at the JAX tool's rtol 1e-3 (the hierarchical schedule reassociates
    the dp sum; nothing else differs)."""
    import numpy as np

    from picotron_tpu_torch.resilience import elastic
    from picotron_tpu_torch.tools import telemetry_report

    fail = lambda msg: (print(f"[chaos-cli] slice_lost: FAIL — {msg}"),  # noqa: E731
                        False)[1]

    def leg(ckpt_dir, *, dp, mbs, ga, slices=1, chaos_spec="",
            elastic_on=False):
        cfg = scenario_config(os.path.dirname(ckpt_dir), chaos_spec,
                              {"checkpoint": {"async_save": False}}, device)
        cfg["distributed"].update(dp_size=dp, slices=slices)
        if slices > 1:
            cfg["distributed"]["dcn_axes"] = "dp"
        cfg["training"].update(micro_batch_size=mbs,
                               gradient_accumulation_steps=ga)
        cfg["checkpoint"]["save_dir"] = ckpt_dir
        if elastic_on:
            cfg["checkpoint"]["elastic"] = True
        return cfg

    def newest_step_dir(ckpt_dir):
        meta = _final_meta(ckpt_dir)
        return os.path.join(ckpt_dir, f"step_{meta['step']:08d}")

    base_dir = os.path.join(workdir, "baseline")
    os.makedirs(base_dir, exist_ok=True)
    base_ckpt = os.path.join(base_dir, "ckpt")
    rc = _run_trainer(_write(leg(base_ckpt, dp=2, mbs=2, ga=1),
                             os.path.join(base_dir, "config.json")),
                      os.path.join(base_dir, "run.log"), {}, device)
    if rc != 0:
        return fail(f"baseline run exited {rc}")
    base_meta = _final_meta(base_ckpt)

    fault_dir = os.path.join(workdir, "fault")
    os.makedirs(fault_dir, exist_ok=True)
    ckpt_dir = os.path.join(fault_dir, "ckpt")
    log_path = os.path.join(fault_dir, "run.log")
    rc = _run_trainer(_write(leg(ckpt_dir, dp=2, mbs=2, ga=1, slices=2,
                                 chaos_spec=f"slice_lost@{STEPS // 2}"),
                             os.path.join(fault_dir, "config_slices2.json")),
                      log_path, {}, device)
    if rc != -signal.SIGKILL:
        return fail(f"leg 1 (slices=2) exited {rc}, expected "
                    f"{-signal.SIGKILL} (SIGKILL)")
    with open(log_path) as f:
        if "slice_lost: the slice hosting process" not in f.read():
            return fail("slice_lost firing (with the lost slice named) "
                        "absent from the leg-1 log")
    saved = elastic.saved_topology(newest_step_dir(ckpt_dir)) or {}
    if saved.get("slices") != 2:
        return fail(f"durable save records topology {saved}, expected "
                    f"slices=2 in its manifest")

    resize_log = os.path.join(fault_dir, "resize.log")
    rc = _restamp(ckpt_dir, resize_log, "--slices", "1")
    if rc != 0:
        return fail(f"elastic_resize --slices 1 exited {rc} (see "
                    f"{resize_log})")
    saved = elastic.saved_topology(newest_step_dir(ckpt_dir)) or {}
    if saved.get("slices", 1) != 1:
        return fail(f"re-stamped store still records {saved}")

    rc = _run_trainer(_write(leg(ckpt_dir, dp=1, mbs=2, ga=2,
                                 elastic_on=True),
                             os.path.join(fault_dir, "config_dp1.json")),
                      log_path, {}, device)
    if rc != 0:
        return fail(f"leg 2 (dp=1, elastic) exited {rc}, expected 0")
    with open(log_path) as f:
        log_text = f.read()
    if verbose:
        print(log_text)
    if not re.search(r"elastic resize:", log_text):
        return fail("marker /elastic resize:/ absent from the leg-2 log")
    meta = _final_meta(ckpt_dir)
    for key in ("step", "trained_tokens"):
        if meta[key] != base_meta[key]:
            return fail(f"final {key} {meta[key]} != fault-free baseline "
                        f"{base_meta[key]}")
    base_losses = _step_losses(os.path.join(base_ckpt, "telemetry.jsonl"))
    fault_losses = _step_losses(os.path.join(ckpt_dir, "telemetry.jsonl"))
    if set(fault_losses) != set(base_losses):
        return fail(f"step sets differ: fault {sorted(fault_losses)} vs "
                    f"baseline {sorted(base_losses)}")
    steps = sorted(base_losses)
    bl = np.array([base_losses[s] for s in steps])
    fl = np.array([fault_losses[s] for s in steps])
    if not np.allclose(fl, bl, **LOSS_TOL):
        return fail(f"loss trajectory diverged from baseline: "
                    f"{list(zip(steps, fl.tolist(), bl.tolist()))}")
    summary = telemetry_report.summarize(telemetry_report.load_events(
        os.path.join(ckpt_dir, "telemetry.jsonl")))
    if summary["categories"].get("resize", 0.0) <= 0.0:
        return fail(f"no `resize` seconds in the goodput categories "
                    f"({summary['categories']})")
    if not summary.get("resize", {}).get("events"):
        return fail("no elastic_resize event in the telemetry stream")
    print(f"[chaos-cli] slice_lost: OK — 2-slice run lost a slice, "
          f"re-stamped --slices 1, finished at dp=1 via runtime elastic; "
          f"final step {meta['step']} / {meta['trained_tokens']} tokens "
          f"and loss trajectory match baseline; resize booked "
          f"{summary['categories']['resize']:.3f}s")
    return True


def run_mpmd_sigterm(workdir: str, verbose: bool = False,
                     device: str = "cpu") -> bool:
    """SIGTERM at tick 2 of step 3's pp 2 mpmd walk drains to the step
    boundary (exit 75, the restart replays no step); a hang at tick 1 of
    step 4 is named by the watchdog (77) and the restart finishes at the
    baseline's step."""
    from picotron_tpu_torch.tools import telemetry_report

    fail = lambda msg: (print(f"[chaos-cli] mpmd_sigterm: FAIL — {msg}"),  # noqa: E731
                        False)[1]

    def leg(ckpt_dir, chaos_spec, overrides):
        cfg = scenario_config(os.path.dirname(ckpt_dir), chaos_spec,
                              {"checkpoint": {"async_save": False},
                               **overrides}, device)
        for section, vals in _pp(2).items():
            cfg.setdefault(section, {}).update(vals)
        cfg["checkpoint"]["save_dir"] = ckpt_dir
        return cfg

    def run(cfg, leg_dir, env):
        return _run_trainer(_write(cfg, os.path.join(leg_dir, "config.json")),
                            os.path.join(leg_dir, "run.log"), env, device)

    base_dir = os.path.join(workdir, "baseline")
    os.makedirs(base_dir, exist_ok=True)
    base_ckpt = os.path.join(base_dir, "ckpt")
    if run(leg(base_ckpt, "", {}), base_dir, {}) != 0:
        return fail("baseline run (pp 2 mpmd) failed")
    base_meta = _final_meta(base_ckpt)

    st_dir = os.path.join(workdir, "sigterm")
    os.makedirs(st_dir, exist_ok=True)
    st_ckpt = os.path.join(st_dir, "ckpt")
    st_cfg = leg(st_ckpt, f"sigterm@{STEPS // 2}#2", {})
    rc = run(st_cfg, st_dir, {})
    if rc != EXIT_PREEMPTED:
        return fail(f"sigterm leg exited {rc}, expected {EXIT_PREEMPTED}")
    rc = run(st_cfg, st_dir, {"PICOTRON_CHAOS": ""})
    if rc != 0:
        return fail(f"sigterm-leg restart exited {rc}, expected 0")
    with open(os.path.join(st_dir, "run.log")) as f:
        st_log = f.read()
    if verbose:
        print(st_log)
    if not re.search(r"firing sigterm at schedule_tick step "
                     rf"{STEPS // 2} \(stage=\d+ tick=2 op=\w+", st_log):
        return fail("no mid-schedule sigterm firing (schedule_tick with "
                    "stage/tick/op) in the sigterm-leg log")
    if not re.search(r"emergency checkpoint ->", st_log):
        return fail("marker /emergency checkpoint ->/ absent")
    meta = _final_meta(st_ckpt)
    for key in ("step", "trained_tokens"):
        if meta[key] != base_meta[key]:
            return fail(f"sigterm leg final {key} {meta[key]} != baseline "
                        f"{base_meta[key]}")
    summary = telemetry_report.summarize(telemetry_report.load_events(
        os.path.join(st_ckpt, "telemetry.jsonl")))
    st = summary.get("steps") or {}
    if st.get("count") != STEPS or st.get("max") != STEPS:
        return fail(f"sigterm leg trained steps {st}, expected "
                    f"count=max={STEPS}")
    if st.get("replayed"):
        return fail(f"sigterm leg replayed {st['replayed']} step(s)")

    hg_dir = os.path.join(workdir, "hang")
    os.makedirs(hg_dir, exist_ok=True)
    hg_ckpt = os.path.join(hg_dir, "ckpt")
    hg_cfg = leg(hg_ckpt, f"hang@{STEPS - 2}~120#1",
                 {"resilience": {"watchdog_timeout": 5.0}})
    rc = run(hg_cfg, hg_dir, {})
    if rc != EXIT_WATCHDOG:
        return fail(f"hang leg exited {rc}, expected {EXIT_WATCHDOG}")
    rc = run(hg_cfg, hg_dir, {"PICOTRON_CHAOS": ""})
    if rc != 0:
        return fail(f"hang-leg restart exited {rc}, expected 0")
    with open(os.path.join(hg_dir, "run.log")) as f:
        hg_log = f.read()
    if verbose:
        print(hg_log)
    m = re.search(r"\[watchdog\] no progress .* last "
                  r"phase='pp_schedule stage=\d+ tick=\d+ op=\w+ mb=\d+'",
                  hg_log)
    if not m:
        return fail("watchdog report does not name the live (stage, tick, "
                    "op): /pp_schedule stage=/ absent from the hang log")
    meta = _final_meta(hg_ckpt)
    for key in ("step", "trained_tokens"):
        if meta[key] != base_meta[key]:
            return fail(f"hang leg final {key} {meta[key]} != baseline "
                        f"{base_meta[key]}")
    print(f"[chaos-cli] mpmd_sigterm: OK — mid-schedule SIGTERM drained "
          f"to the step boundary (exit {EXIT_PREEMPTED}, 0 replayed "
          f"steps) and the mid-schedule hang was watchdog-named "
          f"({m.group(0).split('last ')[-1]}); both legs finished at "
          f"baseline step {base_meta['step']}")
    return True


# ---------------------------------------------------------------------------
# the serving scenarios
# ---------------------------------------------------------------------------


def _run_bench_fleet(leg_dir: str, extra_args: list, device: str,
                     telemetry: Optional[str] = None) -> dict:
    """One `tools.serve_bench --fleet` leg in a child process; returns
    its JSON row."""
    os.makedirs(leg_dir, exist_ok=True)
    env = dict(os.environ)
    env.pop("PICOTRON_CHAOS", None)  # the leg's --chaos is the only fault
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")  # tiny ops: one thread
    cmd = [sys.executable, "-m", "picotron_tpu_torch.tools.serve_bench",
           "--device", device, "--model", "debug-tiny", "--prompt-len",
           "16", "--max-new-tokens", "8", "--serve-slots", "3",
           "--block-size", "4", "--prefill-chunk", "4",
           "--serve-temperature", "0.7", "--serve-seed", "7"] + extra_args
    if telemetry:
        cmd += ["--telemetry", telemetry]
    log_path = os.path.join(leg_dir, "run.log")
    with open(log_path, "ab") as log:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=log,
                              env=env, timeout=RUN_TIMEOUT_S)
        log.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"serve_bench fleet leg exited "
                           f"{proc.returncode} (log: {log_path})")
    for line in reversed(proc.stdout.decode().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON row in serve_bench output (log: "
                       f"{log_path})")


def check_engine_dead(oracle: dict, fault: dict, n_req: int):
    """serve_engine_dead's checks of one fault leg against the fleet-of-1
    oracle: an error string, or None."""
    if fault["engines_dead"] != 1:
        return (f"engines_dead {fault['engines_dead']} != 1 — the chaos "
                f"kill did not land")
    if fault["completed"] != n_req or fault["shed"]:
        return (f"survivor finished {fault['completed']}/{n_req} (shed "
                f"{fault['shed']}) — every request must complete on the "
                f"surviving engine")
    if fault["redispatched"] < 1:
        return ("no requests were re-dispatched — the engine died with "
                "nothing in flight, so the scenario proved nothing")
    if fault["request_digests"] != oracle["request_digests"]:
        bad = [k for k, v in oracle["request_digests"].items()
               if fault["request_digests"].get(k) != v]
        return (f"token parity broken after failover for request(s) {bad} "
                f"— re-dispatched continuations must be bit-identical to "
                f"the fault-free oracle")
    if fault["leaked_blocks"]:
        return (f"{fault['leaked_blocks']} leaked block(s) on survivor "
                f"pools after the trace drained")
    return None


def run_serve_engine_dead(workdir: str, verbose: bool = False,
                          device: str = "cpu") -> bool:
    """Engine failover under load. Oracle leg: a fleet of 1, no faults,
    temperature 0.7. Fault leg: a fleet of 2 with `engine_dead@2` fired
    as request 2 is routed: the engine dies abruptly with requests
    resident. The survivor must finish EVERY request with per-request
    token digests equal to the oracle's, leak no block and leave a
    serve_engine_dead postmortem; a repeat of the fault leg must give the
    same digests (recovery is deterministic, not merely successful)."""
    fail = lambda msg: (print(f"[chaos-cli] serve_engine_dead: FAIL — "  # noqa: E731
                              f"{msg}"), False)[1]
    n_req = 8
    common = ["--requests", str(n_req)]
    oracle = _run_bench_fleet(os.path.join(workdir, "oracle"),
                              common + ["--fleet", "1"], device)
    tel_dir = os.path.join(workdir, "fault")
    fault = _run_bench_fleet(
        tel_dir, common + ["--fleet", "2", "--chaos", "engine_dead@2"],
        device, telemetry=os.path.join(tel_dir, "telemetry.jsonl"))
    if verbose:
        print(json.dumps(oracle), "\n", json.dumps(fault))
    err = check_engine_dead(oracle, fault, n_req)
    if err:
        return fail(err)
    pm_path = os.path.join(tel_dir, "flightdeck_postmortem.json")
    if not os.path.exists(pm_path):
        return fail(f"no flightdeck postmortem at {pm_path}")
    with open(pm_path) as f:
        pm = json.load(f)
    if pm.get("reason") != "serve_engine_dead":
        return fail(f"postmortem reason {pm.get('reason')!r} != "
                    f"'serve_engine_dead'")
    repeat = _run_bench_fleet(
        os.path.join(workdir, "repeat"),
        common + ["--fleet", "2", "--chaos", "engine_dead@2"], device)
    if (repeat["request_digests"] != fault["request_digests"]
            or repeat["redispatched"] != fault["redispatched"]):
        return fail("fault leg is not deterministic across repeats "
                    "(digests or redispatch count changed)")
    dead_engine = (pm.get("extra") or {}).get("engine")
    print(f"[chaos-cli] serve_engine_dead: OK — engine killed mid-burst "
          f"(postmortem engine {dead_engine}), survivor finished "
          f"{fault['completed']}/{n_req} requests bit-identical to the "
          f"single-engine oracle ({fault['redispatched']} re-dispatched), "
          f"0 leaked blocks, deterministic on repeat")
    return True


def check_overload(unloaded: dict, shedleg: dict, n_req: int,
                   deadline_ms: float):
    """serve_overload's checks of the deadline leg against the
    no-deadline leg: an error string, or None."""
    if not shedleg["shed"]:
        return ("burst shed nothing — the overload never tripped the "
                "deadline, scenario proves nothing")
    if shedleg["completed"] + shedleg["shed"] != n_req:
        return (f"completed {shedleg['completed']} + shed "
                f"{shedleg['shed']} != {n_req} submitted")
    mismatch = [k for k, v in shedleg["request_digests"].items()
                if unloaded["request_digests"].get(k) != v]
    if mismatch:
        return (f"admitted request(s) {mismatch} decoded different tokens "
                f"than the no-deadline leg — shedding neighbors must not "
                f"perturb sampling")
    qw95 = shedleg["queue_wait_p95_ms"]
    if qw95 is None or qw95 > deadline_ms + 1e-6:
        return (f"admitted queue wait p95 {qw95} ms exceeds the "
                f"{deadline_ms} ms deadline — admission let an expired "
                f"request through")
    return None


def run_serve_overload(workdir: str, verbose: bool = False,
                       device: str = "cpu") -> bool:
    """Deadline load shedding under a saturation burst: both legs run a
    1-slot engine on the same all-at-t=0 burst of 10 requests. The
    no-deadline leg serves everything late; the deadline leg sheds the
    requests whose VIRTUAL-clock queue wait exceeds the deadline. The
    shed set must be non-empty and equal on a repeat, the admitted
    requests' digests equal to the no-deadline leg's, every admitted
    queue wait within the deadline, and the shed seconds booked to the
    telemetry ledger's `shed` category and rendered by
    telemetry_report."""
    from picotron_tpu_torch.tools import telemetry_report

    fail = lambda msg: (print(f"[chaos-cli] serve_overload: FAIL — "  # noqa: E731
                              f"{msg}"), False)[1]
    n_req = 10
    deadline_ms = 6.0
    burst = ["--requests", str(n_req), "--serve-slots", "1", "--rate", "0",
             "--fleet", "1"]
    unloaded = _run_bench_fleet(os.path.join(workdir, "no_deadline"),
                                burst, device)
    tel_dir = os.path.join(workdir, "deadline")
    tel_path = os.path.join(tel_dir, "telemetry.jsonl")
    shedleg = _run_bench_fleet(
        tel_dir, burst + ["--deadline-ms", str(deadline_ms)], device,
        telemetry=tel_path)
    if verbose:
        print(json.dumps(unloaded), "\n", json.dumps(shedleg))
    err = check_overload(unloaded, shedleg, n_req, deadline_ms)
    if err:
        return fail(err)
    repeat = _run_bench_fleet(
        os.path.join(workdir, "repeat"),
        burst + ["--deadline-ms", str(deadline_ms)], device)
    if (repeat["shed_ids"] != shedleg["shed_ids"]
            or repeat["request_digests"] != shedleg["request_digests"]):
        return fail(f"shed set not deterministic: {shedleg['shed_ids']} "
                    f"vs {repeat['shed_ids']} on repeat")
    summary = telemetry_report.summarize(
        telemetry_report.load_events(tel_path))
    shed_s = (summary.get("categories") or {}).get("shed", 0.0)
    if not shed_s > 0.0:
        return fail("no seconds booked to the `shed` ledger category in "
                    "the telemetry stream")
    sv = summary.get("serving") or {}
    if sv.get("shed") != shedleg["shed"]:
        return fail(f"telemetry_report serving view shed {sv.get('shed')} "
                    f"!= bench row {shedleg['shed']}")
    if "shed" not in telemetry_report.render(summary):
        return fail("telemetry_report render does not show the shed row")
    print(f"[chaos-cli] serve_overload: OK — burst shed "
          f"{shedleg['shed']}/{n_req} deterministically "
          f"(ids {shedleg['shed_ids']}), admitted tokens bit-identical "
          f"to the no-deadline leg, queue wait p95 "
          f"{shedleg['queue_wait_p95_ms']} ms <= {deadline_ms} ms "
          f"deadline, {round(shed_s, 4)}s booked to `shed`")
    return True


CUSTOM_SCENARIOS: dict[str, tuple[Callable, str]] = {
    "dp_resize": (run_dp_resize,
                  "elastic scale-out: SIGKILL a dp=2 run, re-stamp to "
                  "dp=1 offline (files re-split), SIGKILL again, finish at "
                  "dp=4 via checkpoint.elastic; loss-trajectory parity vs "
                  "the dp=2 baseline, resize seconds booked"),
    "pp_resize": (run_pp_resize,
                  "elastic pipeline resize: SIGKILL a pp=2 MPMD run, "
                  "re-stamp to pp=1 offline (layers re-bucketed), SIGKILL "
                  "again, finish at pp=2 via checkpoint.elastic; loss "
                  "parity vs the pp=2 baseline, resize booked"),
    "slice_lost": (run_slice_lost,
                   "whole-slice loss: a dp=2 x slices=2 run (hierarchical "
                   "dp reduction live) SIGKILLed at step 3, re-stamped "
                   "--slices 1 offline, finished at dp=1 via "
                   "checkpoint.elastic; loss parity vs the baseline, "
                   "resize booked"),
    "mpmd_sigterm": (run_mpmd_sigterm,
                     "mid-schedule MPMD faults: SIGTERM at a named "
                     "(stage, tick, op) drains to the step boundary "
                     "(exit 75, zero replayed steps on resume); forced "
                     "hang is watchdog-reported naming the live op"),
    "serve_engine_dead": (run_serve_engine_dead,
                          "engine failover under load: a fleet of 2 "
                          "loses an engine mid-burst; every request "
                          "finishes bit-identical to a fleet of 1, 0 "
                          "leaked blocks, deterministic on repeat"),
    "serve_overload": (run_serve_overload,
                       "deadline load shedding: a 10x burst into 1 slot "
                       "sheds deterministically on the virtual clock, "
                       "admitted tokens unperturbed, shed seconds booked"),
}

# scenarios whose layout needs more ranks than one card gives NCCL
MULTI_RANK = ("dp_resize", "pp_resize", "mpmd_sigterm", "slice_lost")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="picotron-tpu port fault-recovery scenario runner")
    ap.add_argument("--scenario", action="append", default=[],
                    choices=sorted(set(SCENARIOS) | set(CUSTOM_SCENARIOS)
                                   | set(REFUSED)),
                    help="scenario to run (repeatable)")
    ap.add_argument("--all", action="store_true",
                    help="run every scenario the port runs")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the trainer runs (default cuda)")
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (default: a fresh tempdir)")
    ap.add_argument("--verbose", action="store_true",
                    help="print the fault run's log")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        for name, sc in SCENARIOS.items():
            print(f"{name:14s} chaos={sc.chaos!r:24s} {sc.note}")
        for name, (_fn, note) in CUSTOM_SCENARIOS.items():
            print(f"{name:14s} chaos={'custom':26s} {note}")
        for name, why in REFUSED.items():
            print(f"{name:14s} {'refused':33s} {why}")
        return 0
    names = sorted(set(args.scenario))
    if args.all:
        names = sorted(set(SCENARIOS) | set(CUSTOM_SCENARIOS))
    if not names:
        build_parser().error("pick --scenario NAME (repeatable), --all, "
                             "or --list")
    refused = [n for n in names if n in REFUSED]
    if refused:
        for n in refused:
            print(f"[chaos-cli] {n}: refused — {REFUSED[n]}",
                  file=sys.stderr)
        return 2
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("[chaos-cli] --device cuda: CUDA is not available; pass "
                  "--device cpu", file=sys.stderr)
            return 2
        n = torch.cuda.device_count()
        short = [s for s in names if s in MULTI_RANK and n < 8]
        if short:
            print(f"[chaos-cli] {', '.join(short)}: the layouts need 2 to 8 "
                  f"ranks and NCCL takes one per card ({n} here); run them "
                  f"with --device cpu", file=sys.stderr)
            return 2
    workdir = args.workdir or tempfile.mkdtemp(prefix="picotron-chaos-")
    ok = True
    for name in names:
        sub = os.path.join(workdir, name)
        os.makedirs(sub, exist_ok=True)
        if name in CUSTOM_SCENARIOS:
            ok &= CUSTOM_SCENARIOS[name][0](sub, verbose=args.verbose,
                                            device=args.device)
        else:
            ok &= run_scenario(name, sub, verbose=args.verbose,
                               device=args.device)
    print(f"[chaos-cli] {'all scenarios recovered' if ok else 'FAILURES'} "
          f"(workdir {workdir})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
