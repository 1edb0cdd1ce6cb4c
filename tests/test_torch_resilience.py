"""The port's divergence guard, preemption, watchdog and retry against the
JAX package's (picotron_tpu/resilience) and through the port's trainer on
the CPU at debug size: guard decisions identical to the JAX class, the
`grad_norm` log extra and windowed tokens/s, a finite-loss step with
non-finite grads exiting 76 at that step, skip leaving params and moments
bit-identical, rollback restoring and skipping the poisoned batch, SIGTERM
exiting 75 with a lossless auto-resume, the watchdog firing on a stall,
and retry recovering then re-raising."""

import json
import os
import random
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from picotron_tpu.resilience import guards as jguards
from picotron_tpu.resilience import retry as jretry
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch.checkpoint import CheckpointManager
from picotron_tpu_torch.resilience import guards, retry, watchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(tmp_path=None, steps=4, **sections):
    raw = {"model": {"name": "debug-tiny", "dtype": "float32"},
           "training": dict(seq_length=16, micro_batch_size=2,
                            gradient_accumulation_steps=2,
                            total_train_steps=steps, lr_schedule="cosine",
                            lr_warmup_steps=1, learning_rate=1e-3,
                            weight_decay=0.1, remat=False),
           "distributed": {"use_cpu": True},
           "logging": {"log_frequency": 1}}
    if tmp_path is not None:
        raw["checkpoint"] = {"save_dir": str(tmp_path / "ckpt")}
    for section, vals in sections.items():
        raw.setdefault(section, {}).update(vals)
    return tcfg.config_from_dict(raw)


# -- guard decisions --------------------------------------------------------

NAN, INF = float("nan"), float("inf")
FLAT = [2.0 + 0.01 * (i % 3) for i in range(8)]
SEQUENCES = {
    "clean": [(2.0 - 0.1 * i, 1.0, 0.0) for i in range(6)],
    "nan_loss": [(2.0, 1.0, 0.0), (NAN, 1.0, 1.0), (1.9, 1.0, 0.0)],
    "inf_grad_norm": [(2.0, 1.0, 0.0), (1.9, INF, 1.0), (1.8, 1.0, 0.0)],
    "in_step_flag": [(2.0, 1.0, 0.0), (1.9, 1.0, 1.0), (1.8, 1.0, 0.0)],
    "spike": [(x, 1.0, 0.0) for x in FLAT] + [(9.0, 1.0, 0.0),
                                              (2.0, 1.0, 0.0)],
    "escalation": [(2.0, 1.0, 0.0)] + [(NAN, NAN, 1.0)] * 4,
}


@pytest.mark.parametrize("policy", ["skip", "rollback", "abort"])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_guard_decisions_match_jax(policy, name):
    kw = dict(spike_zscore=4.0 if name == "spike" else 0.0, spike_window=8,
              max_trips=3)
    mine = guards.DivergenceGuard(policy, **kw)
    ref = jguards.DivergenceGuard(policy, **kw)
    for step, (loss, gnorm, nonfinite) in enumerate(SEQUENCES[name], 1):
        a, why = mine.observe(step, loss, grad_norm=gnorm,
                              nonfinite=nonfinite)
        b, want = ref.observe(step, loss, grad_norm=gnorm,
                              nonfinite=nonfinite)
        assert (a.value, why) == (b.value, want), (step, loss)
    assert guards.EXIT_DIVERGED == jguards.EXIT_DIVERGED == 76


# -- the trainer's guard and log line ---------------------------------------


def _poison(monkeypatch, at_calls):
    """Make the step calls numbered in `at_calls` (from 1; a rolled-back
    step is called again) produce a finite loss with NaN grads: sqrt(0 * w)
    adds 0 to the loss but its derivative at 0 is inf, and inf * 0 = NaN
    reaches every grad of w."""
    real_make, real_loss = tstep.make_train_step, tstep.loss_sum_count
    calls = [0]

    def poisoned(model, ids, tgt, *args):
        total, count, extras = real_loss(model, ids, tgt, *args)
        return total + torch.sqrt(model.final_norm.sum() * 0.0), count, extras

    def make(cfg):
        fn = real_make(cfg)

        def step(state, batch):
            calls[0] += 1
            if calls[0] in at_calls:
                monkeypatch.setattr(tstep, "loss_sum_count", poisoned)
            try:
                return fn(state, batch)
            finally:
                monkeypatch.setattr(tstep, "loss_sum_count", real_loss)

        return step

    monkeypatch.setattr(ttrain, "make_train_step", make)


def test_log_line_has_grad_norm_and_windowed_tokens_per_s(monkeypatch,
                                                          capsys):
    """log_frequency 2: a line every second step, its tokens/s over both
    steps since the last line (a fake clock gives each window 2 s)."""

    class TwoSecondWindows:
        def lap(self):
            return 2.0

    monkeypatch.setattr(ttrain, "StepTimer", TwoSecondWindows)
    cfg = _cfg(logging={"log_frequency": 2})
    ttrain.run(cfg)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[step ")]
    assert [line[:13] for line in lines] == ["[step 000002]",
                                             "[step 000004]"]
    # 2 steps x 64 tokens in 2 s = 64 tokens/s (the last step alone: 32)
    assert all("| tokens/s: 64 |" in line for line in lines), lines
    assert all(" | grad_norm: " in line for line in lines)
    assert float(lines[0].rsplit("grad_norm: ", 1)[1]) > 0


def test_finite_loss_nonfinite_grads_exits_76_at_that_step(monkeypatch,
                                                           capsys):
    _poison(monkeypatch, {3})
    seen = []
    with pytest.raises(SystemExit) as e:
        ttrain.run(_cfg(steps=5), on_step=lambda s, m: seen.append(m))
    assert e.value.code == 76
    assert len(seen) == 2  # steps 1 and 2 completed; 3 aborted
    out = capsys.readouterr().out
    assert "[guard 000003] non-finite grad norm (nan); aborting" in out


def test_guard_off_applies_no_norm_and_no_guard(monkeypatch):
    cfg = _cfg(steps=2, resilience={"guard_policy": "off"})
    seen = []
    ttrain.run(cfg, on_step=lambda s, m: seen.append(m))
    assert [sorted(m) for m in seen] == [["loss"], ["loss"]]


def test_skip_leaves_params_and_moments_bit_identical(monkeypatch, capsys):
    _poison(monkeypatch, {3})
    cfg = _cfg(steps=3, resilience={"guard_policy": "skip"})
    before = {}

    def snap(step, metrics):
        if step == 2:
            before["state"] = _state_tensors(result_state["state"])
            before["count"] = result_state["state"].optimizer.count

    result_state = {}
    real_build = ttrain.build_state

    def build(cfg, dev):
        out = real_build(cfg, dev)
        result_state["state"] = out[0]
        return out

    monkeypatch.setattr(ttrain, "build_state", build)
    result = ttrain.run(cfg, on_step=snap)
    assert np.isfinite(result["losses"][2])  # the poisoned step's loss
    after = _state_tensors(result["state"])
    assert after.keys() == before["state"].keys()
    for k, v in after.items():
        assert torch.equal(v, before["state"][k]), k
    assert result["state"].optimizer.count == before["count"] == 2
    assert result["state"].step == 3
    assert "batch skipped" in capsys.readouterr().out


def _state_tensors(state):
    out = {}
    for n, p in state.model.named_parameters():
        st = state.optimizer.moments(p)
        out[n] = p.detach().clone()
        out[n + ".mu"] = st["mu"].clone()
        out[n + ".nu"] = st["nu"].clone()
    return out


def test_rollback_restores_and_skips_the_poisoned_batch(monkeypatch, tmp_path,
                                                        capsys):
    _poison(monkeypatch, {3})
    cfg = _cfg(tmp_path, steps=4, resilience={"guard_policy": "rollback"},
               checkpoint={"save_frequency": 2, "async_save": False})
    result = ttrain.run(cfg)
    out = capsys.readouterr().out
    assert "[guard 000003] non-finite grad norm (nan); rolled back to step 2" \
        in out
    # steps 1, 2, 3 (poisoned), then 3 and 4 again on batches 4 and 5
    assert len(result["losses"]) == 5 and result["state"].step == 4
    meta = json.load(open(tmp_path / "ckpt" / "step_00000004" / "meta.json"))
    assert meta["dataloader"] == {"epoch": 0, "cursor": 5 * 4}
    assert meta["trained_tokens"] == 4 * 64

    # the re-run step 3 is step 3 of an unpoisoned run whose third batch
    # is the fourth: same step-2 state, batch 4
    monkeypatch.undo()
    # 2 steps under the same 4-step lr schedule
    ref = ttrain.run(_cfg(steps=4, training={"max_tokens": 2 * 64}))
    from picotron_tpu_torch.data import MicroBatchDataLoader

    dl = MicroBatchDataLoader(cfg, "cpu")
    for _ in range(3):
        next(dl)
    step_fn = tstep.make_train_step(cfg)
    loss = float(step_fn(ref["state"], next(dl))["loss"])
    assert loss == result["losses"][3]


def test_rollback_without_a_checkpoint_exits_76(monkeypatch, tmp_path):
    _poison(monkeypatch, {2})
    cfg = _cfg(tmp_path, steps=3, resilience={"guard_policy": "rollback"})
    with pytest.raises(SystemExit) as e:
        ttrain.run(cfg)
    assert e.value.code == 76


def test_sigterm_exits_75_then_auto_resume_is_lossless(tmp_path, capsys):
    cfg = _cfg(tmp_path, steps=4, checkpoint={"auto_resume": True})

    def preempt(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    first = []
    with pytest.raises(SystemExit) as e:
        ttrain.run(cfg, on_step=lambda s, m: (first.append(m["loss"]),
                                              preempt(s, m)))
    assert e.value.code == 75
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    mgr = CheckpointManager(cfg)
    assert mgr.durable_steps() == [2]
    assert mgr.verify_step(2).status == "verified"
    resumed = ttrain.run(cfg)
    assert resumed["start_step"] == 2
    whole = ttrain.run(_cfg(steps=4))
    assert first + resumed["losses"] == whole["losses"]  # bit for bit
    for (n, p), q in zip(resumed["state"].model.named_parameters(),
                         whole["state"].model.parameters()):
        assert torch.equal(p, q), n
    assert "emergency checkpoint -> " in capsys.readouterr().out


# -- watchdog ---------------------------------------------------------------


def test_watchdog_fires_on_a_stall_and_not_while_beaten():
    fired = threading.Event()
    w = watchdog.Watchdog(0.3, on_timeout=fired.set, poll=0.05)
    w.start()
    try:
        for _ in range(10):  # 1 s of beats every 0.1 s: alive
            w.beat("step")
            fired.wait(0.1)
        assert not fired.is_set()
        assert fired.wait(5.0)  # no beats: fires
    finally:
        w.stop()
    assert not w.started


def test_trainer_arms_the_watchdog_after_step_1(monkeypatch):
    fired = threading.Event()
    monkeypatch.setattr(ttrain, "Watchdog",
                        lambda t: watchdog.Watchdog(t, on_timeout=fired.set,
                                                    poll=0.05))
    cfg = _cfg(steps=3, resilience={"watchdog_timeout": 0.3})
    stalls = {1: 1.0}
    ttrain.run(cfg, on_step=lambda s, m: fired.wait(stalls.get(s, 0)))
    assert fired.is_set()


def test_watchdog_exits_77():
    code = ("import time\nfrom picotron_tpu_torch.resilience.watchdog "
            "import Watchdog\nWatchdog(0.2).start()\ntime.sleep(30)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == watchdog.EXIT_WATCHDOG == 77, out.stderr
    assert "[watchdog] no progress" in out.stderr


# -- retry ------------------------------------------------------------------


def test_retry_recovers_then_reraises():
    calls, slept = [], []

    def flaky(n_fail):
        calls.append(1)
        if len(calls) <= n_fail:
            raise OSError("transient")
        return "ok"

    policy = retry.RetryPolicy(attempts=3, base_delay=0.5, max_delay=30.0)
    assert retry.retry_call(flaky, 2, policy=policy, sleep=slept.append,
                            rng=random.Random(0)) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    calls.clear()
    with pytest.raises(OSError):
        retry.retry_call(flaky, 5, policy=policy, sleep=slept.append)
    assert len(calls) == 3
    with pytest.raises(ValueError):  # not retried
        retry.retry_call(lambda: (_ for _ in ()).throw(ValueError()),
                         policy=policy, sleep=slept.append)
    # the same delays as the JAX package's for the same seed
    mine = list(retry.backoff_delays(policy, random.Random(7)))
    want = list(jretry.backoff_delays(
        jretry.RetryPolicy(attempts=3, base_delay=0.5, max_delay=30.0),
        random.Random(7)))
    assert mine == want
