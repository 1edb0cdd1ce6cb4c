"""Trainer of the PyTorch port (counterpart of picotron_tpu/train.py):

    python -m picotron_tpu_torch.train --config cfg.json [--device cpu]
    torchrun --nproc_per_node N -m picotron_tpu_torch.train --config cfg.json
        [--device cpu] [--report out.json]

Flow: load the config -> telemetry (`Telemetry.from_config`, installed on
the bus) -> loader (synthetic, or an HF dataset: a `save_to_disk`
directory or a `load_dataset` name, with prefetch when
dataset.num_workers > 0) -> state (fresh init from training.seed, then HF
weights, then an explicit `checkpoint.load_path` or `auto_resume` of the
newest verified checkpoint in save_dir) -> the loader fast-forwarded to
the checkpoint's cursor -> chaos installed -> step loop: divergence
guard, one `training_log_line` per logged step (with the `grad_norm`
extra and tokens/s over the window since the last logged step), eval,
periodic save, preemption check -> final save. Runs on CUDA unless
`--device cpu` or config `distributed.use_cpu: true` asks for the CPU;
with no GPU and no such request it raises. MFU is printed as 0.00% on
the CPU: it is a device metric and is not measured there.

Under torchrun (any process group, world 1 included) the run takes the
layout's path (`mesh.init_parallel`: NCCL on cuda:LOCAL_RANK, gloo with
--device cpu; the world must be dp*pp*ep*cp*tp): each rank builds its tp
shards (and for an MoE model its ep shard of the expert banks, its
dispatch exchanging slots over the ep group) of its pipeline stage's
layers (pp > 1: `parallel/pp.py` walks
the pp_engine's or the mpmd schedule's table, exchanging boundary
tensors with the neighbouring stages), reads its dp rows and its cp
slice of their sequence (the cp schedules exchange K/V or heads over the
cp group), reduces the grads over the data group and, with
distributed.zero1, updates its slice of the optimizer state. Only rank 0
prints and writes the report; tokens/s is the global rate and MFU is over
the world's devices (picotron_tpu/train.py's `utils.mfu(..., num_chips)`).
After the first step rank 0 prints the collectives launched per step, by
kind (the cp exchanges and the pp ticks' exchanges as "send_recv", the
cp all-to-alls as "all_to_all"), and under pp its walk: the exchanges,
the most graphs in flight and the table's bubble. `--report PATH`
writes (rank 0) a JSON of the run's losses, step seconds, peak memory,
collectives per step, the pipeline's walk and the kernels' launches.

Observability, as the JAX trainer's (`picotron_tpu/train.py`): the
frozen stdout line, a per-process `telemetry.jsonl` event stream next to
the checkpoints (logging.telemetry_dir moves it, telemetry_max_mb
rotates it, telemetry_jsonl: false turns it off), and the flightdeck:
the span tracer (logging.trace_dir -> `trace.json` at exit), the flight
recorder (logging.flight_steps, on by default: `flightdeck_postmortem.json`
on divergence abort, rollback, preemption, an exception or the
watchdog) and the drift sentinel (logging.sentinel); logging.profile_dir
records a torch.profiler trace of the run-relative steps
[profile_start_step, + profile_num_steps) (`telemetry/profiler.py`; read
it with `tools.trace_summary`). Each loop section
runs under `tel.phases.phase(name, step)`, which times it for the
goodput ledger and beats the watchdog. On the card a phase is the host's
clock: the `step` phase ends once the step's kernels are queued, and
the card's remaining work is booked to the `sync` phase, where the
metrics (which the guard and the log line read) are copied to the host;
nothing is synced for the sake of timing. The port syncs the metrics
every step (its `losses` record every step's loss), where the JAX
trainer skips the sync phase when the guard is off and the step is not
logged. `python -m picotron_tpu_torch.tools.telemetry_report` and
`python -m picotron_tpu_torch.tools.trace_export` read the stream.

Fault injection (resilience/chaos.py, `resilience.chaos` or the
PICOTRON_CHAOS environment variable): `step_begin` fires at the top of
each step, `nan_grad` calls the step with `poison=True` on the poisoned
executions, and the loader, the checkpoint
manager and the pipeline's walk carry their own points. The controller
is reset to inactive when the run ends.

Exit codes (the contract with a supervisor): 75 preempted with a durable
emergency checkpoint (resubmit with auto_resume), 76 diverged, 77 the
watchdog found no progress. What this slice does not run is refused up
front, naming the ROADMAP item that ports it (see `unsupported`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Callable, Optional

import torch

from picotron_tpu_torch import optimizer as topt
from picotron_tpu_torch.checkpoint import (
    CheckpointManager, load_hf_safetensors,
)
from picotron_tpu_torch.ckpt_integrity import preflight_save_dir
from picotron_tpu_torch.config import (
    Config, load_config, resolved_cp_flavor,
)
from picotron_tpu_torch.data import MicroBatchDataLoader, build_eval_source
from picotron_tpu_torch.mesh import init_parallel, launcher_contract, shutdown
from picotron_tpu_torch.models.llama import (
    LlamaModel, init_params, pipeline_stage,
)
from picotron_tpu_torch.ops import flash_attention as fa
from picotron_tpu_torch.parallel import comm
from picotron_tpu_torch.parallel.cp import cp_context
from picotron_tpu_torch.parallel.ep import ep_context
from picotron_tpu_torch.parallel.mpmd import pipeline_bubble_fraction
from picotron_tpu_torch.parallel.sharding import shard_state_dict, tp_flips
from picotron_tpu_torch.parallel.tp import tp_context
from picotron_tpu_torch.resilience import (
    EXIT_DIVERGED, EXIT_PREEMPTED, DivergenceGuard, GuardAction,
    PreemptionHandler, Watchdog, chaos, elastic,
)
from picotron_tpu_torch.telemetry import Telemetry, bus as telemetry_bus
from picotron_tpu_torch.telemetry.profiler import ProfileWindow
from picotron_tpu_torch.train_step import (
    init_train_state, make_eval_step, make_train_step, resolved_grad_engine,
)
from picotron_tpu_torch.utils import (
    StepTimer, cuda_or_cpu, device_memory_gb, device_peak_flops,
    human_format, log_print, mfu, set_log_quiet, training_log_line,
)


def unsupported(cfg: Config) -> list[str]:
    """What the config asks for that this slice lacks, each with its
    ROADMAP item (an empty list means the run is supported)."""
    t = cfg.training
    out = []
    if t.remat and t.remat_policy == "dots_offload":
        out.append("training.remat_policy='dots_offload' (saves in pinned "
                   "host memory: ROADMAP Queue 1 item 7)")
    if cfg.logging.use_wandb:
        out.append("logging.use_wandb (the card's machine has no wandb: "
                   "ROADMAP Queue 1 item 12)")
    return out


def tp_slices_line(cfg: Config, par) -> str:
    """The layout line's tp strategy, tp sync and slices parts ("" when
    the run uses none of them)."""
    d = cfg.distributed
    out = ""
    if d.tp_size > 1 and d.tp_strategy != "megatron":
        out += f", tp_strategy {d.tp_strategy}"
        if par.tp_mesh[1] > 1 or "2d" in d.tp_strategy:
            out += f" {par.tp_mesh[0]}x{par.tp_mesh[1]}"
    if d.tp_sync != "sync":
        out += f", tp_sync {d.tp_sync}"
    if d.slices > 1:
        g_dp, inner = par.dp_granule
        out += (f", slices {d.slices} (hierarchical dp reduction, "
                f"{g_dp} x {inner})" if g_dp > 1
                else f", slices {d.slices} (flat dp reduction)")
    return out


def resolve_device(cfg: Config, device: Optional[str] = None) -> torch.device:
    """CUDA unless the caller asks for the CPU; never a silent fallback."""
    if device is None:
        device = "cpu" if cfg.distributed.use_cpu else "cuda"
    return cuda_or_cpu(device,
                       "pass --device cpu (or set distributed.use_cpu)")


def build_state(cfg: Config, dev: torch.device, par=None):
    """(state, trained_tokens, ckpt_meta, resumed_from, restore_timings):
    fresh init, then HF weights, then resume, in the JAX driver's
    precedence. `resumed_from` is the checkpoint directory the state came
    from ("" when fresh): with auto_resume and no explicit load_path, the
    newest durable AND verified checkpoint in save_dir wins. Under a
    layout (`par`) the model is this rank's tp shards of its pipeline
    stage, each (tp, pp) rank drawing its own (dp and cp ranks draw the
    same; ep ranks draw alike but for their expert banks), and reads its
    cp slice of the sequence under context parallelism. With a Telemetry
    facade on the bus the load runs under its "restore" phase (booked as
    restore; the probe's verification before it, which emits
    `ckpt_corrupt` for each corrupt step it passes, stays outside, as in
    the JAX trainer), or, under `checkpoint.elastic` when the step was
    saved at another topology, its "resize" phase (booked as resize); an
    elastic restore emits `elastic_resize` and prints the JAX trainer's
    line."""
    ck = cfg.checkpoint
    tp = tp_context(par, cfg.distributed.sequence_parallel, cfg)
    stage = stage_of(cfg, par)
    seed = cfg.training.seed + (0 if tp is None else 1_000_003 * tp.rank)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embed_gen = None
    if stage is not None:
        # each stage draws its layers from its own seed, and the embedding
        # from the stage-free one: a tied embedding's copies on the first
        # and the last stage start equal, and stay so (PipelineGrads sums
        # their grads)
        embed_gen = gen
        gen = torch.Generator(device=dev).manual_seed(
            seed + 2_000_003 * (stage.index + 1))
    ep = ep_context(par, cfg)
    bank_gen = None
    if ep is not None and ep.size > 1:
        # the layers' seed (per tp rank and stage), per ep rank
        bank_gen = torch.Generator(device=dev).manual_seed(
            gen.initial_seed() + 3_000_017 * (ep.index + 1))
    model = init_params(LlamaModel(cfg.model, device=dev, tp=tp,
                                   cp=cp_context(par, cfg), stage=stage,
                                   ep=ep),
                        gen, embed_gen, bank_gen)
    state = init_train_state(cfg, model, par)
    if cfg.training.optimizer_offload:
        pinned = "pinned " if dev.type == "cuda" else ""
        log_print(f"optimizer: offload ({pinned}host "
                  f"{state.optimizer.host_bytes / 2 ** 30:.2f} GiB)")
    if ck.init_from_hf:
        params = load_hf_safetensors(ck.init_from_hf, cfg.model)
        if par is not None:
            params = shard_state_dict(params, par.tp_rank, par.tp_size,
                                      par.ep_rank, par.ep_size,
                                      tp_flips(cfg))
        state.optimizer.install(params)
        log_print(f"initialized weights from {ck.init_from_hf}")

    load_dir, mgr, step, verify_s = ck.load_path, None, None, 0.0
    if not load_dir and ck.auto_resume:
        probe = CheckpointManager(cfg, par=par)
        t0 = time.perf_counter()
        step = probe.latest_valid_step()
        verify_s = time.perf_counter() - t0
        if step is not None:
            load_dir, mgr = probe.directory, probe
            log_print(f"auto_resume: found checkpoints in {load_dir}")
    if not load_dir:
        return state, 0, {}, "", {}
    tel = telemetry_bus.active()
    phases = getattr(tel, "phases", None)
    if mgr is None:
        mgr = CheckpointManager(cfg, directory=load_dir, par=par)
    # The phase name is chosen before the phase opens: probe the step's
    # saved topology (restore re-checks it)
    phase_name = "restore"
    if ck.elastic:
        probe_step = step if step is not None else mgr.latest_valid_step()
        if probe_step is not None and elastic.topology_mismatch(
                elastic.saved_topology(mgr._step_dir(probe_step)),
                elastic.topology_from_distributed(cfg.distributed)):
            phase_name = "resize"
    with (phases.phase(phase_name) if phases is not None
          else contextlib.nullcontext()):
        if step is None:
            state, meta = mgr.restore(state)
        else:  # verified by latest_valid_step above
            state, meta = mgr.load_step(state, step)
            mgr.timings["verify_s"] = verify_s
    tokens = int(meta.get("trained_tokens", 0))
    resize = meta.get("elastic_resize")
    if resize:
        if tel is not None:
            tel.emit("elastic_resize", step=int(state.step),
                     **{k: resize[k] for k in ("from", "to", "axes")})
        log_print(
            f"elastic resize: restored step {int(state.step)} saved "
            f"at [{elastic.describe_topology(resize['from'])}] into "
            f"[{elastic.describe_topology(resize['to'])}] "
            f"(axes: {', '.join(resize['axes'])}; global batch "
            f"{cfg.global_batch_size} unchanged)")
    log_print(f"resumed from {load_dir} at step {state.step} "
              f"({human_format(tokens)} tokens; verify "
              f"{mgr.timings['verify_s']:.2f}s, load "
              f"{mgr.timings['load_s']:.2f}s)")
    return state, tokens, meta, load_dir, dict(mgr.timings)


def stage_of(cfg: Config, par=None):
    """This rank's pipeline `Stage` (None without pp): its layers, and
    under the mpmd executor's interleaved schedule its `interleave`
    chunks."""
    d = cfg.distributed
    if par is None or d.pp_size == 1:
        return None
    return pipeline_stage(cfg.model.num_hidden_layers, d.pp_size,
                          par.pp_rank, cfg.pipeline.interleave)


def pipeline_line(cfg: Config) -> str:
    """The layout log's pipeline part: the executor and its table."""
    pl = cfg.pipeline
    if pl.executor == "spmd":
        return f", pp spmd {cfg.distributed.pp_engine}"
    return f", pp mpmd {pl.schedule} interleave {pl.interleave}"


def _save_line(what: str, path: str, timings: dict) -> str:
    parts = [f"{k[:-2]} {v:.2f}s" for k, v in timings.items()
             if k in ("snapshot_s", "write_s", "manifest_s")]
    return f"{what} -> {path} ({', '.join(parts)})"


def _emergency_checkpoint(cfg, ckpt_mgr, state, trained_tokens, dl,
                          saved_steps):
    """Preemption landed: make the in-flight progress durable inside the
    grace window. Builds a manager on the spot when periodic saving was
    off: an emergency save must not depend on save_frequency."""
    mgr = (ckpt_mgr if ckpt_mgr is not None
           else CheckpointManager(cfg, par=state.optimizer.par))
    path = mgr._step_dir(state.step)
    if state.step not in saved_steps:
        path = mgr.save(state, trained_tokens, dataloader_state=dl.state)
        saved_steps.add(state.step)
    mgr.wait_until_finished()
    log_print(_save_line("emergency checkpoint", path, mgr.timings))
    return mgr


def _rollback(ckpt_mgr, state, dl, step, trained_tokens, why):
    """Divergence-guard rollback: restore the last known-good checkpoint
    (durable AND manifest-verified) and reposition the dataloader to the
    cursor AFTER the poison batch. Returns (state, restored step,
    trained_tokens); exits EXIT_DIVERGED when nothing valid exists."""
    if ckpt_mgr is None or ckpt_mgr.latest_valid_step() is None:
        log_print(f"[guard {step:06d}] {why}; rollback requested but no "
                  f"valid checkpoint exists — aborting (exit "
                  f"{EXIT_DIVERGED})")
        raise SystemExit(EXIT_DIVERGED)
    skip_to = dl.state  # position after the poison batch
    state, meta = ckpt_mgr.restore(state)
    dl.reset(skip_to)
    tokens = int(meta.get("trained_tokens", 0))
    log_print(f"[guard {step:06d}] {why}; rolled back to step {state.step} "
              f"(skipping poisoned data through epoch {skip_to['epoch']} "
              f"cursor {skip_to['cursor']}); was "
              f"{human_format(trained_tokens)} tokens, now "
              f"{human_format(tokens)}")
    return state, state.step, tokens


def _any_rank(flag: bool, par) -> bool:
    """`flag` OR-ed over every rank (a host-control all-reduce, not one of
    the model's counted collectives)."""
    if par is None or par.world_size == 1:
        return flag
    t = torch.tensor([int(flag)], device=par.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def run(cfg: Config, device: Optional[str] = None,
        on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
    """Train per the config; returns {"losses", "step_seconds",
    "tokens_per_step", "peak_memory_gb", "device", "state", "val_losses",
    "start_step", "restore_timings", "save_timings", "world_size",
    "collectives_per_step", "pipeline", "dataloader_state",
    "telemetry_path", "trace_path", "profile_path"} (state: the trained
    TrainState;
    val_losses: {step: val_loss}; collectives_per_step: the first step's,
    by kind; pipeline: the first step's walk on this rank under pp, else
    None; dataloader_state: the loader's cursor at the end;
    telemetry_path / trace_path: this process's JSONL stream and span
    trace, or None; profile_path: the logging.profile_dir Chrome trace, or
    None).
    `on_step(step, metrics)` runs after each completed step with its
    metrics as floats, before the preemption check. Raises
    SystemExit(75/76) on preemption/divergence."""
    bad = unsupported(cfg)
    if bad:
        raise NotImplementedError(
            "not supported by this slice of the PyTorch port: "
            + "; ".join(bad))
    dev = resolve_device(cfg, device)
    par = init_parallel(cfg, dev)
    world = 1
    if par is not None:
        dev, world = par.device, par.world_size
        set_log_quiet(not par.is_main)
        log_print(f"layout: {par.sizes} over {world} rank(s), backend "
                  f"{par.backend}, sequence_parallel "
                  f"{cfg.distributed.sequence_parallel}, zero1 "
                  f"{cfg.distributed.zero1}"
                  + (f", cp {resolved_cp_flavor(cfg)} "
                     f"{'x'.join(map(str, par.cp_mesh))} "
                     f"{cfg.distributed.cp_layout}"
                     if par.cp_size > 1 else "")
                  + (pipeline_line(cfg) if par.pp_size > 1 else "")
                  + tp_slices_line(cfg, par))
    t, ck = cfg.training, cfg.checkpoint
    if ck.save_frequency > 0:
        est = preflight_save_dir(cfg)  # raises RuntimeError with the story
        log_print(f"checkpoint preflight: ok ({ck.save_dir}, "
                  f"~{est / 1e9:.2f} GB/checkpoint)")
    # Installed on the bus BEFORE the loader and the state are built, so
    # restore retries and chaos events are captured from the first
    # second.
    tel = telemetry_bus.install(Telemetry.from_config(cfg))
    if tel.jsonl_path:
        log_print(f"telemetry -> {tel.jsonl_path}")
    if tel.trace_path:
        log_print(f"flightdeck trace -> {tel.trace_path}")
    if cfg.distributed.pp_size > 1:
        # the schedule table's fill/drain share of every step phase,
        # booked to the pp_bubble category
        tel.set_pp_bubble_fraction(pipeline_bubble_fraction(cfg))
        log_print(f"pipeline: executor={cfg.pipeline.executor} "
                  f"schedule={cfg.pipeline.schedule} "
                  f"v={cfg.pipeline.interleave} — predicted bubble "
                  f"{tel.pp_bubble_fraction * 100:.1f}% of step wall")
    watchdog = preempt = ckpt_mgr = dl = profiler = None
    step = 0
    exit_code = None
    try:
        ranks = ({} if par is None else
                 {"dp_rank": par.coords["dp"], "cp_rank": par.coords["cp"],
                  "ep_rank": par.ep_rank})
        dl = MicroBatchDataLoader(cfg, dev, **ranks)
        # without a layout the calls keep their one-device form, which
        # callers may wrap
        layout = () if par is None else (par,)
        state, trained_tokens, ckpt_meta, resumed_from, restore_timings = (
            build_state(cfg, dev, *layout))
        start_step = state.step
        tel.ledger.resume_from(start_step)
        if start_step > 0:
            # Fast-forward the loader so resume does not replay consumed
            # data; a checkpoint without a recorded position gets it from
            # the step count and the tail-dropping epoch arithmetic.
            dl_state = ckpt_meta.get("dataloader")
            if dl_state is None:
                per_epoch = max(1, len(dl.source) // cfg.global_batch_size)
                dl_state = {"epoch": start_step // per_epoch,
                            "cursor": (start_step % per_epoch)
                            * cfg.global_batch_size}
            dl.set_state(dl_state)
        step_fn = make_train_step(cfg, *layout)
        log_print(f"grad engine: {resolved_grad_engine(cfg)} (grad_engine "
                  f"{t.grad_engine!r}, remat "
                  f"{t.remat_policy if t.remat else None!r}, ce_chunk_size "
                  f"{t.ce_chunk_size})")
        eval_batches = eval_fn = None
        if t.eval_frequency > 0:
            # a FIXED validation set: every eval (and every resumed run)
            # scores the same batches
            eval_dl = MicroBatchDataLoader(
                cfg, dev, source=build_eval_source(cfg), **ranks)
            eval_batches = [next(eval_dl) for _ in range(t.eval_steps)]
            eval_dl.close()
            eval_fn = make_eval_step(cfg, par)
        ckpt_mgr = (CheckpointManager(cfg, par=par)
                    if ck.save_frequency > 0 else None)
        peak = device_peak_flops(dev) if dev.type == "cuda" else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        # two stop conditions, whichever bites first: steps and tokens
        total_steps = t.total_train_steps
        if t.max_tokens is not None:
            remaining = max(0, t.max_tokens - trained_tokens)
            total_steps = min(total_steps, start_step
                              + -(-remaining // cfg.tokens_per_step))

        rcfg = cfg.resilience
        # Chaos installs LAST, so that the eval batches made above cannot
        # consume a data event meant for the training stream.
        ctrl = chaos.install(rcfg.chaos)
        if ctrl.active:
            log_print(f"chaos: {ctrl.describe()}")
        guard = (DivergenceGuard.from_config(rcfg)
                 if rcfg.guard_policy != "off" else None)
        preempt = PreemptionHandler()
        watchdog = Watchdog(rcfg.watchdog_timeout)
        # one clock for liveness and timing: every phase entry below
        # beats the watchdog AND times the section for the ledger
        tel.attach_watchdog(watchdog)
        ph = tel.phases
        # logging.profile_dir: torch.profiler over the run-relative steps
        # [profile_start_step, + profile_num_steps)
        profiler = ProfileWindow(cfg.logging, start_step, dev,
                                 0 if par is None else par.rank)
        # Steps whose checkpoint already exists in the SAVE directory: the
        # loaded step counts only when the resume source IS the save dir.
        resumed_in_place = bool(resumed_from) and (
            os.path.abspath(resumed_from) == os.path.abspath(ck.save_dir))
        saved_steps = {start_step} if resumed_in_place else set()
        losses, step_seconds, val_losses = [], [], {}
        per_step = None  # the collectives of the first step, by kind
        pipeline = None  # the pipeline's walk of the first step
        window = StepTimer()
        last_logged_step = start_step
        step = start_step
        # A while loop, not a range: rollback rewinds `step` to the
        # restored checkpoint and the loop re-trains from there.
        preempt.install()
        while step < total_steps:
            step += 1
            chaos.fire("step_begin", step=step)
            profiler.begin(step)
            t0 = time.perf_counter()
            before = dict(comm.collectives)
            with ph.phase("data", step):
                batch = next(dl)
            with ph.phase("step", step):
                if ctrl.poison_step(step):
                    metrics = step_fn(state, batch, poison=True)
                else:
                    metrics = step_fn(state, batch)
            with ph.phase("sync", step):
                # one device->host copy (and sync) for all of the metrics
                fmetrics = dict(zip(metrics, torch.stack(
                    list(metrics.values())).tolist()))
            step_seconds.append(time.perf_counter() - t0)
            if profiler.end(step):
                log_print(f"profiler trace -> {profiler.path}")
            if per_step is None and par is not None:
                per_step = {k: comm.collectives[k] - before[k]
                            for k in before}
                log_print("collectives per step (rank 0): "
                          + ", ".join(f"{k} {v}" for k, v in
                                      per_step.items()))
                walked = getattr(step_fn, "pipeline", None)
                if walked is not None:
                    pipeline = {"exchanges_per_step": walked.stats.exchanges,
                                "max_in_flight": walked.stats.max_in_flight,
                                "bubble_fraction":
                                    pipeline_bubble_fraction(cfg)}
                    log_print(f"pipeline (rank 0, stage "
                              f"{par.pp_rank}): {pipeline}")
            losses.append(fmetrics["loss"])
            trained_tokens += cfg.tokens_per_step
            if not watchdog.started:
                # Arm only after the first step completes: step 1 includes
                # the kernels' build and cuBLAS set-up.
                watchdog.start()

            if guard is not None:
                action, why = guard.observe(
                    step, fmetrics["loss"],
                    grad_norm=fmetrics.get("grad_norm"),
                    nonfinite=fmetrics.get("nonfinite"))
                if action is not GuardAction.OK:
                    tel.emit("guard", action=action.value, step=step,
                             why=why)
                if action is GuardAction.ABORT:
                    log_print(f"[guard {step:06d}] {why}; aborting "
                              f"(exit {EXIT_DIVERGED})")
                    if tel.flight is not None:
                        tel.flight.dump("divergence_abort", step=step,
                                        why=why)
                    exit_code = EXIT_DIVERGED
                    break
                if action is GuardAction.SKIP:
                    if "spike" in why:
                        log_print(f"[guard {step:06d}] {why}; quarantined "
                                  f"from the spike window (update already "
                                  f"applied — policy 'rollback' undoes it)")
                    else:
                        log_print(f"[guard {step:06d}] {why}; batch skipped "
                                  f"(update suppressed in-step, optimizer "
                                  f"state preserved)")
                elif action is GuardAction.ROLLBACK:
                    bad_step = step
                    if tel.flight is not None:
                        # before restoring: the window still holds the
                        # diverging steps, and _rollback can itself exit
                        tel.flight.dump("rollback", step=bad_step, why=why)
                    with ph.phase("rollback", step):
                        state, step, trained_tokens = _rollback(
                            ckpt_mgr, state, dl, step, trained_tokens, why)
                    # steps (restored, bad_step] now re-run at or below
                    # the ledger's high-water mark: booked as replay
                    tel.emit("rollback", step=bad_step, restored=step,
                             why=why)
                    saved_steps.add(step)
                    last_logged_step = step
                    window.lap()  # restart the throughput window
                    continue

            if step % cfg.logging.log_frequency == 0 or step == total_steps:
                extras = {k: v for k, v in fmetrics.items()
                          if k not in ("loss", "nonfinite")}
                # tokens/s over the window since the last logged step
                dt = max(window.lap(), 1e-9)
                tps = cfg.tokens_per_step * (step - last_logged_step) / dt
                last_logged_step = step
                mfu_frac = (mfu(tps, cfg.model, t.seq_length, world, peak)
                            if peak else 0.0)
                mem_gb = device_memory_gb(dev)
                # one record, every sink: stdout gets the preformatted
                # line byte for byte, the JSONL the structured fields
                tel.record_step(
                    step, training_log_line(
                        step, fmetrics["loss"], tps, tps / world, mfu_frac,
                        trained_tokens, mem_gb, extras=extras),
                    loss=fmetrics["loss"], tokens_per_sec=tps,
                    tokens_per_sec_per_chip=tps / world, mfu=mfu_frac,
                    trained_tokens=trained_tokens, memory_gb=mem_gb,
                    **extras)

            if eval_fn is not None and (step % t.eval_frequency == 0
                                        or step == total_steps):
                with ph.phase("eval", step):
                    val = (sum(float(eval_fn(state.model, b))
                               for b in eval_batches) / len(eval_batches))
                val_losses[step] = val
                tel.record_eval(step, val, f"[eval  {step:06d}] val_loss: "
                                f"{val:.4f} ({t.eval_steps} batches)")

            if ckpt_mgr is not None and step % ck.save_frequency == 0:
                with ph.phase("save", step):
                    path = ckpt_mgr.save(state, trained_tokens,
                                         dataloader_state=dl.state)
                saved_steps.add(step)
                log_print(f"saved checkpoint -> {path}")

            if on_step is not None:
                on_step(step, fmetrics)

            if _any_rank(preempt.triggered, par):
                # The in-flight step finished above; make it durable and
                # hand control back to the supervisor.
                with ph.phase("preempt-save", step):
                    ckpt_mgr = _emergency_checkpoint(
                        cfg, ckpt_mgr, state, trained_tokens, dl,
                        saved_steps)
                tel.emit("preempted", step=step)
                if tel.flight is not None:
                    tel.flight.dump("preempted", step=step)
                log_print(f"preempted at step {step}; state is durable — "
                          f"exiting {EXIT_PREEMPTED} for auto_resume")
                exit_code = EXIT_PREEMPTED
                break

        if exit_code is None and ckpt_mgr is not None \
                and state.step not in saved_steps:
            # Final save, unless this run already wrote this exact step.
            with ph.phase("save", state.step):
                ckpt_mgr.save(state, trained_tokens,
                              dataloader_state=dl.state)
    except SystemExit:
        raise  # deliberate exits (rollback without a checkpoint) dumped above
    except BaseException as e:  # noqa: BLE001
        # an unhandled crash leaves the last-K-steps window next to the
        # checkpoints before the teardown below runs
        if tel.flight is not None:
            tel.flight.dump("exception", step=step, error=repr(e))
        raise
    finally:
        # A crash must not leak the watchdog, the signal handlers, the
        # producer thread, a half-written async checkpoint, the chaos
        # controller or the bus; each cleanup is fenced so one failure
        # cannot mask the original exception.
        if watchdog is not None:
            watchdog.stop()
        if preempt is not None:
            preempt.uninstall()
        if profiler is not None and profiler.tracing:
            try:
                profiler.close(step)
                log_print(f"profiler trace -> {profiler.path}")
            except Exception as e:  # noqa: BLE001
                log_print(f"profiler stop failed during shutdown: {e!r}")
        if ckpt_mgr is not None:
            try:
                ckpt_mgr.wait_until_finished()
            except Exception as e:  # noqa: BLE001
                log_print(f"checkpoint finalization failed during "
                          f"shutdown: {e!r}")
        if dl is not None:
            dl.close()
        chaos.uninstall()
        # writes run_summary (ledger + metrics), exports the trace, closes
        # the JSONL stream and uninstalls the bus
        try:
            tel.close()
        except Exception as e:  # noqa: BLE001
            log_print(f"telemetry close failed during shutdown: {e!r}")
    if exit_code is not None:
        raise SystemExit(exit_code)
    return {"losses": losses, "step_seconds": step_seconds,
            "tokens_per_step": cfg.tokens_per_step,
            "peak_memory_gb": device_memory_gb(dev), "device": str(dev),
            "state": state, "val_losses": val_losses,
            "start_step": start_step, "restore_timings": restore_timings,
            "save_timings": dict(ckpt_mgr.timings) if ckpt_mgr else {},
            "world_size": world, "collectives_per_step": per_step,
            "pipeline": pipeline, "dataloader_state": dl.state,
            "telemetry_path": tel.jsonl_path, "trace_path": tel.trace_path,
            "profile_path": profiler.path}


def write_report(result: dict, path: str) -> None:
    """The run's numbers as one JSON object (rank 0 of a layout)."""
    report = {k: result[k] for k in (
        "losses", "step_seconds", "tokens_per_step", "peak_memory_gb",
        "device", "world_size", "collectives_per_step", "pipeline",
        "start_step", "restore_timings", "save_timings")}
    report["launches"] = {**fa.launches, **topt.launches}
    report["flash_variants"] = {"fwd": dict(fa.fwd_launches),
                                "dq": dict(fa.dq_launches),
                                "dkv": dict(fa.dkv_launches)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="picotron-tpu PyTorch trainer")
    ap.add_argument("--config", required=True, help="config JSON path")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--report", default=None,
                    help="write the run's numbers here as JSON (rank 0)")
    args = ap.parse_args(argv)
    launched = launcher_contract() is not None
    try:
        result = run(load_config(args.config), args.device)
        log_print("training done")
        if args.report and (not launched
                            or torch.distributed.get_rank() == 0):
            write_report(result, args.report)
    finally:
        if launched:
            shutdown()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
