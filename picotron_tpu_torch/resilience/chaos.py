"""Deterministic fault injection: every recovery path testable on the CPU
(the port's copy of picotron_tpu/resilience/chaos.py).

A chaos spec is a comma-separated list of events, each

    KIND@STEP[xCOUNT][~SECS][#TICK]

- ``KIND``: one of ``sigterm`` / ``sigint`` (deliver that signal to this
  process at the start of step STEP: exercises the real preemption
  handler), ``kill`` (SIGKILL at the start of step STEP: a hard crash, no
  handler, no emergency checkpoint; exercises a supervisor's restart from
  whatever is durable), ``slice_lost`` (SIGKILL at the start of step STEP,
  logged as the loss of this process's slice: every process of the slice
  dies at once and the job cannot come back at the old shape), ``hang``
  (sleep SECS in the step loop at step STEP), ``ckpt_io`` (raise OSError
  from the next COUNT checkpoint-save attempts at step STEP: exercises the
  save retry), ``data_io`` (the same for the next COUNT batch-assembly
  attempts at *batch* STEP), ``data_stall`` (sleep SECS while producing
  batch STEP: exercises the watchdog), ``nan_grad`` (poison the gradients
  and loss of COUNT step executions starting at the first execution of
  step STEP; a budget, so that a guard-rollback re-run of the same step
  number does not re-fire; exercises the divergence guard; injected inside
  the step by ``train_step.make_train_step``'s ``poison=True``), and
  the corruption kinds ``ckpt_corrupt_bitflip`` / ``ckpt_truncate`` /
  ``ckpt_torn_meta`` (mutate the checkpoint COMMITTED at step STEP on
  disk: flip a byte in the largest tensor payload under ``state/``,
  truncate it to half, or tear meta.json; exercising manifest
  verification and the lineage fallback of
  ``checkpoint.CheckpointManager.latest_valid_step``).
- ``xCOUNT`` defaults to 1; ``~SECS`` defaults to 0 and is required for the
  sleep kinds.
- ``#TICK`` (signal and sleep kinds only) moves the event INSIDE the
  pipeline's schedule walk: instead of firing at the start of step STEP,
  it fires at the named tick of that step's walk, the ``schedule_tick``
  point that ``parallel/pp.walk`` calls per op of an mpmd table
  (``pipeline.executor == "mpmd"``; the spmd engines have no ticks in the
  JAX package, so their walks do not fire it), with the live (stage,
  tick, op, mb) as context. An event without ``#TICK`` never fires there,
  and a ``#TICK`` event never fires at step_begin.

Serving faults key on the REQUEST id instead of the step number (the JAX
serve fleet fires them with the request id in the STEP position: same
grammar, different clock): ``engine_dead@REQ`` (the engine request REQ is
routed to, or decoding on, dies abruptly: `ChaosEngineDead`),
``decode_hang@REQ~SECS`` (sleep SECS inside the decode dispatch while
request REQ is resident), and ``shed_storm@REQ`` (force the deadline shed
of request REQ, and with ``xCOUNT`` of the next COUNT routed requests:
`ChaosShed`). The fleet (serve/fleet.py) fires them; in a training run
they parse and never fire, as in the JAX package.

Examples: ``sigterm@3``, ``ckpt_io@2x2,nan_grad@4``, ``data_stall@3~10``,
``ckpt_corrupt_bitflip@4,kill@5``, ``sigterm@3#2`` (mid-schedule),
``hang@4~120#1``, ``engine_dead@4``, ``decode_hang@2~5``,
``shed_storm@6x3``.

The spec comes from ``resilience.chaos`` in the config; the
``PICOTRON_CHAOS`` environment variable, when set (even to the empty
string), overrides it: that is how a supervisor restarts a chaos run
without the fault recurring. Events key on the step/batch *number*, so
injection is deterministic and identical across processes of a multi-host
run (every process self-delivers its SIGTERM at the same step, the way a
real preemption hits every host of a pod at once).

Injection points call `fire(point, step)`; an inactive controller (the
default) makes those calls free, so library code carries the hooks
unconditionally. The points of the port: ``step_begin`` (train.py),
``schedule_tick`` (parallel/pp.walk), ``ckpt_save`` and ``ckpt_committed``
(checkpoint.py), ``data_produce`` (data.py); ``nan_grad`` is read through
``poison_step``.
"""

from __future__ import annotations

import os
import re
import signal
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

KINDS = ("sigterm", "sigint", "kill", "slice_lost", "hang", "ckpt_io",
         "data_io", "data_stall", "nan_grad", "ckpt_corrupt_bitflip",
         "ckpt_truncate", "ckpt_torn_meta",
         "engine_dead", "decode_hang", "shed_storm")


class ChaosEngineDead(Exception):
    """Raised by fire() at a serve point for `engine_dead`: the engine
    handling this request dies abruptly. The FleetSupervisor catches it,
    discards the engine's state wholesale (pool and all — nothing
    graceful, the SIGKILL analogue for an in-process replica) and
    re-dispatches its residents; anything else letting it propagate is a
    bug, which is exactly what the chaos run would surface."""

    def __init__(self, engine=None):
        super().__init__(f"chaos: engine {engine} dead")
        self.engine = engine


class ChaosShed(Exception):
    """Raised by fire() at the serve_route point for `shed_storm`: the
    supervisor must shed this request as if its deadline were already
    blown — the deterministic stand-in for a burst arriving faster than
    admission can drain."""

# Which event kinds an injection point can trigger. "nan_grad" has no fire
# point: the driver asks poison_step() and routes those steps through the
# poisoned step instead. "ckpt_committed" fires from CheckpointManager's
# commit (manifest written, rank 0) with the step dir as context: the
# corruption kinds mutate a checkpoint the store considers good.
_POINT_KINDS = {
    # slice_lost is step_begin-only: a slice dies between steps from the
    # surviving scheduler's viewpoint; mid-schedule slice death is the
    # #TICK kill (the walk cannot tell which process vanished)
    "step_begin": ("sigterm", "sigint", "kill", "slice_lost", "hang"),
    # inside the pipeline's walk of an mpmd table (parallel/pp.walk), one
    # call per op with ctx (tick, stage, op, mb); only #TICK events fire
    # here
    "schedule_tick": ("sigterm", "sigint", "kill", "hang"),
    "ckpt_save": ("ckpt_io",),
    "data_produce": ("data_io", "data_stall"),
    "ckpt_committed": ("ckpt_corrupt_bitflip", "ckpt_truncate",
                       "ckpt_torn_meta"),
    # serve points fire with a REQUEST id in the step position (the
    # serving clock is requests, not steps). serve_route: the fleet is
    # routing request REQ to an engine (ctx: engine). serve_dispatch:
    # an engine is about to run a decode dispatch with request REQ
    # resident (ctx: engine) — the point a hang must hit for the
    # watchdog to name the dispatch.
    "serve_route": ("engine_dead", "shed_storm"),
    "serve_dispatch": ("engine_dead", "decode_hang"),
}

# Kinds that may carry a #TICK suffix (the schedule_tick-capable set).
_TICK_KINDS = ("sigterm", "sigint", "kill", "hang")

_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<step>\d+)"
    r"(?:x(?P<count>\d+))?(?:~(?P<secs>\d+(?:\.\d+)?))?"
    r"(?:#(?P<tick>\d+))?$")


@dataclass
class ChaosEvent:
    kind: str
    step: int          # 1-based training step (or batch number for data_*)
    count: int = 1     # xN: firings before the event is exhausted
    secs: float = 0.0  # ~S: sleep duration for hang / data_stall
    tick: Optional[int] = None  # #T: fire at this schedule tick
    fired: int = field(default=0, compare=False)


def parse_spec(spec: str) -> list[ChaosEvent]:
    """Parse a chaos spec; raises ValueError naming the bad event."""
    events = []
    for item in (spec or "").replace(" ", "").split(","):
        if not item:
            continue
        m = _EVENT_RE.match(item)
        if not m:
            raise ValueError(
                f"bad chaos event {item!r}: expected "
                f"KIND@STEP[xCOUNT][~SECS][#TICK] with KIND in {KINDS}")
        kind = m.group("kind")
        if kind not in KINDS:
            raise ValueError(
                f"unknown chaos kind {kind!r} in {item!r}; known: {KINDS}")
        secs = float(m.group("secs") or 0.0)
        if kind in ("hang", "data_stall", "decode_hang") and secs <= 0:
            raise ValueError(
                f"chaos event {item!r} needs a ~SECS duration (e.g. "
                f"{kind}@{m.group('step')}~5)")
        tick = m.group("tick")
        if tick is not None and kind not in _TICK_KINDS:
            raise ValueError(
                f"chaos event {item!r}: #TICK (mid-schedule injection) "
                f"only applies to {_TICK_KINDS}, not {kind!r}")
        events.append(ChaosEvent(kind=kind, step=int(m.group("step")),
                                 count=int(m.group("count") or 1), secs=secs,
                                 tick=int(tick) if tick is not None
                                 else None))
    return events


def _log(msg: str) -> None:
    # stderr, every process: chaos firings must be visible even from
    # non-logging hosts (they are the whole point of a chaos run).
    print(f"[chaos] {msg}", file=sys.stderr, flush=True)


def _emit(e: "ChaosEvent", point: str, step: int, **ctx) -> None:
    # Record-only telemetry (no category: the injected fault's COST is
    # booked by whatever it disrupts — the stalled data phase, the retry
    # backoff, the rollback — so booking the injection too would
    # double-count). The event ties the booked badput to its cause in
    # the JSONL stream; schedule_tick firings carry the live
    # (stage, tick, op, mb) so a mid-schedule fault is addressable.
    from picotron_tpu_torch.telemetry import bus

    bus.emit("chaos", chaos_kind=e.kind, point=point, step=step,
             fired=e.fired, count=e.count, **ctx)


class ChaosController:
    def __init__(self, events: list[ChaosEvent]):
        self.events = list(events)

    @property
    def active(self) -> bool:
        return bool(self.events)

    def describe(self) -> str:
        return ", ".join(
            f"{e.kind}@{e.step}" + (f"x{e.count}" if e.count > 1 else "")
            + (f"~{e.secs:g}" if e.secs else "")
            + (f"#{e.tick}" if e.tick is not None else "")
            for e in self.events)

    def has_tick_events(self) -> bool:
        """True when any event targets a schedule tick."""
        return any(e.tick is not None for e in self.events)

    def has_nan_grad(self) -> bool:
        """True when the spec names any nan_grad event (the JAX trainer
        then builds its poisoned step twin; the port's step takes
        `poison=True` per call)."""
        return any(e.kind == "nan_grad" for e in self.events)

    def poison_step(self, step: int) -> bool:
        """Should this step execution run with poisoned gradients?
        nan_grad@S xN fires on the first N step *executions* starting at
        the first execution of step S — a budget, not a step predicate:
        after a guard rollback re-runs step S (on the post-poison data the
        rollback skipped to), an exhausted event must not re-fire, or the
        run would re-live the same divergence forever."""
        for e in self.events:
            if e.kind != "nan_grad" or e.fired >= e.count:
                continue
            if e.fired > 0 or step == e.step:
                e.fired += 1
                _log(f"poisoning gradients at step {step} "
                     f"({e.fired}/{e.count})")
                _emit(e, "poison_step", step)
                return True
        return False

    def fire(self, point: str, step: int, **ctx) -> None:
        """Trigger any event bound to `point` whose step matches and whose
        firing budget is not exhausted. May sleep, raise OSError, deliver
        a signal to this process, or corrupt committed bytes on disk
        (`ctx["path"]` carries the checkpoint step dir for the
        ckpt_committed point). A #TICK event fires ONLY at the
        schedule_tick point when `ctx["tick"]` matches; an event without
        a tick never fires there — the two injection sites are disjoint
        by construction."""
        for e in self.events:
            if (e.kind not in _POINT_KINDS.get(point, ())
                    or e.fired >= e.count):
                continue
            if e.kind == "shed_storm":
                # a STORM: fires on request REQ, then keeps firing on
                # every subsequently routed request until its xCOUNT
                # budget drains (the nan_grad budget arrangement) — one
                # event sheds a contiguous run of arrivals.
                if e.fired == 0 and e.step != step:
                    continue
            elif e.step != step:
                continue
            if point == "schedule_tick":
                if e.tick is None or ctx.get("tick") != e.tick:
                    continue
            elif e.tick is not None:
                continue
            e.fired += 1
            where = (f" (stage={ctx.get('stage')} tick={ctx.get('tick')} "
                     f"op={ctx.get('op')} mb={ctx.get('mb')})"
                     if point == "schedule_tick" else
                     (f" (engine={ctx.get('engine')})"
                      if point.startswith("serve_") else ""))
            unit = "request" if point.startswith("serve_") else "step"
            _log(f"firing {e.kind} at {point} {unit} {step}{where} "
                 f"({e.fired}/{e.count})")
            _emit(e, point, step,
                  **{k: v for k, v in ctx.items()
                     if k in ("tick", "stage", "op", "mb", "engine")})
            if e.kind == "engine_dead":
                raise ChaosEngineDead(ctx.get("engine"))
            if e.kind == "shed_storm":
                raise ChaosShed(f"chaos: shed_storm at request {step}")
            if e.kind == "decode_hang":
                time.sleep(e.secs)
                continue
            if e.kind in ("sigterm", "sigint"):
                os.kill(os.getpid(),
                        signal.SIGTERM if e.kind == "sigterm"
                        else signal.SIGINT)
            elif e.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif e.kind == "slice_lost":
                # whole-slice death: every process of the slice vanishes
                # at once, ungracefully. Self-delivered SIGKILL per
                # process (deterministic across the pod, like the signal
                # kinds); the log names the slice this process sits on so
                # a multi-host transcript reads as one slice going dark.
                from picotron_tpu_torch.telemetry import process_index

                proc = process_index()
                _log(f"slice_lost: the slice hosting process {proc} is "
                     f"gone (SIGKILL, no emergency checkpoint) — the job "
                     f"cannot restart at this slice count")
                os.kill(os.getpid(), signal.SIGKILL)
            elif e.kind in ("hang", "data_stall"):
                time.sleep(e.secs)
            elif e.kind in _CORRUPTIONS:
                _CORRUPTIONS[e.kind](ctx["path"])
            else:  # ckpt_io / data_io
                raise OSError(
                    f"chaos-injected {e.kind} failure at {point} "
                    f"step {step} ({e.fired}/{e.count})")


# ---------------------------------------------------------------------------
# Checkpoint corruption — the silent-data-corruption failure class. Each
# mutates a COMMITTED step dir (manifest already written, store considers
# it good), so recovery must come from verification + lineage fallback,
# not the commit protocol. Deterministic targets: the largest payload file
# is the same on every run of the same config.
# ---------------------------------------------------------------------------


def _largest_payload(step_dir: str) -> str:
    """Biggest file under the step's `state` dir: in the port's layout a
    torch payload (`opt_state.pt`, or a rank's file under a layout), the
    realistic bit-rot victim."""
    best, best_size = None, -1
    for root, _dirs, files in os.walk(os.path.join(step_dir, "state")):
        for f in files:
            p = os.path.join(root, f)
            size = os.path.getsize(p)
            if size > best_size:
                best, best_size = p, size
    if best is None:
        raise FileNotFoundError(f"no state payload files under {step_dir}")
    return best


def _corrupt_bitflip(step_dir: str) -> None:
    p = _largest_payload(step_dir)
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    _log(f"flipped a byte mid-file in {p}")


def _corrupt_truncate(step_dir: str) -> None:
    p = _largest_payload(step_dir)
    os.truncate(p, os.path.getsize(p) // 2)
    _log(f"truncated {p} to half")


def _corrupt_torn_meta(step_dir: str) -> None:
    p = os.path.join(step_dir, "meta.json")
    with open(p, "rb") as f:
        data = f.read()
    with open(p, "wb") as f:
        f.write(data[:max(1, len(data) // 2)])
    _log(f"tore {p} (half-written JSON)")


_CORRUPTIONS = {
    "ckpt_corrupt_bitflip": _corrupt_bitflip,
    "ckpt_truncate": _corrupt_truncate,
    "ckpt_torn_meta": _corrupt_torn_meta,
}


# Module-level controller: library injection points (checkpoint.py,
# data.py, parallel/pp.py) reach chaos without any plumbing; train.run
# installs per run.
_controller = ChaosController([])


def install(spec: str = "") -> ChaosController:
    """Activate chaos for this process. `spec` is the config's
    resilience.chaos; PICOTRON_CHAOS, when set, wins (empty value =
    disable — the supervisor-restart story)."""
    env = os.environ.get("PICOTRON_CHAOS")
    if env is not None:
        spec = env
    global _controller
    _controller = ChaosController(parse_spec(spec))
    return _controller


def uninstall() -> None:
    """Back to the inactive controller (the trainer's teardown: a run's
    spec must not fire in a later run of the same process)."""
    global _controller
    _controller = ChaosController([])


def controller() -> ChaosController:
    return _controller


def fire(point: str, step: int, **ctx) -> None:
    _controller.fire(point, step, **ctx)
