"""The pipeline's schedule tables (port of the host-side half of
picotron_tpu/parallel/mpmd.py), pure host code.

The JAX package's MPMD executor compiles one program per stage and walks
a host-side table of `TickOp`s; its SPMD executor runs a lockstep scan.
In PyTorch one rank per stage runs its own ops in order, so both
executors are one thing here: `parallel/pp.py`'s walk of a table. This
module builds the tables of `pipeline.executor: "mpmd"` (`build_schedule`:
"1f1b", "gpipe" and "interleaved", and "zb" as a table only, as in the
JAX package), lints them (`lint_schedule`), and prices them
(`schedule_stats`, `pipeline_bubble_fraction`). Virtual stage j of
V = pp * interleave runs on pipeline rank j % pp (Megatron's round-robin
chunk placement; its layers: `models/llama.stage_layers`).
`ScheduleBufferError` is what the walk raises when a table leaves a
boundary buffer that nothing consumed. `stage_slice_placement` and
`check_stage_slice_placement` place the stages on the slices of a
multi-slice layout (the guard of a pp cut, run when a walk of an mpmd
table is built); the JAX `boundary_dcn_traffic` prices the crossing
exchanges through the cost model and waits for it (ROADMAP Queue 1
item 13).
"""

from __future__ import annotations

import dataclasses

# Executable schedules ("zb" is accounting only: its split backward has
# no walk op; the config refuses it as a pipeline.schedule value)
SCHEDULES = ("1f1b", "gpipe", "interleaved", "zb")


@dataclasses.dataclass(frozen=True)
class TickOp:
    """One scheduled unit: pipeline rank `group` runs `op` for microbatch
    `mb` of virtual stage `vstage` at tick `tick`. Ops: "F" forward, "B"
    backward, "BX"/"BW" the zero-bubble split (input-grad / weight-grad
    halves)."""

    tick: int
    group: int
    op: str
    mb: int
    vstage: int


class ScheduleBufferError(RuntimeError):
    """A schedule's walk (or its lint) found boundary buffers that a
    dispatched op produced and no later op consumed, or an op consuming
    one that nothing produced: always a table bug (truncated, or a
    broken dependency edge), named so the message lists exactly which
    (vstage, mb) keys were orphaned."""


def build_schedule(kind: str, n_micro: int, pp: int,
                   interleave: int = 1) -> list:
    """Greedy dependency-driven schedule table, sorted by (tick, group)
    (port of the JAX function: its docstring has the model).

    V = pp * interleave virtual stages, virtual stage j on group j % pp;
    each group runs at most one op per tick and every op costs one tick.
    F(m, j) needs F(m, j-1); B(m, j) needs F(m, j) and B(m, j+1); under
    "zb" BX carries B's dependencies and BW needs BX(m, j) only, at the
    lowest priority. "gpipe" runs any ready forward first; the others
    run ready backwards first, which gives 1f1b's warmup, steady state
    and cooldown and its 2n + 2(pp-1) tick makespan."""
    if kind not in SCHEDULES:
        raise ValueError(f"unknown schedule kind {kind!r}; one of {SCHEDULES}")
    if n_micro < 1 or pp < 1:
        raise ValueError(
            f"need n_micro >= 1 and pp >= 1, got {n_micro}/{pp}")
    v = interleave if kind == "interleaved" else 1
    if interleave != 1 and kind != "interleaved":
        raise ValueError(
            f"interleave={interleave} only applies to the 'interleaved' "
            f"schedule, got kind={kind!r}")
    if v < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    V = pp * v
    split_b = kind == "zb"

    f_done: dict = {}   # (mb, vstage) -> first tick the result is usable
    b_done: dict = {}   # combined B, or BX under the zb split
    w_done: dict = {}   # BW under the zb split
    ops: list = []
    total = n_micro * V * (3 if split_b else 2)
    t = 0
    max_ticks = 8 * total + 16  # generous; greedy always progresses
    while len(ops) < total and t < max_ticks:
        for g in range(pp):
            stages = range(g, V, pp)
            ready_f = [(m, j) for j in stages for m in range(n_micro)
                       if (m, j) not in f_done
                       and (j == 0 or f_done.get((m, j - 1), t + 1) <= t)]
            ready_b = [(m, j) for j in stages for m in range(n_micro)
                       if (m, j) not in b_done
                       and f_done.get((m, j), t + 1) <= t
                       and (j == V - 1 or b_done.get((m, j + 1), t + 1) <= t)]
            ready_w = [(m, j) for j in stages for m in range(n_micro)
                       if split_b and (m, j) not in w_done
                       and b_done.get((m, j), t + 1) <= t]
            # F tie-break: deepest virtual stage first under interleaving
            # (in-flight microbatches advance, so backwards fall ready)
            f_key = (lambda o: (-o[1], o[0])) if v > 1 else (
                lambda o: (o[0], o[1]))
            b_key = lambda o: (o[0], -o[1])  # noqa: E731 — FIFO microbatches
            pick = None
            if kind == "gpipe":
                if ready_f:
                    pick, kop = min(ready_f, key=f_key), "F"
                elif ready_b:
                    pick, kop = min(ready_b, key=b_key), "B"
            else:
                if ready_b:
                    pick, kop = min(ready_b, key=b_key), ("BX" if split_b
                                                          else "B")
                elif ready_f:
                    pick, kop = min(ready_f, key=f_key), "F"
                elif ready_w:
                    pick, kop = min(ready_w, key=b_key), "BW"
            if pick is None:
                continue
            m, j = pick
            ops.append(TickOp(tick=t, group=g, op=kop, mb=m, vstage=j))
            done = {"F": f_done, "B": b_done, "BX": b_done, "BW": w_done}[kop]
            done[(m, j)] = t + 1
        t += 1
    if len(ops) < total:
        raise RuntimeError(
            f"schedule simulator stalled at {len(ops)}/{total} ops "
            f"(kind={kind}, n={n_micro}, pp={pp}, v={interleave})")
    problems = lint_schedule(ops, n_micro, pp, interleave, kind=kind)
    if problems:
        raise ScheduleBufferError(
            f"schedule table fails the static lint (kind={kind}, "
            f"n={n_micro}, pp={pp}, v={interleave}): "
            f"{'; '.join(problems)}")
    return ops


def lint_schedule(table: list, n_micro: int, pp: int,
                  interleave: int = 1, kind: str = None) -> list:
    """Every problem of a table as a string (empty: clean), found by
    walking it with the walk's own produce/consume rules before any of
    it runs (port of the JAX function):

    - consume-before-produce: an op that takes an activation, cotangent
      or saved input that no earlier op made (a B before its F);
    - balanced produce/consume: buffers left live at the end (a
      truncated table);
    - bounded live set: the saved inputs per virtual stage at peak within
      the schedule's budget (n_micro for gpipe, else min(n_micro,
      2 * pp * v));
    - coverage (the port's addition): every microbatch runs F and B (or
      BX and BW under zb) exactly once at every virtual stage, so a table
      missing a whole microbatch, or repeating a first-stage forward that
      the buffer rules cannot see, is caught too.

    Ops sort by (tick, group); BX carries B's buffer rules and BW none.
    At V < 2 there are no boundary buffers, but coverage still holds."""
    v = interleave if interleave > 1 else 1
    V = pp * v
    problems: list = []
    split = kind == "zb"
    want = ("F", "BX", "BW") if split else ("F", "B")
    seen: dict = {}
    for op in table:
        key = (op.op, op.mb, op.vstage)
        seen[key] = seen.get(key, 0) + 1
    for op_name in want:
        for j in range(V):
            for m in range(n_micro):
                n = seen.pop((op_name, m, j), 0)
                if n != 1:
                    problems.append(f"{op_name} (vstage={j}, mb={m}) runs "
                                    f"{n} times, not once")
    for op_name, m, j in sorted(seen):
        problems.append(f"{op_name} (vstage={j}, mb={m}) is not an op of "
                        f"this schedule (n_micro={n_micro}, V={V})")
    if V < 2:
        return problems
    names = {"x": "activation", "s": "saved-input", "g": "cotangent"}
    live: dict = {}            # ("x"|"s"|"g", vstage, mb) -> True
    peak_saved: dict = {}      # vstage -> peak live saved inputs
    n_saved: dict = {}

    def produce(b, j, m):
        live[(b, j, m)] = True
        if b == "s":
            n_saved[j] = n_saved.get(j, 0) + 1
            peak_saved[j] = max(peak_saved.get(j, 0), n_saved[j])

    def consume(b, j, m, op):
        if not live.pop((b, j, m), None):
            problems.append(
                f"{op.op}@tick{op.tick} (vstage={op.vstage}, mb={op.mb}) "
                f"consumes {names[b]} (vstage={j}, mb={m}) never produced")
        elif b == "s":
            n_saved[j] -= 1

    for op in sorted(table, key=lambda o: (o.tick, o.group)):
        j, m = op.vstage, op.mb
        if op.op == "F":
            if j == 0:
                produce("x", j + 1, m)
            elif j == V - 1:
                consume("x", j, m, op)
                produce("s", j, m)
            else:
                consume("x", j, m, op)
                produce("s", j, m)
                produce("x", j + 1, m)
        elif op.op in ("B", "BX"):
            if j == V - 1:
                consume("s", j, m, op)
                produce("g", j - 1, m)
            elif j == 0:
                consume("g", j, m, op)
            else:
                consume("s", j, m, op)
                consume("g", j, m, op)
                produce("g", j - 1, m)
        # BW: the weight-grad half, touches no boundary buffer
    leftover = sorted(live)
    if leftover:
        keys = "; ".join(f"{names[b]} (vstage={j}, mb={m})"
                         for b, j, m in leftover)
        problems.append(
            f"{len(leftover)} live boundary buffer(s) at end of walk — "
            f"produced but never consumed: {keys}")
    budget = n_micro if kind == "gpipe" else min(n_micro, 2 * pp * v)
    for j, peak in sorted(peak_saved.items()):
        if peak > budget:
            problems.append(
                f"vstage {j} holds {peak} saved inputs at peak, over the "
                f"schedule's in-flight budget of {budget} — the table "
                f"defers backwards past the {kind or 'schedule'} "
                f"in-flight depth (activation OOM on hardware)")
    return problems


def schedule_stats(kind: str, n_micro: int, pp: int,
                   interleave: int = 1) -> dict:
    """Tick accounting in full units (one unit: one stage's forward and
    backward of one microbatch); port of the JAX function. "spmd" prices
    the lockstep scan closed-form (n + 2(pp-1) ticks, every tick a full
    unit); the others price the simulated table: makespan ticks over the
    ticks per unit (2v chunk ops, 3v under zb). busy is n_micro units,
    the bubble the rest."""
    if kind == "spmd":
        makespan = float(n_micro + 2 * (pp - 1))
        return {
            "kind": kind, "n_micro": n_micro, "pp": pp, "interleave": 1,
            "ticks": n_micro + 2 * (pp - 1), "makespan_units": makespan,
            "busy_units": float(n_micro),
            "bubble_units": float(2 * (pp - 1)),
            "bubble_fraction": 2 * (pp - 1) / makespan if makespan else 0.0,
        }
    table = build_schedule(kind, n_micro, pp, interleave)
    v = interleave if kind == "interleaved" else 1
    ticks = max(op.tick for op in table) + 1
    per_unit = (3 if kind == "zb" else 2) * v
    makespan = ticks / per_unit
    bubble = makespan - n_micro
    return {
        "kind": kind, "n_micro": n_micro, "pp": pp, "interleave": interleave,
        "ticks": ticks, "makespan_units": makespan,
        "busy_units": float(n_micro), "bubble_units": bubble,
        "bubble_fraction": bubble / makespan if makespan else 0.0,
    }


def pipeline_bubble_fraction(cfg) -> float:
    """The schedule's idle fraction of a step for this config (0.0 at
    pp 1): the spmd executor's full-price accounting, or the mpmd
    table's."""
    pp = cfg.distributed.pp_size
    if pp <= 1:
        return 0.0
    n = cfg.training.gradient_accumulation_steps
    kind = ("spmd" if cfg.pipeline.executor == "spmd"
            else cfg.pipeline.schedule)
    return schedule_stats(kind, n, pp, cfg.pipeline.interleave)[
        "bubble_fraction"]


# ---------------------------------------------------------------------------
# placement of the stages on the slices
# ---------------------------------------------------------------------------


def slice_of(rank: int, sizes: tuple, dcn_shape: tuple) -> int:
    """The slice of a rank of the row-major (dp, pp, ep, cp, tp) grid
    `sizes`: the granule (outermost) coordinate of each axis the slices
    split (`dcn_shape`, `mesh._split_axes_over_dcn`), row-major (the JAX
    `SliceTopology.slice_of`)."""
    coords, rem = [], rank
    for n in reversed(sizes):
        coords.append(rem % n)
        rem //= n
    idx = 0
    for c, g, n in zip(reversed(coords), dcn_shape, sizes):
        idx = idx * g + c // (n // g)
    return idx


def _slice_layout(cfg) -> tuple:
    from picotron_tpu_torch.mesh import _split_axes_over_dcn

    d = cfg.distributed
    grid = (d.dp_size, d.pp_size, d.ep_size, d.cp_size, d.tp_size)
    dcn = (_split_axes_over_dcn(grid, d.slices)[0] if d.slices > 1
           else (1,) * len(grid))
    return grid, dcn


def stage_slice_placement(cfg) -> list:
    """The slice each pipeline stage's ranks live on, None for a stage
    whose ranks span slices (port of the JAX function of this name). When
    pp alone carries the slice granule every stage lies on one slice, and
    the stage boundaries' exchanges are the only traffic across the
    cut."""
    import numpy as np

    grid, dcn = _slice_layout(cfg)
    ranks = np.arange(int(np.prod(grid))).reshape(grid)
    out = []
    for g in range(cfg.distributed.pp_size):
        slices = {slice_of(int(r), grid, dcn) for r in ranks[:, g].ravel()}
        out.append(slices.pop() if len(slices) == 1 else None)
    return out


def check_stage_slice_placement(cfg) -> list:
    """Raise unless every stage lies whole on one slice when pp alone
    carries the slice cut (a dp cut spans every stage over the slices
    legitimately: the hierarchical dp reduction handles it). Returns the
    placement (the JAX function of this name)."""
    placement = stage_slice_placement(cfg)
    grid, dcn = _slice_layout(cfg)
    cut = tuple(a for a, g in zip(("dp", "pp", "ep", "cp", "tp"), dcn)
                if g > 1)
    if cfg.distributed.slices > 1 and cut == ("pp",):
        bad = [g for g, s in enumerate(placement) if s is None]
        if bad:
            raise RuntimeError(
                f"mpmd stage placement violates the slice cut: device "
                f"group(s) {bad} span multiple slices although pp alone "
                f"carries the {cfg.distributed.slices}-slice granule — "
                f"stage programs would run ICI collectives over DCN. The "
                f"mesh grid no longer matches mesh._split_axes_over_dcn's "
                f"house rule; this is a bug, not a layout choice.")
    return placement
