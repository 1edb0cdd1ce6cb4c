"""The pipeline's schedule tables and the walk's mechanics, no process
group needed: the port's `parallel/mpmd.py` against the JAX package's
(`build_schedule` tick by tick over every kind, n_micro {1, 2, 4, 8}, pp
{1, 2, 4} and interleave 2; `schedule_stats` and
`pipeline_bubble_fraction`; the interleaved chunk placement of
`_stage_blocks` and `pp_layer_placement`), the spmd engines' tables
(`parallel/pp.engine_table`: the closed forms of the JAX `pp.py`), the
lint on planted bad tables, and `parallel/pp.walk` over stand-in stages
in a thread world (`chip_smoke.ThreadWorld`, one thread per stage): the
orphaned-buffer diagnostic, the watchdog's beat naming the live op, and
a SIGTERM mid-walk that drains to the step boundary."""

import dataclasses
import re
import signal
import threading
import time

import pytest
import torch

import chip_smoke
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.parallel import mpmd as tmpmd
from picotron_tpu_torch.parallel import pp as tpp
from picotron_tpu_torch.resilience.preemption import PreemptionHandler
from picotron_tpu_torch.resilience.watchdog import Watchdog

N_MICRO = (1, 2, 4, 8)
PP = (1, 2, 4)
CASES = [(kind, v) for kind in tmpmd.SCHEDULES
         for v in ((1, 2) if kind == "interleaved" else (1,))]


def _rows(table) -> list:
    return [(o.tick, o.group, o.op, o.mb, o.vstage) for o in table]


@pytest.mark.parametrize("pp", PP)
@pytest.mark.parametrize("n_micro", N_MICRO)
@pytest.mark.parametrize("kind,v", CASES)
def test_build_schedule_matches_jax_tick_by_tick(kind, v, n_micro, pp):
    from picotron_tpu.parallel import mpmd as jmpmd

    got = tmpmd.build_schedule(kind, n_micro, pp, v)
    assert _rows(got) == _rows(jmpmd.build_schedule(kind, n_micro, pp, v))
    assert tmpmd.lint_schedule(got, n_micro, pp, v, kind=kind) == []
    assert jmpmd.lint_schedule(got, n_micro, pp, v, kind=kind) == []


@pytest.mark.parametrize("pp", PP)
@pytest.mark.parametrize("n_micro", N_MICRO)
@pytest.mark.parametrize("kind,v", CASES + [("spmd", 1)])
def test_schedule_stats_match_jax(kind, v, n_micro, pp):
    from picotron_tpu.parallel import mpmd as jmpmd

    assert tmpmd.schedule_stats(kind, n_micro, pp, v) == \
        jmpmd.schedule_stats(kind, n_micro, pp, v)


MPMD = ({"executor": "mpmd"}, {"executor": "mpmd", "schedule": "gpipe"},
        {"executor": "mpmd", "schedule": "interleaved", "interleave": 2})


@pytest.mark.parametrize("pipeline,pp", [({}, 1), ({}, 2), ({}, 4)]
                         + [(p, pp) for p in MPMD for pp in (2, 4)])
def test_pipeline_bubble_fraction_matches_jax(pipeline, pp):
    from picotron_tpu import config as jcfg
    from picotron_tpu.parallel import mpmd as jmpmd

    raw = {"model": {"name": "debug-tiny", "num_hidden_layers": 8},
           "training": {"seq_length": 32, "gradient_accumulation_steps": 8},
           "distributed": {"pp_size": pp}, "pipeline": pipeline}
    got = tmpmd.pipeline_bubble_fraction(tcfg.config_from_dict(raw))
    assert got == jmpmd.pipeline_bubble_fraction(jcfg.config_from_dict(raw))
    assert (got == 0.0) == (pp == 1)


@pytest.mark.parametrize("layers,pp,v", [
    (4, 2, 1), (3, 2, 1), (5, 2, 1), (5, 3, 1), (7, 4, 1), (4, 2, 2),
    (8, 4, 2), (3, 2, 2), (6, 2, 3), (12, 4, 3)])
def test_stage_layers_match_the_jax_stage_blocks(layers, pp, v):
    """Virtual stage j's real layers: the rows of the JAX padded stack in
    `_stage_blocks`' block j that `pp_layer_placement` fills; its group
    is j % pp."""
    from picotron_tpu import config as jcfg
    from picotron_tpu.models.llama import pp_layer_placement
    from picotron_tpu.parallel import mpmd as jmpmd

    raw = {"model": {"name": "debug-tiny", "num_hidden_layers": layers},
           "training": {"seq_length": 32},
           "distributed": {"pp_size": pp},
           "pipeline": {"executor": "mpmd", "interleave": v,
                        "schedule": "interleaved" if v > 1 else "1f1b"}}
    padded, slots = pp_layer_placement(layers, pp)
    assert tllama.pp_layer_placement(layers, pp) == (padded, list(slots))
    layer_of = {int(s): i for i, s in enumerate(slots)}
    want = [[layer_of[r] for r in range(lo, hi) if r in layer_of]
            for lo, hi, _ in jmpmd._stage_blocks(jcfg.config_from_dict(raw))]
    got = tllama.stage_layers(layers, pp, v)
    assert got == want
    for k in range(pp):
        st = tllama.pipeline_stage(layers, pp, k, v)
        assert st.chunks == tuple(tuple(c) for c in got[k::pp])
        assert st.layers == sorted(i for c in got[k::pp] for i in c)
    if v == 1:
        # stage k: L // pp layers, plus one on the first L % pp stages
        assert [len(c) for c in got] == [layers // pp + (k < layers % pp)
                                         for k in range(pp)]


@pytest.mark.parametrize("engine", ["1f1b", "afab"])
@pytest.mark.parametrize("n_micro,pp", [(1, 2), (2, 4), (4, 2), (8, 4),
                                        (3, 3)])
def test_engine_tables_are_the_jax_closed_forms(engine, n_micro, pp):
    from picotron_tpu.parallel.pp import pp_1f1b_ring_slots, pp_1f1b_ticks

    assert tpp.pp_1f1b_ticks(n_micro, pp) == pp_1f1b_ticks(n_micro, pp)
    assert tpp.pp_1f1b_ring_slots(n_micro, pp) == \
        pp_1f1b_ring_slots(n_micro, pp)
    table = tpp.engine_table(engine, n_micro, pp)
    ticks = max(o.tick for o in table) + 1
    f = {(o.mb, o.vstage): o.tick for o in table if o.op == "F"}
    b = {(o.mb, o.vstage): o.tick for o in table if o.op == "B"}
    assert all(f[(m, s)] == m + s for m, s in f)
    if engine == "1f1b":
        assert ticks == pp_1f1b_ticks(n_micro, pp)
        assert all(b[(m, s)] == m + 2 * (pp - 1) - s for m, s in b)
    else:
        # the backwards of the n + pp - 1 forward ticks, in reverse
        assert ticks == 2 * (n_micro + pp - 1)
        assert all(b[(m, s)] == ticks - 1 - f[(m, s)] for m, s in b)
    assert len(f) == len(b) == n_micro * pp
    for o in table:
        assert o.group == o.vstage


def _planted(kind: str) -> list:
    table = tmpmd.build_schedule("1f1b", 4, 2)
    if kind == "b_before_f":
        i = next(i for i, o in enumerate(table)
                 if o.op == "B" and o.vstage == 1 and o.mb == 2)
        f = next(o for o in table if o.op == "F" and o.vstage == 1
                 and o.mb == 2)
        return table[:i] + [dataclasses.replace(table[i], tick=f.tick - 1)] \
            + table[i + 1:]
    if kind == "duplicated_op":
        i = next(i for i, o in enumerate(table) if o.op == "B")
        return table[:i + 1] + [dataclasses.replace(table[i], tick=99)] \
            + table[i + 1:]
    if kind == "missing_microbatch":
        return [o for o in table if o.mb != 1]
    raise ValueError(kind)


@pytest.mark.parametrize("kind,says", [
    ("b_before_f", "consumes saved-input (vstage=1, mb=2) never produced"),
    ("duplicated_op", "runs 2 times, not once"),
    ("missing_microbatch", "F (vstage=0, mb=1) runs 0 times, not once")])
def test_lint_catches_planted_bad_tables(kind, says):
    """A B before its F and a duplicated op also fail the JAX lint; a
    whole microbatch missing moves no buffer, which only the port's
    coverage rule sees."""
    from picotron_tpu.parallel import mpmd as jmpmd

    bad = _planted(kind)
    problems = tmpmd.lint_schedule(bad, 4, 2, kind="1f1b")
    assert any(says in p for p in problems), problems
    jax_problems = jmpmd.lint_schedule(bad, 4, 2, kind="1f1b")
    assert bool(jax_problems) == (kind != "missing_microbatch")


# ---------------------------------------------------------------------------
# the walk over stand-in stages
# ---------------------------------------------------------------------------


class FakeStage:
    """Stand-in ops: the first virtual stage makes [mb, mb], each later
    one adds 1, B returns ones; `on_op(stage, tick)` runs before each op
    (ops counted by kind)."""

    def __init__(self, V: int, on_op=None):
        self.V = V
        self.on_op = on_op
        self.ops = {"F": 0, "B": 0}
        self.sums = []

    def boundary(self):
        return (2,), torch.float32

    def forward(self, j, mb, x):
        self.ops["F"] += 1
        if self.on_op:
            self.on_op(self, j, mb)
        y = torch.full((2,), float(mb)) if j == 0 else x + 1
        if j == self.V - 1:
            self.sums.append((mb, y.tolist()))
            return (j, mb), None
        return (j, mb), y

    def backward(self, j, mb, graph, g):
        self.ops["B"] += 1
        if self.on_op:
            self.on_op(self, j, mb)
        assert graph == (j, mb)
        return None if j == 0 else torch.ones(2)


def fake_walk(table, pp: int, step=None, on_op=None) -> list:
    world = chip_smoke.ThreadWorld(pp, timeout=60)
    V = max(o.vstage for o in table) + 1
    stages = [FakeStage(V, on_op) for _ in range(pp)]

    def rank(r):
        stats = tpp.walk(table, r, stages[r], world.comm(r), step=step)
        return stages[r], stats

    return world.run(rank)


@pytest.mark.parametrize("kind,pp,v", [("1f1b", 2, 1), ("gpipe", 4, 1),
                                       ("interleaved", 2, 2)])
def test_walk_runs_every_op_once_and_moves_every_tensor(kind, pp, v):
    table = tpp._tick_order(tmpmd.build_schedule(kind, 4, pp, v))
    V = pp * v
    out = fake_walk(table, pp)
    for r, (stage, stats) in enumerate(out):
        assert stage.ops == {"F": 4 * v, "B": 4 * v}
        assert stats.exchanges > 0
    last = out[(V - 1) % pp][0]
    # microbatch m reaches the last virtual stage as m + (V - 1)
    assert sorted(last.sums) == [(m, [m + V - 1.0] * 2) for m in range(4)]


def test_walk_names_orphaned_buffers():
    """A truncated table (the final stage-0 backward dropped) leaves its
    cotangent and its graph live: the walk raises the named diagnostic
    listing exactly the orphaned (vstage, mb) keys."""
    table = tpp.engine_table("1f1b", 2, 2)
    fake_walk(table, 2)  # the full table walks clean
    drop = max(i for i, o in enumerate(table)
               if o.op == "B" and o.vstage == 0)
    mb = table[drop].mb
    with pytest.raises(AssertionError) as exc:
        fake_walk(table[:drop] + table[drop + 1:], 2)
    err = exc.value.__cause__
    assert isinstance(err, tmpmd.ScheduleBufferError)
    msg = str(err)
    assert "live boundary buffer" in msg
    assert f"cotangent (vstage=0, mb={mb})" in msg
    assert f"saved graph (vstage=0, mb={mb})" in msg


def test_watchdog_beat_names_the_live_schedule_op():
    w = Watchdog(timeout=60.0)
    w.start()
    try:
        phases = []
        fake_walk(tpp.engine_table("1f1b", 2, 2), 2, step=3,
                  on_op=lambda st, j, mb: phases.append(w._last))
        for _t, phase, step in phases:
            assert re.fullmatch(
                r"pp_schedule stage=\d+ tick=\d+ op=[FB] mb=\d+", phase), phase
            assert step == 3
        assert len(phases) == 2 * 2 * 2
    finally:
        w.stop()


def test_sigterm_mid_walk_drains_to_the_step_boundary():
    """A SIGTERM delivered mid-walk only sets the preemption flag: the
    walk goes on to its last op and every microbatch's forward and
    backward runs, so an emergency checkpoint after the step holds whole
    steps only."""
    table = tpp.engine_table("1f1b", 4, 2)
    main = threading.main_thread().ident
    seen = []

    with PreemptionHandler() as ph:
        def on_op(stage, j, mb):
            if j == 0 and stage.ops["F"] + stage.ops["B"] == 3:
                signal.pthread_kill(main, signal.SIGTERM)
                deadline = time.monotonic() + 10
                while not ph.triggered and time.monotonic() < deadline:
                    time.sleep(0.01)
                seen.append("sent")
            elif seen:
                seen.append(ph.triggered)

        out = fake_walk(table, 2, on_op=on_op)
        assert ph.triggered
    # flagged on rank 0's third op, and the walk went on to its end
    assert seen[0] == "sent" and len(seen) > 5 and all(seen[1:])
    for stage, _ in out:
        assert stage.ops == {"F": 4, "B": 4}
    assert sorted(out[1][0].sums) == [(m, [m + 1.0] * 2) for m in range(4)]
