"""The port's serving fleet (picotron_tpu_torch/serve/fleet.py) held to
what tests/test_fleet.py holds the JAX fleet to, on the CPU, fp32, the
JAX params transplanted (the fixtures of tests/test_torch_serve.py):

- sampled tokens (temperature 0.7) equal across fleet sizes 1, 2 and 3
  and to a single engine's; bit parity after a mid-flight `kill_engine`
  (plain and disaggregated replicas), 0 leaked blocks on survivors, the
  death and every re-dispatch on the stream; the last engine's death
  raises; chaos `engine_dead` in the route loop;
- deadline shedding deterministic on the virtual clock, invariant to
  submission order, and the shed ids (and the admitted greedy tokens)
  equal to the JAX fleet's on the same trace; `shed_storm`;
- drain with no leaks, grace expiry re-dispatching, the last routable
  engine refused; least-loaded routing; the speculator and MoE refused;
- ROADMAP Queue 3 item 7: a hung decode dispatch under the fleet's
  watchdog (and under `ServeEngine.run(watchdog_timeout=)`) leaves a
  flightdeck postmortem whose reason is `serve_hang`, its phase naming
  the engine and the dispatch;
- the chaos tool's serve scenarios: their checks over `tools.serve_bench`
  legs run in process (tier-1), and the scenarios themselves as child
  processes (marked slow, as the JAX package marks its own).
"""

import json
import time

import pytest

from picotron_tpu import config as jcfg
from picotron_tpu.serve import FleetSupervisor as JFleetSupervisor
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch.resilience import chaos, watchdog
from picotron_tpu_torch.serve import FleetSupervisor, ServeEngine
from picotron_tpu_torch.telemetry import Telemetry, bus
from picotron_tpu_torch.telemetry.flightdeck import FlightRecorder
from tests.test_torch_serve import (  # noqa: F401  (module fixtures)
    one_thread, requests5, tiny,
)

FLEET = dict(decode_slots=3, block_size=4, num_blocks=24, prefill_chunk=4,
             max_model_len=32, decode_interval=3)


@pytest.fixture(autouse=True)
def _chaos_hygiene(monkeypatch):
    monkeypatch.delenv("PICOTRON_CHAOS", raising=False)
    chaos.uninstall()
    yield
    chaos.uninstall()


def scfg(**kw):
    return tcfg.ServeConfig(**{**FLEET, **kw})


def make_fleet(model, n=2, cfg_kw=None, **kw):
    return FleetSupervisor(model, scfg(fleet_size=n, **(cfg_kw or {})),
                           temperature=0.7, seed=7, device="cpu", **kw)


def by_id(results) -> dict:
    return {r["id"]: r["tokens"] for r in results}


@pytest.fixture(scope="module")
def sampled_refs(tiny, requests5):
    """Per-request tokens of one plain ServeEngine at temperature 0.7:
    what every fleet (any size, any failover history) must reproduce bit
    for bit."""
    _, _, model = tiny
    eng = ServeEngine(model, scfg(), temperature=0.7, seed=7, device="cpu")
    res = eng.run(requests5)
    eng.close()
    return by_id(res)


class _Capture:
    """A telemetry sink keeping every event."""

    def __init__(self):
        self.events = []

    def emit(self, e):
        self.events.append(e)

    def close(self):
        pass

    def of(self, kind):
        return [e for e in self.events if e.get("kind") == kind]


# ---------------------------------------------------------------------------
# failover re-dispatch parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_engines", [1, 2, 3])
def test_fleet_token_parity_at_temperature(tiny, requests5, sampled_refs,
                                           n_engines):
    """Fleet size is invisible in the tokens: sampling is keyed by
    (seed, request id, token index), never by engine or slot."""
    _, _, model = tiny
    fl = make_fleet(model, n=n_engines)
    res = fl.run(requests5)
    assert by_id(res) == sampled_refs
    assert fl.leaked_blocks() == 0
    assert fl.summary["fleet_size"] == n_engines
    assert all(e.model is not model for e in fl.engines)  # own copies
    fl.close()


@pytest.mark.parametrize("disagg", [False, True], ids=["plain", "disagg"])
def test_midflight_kill_redispatches_with_bit_parity(tiny, requests5,
                                                     sampled_refs, disagg):
    """Kill 1 of 2 engines while requests are resident: the survivor
    finishes EVERYTHING, the continuations bit for bit the fault-free
    tokens, 0 blocks leaked on the survivor, the death and every
    re-dispatch on the stream."""
    _, _, model = tiny
    cap = _Capture()
    tel = Telemetry(sinks=[cap])
    fl = make_fleet(model, n=2, telemetry=tel, cfg_kw={"disagg": disagg})
    for p, n in requests5:
        fl.submit(p, n)
    fl.tick()
    sched = fl.engines[0].sched
    resident = sorted(s.req.id for s in [*sched.slots,
                                         *getattr(sched, "pslots", [])]
                      if s is not None)
    assert resident, "nothing resident on engine 0 after a tick"
    moved = fl.kill_engine(0, cause="test")
    assert moved >= len(resident)
    assert fl.alive == [False, True]
    while fl.has_work():
        fl.tick()
    fl._emit_summary(0.0)

    assert by_id(fl.results) == sampled_refs
    assert fl.leaked_blocks() == 0
    dead = cap.of("serve_engine_dead")
    assert len(dead) == 1
    assert dead[0]["engine"] == 0 and dead[0]["inflight"] == moved
    redis = cap.of("serve_redispatch")
    assert len(redis) == moved == fl.summary["redispatched"]
    assert {e["id"] for e in redis} >= set(resident)
    assert all(e["from_engine"] == 0 and e["to_engine"] == 1
               for e in redis)
    assert fl.summary["engines_dead"] == 1
    tel.close()


def test_kill_survivors_then_last_engine_raises(tiny, requests5):
    _, _, model = tiny
    fl = make_fleet(model, n=2)
    for p, n in requests5:
        fl.submit(p, n)
    fl.tick()
    fl.kill_engine(1)
    with pytest.raises(RuntimeError, match="no replicas survive"):
        fl.kill_engine(0)
    fl.close()


def test_chaos_engine_dead_in_route_loop(tiny, requests5, sampled_refs):
    chaos.install("engine_dead@2")
    _, _, model = tiny
    fl = make_fleet(model, n=2)
    res = fl.run(requests5)
    assert by_id(res) == sampled_refs
    assert fl.summary["engines_dead"] == 1
    assert fl.leaked_blocks() == 0
    fl.close()


# ---------------------------------------------------------------------------
# deadline shedding
# ---------------------------------------------------------------------------


def _shed_trace(requests5):
    """Staggered arrivals with a deadline tight enough that a 1-slot
    engine must shed the tail of the burst."""
    return [(p, n, 0.0 if i < 3 else 0.002, 1.0)
            for i, (p, n) in enumerate(requests5)]


def _shed_leg(model, trace, temperature=0.7):
    fl = FleetSupervisor(model, scfg(fleet_size=1, decode_slots=1,
                                     deadline_ms=1.0),
                         temperature=temperature, seed=7, tick_s=0.001,
                         device="cpu")
    res = fl.run(trace)
    out = (sorted(s["id"] for s in fl.all_shed), by_id(res),
           fl.leaked_blocks())
    fl.close()
    return out


def test_shed_is_deterministic_on_the_virtual_clock(tiny, requests5):
    _, _, model = tiny
    shed_a, res_a, leak_a = _shed_leg(model, _shed_trace(requests5))
    shed_b, res_b, leak_b = _shed_leg(model, _shed_trace(requests5))
    assert shed_a == shed_b and res_a == res_b
    assert shed_a, "trace shed nothing — the pin proves nothing"
    assert len(shed_a) + len(res_a) == len(requests5)
    assert not set(shed_a) & set(res_a)
    assert leak_a == leak_b == 0


def test_shed_ids_equal_the_jax_fleets(tiny, requests5):
    """Greedy, the same trace through the JAX fleet: the same requests
    shed, the admitted ones' tokens equal."""
    jmodel_cfg, jparams, model = tiny
    shed, res, _ = _shed_leg(model, _shed_trace(requests5), temperature=0.0)
    jfl = JFleetSupervisor(jparams, jmodel_cfg, jcfg.ServeConfig(
        **{**FLEET, "fleet_size": 1, "decode_slots": 1, "deadline_ms": 1.0}),
        temperature=0.0, seed=7, tick_s=0.001)
    jres = jfl.run(_shed_trace(requests5))
    assert shed == sorted(s["id"] for s in jfl.all_shed) and shed
    assert res == by_id(jres)
    jfl.close()


def test_shed_decision_is_submission_order_invariant(tiny, requests5,
                                                     sampled_refs):
    _, _, model = tiny
    trace = _shed_trace(requests5)

    def leg(order):
        fl = FleetSupervisor(model, scfg(fleet_size=1, decode_slots=1,
                                         deadline_ms=1.0),
                             temperature=0.7, seed=7, tick_s=0.001,
                             device="cpu")
        for i in order:
            p, n, arr, dl = trace[i]
            fl.submit(p, n, req_id=i, arrival=arr, deadline_ms=dl)
        while fl.has_work():
            fl.tick()
        out = (sorted(s["id"] for s in fl.all_shed), by_id(fl.results))
        fl.close()
        return out

    fwd = leg(range(len(trace)))
    rev = leg(range(len(trace) - 1, -1, -1))
    assert fwd == rev
    shed, res = fwd
    assert shed
    for rid, toks in res.items():
        assert toks == sampled_refs[rid], rid


def test_shed_storm_chaos_forces_sheds(tiny, requests5):
    chaos.install("shed_storm@2x2")
    _, _, model = tiny
    fl = make_fleet(model, n=2)
    res = fl.run(requests5)
    assert sorted(s["id"] for s in fl.shed_results) == [2, 3]
    assert all(s["shed"] for s in fl.shed_results)
    assert sorted(r["id"] for r in res) == [0, 1, 4]
    assert fl.summary["shed"] == 2
    fl.close()


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------


def test_drain_then_retire_leaves_no_residents_no_leaks(tiny, requests5,
                                                        sampled_refs):
    _, _, model = tiny
    cap = _Capture()
    tel = Telemetry(sinks=[cap])
    fl = make_fleet(model, n=2, telemetry=tel)
    for p, n in requests5:
        fl.submit(p, n)
    fl.tick()
    fl.drain(0)
    while fl.has_work() or fl.draining:
        fl.tick()
    fl._emit_summary(0.0)

    assert fl.drained == [0] and fl.alive == [False, True]
    eng = fl.engines[0]
    assert not eng.sched.has_work() and eng.pool.in_use == 0
    assert fl.leaked_blocks() == 0
    assert by_id(fl.results) == sampled_refs
    drains = cap.of("serve_drain")
    assert len(drains) == 1 and drains[0]["engine"] == 0
    assert drains[0]["pool_in_use"] == 0
    assert fl.summary["drains"] == 1
    tel.close()


def test_drain_grace_expiry_redispatches_residents(tiny, requests5):
    _, _, model = tiny
    fl = FleetSupervisor(model, scfg(fleet_size=2, drain_grace_s=0.0,
                                     decode_interval=1),
                         temperature=0.7, seed=7, tick_s=0.001,
                         device="cpu")
    for p, _ in requests5:
        fl.submit(p, 16)
    fl.tick()
    assert fl.engines[0].sched.has_work()
    fl.drain(0)
    for _ in range(50):
        fl.tick()
        if 0 in fl.drained:
            break
    assert 0 in fl.drained
    assert fl.engines[0].pool.in_use == 0
    assert fl.n_redispatched > 0
    while fl.has_work():
        fl.tick()
    assert len(fl.results) == len(requests5)
    assert fl.leaked_blocks() == 0
    fl.close()


def test_drain_last_routable_engine_rejected(tiny):
    _, _, model = tiny
    fl = make_fleet(model, n=2)
    fl.drain(0)
    with pytest.raises(ValueError, match="last routable"):
        fl.drain(1)
    fl.kill_engine(0)
    with pytest.raises(ValueError, match="not alive"):
        fl.drain(0)
    fl.close()


# ---------------------------------------------------------------------------
# routing, health, refusals
# ---------------------------------------------------------------------------


def test_routing_is_least_loaded(tiny, requests5):
    _, _, model = tiny
    fl = make_fleet(model, n=2)
    fl.run(requests5)
    per = [pe["requests"] for pe in fl.summary["per_engine"]]
    assert sum(per) == len(requests5)
    assert all(n > 0 for n in per), (
        f"least-loaded routing left an engine idle: {per}")
    fl.close()


def test_watchdog_names_hung_decode_dispatch(tiny, requests5, tmp_path):
    """ROADMAP Queue 3 item 7: a wedged decode dispatch (chaos
    decode_hang in the fleet loop) trips the fleet's watchdog with a
    phase naming the engine and the dispatch, and the flightdeck
    postmortem's reason is serve_hang. on_timeout stands in for the exit
    77 so that the test survives."""
    _, _, model = tiny
    tel = Telemetry(sinks=[])
    tel.flight = FlightRecorder(str(tmp_path), max_steps=4)
    bus.install(tel)
    chaos.install("decode_hang@0~1.2")
    fired = []
    try:
        fl = make_fleet(model, n=2, telemetry=tel, watchdog_timeout=0.3,
                        watchdog_on_timeout=lambda: fired.append(
                            fl.watchdog._last))
        assert fl.watchdog.reason == "serve_hang"
        fl.run(requests5)
    finally:
        bus.install(None)
    assert fired, "watchdog never fired on a 1.2s hang at 0.3s timeout"
    _, phase, _ = fired[0]
    assert phase.startswith("serve engine=") and "dispatch=decode" in phase
    pm = json.loads((tmp_path / "flightdeck_postmortem.json").read_text())
    assert pm["reason"] == "serve_hang"
    assert "dispatch=decode" in pm["extra"]["phase"]
    fl.close()


def test_engine_watchdog_reports_serve_hang(tiny, requests5, tmp_path,
                                            monkeypatch):
    """ROADMAP Queue 3 item 7 for the single engine:
    `ServeEngine.run(watchdog_timeout=)` arms its watchdog with reason
    serve_hang, so a hung decode dispatch leaves that postmortem (the
    watchdog's exit replaced by a record, as above)."""
    _, _, model = tiny
    fired, armed = [], []

    class Caught(watchdog.Watchdog):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            armed.append(self)
            self._on_timeout = lambda: fired.append(self._last)

    monkeypatch.setattr(watchdog, "Watchdog", Caught)
    tel = Telemetry(sinks=[])
    tel.flight = FlightRecorder(str(tmp_path), max_steps=4)
    bus.install(tel)
    eng = ServeEngine(model, scfg(), device="cpu", telemetry=tel)
    inner = eng._decode_fn

    def hang_once(*args, **kw):
        if not fired and eng.stats["decode_steps"] == 1:
            time.sleep(1.0)
        return inner(*args, **kw)

    eng._decode_fn = hang_once
    try:
        eng.run(requests5, watchdog_timeout=0.3)
    finally:
        bus.install(None)
    assert [w.reason for w in armed] == ["serve_hang"]
    assert fired and fired[0][1] == "serve engine=0 dispatch=decode"
    pm = json.loads((tmp_path / "flightdeck_postmortem.json").read_text())
    assert pm["reason"] == "serve_hang"
    eng.close()


def test_supervisor_refusals(tiny):
    _, _, model = tiny
    with pytest.raises(ValueError, match="speculator"):
        FleetSupervisor(model, scfg(fleet_size=2, speculator="ngram",
                                    draft_len=2), device="cpu")
    moe_cfg = tcfg.config_from_dict({"model": {"name": "debug-tiny-moe"}})
    from picotron_tpu_torch.models.llama import LlamaModel

    # refused by the replicas' engines, as in the JAX fleet
    with pytest.raises(ValueError, match="num_experts"):
        FleetSupervisor(LlamaModel(moe_cfg.model, device="cpu"),
                        scfg(fleet_size=2), device="cpu")
    with pytest.raises(ValueError, match="not on the fleet's device"):
        FleetSupervisor(model, scfg(fleet_size=2), device="meta")


# ---------------------------------------------------------------------------
# the chaos tool's serve scenarios
# ---------------------------------------------------------------------------


def test_serve_scenario_checks_in_process():
    """The serve_engine_dead and serve_overload checks over
    `tools.serve_bench` legs run in this process (the scenarios' child
    processes are the slow test below): fleet-of-1 digests equal after a
    kill mid-burst, and the overload's shed bookkeeping."""
    from picotron_tpu_torch.tools import chaos as chaos_tool
    from picotron_tpu_torch.tools import serve_bench

    def leg(**kw):
        args = dict(slots=3, block_size=4, num_blocks=0, prefill_chunk=4,
                    prompt_len=16, max_new=8, rate=0.0, temperature=0.7,
                    seed=7, device="cpu")
        return serve_bench.run_serve_fleet("debug-tiny", 0,
                                           **{**args, **kw})

    oracle = leg(fleet=1, n_requests=8)
    fault = leg(fleet=2, n_requests=8, chaos_spec="engine_dead@2")
    assert chaos_tool.check_engine_dead(oracle, fault, 8) is None
    assert fault["engines_dead"] == 1 and fault["redispatched"] >= 1
    assert fault["per_engine_requests"][0] == 0
    broken = dict(fault, request_digests=dict(
        fault["request_digests"], **{"3": "0" * 16}))
    assert "parity broken" in chaos_tool.check_engine_dead(oracle, broken, 8)

    over = dict(slots=1, n_requests=10)
    unloaded = leg(fleet=1, **over)
    shed = leg(fleet=1, deadline_ms=6.0, **over)
    again = leg(fleet=1, deadline_ms=6.0, **over)
    assert chaos_tool.check_overload(unloaded, shed, 10, 6.0) is None
    assert shed["shed_ids"] == again["shed_ids"] and shed["shed"] > 0
    assert shed["request_digests"] == again["request_digests"]
    assert set(shed["request_digests"]) | {
        str(i) for i in shed["shed_ids"]} == {str(i) for i in range(10)}
    assert "shed nothing" in chaos_tool.check_overload(
        unloaded, unloaded, 10, 6.0)


@pytest.mark.slow
def test_serve_chaos_scenarios_recover(tmp_path, capsys):
    from picotron_tpu_torch.tools import chaos as chaos_tool

    assert chaos_tool.main(["--scenario", "serve_engine_dead", "--scenario",
                            "serve_overload", "--device", "cpu",
                            "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "serve_engine_dead: OK" in out and "serve_overload: OK" in out
