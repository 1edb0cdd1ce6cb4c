"""Fleet serving: a supervisor fronting N engine replicas, built
robustness-first (port of picotron_tpu/serve/fleet.py): engine death,
hung dispatches and overload bursts are routine, chaos-tested events,
not crashes.

`FleetSupervisor` owns N `ServeEngine` / `DisaggServeEngine` replicas
(`serve.fleet_size`, `serve.disagg`). Replica k lives on device k %
(visible devices), under disagg its decode pool on 2k and its prefill
pool on 2k + 1 (mod the same count), with its own copy of the model made
on that device, its own KV pool, and the SAME sampling seed: killing a
replica discards state no survivor shares. On one card every replica
and pool sits on cuda:0. Requests flow through a fleet-global FIFO:
arrivals route to the least-loaded live engine; after that the
single-engine machinery runs unchanged.

Four robustness mechanisms, over the scheduler's invariants:

- **Health and hang detection.** Every dispatch heartbeats the
  `resilience/watchdog.py` machinery with a phase naming the live
  ``serve engine=K dispatch=decode|prefill``, so a hung dispatch is
  reported as THAT dispatch. The supervisor arms its own watchdog
  (``watchdog_timeout``) with postmortem reason ``serve_hang``: a stall
  dumps the flightdeck window and exits 77 for the supervisor wrapper,
  as a wedged training step does.
- **Failover re-dispatch.** `kill_engine(k)` (or the chaos kind
  ``engine_dead@REQ``) marks a replica dead ABRUPTLY: its pool, cache
  and model are discarded wholesale, the in-process analogue of
  SIGKILLing the replica. Its in-flight requests (generated tokens
  intact) requeue at the FRONT of the survivors' queues and recompute
  through the preemption path. Sampling is keyed by (seed, request id,
  token index), so the re-dispatched continuation equals a fault-free
  run's at any temperature, bit for bit. Survivor pools must show zero
  leaked blocks.
- **Deadline admission and load shedding.** Requests carry
  `deadline_ms` (or inherit `serve.deadline_ms`); a request still queued
  when its wait exceeds the deadline is SHED at the admission attempt:
  rejected, a `serve_shed` event, its queue seconds booked to the `shed`
  ledger category (badput). The decision runs on the fleet's VIRTUAL
  trace clock (`tick_s` per fleet iteration), so the shed set is a
  deterministic function of the trace.
- **Graceful drain.** `drain(k)` stops routing to one engine, lets its
  residents finish (bounded by `serve.drain_grace_s` on the trace clock,
  after which they are re-dispatched to survivors), then retires it with
  a `serve_drain` event and an empty pool: the redeploy and autoscale
  primitive.

Chaos: the fleet loop fires the request-indexed points ``serve_route``
(per routed request: ``engine_dead@REQ``, ``shed_storm@REQ``) and
``serve_dispatch`` (per resident request per decode dispatch:
``engine_dead@REQ``, ``decode_hang@REQ~SECS``); `python -m
picotron_tpu_torch.tools.chaos --scenario serve_engine_dead /
serve_overload` drive the end-to-end recovery scenarios through
`tools.serve_bench --fleet N --chaos`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from picotron_tpu_torch.config import ServeConfig
from picotron_tpu_torch.generate import model_device
from picotron_tpu_torch.resilience import chaos, watchdog
from picotron_tpu_torch.serve.disagg import DisaggServeEngine, model_copy
from picotron_tpu_torch.serve.engine import ServeEngine
from picotron_tpu_torch.serve.scheduler import Request
from picotron_tpu_torch.telemetry import Telemetry
from picotron_tpu_torch.utils import cuda_or_cpu


class FleetSupervisor:
    """Route requests across N engine replicas; survive the loss of
    N - 1 of them. Drives engines through their public step() with a
    virtual trace clock (`tick_s` seconds per fleet iteration), so every
    routing, shedding and failover decision is a deterministic function
    of the trace. `device` names the device type (default cuda, which
    must exist), as for `ServeEngine`."""

    def __init__(self, model, serve_cfg: Optional[ServeConfig] = None, *,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 telemetry: Optional[Telemetry] = None,
                 tick_s: float = 0.001, watchdog_timeout: float = 0.0,
                 watchdog_on_timeout=None, device=None):
        scfg = serve_cfg or ServeConfig()
        scfg.validate()
        if scfg.speculator != "off":
            raise ValueError(
                "serve.fleet_size > 1 does not support speculative decode "
                "(serve.speculator != 'off'): the drafter's context is "
                "engine-local and is not carried across failover "
                "re-dispatch; set serve.speculator='off' or "
                "serve.fleet_size=1")
        dev_type = cuda_or_cpu("cuda" if device is None
                               else str(device)).type
        if model_device(model).type != dev_type:
            raise ValueError(f"the model is on {model_device(model)}, not "
                             f"on the fleet's device type {dev_type}")
        self.scfg = scfg
        self.n = max(int(scfg.fleet_size), 1)
        self.tick_s = float(tick_s)

        self._owns_telemetry = telemetry is None
        self.telemetry = telemetry or Telemetry(sinks=[])

        # Replica k lives wholly on device k % count (under disagg, its
        # pools on 2k and 2k + 1), with a model copy of its own there, so
        # "discard the engine" is a statement about device state. A tp
        # rank's model is shared by every replica on the rank's device
        # (the JAX "mesh" case): the fleet still routes, only the
        # physical separation goes.
        count = torch.cuda.device_count() if dev_type == "cuda" else 1

        def on(idx: int):
            return (torch.device("cpu") if dev_type == "cpu"
                    else torch.device("cuda", idx % count))

        kw = dict(eos_token_id=eos_token_id, temperature=temperature,
                  top_k=top_k, seed=seed, telemetry=self.telemetry,
                  device=dev_type)
        self.engines: list = []
        for k in range(self.n):
            home = 2 * k if scfg.disagg else k
            m_k = (model if model.tp is not None
                   else model_copy(model, on(home)))
            if scfg.disagg:
                ecfg = dataclasses.replace(
                    scfg, decode_device=home % count,
                    prefill_device=(home + 1) % count)
                eng = DisaggServeEngine(m_k, ecfg, engine_id=k, **kw)
            else:
                eng = ServeEngine(m_k, scfg, engine_id=k, **kw)
            self.engines.append(eng)

        self.alive = [True] * self.n
        self.draining: dict = {}   # engine -> drain start (trace clock)
        self.drained: list = []    # engines retired via drain
        self.pending: list = []    # fleet queue: RequestStates, FIFO by
        #                            (arrival, id), kept sorted so that
        #                            submission order cannot matter
        self.shed_results: list = []
        self.n_shed_fleet = 0
        self.n_redispatched = 0
        self.n_engines_dead = 0
        self._next_auto_id = 0
        self.now = 0.0             # virtual trace clock
        self.summary: Optional[dict] = None

        self.watchdog = (watchdog.Watchdog(watchdog_timeout,
                                           on_timeout=watchdog_on_timeout,
                                           reason="serve_hang")
                         if watchdog_timeout > 0 else None)

    # -- intake ------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               req_id: Optional[int] = None, arrival: float = 0.0,
               deadline_ms: Optional[float] = None) -> int:
        """Enqueue one request fleet-wide. Request ids are FLEET-global:
        they key the sampling, so a request keeps its id across engines
        (the whole failover-parity mechanism). `deadline_ms` defaults to
        serve.deadline_ms when unset (0 = no deadline)."""
        if req_id is None:
            req_id = self._next_auto_id
        self._next_auto_id = max(self._next_auto_id, req_id + 1)
        if deadline_ms is None and self.scfg.deadline_ms > 0:
            deadline_ms = self.scfg.deadline_ms
        req = Request(req_id, tuple(prompt), max_new_tokens, arrival,
                      deadline_ms)
        # capacity validation through a live scheduler (the same limits
        # on every replica): submit appends a fresh RequestState after
        # the never-servable checks, popped straight into the fleet queue
        ref = self.engines[0].sched
        ref.submit(req)
        st = ref.queue.pop()
        self.pending.append(st)
        self.pending.sort(key=lambda s: (s.req.arrival, s.req.id))
        return req_id

    # -- engine lifecycle --------------------------------------------------

    def _routable(self) -> list:
        return [k for k in range(self.n)
                if self.alive[k] and k not in self.draining]

    def _survivors(self) -> list:
        return self._routable() or [k for k in range(self.n)
                                    if self.alive[k]]

    def _load(self, k: int) -> int:
        s = self.engines[k].sched
        n = len(s.queue) + sum(x is not None for x in s.slots)
        n += sum(x is not None for x in getattr(s, "pslots", ()))
        return n

    def _displace(self, k: int, free_blocks: bool) -> list:
        """Pull every in-flight request out of engine k, oldest-admitted
        first, queued requests behind them, reset for recompute. With
        free_blocks (graceful drain) the blocks return to the engine's
        pools; without (abrupt death) the pools are discarded wholesale:
        freeing into a dead engine's pool would only launder the leak
        accounting the tests pin on SURVIVOR pools."""
        eng = self.engines[k]
        sched = eng.sched
        resident = []  # (state, owning pool): disagg prefill slots hold
        #                prefill-pool blocks, decode slots decode-pool ones
        for i, s in enumerate(sched.slots):
            if s is not None:
                resident.append((s, eng.pool))
                sched.slots[i] = None
        pslots = getattr(sched, "pslots", None)
        if pslots is not None:
            for i, s in enumerate(pslots):
                if s is not None:
                    resident.append((s, eng.pool_p))
                    pslots[i] = None
        resident.sort(key=lambda sp: sp[0].admit_seq)
        if free_blocks:
            for st, pool in resident:
                if st.blocks:
                    pool.free(st.blocks)
        sts = [sp[0] for sp in resident] + list(sched.queue)
        sched.queue.clear()
        for st in sts:
            st.blocks = []
            st.n_prefilled = 0
            st.prefill_ids = ()
        eng._decode_state = None
        return sts

    def _redispatch(self, sts: list, survivors: list,
                    from_engine: int) -> int:
        """Requeue displaced requests at the FRONT of the survivors'
        queues (round-robin, relative order kept): they carry their
        generated tokens and recompute through the preemption path, so
        the continuation is bit-identical, and arrival priority survives
        the engine that did not."""
        if not survivors:
            raise RuntimeError(
                "fleet: no surviving engines to re-dispatch onto — the "
                "whole fleet is dead")
        per: dict = {k: [] for k in survivors}
        for i, st in enumerate(sts):
            per[survivors[i % len(survivors)]].append(st)
        for k, lst in per.items():
            if not lst:
                continue
            # extendleft(reversed(...)) puts lst[0] leftmost: the oldest
            # at the very front, the preemption requeue discipline
            self.engines[k].sched.queue.extendleft(reversed(lst))
            for st in lst:
                self.n_redispatched += 1
                self.telemetry.emit(
                    "serve_redispatch", id=st.req.id,
                    from_engine=from_engine, to_engine=k,
                    tokens=len(st.generated))
        return len(sts)

    def kill_engine(self, k: int, cause: str = "dead") -> int:
        """Abrupt replica death (the SIGKILL analogue): state discarded
        wholesale, in-flight requests re-dispatched onto survivors.
        Returns the number of requests re-dispatched."""
        if not self.alive[k]:
            return 0
        self.alive[k] = False
        self.draining.pop(k, None)
        self.n_engines_dead += 1
        sts = self._displace(k, free_blocks=False)
        self.telemetry.emit("serve_engine_dead", engine=k, cause=cause,
                            inflight=len(sts))
        flight = getattr(self.telemetry, "flight", None)
        if flight is not None:
            flight.dump("serve_engine_dead", engine=k, cause=cause,
                        inflight=len(sts))
        if not any(self.alive):
            raise RuntimeError(
                f"fleet: engine {k} died ({cause}) and no replicas "
                f"survive — nothing left to re-dispatch "
                f"{len(sts)} in-flight request(s) onto")
        if sts:
            self._redispatch(sts, self._survivors(), k)
        return len(sts)

    def drain(self, k: int) -> None:
        """Stop routing new work to engine k; let residents finish
        (bounded by serve.drain_grace_s on the trace clock, then they
        re-dispatch to survivors); the engine retires once empty."""
        if not self.alive[k]:
            raise ValueError(f"fleet: engine {k} is not alive")
        others = [j for j in range(self.n)
                  if j != k and self.alive[j] and j not in self.draining]
        if not others:
            raise ValueError(
                f"fleet: cannot drain engine {k} — it is the last "
                f"routable replica")
        self.draining.setdefault(k, self.now)

    def _drain_tick(self, now: float) -> None:
        for k in list(self.draining):
            eng = self.engines[k]
            start = self.draining[k]
            moved = 0
            if eng.sched.has_work():
                if now - start <= self.scfg.drain_grace_s:
                    continue  # still inside the grace window
                sts = self._displace(k, free_blocks=True)
                moved = self._redispatch(sts, self._survivors(), k)
            # empty (or forcibly emptied): retire
            self.draining.pop(k)
            self.alive[k] = False
            self.drained.append(k)
            self.telemetry.emit(
                "serve_drain", engine=k, redispatched=moved,
                drain_s=round(now - start, 6),
                pool_in_use=eng.pool.in_use)

    # -- routing -----------------------------------------------------------

    def _shed(self, st, now: float, forced: bool = False) -> None:
        wait = max(now - st.req.arrival, 0.0)
        self.n_shed_fleet += 1
        self.shed_results.append(
            {"id": st.req.id, "prompt_len": len(st.req.prompt),
             "queue_wait_s": wait, "deadline_ms": st.req.deadline_ms,
             "shed": True})
        self.telemetry.emit("serve_shed", category="shed", secs=wait,
                            id=st.req.id, deadline_ms=st.req.deadline_ms,
                            queue_wait_s=round(wait, 6), forced=forced)

    def _route_pending(self, now: float) -> None:
        """Send fleet-queued requests to the least-loaded routable engine
        (ties to the lowest id), head of line first. Heads past their
        deadline shed here; the rest of the deadline policy lives in each
        engine's scheduler, on the same virtual clock."""
        while self.pending:
            st = self.pending[0]
            dl = st.req.deadline_ms
            if dl is not None and (now - st.req.arrival) * 1e3 > dl:
                self.pending.pop(0)
                self._shed(st, now)
                continue
            cands = self._routable()
            if not cands:
                if not any(self.alive):
                    raise RuntimeError(
                        "fleet: requests pending but every engine is dead")
                break
            k = min(cands, key=lambda j: (self._load(j), j))
            try:
                chaos.fire("serve_route", st.req.id, engine=k)
            except chaos.ChaosEngineDead:
                self.kill_engine(k, cause="chaos engine_dead")
                continue  # the head stays; re-routed to a survivor next
            except chaos.ChaosShed:
                self.pending.pop(0)
                self._shed(st, now, forced=True)
                continue
            self.pending.pop(0)
            self.engines[k].sched.queue.append(st)

    def _step_engine(self, k: int, now: float) -> bool:
        eng = self.engines[k]
        if not eng.sched.has_work():
            return False
        if watchdog.active():
            watchdog.touch(f"serve engine={k} dispatch=decode")
        if chaos.controller().active:
            try:
                for s in eng.sched.slots:
                    if s is not None:
                        chaos.fire("serve_dispatch", s.req.id, engine=k)
            except chaos.ChaosEngineDead:
                self.kill_engine(k, cause="chaos engine_dead")
                return False
        return eng.step(now)

    # -- the fleet loop ----------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.pending) or any(
            self.alive[k] and self.engines[k].sched.has_work()
            for k in range(self.n))

    def tick(self, now: Optional[float] = None) -> bool:
        """One fleet iteration: route, step every live engine, progress
        drains, advance the virtual clock by tick_s."""
        if now is not None:
            self.now = now
        self._route_pending(self.now)
        worked = False
        for k in range(self.n):
            if self.alive[k]:
                worked = self._step_engine(k, self.now) or worked
        self._drain_tick(self.now)
        self.now += self.tick_s
        return worked

    def run(self, requests=(), max_ticks: int = 2_000_000) -> list:
        """Drive a whole trace of (prompt, max_new_tokens[, arrival[,
        deadline_ms]]) tuples against the virtual clock. Returns result
        dicts for every request that FINISHED, sorted by id; shed
        requests land in `self.shed_results` (the fleet's) and the
        engines' own (`all_shed`)."""
        def arrival(r):
            return r[2] if len(r) > 2 else 0.0

        arrivals = sorted((tuple(r) for r in requests), key=arrival)
        wall_t0 = time.perf_counter()
        if self.watchdog is not None:
            self.watchdog.start()
        ticks = 0
        try:
            while arrivals or self.has_work() or self.draining:
                while arrivals and arrival(arrivals[0]) <= self.now:
                    r = arrivals.pop(0)
                    self.submit(r[0], r[1], arrival=arrival(r),
                                deadline_ms=r[3] if len(r) > 3 else None)
                if (arrivals and not self.has_work()
                        and not self.draining):
                    # idle: jump the virtual clock to the next arrival
                    self.now = max(self.now, arrival(arrivals[0]))
                    continue
                self.tick()
                ticks += 1
                if ticks > max_ticks:
                    raise RuntimeError(
                        f"fleet: no convergence after {max_ticks} ticks "
                        f"— a request cannot finish (wedged engine?)")
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
        self._emit_summary(time.perf_counter() - wall_t0)
        return self.results

    # -- results / summary -------------------------------------------------

    @property
    def results(self) -> list:
        out = []
        for eng in self.engines:
            out.extend(eng.results)
        return sorted(out, key=lambda r: r["id"])

    @property
    def all_shed(self) -> list:
        out = list(self.shed_results)
        for eng in self.engines:
            out.extend(eng.shed_results)
        return sorted(out, key=lambda r: r["id"])

    def leaked_blocks(self) -> int:
        """Blocks still held across every LIVING pool after a drained
        trace; dead engines' pools were discarded wholesale and do not
        count (the failover contract). Must be zero."""
        total = 0
        for k, eng in enumerate(self.engines):
            if not self.alive[k] and k not in self.drained:
                continue  # died abruptly: pool discarded, not leaked
            total += eng.pool.in_use
            pool_p = getattr(eng, "pool_p", None)
            if pool_p is not None:
                total += pool_p.in_use
        return total

    def _emit_summary(self, wall: float) -> None:
        reg = self.telemetry.registry
        ttft = reg.histogram("serve/ttft")
        qw = reg.histogram("serve/queue_wait")
        results = self.results
        shed = self.all_shed
        per_engine = []
        for k, eng in enumerate(self.engines):
            per_engine.append({
                "engine": k,
                "alive": self.alive[k],
                "drained": k in self.drained,
                "requests": len(eng.results),
                "shed": eng.sched.n_shed,
                "decode_steps": eng.stats["decode_steps"],
                "preemptions": eng.sched.n_preempted,
                "pool_in_use": eng.pool.in_use,
                "pool_peak_utilization": round(
                    eng.pool.peak_in_use / eng.num_blocks, 4),
            })
        self.summary = {
            "fleet_size": self.n,
            "requests": len(results),
            "shed": len(shed),
            "redispatched": self.n_redispatched,
            "engines_dead": self.n_engines_dead,
            "drains": len(self.drained),
            "leaked_blocks": self.leaked_blocks(),
            "output_tokens": sum(r["output_tokens"] for r in results),
            "wall_s": round(wall, 6),
            "ttft_p50_s": ttft.p50, "ttft_p95_s": ttft.p95,
            "queue_wait_p50_s": qw.p50, "queue_wait_p95_s": qw.p95,
            "decode_steps": sum(e.stats["decode_steps"]
                                for e in self.engines),
            "decode_compiles": sum(e.stats["decode_compiles"]
                                   for e in self.engines),
            "preemptions": sum(e.sched.n_preempted for e in self.engines),
            "per_engine": per_engine,
        }
        self.telemetry.emit("serve_summary", **self.summary)

    def close(self) -> None:
        if self._owns_telemetry:
            self.telemetry.close()
