"""The port's disaggregated serving (picotron_tpu_torch/serve/disagg.py,
`DisaggScheduler`) against the JAX package's on the CPU, fp32, with the
JAX params transplanted (the fixtures of tests/test_torch_serve.py):

- `DisaggScheduler` held to the JAX one decision by decision: the
  boundary cases of tests/test_disagg.py (handoff preempting only
  strictly younger decode residents, decode growth preempting the
  younger, both pools at the survivability minimum, unservable
  requests) and seeded random traces of submits, admissions, prefill,
  handoffs, decode growth, retirements and cancels;
- `DisaggServeEngine` greedy tokens equal to the JAX disaggregated
  engine's, to the port's colocated engine's and to `generate`, at
  decode intervals 1 and 4, under decode-pool preemption, with both
  pools exhausted and with n-gram speculation, the scheduling counts
  (handoffs, their blocks, preemptions, dispatches, stall ticks, drafts)
  equal to the JAX engine's and no block leaked; sampled tokens
  (temperature 0.7) equal to the colocated engine's (the keyed sampler
  cannot match JAX's RNG);
- placement: an out-of-range pool index raises; the handoff's padding
  reaches only the decode pool's scratch block; cancel on the prefill
  side frees the prefill pool;
- the `handoff` ledger category and the disagg summary keys (the JAX
  engine's set) rendered by the port's `tools.telemetry_report`;
- `tools/serve_bench.py --disagg` on the JAX bench's tiny config, its
  bf16 weights transplanted: the burst trace's stall ticks and drop, the
  handoffs and the acceptance sweep's counts equal to `bench.py`'s; the
  traces equal to the JAX bench's.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu.serve import BlockPool as JBlockPool
from picotron_tpu.serve import DisaggScheduler as JDisaggScheduler
from picotron_tpu.serve import DisaggServeEngine as JDisaggServeEngine
from picotron_tpu.serve import Request as JRequest
from picotron_tpu.serve.scheduler import RequestState as JRequestState
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import weights
from picotron_tpu_torch.serve import (
    BlockPool, DisaggScheduler, DisaggServeEngine, Request, RequestState,
    ServeEngine,
)
from picotron_tpu_torch.serve import disagg as tdisagg
from picotron_tpu_torch.telemetry import JsonlSink, Telemetry
from tests.test_torch_serve import (  # noqa: F401  (module fixtures)
    SCFG, RequestSpec, offline, one_thread, req, requests5, tiny,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DISAGG = {**SCFG, "disagg": True}


# ---------------------------------------------------------------------------
# the scheduler, decision by decision
# ---------------------------------------------------------------------------


def _state(st) -> tuple:
    return (st.req.id, st.req.prompt, st.req.max_new_tokens,
            tuple(st.generated), tuple(st.prefill_ids), st.n_prefilled,
            tuple(st.blocks), st.admit_seq, st.t_admit, st.n_preempted)


def _snapshot(s) -> tuple:
    rows = lambda xs: tuple(None if st is None else _state(st)  # noqa: E731
                            for st in xs)
    return (rows(s.queue), rows(s.pslots), rows(s.slots),
            tuple(s.prefill_pool._free), s.prefill_pool.peak_in_use,
            tuple(s.pool._free), s.pool.peak_in_use, s.n_admitted,
            s.n_preempted, s.n_retired, s.n_handoffs, s.n_shed,
            s.n_cancelled, rows(s.shed))


def _norm(x):
    if isinstance(x, (RequestState, JRequestState)):
        return ("state", x.req.id)
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    return x


class DTwin:
    """The port's DisaggScheduler and the JAX one fed the same calls;
    every call's result (or exception type) and the whole state after it
    must be equal."""

    def __init__(self, pslots=2, dslots=2, pblocks=8, dblocks=8, bs=4,
                 max_blocks=8):
        self.port = DisaggScheduler(pslots, dslots, BlockPool(pblocks),
                                    BlockPool(dblocks), bs, max_blocks)
        self.jax = JDisaggScheduler(pslots, dslots, JBlockPool(pblocks),
                                    JBlockPool(dblocks), bs, max_blocks)
        self.calls = 0

    def call(self, name, *args, **kw):
        out = []
        for s, req_cls in ((self.port, Request), (self.jax, JRequest)):
            a = [req_cls(*r) if isinstance(r, RequestSpec) else r
                 for r in args]
            try:
                out.append(("ok", _norm(getattr(s, name)(*a, **kw))))
            except (ValueError, RuntimeError) as e:
                out.append(("raise", type(e).__name__))
        assert out[0] == out[1], (name, args, out)
        assert _snapshot(self.port) == _snapshot(self.jax), (name, args)
        self.calls += 1
        return out[0][1]

    def mutate(self, where: str, slot: int, fn) -> None:
        for s in (self.port, self.jax):
            fn(getattr(s, where)[slot])
        assert _snapshot(self.port) == _snapshot(self.jax)

    def prefill_done(self, tok: int = 7) -> None:
        """Finish every admitted prefill and sample its first token."""
        for s in self.call("prefill_slots"):
            n = len(self.port.pslots[s].prefill_ids)
            self.call("note_prefilled", s, n)
            self.mutate("pslots", s, lambda st: st.generated.append(tok))


def test_handoff_preempts_only_strictly_younger_matches_jax():
    """tests/test_disagg.py's boundary case through both schedulers: the
    youngest candidate waits (None, nobody preempted), a freed resident
    lets it in with no victim, and decode growth of the older resident
    preempts the younger, requeued at the front."""
    t = DTwin(2, 2, pblocks=8, dblocks=2, bs=4, max_blocks=8)
    for i in range(4):
        t.call("submit", req(i, (1,) * 4, 4))
    t.call("admit")
    t.prefill_done()
    assert t.call("handoff", 0) is not None
    assert t.call("handoff", 1) is not None
    t.call("admit")
    t.prefill_done()
    ready = t.call("handoff_ready")
    assert ready
    assert t.call("handoff", ready[0]) is None
    assert t.port.n_preempted == 0
    slot0 = next(i for i, s in enumerate(t.port.slots)
                 if s is not None and s.req.id == 0)
    t.call("retire", slot0)
    out = t.call("handoff", ready[0])
    assert out is not None and out[3] == []
    slot1 = next(i for i, s in enumerate(t.port.slots)
                 if s is not None and s.req.id == 1)
    t.mutate("slots", slot1, lambda st: st.generated.extend([7, 7]))
    assert t.call("ensure_block", slot1, 1) == (True, [1 - slot1])
    assert t.port.queue[0].req.id == 2 and t.port.n_preempted == 1


def test_handoff_preempts_younger_decode_resident_matches_jax():
    """The other half of the rule: an OLD candidate at the boundary
    evicts a younger decode resident to get its blocks; the victim is
    requeued at the front and re-prefills its generated token."""
    t = DTwin(2, 2, pblocks=4, dblocks=1, bs=8, max_blocks=4)
    for i in range(2):
        t.call("submit", req(i, (1,) * 4, 4))
    t.call("admit")
    t.prefill_done()
    dslot, _, _, victims = t.call("handoff", 1)  # the younger crosses first
    assert victims == []
    assert t.call("handoff", 0)[3] == [dslot]
    assert t.port.queue[0].req.id == 1 and t.port.n_preempted == 1
    t.call("admit")
    assert t.port.pslots[0].prefill_ids == (1,) * 4 + (7,)


def test_disagg_scheduler_rejects_unservable_like_jax():
    t = DTwin(1, 1, pblocks=2, dblocks=8, bs=4, max_blocks=8)
    assert t.call("submit", req(0, (1,) * 12, 2)) == "ValueError"  # prefill
    t = DTwin(1, 1, pblocks=8, dblocks=2, bs=4, max_blocks=8)
    assert t.call("submit", req(0, (1,) * 8, 4)) == "ValueError"  # decode
    t = DTwin(1, 1, pblocks=8, dblocks=8, bs=4, max_blocks=2)
    assert t.call("submit", req(0, (1,) * 8, 4)) == "ValueError"  # table
    with pytest.raises(ValueError):
        DisaggScheduler(0, 1, BlockPool(1), BlockPool(1), 4, 2)


def test_disagg_scheduler_cancel_and_shed_match_jax():
    t = DTwin(1, 1, pblocks=4, dblocks=4, bs=4)
    t.call("submit", req(0, (1,) * 6, 2, 0.0))
    t.call("submit", req(1, (1,) * 4, 2, 0.0, 10.0))
    t.call("submit", req(2, (1,) * 4, 2, 0.0))
    t.call("admit", 0.0)
    assert t.call("cancel", 0) == ("pslot", 0, ("state", 0))
    assert t.port.prefill_pool.in_use == 0
    t.call("admit", 0.020)
    assert t.call("drain_shed") == [("state", 1)]
    assert t.call("cancel", 9) is None


@pytest.mark.parametrize("seed", range(6))
def test_disagg_scheduler_random_traces_match_jax(seed):
    """Seeded random traces through both schedulers: every decision
    (admission into the prefill pool, prefill order, handoffs and their
    victims, decode growth and preemption, retirement on either side,
    cancel, shedding) equal at every call."""
    rng = np.random.default_rng(seed)
    t = DTwin(int(rng.integers(1, 3)), 3, pblocks=int(rng.integers(6, 10)),
              dblocks=int(rng.integers(8, 14)), bs=2, max_blocks=8)
    next_id, now = 0, 0.0
    for _ in range(160):
        op = rng.choice(["submit", "submit", "admit", "prefill", "handoff",
                         "decode", "cancel"])
        now += float(rng.uniform(0, 0.01))
        if op == "submit":
            dl = float(rng.choice([0.0, 5.0, 30.0]))
            prompt = tuple(rng.integers(0, 50, rng.integers(1, 7)))
            t.call("submit", req(next_id, prompt, int(rng.integers(1, 7)),
                                 now, dl if dl else None))
            next_id += 1
        elif op == "admit":
            t.call("admit", now)
            t.call("drain_shed")
        elif op == "prefill":
            for s in t.call("prefill_slots"):
                t.call("note_prefilled", s, int(rng.integers(1, 4)))
                if not t.port.pslots[s].prefilling:
                    tok = int(rng.integers(0, 50))
                    t.mutate("pslots", s, lambda st: st.generated.append(tok))
                    if t.call("should_retire", s, None, pslot=True):
                        t.call("retire_prefill", s)
        elif op == "handoff":
            for p in t.call("handoff_ready"):
                if t.call("handoff", p) is None:
                    break
        elif op == "decode":
            horizon = int(rng.integers(1, 4))
            for s in t.call("decode_ready"):
                if t.port.slots[s] is None:
                    continue  # preempted by an earlier slot's growth
                ok, _ = t.call("ensure_block", s, horizon)
                if not ok:
                    continue
                for _ in range(horizon):
                    tok = int(rng.integers(0, 50))
                    t.mutate("slots", s, lambda st: st.generated.append(tok))
                    if t.call("should_retire", s, 7):
                        t.call("retire", s)
                        break
        elif next_id:
            t.call("cancel", int(rng.integers(0, next_id)))
    assert t.calls > 150 and t.port.n_handoffs > 0


# ---------------------------------------------------------------------------
# the engine against the JAX disaggregated engine, the colocated engine
# and generate
# ---------------------------------------------------------------------------

STRUCTURAL = ("requests", "output_tokens", "decode_steps", "prefill_chunks",
              "decode_stall_ticks_max", "draft_tokens",
              "accepted_draft_tokens", "preemptions", "handoffs",
              "handoff_blocks", "prefill_slots", "prefill_num_blocks",
              "prefill_slot_occupancy", "prefill_pool_peak_utilization",
              "slot_occupancy", "pool_peak_utilization")


def run_port(model, requests, cls=DisaggServeEngine, telemetry=None, **kw):
    sk = {k: kw.pop(k) for k in list(kw)
          if k in tcfg.ServeConfig.__annotations__}
    eng = cls(model, tcfg.ServeConfig(**{**DISAGG, **sk}), device="cpu",
              telemetry=telemetry, **kw)
    res = eng.run(requests)
    eng.close()
    return eng, [r["tokens"] for r in res]


def run_jax(jmodel_cfg, jparams, requests, **kw):
    sk = {k: kw.pop(k) for k in list(kw)
          if k in jcfg.ServeConfig.__annotations__}
    eng = JDisaggServeEngine(jparams, jmodel_cfg,
                             jcfg.ServeConfig(**{**DISAGG, **sk}), **kw)
    res = eng.run(requests)
    eng.close()
    return eng, [r["tokens"] for r in res]


@pytest.mark.parametrize("case", [
    {"decode_interval": 4},
    {"decode_interval": 1},
    {"num_blocks": 5},
    {"num_blocks": 4, "prefill_slots": 2, "prefill_num_blocks": 4},
    {"num_blocks": 5, "speculator": "ngram", "draft_len": 2},
], ids=["interval4", "interval1", "preemption", "both_pools_exhausted",
        "ngram_preemption"])
def test_disagg_greedy_matches_jax_colocated_and_generate(
        tiny, requests5, offline, case):
    jmodel_cfg, jparams, model = tiny
    eng, got = run_port(model, requests5, **case)
    jeng, want = run_jax(jmodel_cfg, jparams, requests5, **case)
    colo_case = {k: v for k, v in case.items() if not k.startswith("prefill")}
    _, colo = run_port(model, requests5, cls=ServeEngine, **colo_case)
    assert got == want == colo == offline
    for key in STRUCTURAL:
        assert eng.summary[key] == jeng.summary[key], key
    assert set(eng.summary) == set(jeng.summary)
    assert eng.summary["disagg"] is True and eng.summary["handoffs"] > 0
    assert eng.pool.in_use == 0 and eng.pool_p.in_use == 0
    assert eng.pool.free_blocks == eng.num_blocks
    if case.get("num_blocks", 24) < 24:
        assert eng.sched.n_preempted > 0
        assert eng.sched.n_handoffs > len(requests5)  # re-handoffs


def test_disagg_sampled_equals_colocated(tiny, requests5):
    """Sampling is keyed by (seed, request id, token index) alone, so
    WHERE a token is sampled (which pool, which slot, before or after a
    handoff or a preemption) cannot move it."""
    _, _, model = tiny
    kw = dict(temperature=0.7, top_k=8, seed=3)
    _, colo = run_port(model, requests5, cls=ServeEngine, **kw)
    for extra in ({}, {"num_blocks": 5}):
        eng, dis = run_port(model, requests5, **extra, **kw)
        assert dis == colo
    assert eng.sched.n_preempted > 0


def test_pool_index_out_of_range_raises(tiny):
    _, _, model = tiny
    for field in ("prefill_device", "decode_device"):
        sc = tcfg.ServeConfig(**{**DISAGG, field: 1})
        with pytest.raises(ValueError, match=f"serve.{field} = 1 but only "
                                             f"1 device"):
            DisaggServeEngine(model, sc, device="cpu")
    with pytest.raises(ValueError, match="not on the engine's device"):
        DisaggServeEngine(model, tcfg.ServeConfig(**DISAGG), device="meta")


def test_handoff_padding_reaches_only_the_scratch_block(tiny):
    _, _, model = tiny
    eng = DisaggServeEngine(model, tcfg.ServeConfig(
        **{**DISAGG, "num_blocks": 5, "prefill_num_blocks": 6}),
        device="cpu")
    assert eng.device_p == eng.device and eng.model_p is eng.model
    g = torch.Generator().manual_seed(0)
    eng._k_p.copy_(torch.randn(eng._k_p.shape, generator=g))
    eng._v_p.copy_(torch.randn(eng._v_p.shape, generator=g))
    before_k, before_v = eng._k.clone(), eng._v.clone()
    eng._copy_blocks([4, 1, 3], [2, 0, 4])
    for s, d in ((4, 2), (1, 0), (3, 4)):
        assert torch.equal(eng._k[:, d], eng._k_p[:, s])
        assert torch.equal(eng._v[:, d], eng._v_p[:, s])
    scratch = eng.num_blocks
    assert eng.max_blocks > 3  # the destination really had padding
    assert torch.equal(eng._k[:, 1], before_k[:, 1])
    assert torch.equal(eng._k[:, 3], before_k[:, 3])
    assert torch.equal(eng._v[:, [1, 3]], before_v[:, [1, 3]])
    # padding gathers prefill block 0 and lands in the scratch block
    assert torch.equal(eng._k[:, scratch], eng._k_p[:, 0])
    assert torch.isfinite(eng._k).all() and torch.isfinite(eng._v).all()
    eng.close()


def test_cancel_mid_prefill_frees_the_prefill_pool(tiny, requests5,
                                                   offline):
    _, _, model = tiny
    eng = DisaggServeEngine(model, tcfg.ServeConfig(**DISAGG), device="cpu")
    for p, n in requests5:
        eng.submit(p, n)
    eng.step(0.0)
    mid = [s.req.id for s in eng.sched.pslots if s is not None]
    assert mid
    held = eng.pool_p.in_use
    assert eng.cancel(mid[0])
    assert eng.pool_p.in_use < held
    while eng.sched.has_work():
        eng.step()
    assert eng.pool.in_use == eng.pool_p.in_use == 0
    done = {r["id"]: r["tokens"] for r in eng.results}
    assert set(done) == set(range(5)) - {mid[0]}
    for rid, toks in done.items():
        assert toks == offline[rid]
    eng.close()


def test_disagg_telemetry_handoff_and_report(tiny, requests5, tmp_path):
    """The stream books the handoff as its own (non-goodput) ledger
    category, and tools.telemetry_report renders the disagg and
    speculative rows from the stream alone."""
    from picotron_tpu_torch.telemetry.goodput import (
        CATEGORIES, GOODPUT_CATEGORIES,
    )
    from picotron_tpu_torch.tools import telemetry_report

    assert "handoff" in CATEGORIES and "handoff" not in GOODPUT_CATEGORIES
    _, _, model = tiny
    path = str(tmp_path / "telemetry.jsonl")
    tel = Telemetry(sinks=[JsonlSink(path)])
    run_port(model, requests5, telemetry=tel, speculator="ngram",
             draft_len=2)
    tel.close()
    events = [json.loads(line) for line in open(path)]
    cats = {e.get("category") for e in events if e["kind"] == "phase"}
    assert {"prefill", "decode", "handoff"} <= cats
    summ = next(e for e in events if e["kind"] == "serve_summary")
    assert summ["disagg"] is True and summ["handoffs"] > 0
    assert summ["prefill_slot_occupancy"] > 0
    assert summ["acceptance_rate"] is not None
    s = telemetry_report.summarize(events)
    sv = s["serving"]
    for key in ("handoffs", "prefill_slot_occupancy", "acceptance_rate"):
        assert sv[key] == summ[key], key
    assert "handoff" in s["categories"]
    text = telemetry_report.render(s)
    assert "disagg:" in text and "speculative:" in text


# ---------------------------------------------------------------------------
# tools/serve_bench.py against bench.py
# ---------------------------------------------------------------------------


def test_serve_bench_traces_match_jax_bench():
    sys.path.insert(0, ROOT)
    import bench

    from picotron_tpu_torch.tools import serve_bench

    args = (3, 32, 4, 3, 24, 256)
    assert (serve_bench.make_burst_trace(*args, seed=1)
            == bench.make_burst_trace(*args, seed=1))
    a = serve_bench.make_burst_trace(*args, seed=1)
    assert all(t == 0.0 for _, _, t in a)
    assert [len(p) for p, _, _ in a] == [4, 4, 4, 32, 32, 32]
    for rate in (0.0, 5.0):
        assert (serve_bench.make_serve_trace(6, rate, 16, 8, 256, seed=3)
                == bench.make_serve_trace(6, rate, 16, 8, 256, seed=3))


def test_serve_bench_disagg_matches_jax_bench(monkeypatch):
    """The JAX bench's tiny disagg row (tests/test_disagg.py's
    arguments) and the port's on the same weights: the stall ticks, their
    drop, the handoffs and the acceptance counts are structural, so they
    are equal. Both run in fp32 (the preset's dtype and the JAX bench's
    weight cast patched): in bf16 the two frameworks' CPU round-off moves
    late greedy tokens of this random model, and the n-gram acceptance
    with them."""
    sys.path.insert(0, ROOT)
    import bench
    from picotron_tpu.models.llama import init_params as jinit

    from picotron_tpu_torch.tools import serve_bench

    def fp32(resolve):
        return lambda name: {**resolve(name), "dtype": "float32"}

    monkeypatch.setattr(jcfg, "resolve_preset", fp32(jcfg.resolve_preset))
    monkeypatch.setattr(tcfg, "resolve_preset", fp32(tcfg.resolve_preset))
    monkeypatch.setattr(bench, "jnp", types.SimpleNamespace(
        bfloat16=jnp.float32))
    kw = dict(slots=2, block_size=4, num_blocks=0, prefill_chunk=4,
              prompt_len=24, max_new=16, n_requests=4, rate=0.0,
              decode_interval=2, draft_lens=(2,))
    want = bench.run_serve_disagg("debug-tiny", 2, **kw)
    # bench.py's weights: the preset at 2 layers from key 0
    preset = jcfg.resolve_preset("debug-tiny")
    preset["max_position_embeddings"] = max(
        preset.get("max_position_embeddings", 0), 24 + 16)
    preset["num_hidden_layers"] = 2
    tree = jinit(jcfg.ModelConfig(name="debug-tiny", **preset),
                 jax.random.key(0))
    tc = tcfg.config_from_dict({"model": {"name": "debug-tiny",
                                          "num_hidden_layers": 2}})
    sd = weights.params_from_jax(jax.tree.map(np.asarray, tree), tc.model)
    got = serve_bench.run_serve_disagg("debug-tiny", 2, device="cpu",
                                       state_dict=sd, **kw)
    assert got["unit"] == want["unit"] == "decode_stall_ticks_drop"
    for key in ("value", "colocated_stall_ticks_max",
                "disagg_stall_ticks_max", "burst_requests", "handoffs",
                "handoff_blocks", "preemptions", "prefill_slots",
                "prefill_slot_occupancy", "decode_compiles"):
        assert got[key] == want[key], key
    assert got["value"] > 0 and got["handoffs"] > 0
    assert got["acceptance_sweep"] == want["acceptance_sweep"]
    assert got["acceptance_sweep"][0]["accepted_draft_tokens"] > 0
    assert [p["disagg"]["decode_stall_ticks_max"] for p in got["slo_curve"]
            ] == [p["disagg"]["decode_stall_ticks_max"]
                  for p in want["slo_curve"]]
    assert got["device_kind"] == "cpu" and "wall_note" in got
    assert set(got) == set(want) - {"predicted_handoff_ms_worstcase",
                                    "predicted_handoff_bytes_worstcase"}


def test_model_copy_is_its_own(tiny):
    _, _, model = tiny
    twin = tdisagg.model_copy(model, "cpu")
    for (n, a), (m, b) in zip(model.state_dict().items(),
                              twin.state_dict().items(), strict=True):
        assert n == m and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()
