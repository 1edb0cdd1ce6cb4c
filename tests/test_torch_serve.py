"""The port's serving stack (picotron_tpu_torch/serve/) against the JAX
package's on the CPU, fp32, with the JAX params transplanted:

- `BlockPool` accounting, and the `Scheduler` held to the JAX one
  decision by decision: the cases of tests/test_serve.py (FIFO and
  block-budgeted admission, head-of-line blocking, unservable requests,
  youngest-first preemption, the single-request guard, deadline
  shedding) and seeded random traces of submits, admissions, prefill,
  decode growth, retirements and cancels, fed to both, every call's
  result and the whole state compared after it;
- `ServeEngine` greedy tokens equal to the JAX `ServeEngine`'s and to
  the port's `generate`, at decode intervals 1 and 4, under preemption
  and with EOS; cancel of a resident and a queued request with no leak;
  sampled tokens invariant to slot count and arrival order (temperature
  0.8, top-k 20); n-gram speculation equal to plain decode, greedy and
  sampled, and greedy equal to the JAX speculative engine;
- the paged cache: bytes scale with blocks, not batch x max length;
  writes that must not land (idle slots, chunk padding, past the table,
  unmapped entries) reach only the scratch block; the gathered view
  stays finite; the keyed sampler's hash;
- the serve JSONL: event kinds and keys equal to the JAX engine's on the
  same trace (times aside), and tools/telemetry_report.py renders both
  streams with the same request count and token totals.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu.models import llama as jllama
from picotron_tpu.serve import BlockPool as JBlockPool
from picotron_tpu.serve import Request as JRequest
from picotron_tpu.serve import Scheduler as JScheduler
from picotron_tpu.serve import ServeEngine as JServeEngine
from picotron_tpu.serve.scheduler import RequestState as JRequestState
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import generate as tgen
from picotron_tpu_torch import weights
from picotron_tpu_torch.serve import (
    BlockPool, Request, RequestState, Scheduler, ServeEngine, blocks_for,
    init_paged_cache,
)
from picotron_tpu_torch.serve import engine as tengine
from picotron_tpu_torch.telemetry import JsonlSink, Telemetry

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models run many small ops: one intra-op thread each, so that
    the suite's parallel workers do not oversubscribe the host's cores
    (which slows such ops by two orders of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# block pool and scheduler
# ---------------------------------------------------------------------------


def test_block_pool_accounting():
    pool = BlockPool(6)
    a = pool.alloc(4)
    assert len(a) == 4 and pool.in_use == 4 and pool.free_blocks == 2
    assert pool.alloc(3) is None and pool.in_use == 4  # all-or-nothing
    b = pool.alloc(2)
    assert pool.in_use == 6 and pool.peak_in_use == 6
    pool.free(a)
    assert pool.free_blocks == 4
    with pytest.raises(ValueError):
        pool.free(a[:1])  # double free
    with pytest.raises(ValueError):
        pool.free([99])
    with pytest.raises(ValueError):
        pool.alloc(-1)
    with pytest.raises(ValueError):
        BlockPool(0)
    pool.free(b)
    assert pool.in_use == 0 and pool.peak_in_use == 6
    jpool = JBlockPool(6)
    assert [jpool.alloc(2), jpool.alloc(3)] == [BlockPool(6).alloc(2),
                                               [2, 3, 4]]


def _state(st) -> tuple:
    return (st.req.id, st.req.prompt, st.req.max_new_tokens,
            tuple(st.generated), tuple(st.prefill_ids), st.n_prefilled,
            tuple(st.blocks), st.admit_seq, st.t_admit, st.n_preempted)


def _snapshot(s) -> tuple:
    return (tuple(_state(st) for st in s.queue),
            tuple(None if st is None else _state(st) for st in s.slots),
            tuple(s.pool._free), s.pool.peak_in_use, s.n_admitted,
            s.n_preempted, s.n_retired, s.n_shed, s.n_cancelled,
            tuple(_state(st) for st in s.shed))


def _norm(x):
    """A decision with the framework's objects replaced by their ids."""
    if isinstance(x, (RequestState, JRequestState)):
        return ("state", x.req.id)
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    return x


class Twin:
    """The port's Scheduler and the JAX one fed the same calls; every
    call's result (or exception type) and the state after it must be
    equal."""

    def __init__(self, slots=2, blocks=8, bs=4, max_blocks=8):
        self.port = Scheduler(slots, BlockPool(blocks), bs, max_blocks)
        self.jax = JScheduler(slots, JBlockPool(blocks), bs, max_blocks)
        self.calls = 0

    def call(self, name, *args):
        out = []
        for s, req_cls in ((self.port, Request), (self.jax, JRequest)):
            a = [req_cls(*r) if isinstance(r, RequestSpec) else r
                 for r in args]
            try:
                out.append(("ok", _norm(getattr(s, name)(*a))))
            except (ValueError, RuntimeError) as e:
                out.append(("raise", type(e).__name__))
        assert out[0] == out[1], (name, args, out)
        assert _snapshot(self.port) == _snapshot(self.jax), (name, args)
        self.calls += 1
        return out[0][1]

    def mutate(self, slot: int, fn) -> None:
        for s in (self.port, self.jax):
            fn(s.slots[slot])
        assert _snapshot(self.port) == _snapshot(self.jax)


class RequestSpec(tuple):
    """Request fields, built into each framework's own Request."""


def req(*fields):
    return RequestSpec(fields)


def test_scheduler_admission_cases_match_jax():
    t = Twin(slots=2, blocks=3, bs=4)
    for r in (req(0, (1,) * 8, 4), req(1, (1,) * 4, 4), req(2, (1,) * 4, 4)):
        t.call("submit", r)
    assert [x[1] for x in t.call("admit")] == [("state", 0), ("state", 1)]
    t.mutate(1, lambda st: st.generated.append(5))
    t.call("retire", 1)
    assert [x[1] for x in t.call("admit")] == [("state", 2)]
    # head of line: 1 needs 2 blocks, only 1 left; 2 would fit but waits
    t = Twin(slots=2, blocks=3, bs=4)
    for r in (req(0, (1,) * 8, 4), req(1, (1,) * 8, 4), req(2, (1,) * 4, 4)):
        t.call("submit", r)
    assert len(t.call("admit")) == 1
    assert [st.req.id for st in t.port.queue] == [1, 2]


def test_scheduler_rejects_unservable_like_jax():
    t = Twin(slots=1, blocks=4, bs=4, max_blocks=4)
    assert t.call("submit", req(0, (1,) * 16, 8)) == "ValueError"
    t2 = Twin(slots=1, blocks=2, bs=4, max_blocks=8)
    assert t2.call("submit", req(0, (1,) * 8, 4)) == "ValueError"
    for bad in ((1, (), 4), (1, (1,), 0), (1, (1,), 2, 0.0, -5.0)):
        with pytest.raises(ValueError):
            Request(*bad)
        with pytest.raises(ValueError):
            JRequest(*bad)


def test_scheduler_preemption_matches_jax():
    t = Twin(slots=2, blocks=4, bs=2)
    t.call("submit", req(0, (1, 2, 3), 4))
    t.call("submit", req(1, (4, 5, 6), 4))
    t.call("admit")
    for slot in (0, 1):
        t.mutate(slot, lambda st: (setattr(st, "n_prefilled",
                                           len(st.prefill_ids)),
                                   st.generated.append(7)))
    assert t.call("decode_ready") == [0, 1]
    assert t.call("ensure_block", 0, 2) == (True, [1])
    assert [st.req.id for st in t.port.queue] == [1]
    assert t.port.queue[0].generated == [7]
    assert t.port.n_preempted == 1
    # the readmitted request re-prefills its prompt and generated tokens
    t.call("retire", 0)
    t.call("admit")
    assert t.port.slots[0].prefill_ids == (4, 5, 6, 7)


def test_scheduler_single_request_guard_matches_jax():
    t = Twin(slots=1, blocks=1, bs=2, max_blocks=8)
    for s, cls, rcls in ((t.port, RequestState, Request),
                         (t.jax, JRequestState, JRequest)):
        st = cls(rcls(0, (1, 2), 8))
        st.prefill_ids = st.req.prompt
        st.n_prefilled = 2
        st.blocks = s.pool.alloc(1)
        st.generated.extend([3, 4])
        s.slots[0] = st
    assert t.call("ensure_block", 0, 2) == "RuntimeError"


def test_scheduler_deadline_shedding_matches_jax():
    t = Twin(slots=1, blocks=8, bs=4)
    t.call("submit", req(0, (1,) * 4, 4, 0.0))
    t.call("submit", req(1, (1,) * 4, 4, 0.0, 10.0))
    t.call("submit", req(2, (1,) * 4, 4, 0.0, 50.0))
    assert [x[1] for x in t.call("admit", 0.0)] == [("state", 0)]
    assert t.call("admit", 0.020) == []
    assert t.call("drain_shed") == [("state", 1)]
    assert t.call("drain_shed") == []
    t.call("admit", 0.060)
    assert t.call("drain_shed") == [("state", 2)]
    assert t.port.n_shed == 2


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_random_traces_match_jax(seed):
    """Seeded random traces through both schedulers: every decision
    (admission, prefill order, block growth, preemption victims,
    retirement, cancel) equal at every call."""
    rng = np.random.default_rng(seed)
    t = Twin(slots=3, blocks=int(rng.integers(8, 14)), bs=2, max_blocks=8)
    next_id, now = 0, 0.0
    for _ in range(120):
        op = rng.choice(["submit", "submit", "admit", "prefill", "decode",
                         "cancel"])
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
                if not t.port.slots[s].prefilling:
                    tok = int(rng.integers(0, 50))
                    t.mutate(s, lambda st: st.generated.append(tok))
                    if t.call("should_retire", s, None):
                        t.call("retire", s)
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
                    t.mutate(s, lambda st: st.generated.append(tok))
                    if t.call("should_retire", s, 7):
                        t.call("retire", s)
                        break
        elif next_id:
            t.call("cancel", int(rng.integers(0, next_id)))
    assert t.calls > 150


# ---------------------------------------------------------------------------
# engine against the JAX engine and the port's generate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    raw = {"model": {"name": "debug-tiny", "dtype": "float32",
                     "max_position_embeddings": 64},
           "training": {"seq_length": 32}}
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jc.model, jax.random.key(0)))
    model = tgen.load_for_decode(weights.params_from_jax(tree, tc.model),
                                 tc.model, "cpu")
    return jc.model, jax.tree.map(jnp.asarray, tree), model


@pytest.fixture(scope="module")
def requests5(tiny):
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, 256, size=n)))
               for n in (5, 9, 3, 7, 11)]
    return list(zip(prompts, [6, 3, 8, 5, 4]))


@pytest.fixture(scope="module")
def offline(tiny, requests5):
    """Per-request greedy tokens from the port's offline `generate`."""
    _, _, model = tiny
    return [tgen.generate(model, [p], n)[0, len(p):].tolist()
            for p, n in requests5]


SCFG = dict(decode_slots=3, block_size=4, num_blocks=24, prefill_chunk=4,
            max_model_len=32, decode_interval=4)


def run_port(model, requests, telemetry=None, **kw):
    sk = {k: kw.pop(k) for k in list(kw)
          if k in tcfg.ServeConfig.__annotations__}
    eng = ServeEngine(model, tcfg.ServeConfig(**{**SCFG, **sk}),
                      device="cpu", telemetry=telemetry, **kw)
    res = eng.run(requests)
    eng.close()
    return eng, [r["tokens"] for r in res]


def run_jax(jmodel_cfg, jparams, requests, telemetry=None, **kw):
    sk = {k: kw.pop(k) for k in list(kw)
          if k in jcfg.ServeConfig.__annotations__}
    eng = JServeEngine(jparams, jmodel_cfg,
                       jcfg.ServeConfig(**{**SCFG, **sk}),
                       telemetry=telemetry, **kw)
    res = eng.run(requests)
    eng.close()
    return eng, [r["tokens"] for r in res]


@pytest.mark.parametrize("case", [
    {"decode_interval": 4},
    {"decode_interval": 1},
    {"num_blocks": 8},
    {"speculator": "ngram", "draft_len": 4},
], ids=["interval4", "interval1", "preemption", "ngram"])
def test_engine_greedy_matches_jax_and_generate(tiny, requests5, offline,
                                                case):
    jmodel_cfg, jparams, model = tiny
    eng, got = run_port(model, requests5, **case)
    _, want = run_jax(jmodel_cfg, jparams, requests5, **case)
    assert got == want == offline
    assert eng.pool.in_use == 0 and eng.pool.free_blocks == eng.num_blocks
    if case.get("num_blocks") == 8:
        assert eng.sched.n_preempted > 0
    assert eng.summary["requests"] == len(requests5)
    assert eng.summary["decode_compiles"] == 0


def test_engine_eos_matches_jax_and_generate(tiny, requests5):
    jmodel_cfg, jparams, model = tiny
    prompt, _ = requests5[0]
    full = tgen.generate(model, [prompt], 8)[0, len(prompt):].tolist()
    eos = full[2]
    ref = tgen.generate(model, [prompt], 8, eos_token_id=eos)
    ref = ref[0, len(prompt):].tolist()
    ref = ref[:ref.index(eos) + 1]
    reqs = [(prompt, 8)] + requests5[1:]
    eng, got = run_port(model, reqs, eos_token_id=eos)
    _, want = run_jax(jmodel_cfg, jparams, reqs, eos_token_id=eos)
    assert got == want and got[0] == ref and got[0][-1] == eos
    assert eng.pool.in_use == 0


def test_engine_cancel_resident_and_queued_no_leak(tiny, requests5,
                                                   offline):
    _, _, model = tiny

    class Cap:
        events = []

        def emit(self, e):
            self.events.append(e)

        def close(self):
            pass

    cap = Cap()
    eng = ServeEngine(model, tcfg.ServeConfig(**{**SCFG, "decode_slots": 2}),
                      device="cpu", telemetry=Telemetry(sinks=[cap]))
    for p, n in requests5:
        eng.submit(p, n)
    eng.step(0.0)
    eng.step(0.0)
    resident = [s.req.id for s in eng.sched.slots if s is not None]
    queued = [s.req.id for s in eng.sched.queue]
    assert resident and queued
    held = eng.pool.in_use
    assert eng.cancel(resident[0])
    assert eng.pool.in_use < held
    assert eng.cancel(queued[0])
    assert not eng.cancel(resident[0])
    assert eng.stats["cancelled"] == 2
    while eng.sched.has_work():
        eng.step()
    assert eng.pool.in_use == 0
    done = {r["id"]: r["tokens"] for r in eng.results}
    assert set(done) == set(range(5)) - {resident[0], queued[0]}
    for rid, toks in done.items():
        assert toks == offline[rid]
    cancels = [e for e in cap.events if e["kind"] == "serve_cancel"]
    assert sorted(e["id"] for e in cancels) == sorted([resident[0],
                                                       queued[0]])
    assert {e["where"] for e in cancels} == {"slot", "queue"}
    eng.close()


def _sampled(model, requests, order, **scfg):
    eng = ServeEngine(model, tcfg.ServeConfig(**{**SCFG, **scfg}),
                      device="cpu", temperature=0.8, top_k=20, seed=7)
    for i in order:
        eng.submit(requests[i][0], requests[i][1], req_id=i)
    while eng.sched.has_work():
        eng.step()
    eng.close()
    return {r["id"]: r["tokens"] for r in eng.results}


def test_sampled_tokens_invariant_to_slots_and_order(tiny, requests5,
                                                     offline):
    _, _, model = tiny
    runs = [_sampled(model, requests5, list(order), decode_slots=slots,
                     decode_interval=interval)
            for order in (range(5), range(4, -1, -1), (2, 0, 4, 1, 3))
            for slots, interval in ((1, 1), (2, 2), (4, 4))]
    runs.append(_sampled(model, requests5, range(5), num_blocks=8))
    assert all(r == runs[0] for r in runs)
    assert [runs[0][i] for i in range(5)] != offline  # really sampled
    assert all(len(runs[0][i]) == n for i, (_, n) in enumerate(requests5))


def test_ngram_speculation_equals_plain_decode(tiny):
    """Greedy and sampled, on long streams (random weights fall into
    loops there, so drafts are accepted): the speculative engine emits
    the plain engine's tokens."""
    _, _, model = tiny
    rng = np.random.default_rng(1)
    reqs = [(list(map(int, rng.integers(0, 256, 4))), 56) for _ in range(6)]
    long = dict(max_model_len=64, num_blocks=96)
    for kw in ({}, {"temperature": 0.3, "top_k": 3, "seed": 3}):
        _, plain = run_port(model, reqs, **long, **kw)
        eng, spec = run_port(model, reqs, speculator="ngram", draft_len=4,
                             **long, **kw)
        assert spec == plain
        assert eng.stats["accepted_draft_tokens"] > 0
        assert eng.summary["acceptance_rate"] > 0
        assert eng.pool.in_use == 0


def test_ngram_draft_matches_jax():
    from picotron_tpu.serve import spec_decode as jspec
    from picotron_tpu_torch.serve import spec_decode as tspec

    rng = np.random.default_rng(5)
    ctx = rng.integers(0, 4, (6, tspec.CTX_W))
    ctx[0, :20] = tspec.CTX_PAD
    ctx[1] = tspec.CTX_PAD
    last = rng.integers(0, 4, 6)
    for d in (1, 4, tspec.max_draft_len()):
        got = tspec._ngram_draft(torch.as_tensor(ctx), torch.as_tensor(last),
                                 d)
        want = jspec._ngram_draft(jnp.asarray(ctx), jnp.asarray(last), d)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tspec.max_draft_len() == jspec.max_draft_len()


def test_engine_refusals(tiny):
    _, _, model = tiny
    with pytest.raises(ValueError, match="draft_len"):
        ServeEngine(model, tcfg.ServeConfig(speculator="ngram",
                                            draft_len=31), device="cpu")
    with pytest.raises(ValueError, match="not on the engine's device"):
        ServeEngine(model, device="meta")


# ---------------------------------------------------------------------------
# the paged cache and the keyed sampler
# ---------------------------------------------------------------------------


def test_cache_bytes_scale_with_blocks_not_batch_x_maxlen(tiny):
    _, _, model = tiny
    sc = tcfg.ServeConfig(**{**SCFG, "num_blocks": 9})  # 36 token slots
    eng = ServeEngine(model, sc, device="cpu")
    contiguous = sc.decode_slots * blocks_for(32, sc.block_size)
    # the pool and its one scratch block
    assert eng._k.shape[1] == 9 + 1 < contiguous
    per_block = eng._k[0, 0].numel() * eng._k.element_size()
    assert eng._k.nbytes == model.cfg.num_hidden_layers * 10 * per_block
    big = ServeEngine(model, tcfg.ServeConfig(**{**SCFG, "num_blocks": 18,
                                                  "decode_slots": 1}),
                      device="cpu")
    assert big._k.nbytes == model.cfg.num_hidden_layers * 19 * per_block
    eng.close()
    big.close()


def test_dropped_writes_reach_only_the_scratch_block(tiny):
    _, _, model = tiny
    cfg = model.cfg
    cache = init_paged_cache(cfg, num_blocks=4, block_size=2, num_slots=2,
                             max_blocks=3)
    cache.tables[0, :2] = torch.tensor([2, 0])  # slot 0: blocks 2, 0
    live = cache.k.clone()
    s = 4
    k = torch.randn(2, s, cfg.num_key_value_heads, cfg.head_dim)
    # slot 0 writes positions 0, 1 (block 2), 2 (block 0) and 6 (past the
    # table); slot 1 has no blocks mapped and a padded position
    q_pos = torch.tensor([[0, 1, 2, 6], [-1, 0, 3, -1]])
    cache.write(1, k, k, cache.slots(q_pos))
    assert torch.equal(cache.k[1, 2, 0], k[0, 0])
    assert torch.equal(cache.k[1, 2, 1], k[0, 1])
    assert torch.equal(cache.k[1, 0, 0], k[0, 2])
    # nothing else changed outside the scratch block
    changed = (cache.k != live).any(dim=(3, 4))  # [L, blocks+1, bs]
    changed[1, 2] = changed[1, 0, 0] = False
    assert not changed[:, :4].any()
    kv, _ = cache.layer_view(1)
    assert kv.shape == (2, 6, cfg.num_key_value_heads, cfg.head_dim)
    assert torch.isfinite(kv).all()
    assert torch.equal(kv[0, :3], k[0, :3])


def test_keyed_sampler():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 1000)
    for c in (0x7FEB352D, 0x846CA68B):
        got = tengine._mul32(torch.as_tensor(x), c).numpy()
        np.testing.assert_array_equal(
            got, [(int(v) * c) & 0xFFFFFFFF for v in x])
        assert all(tengine._mul32(int(v), c) == g for v, g in
                   zip(x[:20], got[:20]))
    rids, tidx = torch.tensor([0, 0, 1, 5]), torch.tensor([0, 1, 0, 0])
    u = tengine.keyed_uniform(7, rids, tidx, 50)
    assert u.shape == (4, 50) and ((u > 0) & (u < 1)).all()
    assert torch.equal(u, tengine.keyed_uniform(7, rids, tidx, 50))
    rows = {tuple(r.tolist()) for r in u}
    assert len(rows) == 4  # each (request, index) its own noise
    assert not torch.equal(u, tengine.keyed_uniform(8, rids, tidx, 50))
    big = tengine.keyed_uniform(1, torch.arange(64), torch.zeros(64,
                                dtype=torch.long), 4096)
    assert abs(float(big.mean()) - 0.5) < 0.01
    logits = torch.tensor([[0.0, 5.0, -1.0], [2.0, 2.0, 9.0]])
    assert tengine._keyed_sample(logits, 0.0, 0, 0, rids[:2],
                                 tidx[:2]).tolist() == [1, 2]
    assert tengine._keyed_sample(logits, 5.0, 1, 0, rids[:2],
                                 tidx[:2]).tolist() == [1, 2]


# ---------------------------------------------------------------------------
# the serve JSONL against the JAX engine's
# ---------------------------------------------------------------------------


def _stream(path: str) -> list:
    return [json.loads(line) for line in open(path)]


def test_serve_jsonl_matches_jax(tiny, requests5, tmp_path):
    """Event kinds and keys equal on the same trace (a cancel and a shed
    request in it), times aside; the JAX stream alone holds `compile`
    events (its jit compiles: the port compiles nothing on this path);
    tools/telemetry_report.py renders both with the same request count
    and token totals."""
    from picotron_tpu.telemetry import JsonlSink as JJsonlSink
    from picotron_tpu.telemetry import Telemetry as JTelemetry

    jmodel_cfg, jparams, model = tiny
    streams = {}
    for name, sink_cls, tel_cls in (("port", JsonlSink, Telemetry),
                                    ("jax", JJsonlSink, JTelemetry)):
        path = str(tmp_path / f"{name}.jsonl")
        tel = tel_cls(sinks=[sink_cls(path)])
        if name == "port":
            eng = ServeEngine(model, tcfg.ServeConfig(**SCFG), device="cpu",
                              telemetry=tel)
        else:
            eng = JServeEngine(jparams, jmodel_cfg,
                               jcfg.ServeConfig(**SCFG), telemetry=tel)
        eng.submit([1, 2, 3], 4, req_id=99, arrival=-1.0, deadline_ms=1.0)
        for i, (p, n) in enumerate(requests5):
            eng.submit(p, n, req_id=i)
        eng.step(0.0)
        assert eng.cancel(4)
        eng.run()
        tel.close()
        streams[name] = _stream(path)
    kinds = {n: {e["kind"] for e in s} - {"compile"}
             for n, s in streams.items()}
    assert kinds["port"] == kinds["jax"]
    assert {"run_start", "phase", "serve_request", "serve_summary",
            "serve_shed", "serve_cancel", "run_summary"} <= kinds["port"]
    assert "compile" not in {e["kind"] for e in streams["port"]}
    for kind in kinds["port"]:
        keys = {n: {frozenset(e) for e in s if e["kind"] == kind}
                for n, s in streams.items()}
        assert keys["port"] == keys["jax"], kind
    for n, s in streams.items():
        summary = [e for e in s if e["kind"] == "serve_summary"]
        assert len(summary) == 1
    assert ({k for e in streams["port"] if e["kind"] == "serve_summary"
             for k in e} == {k for e in streams["jax"]
                             if e["kind"] == "serve_summary" for k in e})
    phases = {n: sorted((e["phase"], e.get("tokens"))
                        for e in s if e["kind"] == "phase")
              for n, s in streams.items()}
    assert phases["port"] == phases["jax"]

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import telemetry_report

    views = {n: telemetry_report.summarize(s) for n, s in streams.items()}
    sv, jv = views["port"]["serving"], views["jax"]["serving"]
    assert sv["requests"] == jv["requests"] == 4
    assert sv["output_tokens"] == jv["output_tokens"] == sum(
        n for i, (_, n) in enumerate(requests5) if i != 4)
    assert views["port"]["goodput_pct"] > 0
    text = telemetry_report.render(views["port"])
    assert "serving:" in text and "TTFT" in text
