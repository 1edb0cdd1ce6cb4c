"""Serving engine: continuous batching over a paged KV cache (port of
picotron_tpu/serve/engine.py).

The host loop owns the scheduler (admission / chunked prefill /
preemption / retirement, serve/scheduler.py) and drives two device
programs:

- ``decode step`` (`_decode_step_impl`): `decode_interval` steps over a
  fixed batch of `decode_slots` slots in one dispatch, one token per slot
  per step. Which request occupies which slot, every slot's position and
  the block tables are ordinary device data, so requests enter and leave
  mid-flight. Idle/prefilling slots ride along at position -1: their
  q-rows compute masked garbage that is discarded and their K/V writes
  land in the pool's scratch block. Slots that emit EOS mid-interval are
  forced to keep emitting EOS (generate.py's semantics); the host
  truncates and retires them at dispatch end. The step's outputs
  (positions, token indices, last tokens) stay on the device and feed the
  next dispatch while the roster is unchanged; the host reads the device
  once per dispatch, for its tokens. Nothing inside the dispatch reads
  the device (`chip_smoke.py` runs it under
  `torch.cuda.set_sync_debug_mode("error")`).
- ``prefill chunk`` (`_prefill_chunk_impl`): the next `prefill_chunk`
  tokens of every mid-prefill slot in one padded [S, C] dispatch,
  interleaved with the decode steps so a long prompt never stalls the
  in-flight batch. A row's final chunk returns its last valid position's
  sample: the request's first token (TTFT).

Both run `generate._decode_layers` against `PagedKVCache`, the same layer
math as the offline contiguous path, so greedy parity between the two
caches is structural. Under tp (a model from `generate.place_for_decode`)
every rank runs the same engine over its shards and its Hkv/tp pool
heads; the logits are gathered, so every rank samples the same tokens
and the host decisions stay in step (the ranks must be fed the same
trace).

Sampling draws from a counter-based hash of (seed, request id, token
index, vocab index) turned into Gumbel noise (`_keyed_sample`): the
torch counterpart of the JAX engine's `fold_in(fold_in(key, request id),
token index)`, with no generator state on the device. Tokens are
therefore independent of slot assignment, arrival order and preemption
at any temperature (they cannot match the JAX package's RNG). With
``serve.speculator = "ngram"`` the decode program is the speculative
verify-and-accept step (serve/spec_decode.py), keyed the same way at
every candidate position, so its tokens are the non-speculative ones.
MoE models are refused, as in the JAX engine.

The JAX engine's sharding discipline guards against JAX recompiles (a
new jit variant per committed or uncommitted argument); the port has no
JIT, so it is dropped. Its feed check stays, for what it means here:
`analysis/variants.check_engine_feed` proves at construction that every
persistent input (the model's parameters and buffers, the KV pool, the
rope tables) lies on the engine's device, the discipline a decode
captured as a CUDA graph needs, and each hazard it finds is a
`variant_hazard` telemetry event (`variant_report` keeps the report),
as in the JAX engine. Its CompileWatch books
the nvcc builds of `kernels/build.py`, of which the serving path has
none, so `decode_compiles` counts 0 where the JAX engine counts its one
decode compile.

Observability is the JAX engine's: the GoodputLedger books queue_wait /
prefill / decode, per-request TTFT and TPOT land in the registry
histograms and as ``serve_request`` / ``serve_summary`` JSONL events,
with ``serve_shed`` and ``serve_cancel`` beside them, and
tools/telemetry_report.py renders the serving view.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.config import ServeConfig
from picotron_tpu_torch.generate import (
    _decode_layers, _logits_last, gumbel, kv_heads, model_device,
    top_k_mask,
)
from picotron_tpu_torch.models.llama import embed, model_rope_tables
from picotron_tpu_torch.resilience import watchdog
from picotron_tpu_torch.serve.paged_cache import (
    BlockPool, PagedKVCache, init_paged_cache,
)
from picotron_tpu_torch.serve.scheduler import Request, Scheduler, blocks_for
from picotron_tpu_torch.telemetry import Telemetry
from picotron_tpu_torch.utils import cuda_or_cpu

# ---------------------------------------------------------------------------
# Keyed sampling: a pure function of (seed, request id, token index)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """The low 32 bits of x * c (x, c < 2**32) with no intermediate past
    2**49, so int64 tensors never overflow (and Python ints agree)."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A bijective 32-bit integer hash (lowbias32) of values < 2**32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_uniform(seed: int, rids: torch.Tensor, tidx: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """[..., vocab] fp32 uniforms in (0, 1), each a hash of (seed, request
    id, token index, vocab index); rids and tidx broadcast. Integer ops
    only, on the device, with no generator state."""
    row = _mix32(_mix32(_mix32(seed & _MASK32) ^ (rids & _MASK32))
                 ^ (tidx & _MASK32))
    col = torch.arange(vocab, device=row.device)
    h = _mix32(_mix32(row[..., None] ^ col) ^ _mix32(row ^ 0x9E3779B9)[
        ..., None])
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _keyed_sample(logits, temperature: float, top_k: int, seed: int,
                  rids, tidx):
    """Token per row of logits [..., V]: argmax at temperature 0, else
    argmax(logits / T, top-k masked, + Gumbel noise keyed by (seed, rids,
    tidx)) — a draw from the tempered top-k softmax."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    lg = top_k_mask(logits / temperature, top_k)
    u = keyed_uniform(seed, rids, tidx, lg.shape[-1])
    return (lg + gumbel(u)).argmax(dim=-1)


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------


@torch.no_grad()
def _decode_step_impl(model, cache, toks, positions, rids, tidx, seed: int,
                      cos, sin, *, temperature: float, top_k: int,
                      interval: int, eos_token_id):
    """`interval` decode steps over all slots in one dispatch.
    toks/positions/rids/tidx: [S]; positions < 0 = idle slot (output
    ignored, write to scratch). Returns (tokens [S, interval], last
    tokens, next positions, next tidx), all on the device."""
    live = positions >= 0
    done = torch.zeros_like(live)
    out = []
    for _ in range(interval):
        x = _decode_layers(model, embed(model, toks[:, None]), cache,
                           positions[:, None], cos, sin)
        nxt = _keyed_sample(_logits_last(model, x), temperature, top_k,
                            seed, rids, tidx)
        if eos_token_id is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        positions = torch.where(live, positions + 1, positions)
        tidx = torch.where(live, tidx + 1, tidx)
        out.append(nxt)
        toks = nxt
    return torch.stack(out, dim=1), toks, positions, tidx


@torch.no_grad()
def _prefill_chunk_impl(model, cache, chunk_ids, start_pos, n_valid, rids,
                        tidx, seed: int, cos, sin, *, temperature: float,
                        top_k: int):
    """The next chunk of every mid-prefill slot in one dispatch: chunk_ids
    [S, C] (padded), start_pos/n_valid/rids/tidx [S]. Rows with n_valid =
    0 are idle slots riding along (all positions -1); padded positions
    inside a live row behave the same. Samples each row's next token off
    its last valid position's logits with the decode step's keys.
    Returns tokens [S]."""
    s, c = chunk_ids.shape
    t = torch.arange(c, device=chunk_ids.device)[None, :]
    pos = torch.where(t < n_valid[:, None], start_pos[:, None] + t, -1)
    x = _decode_layers(model, embed(model, chunk_ids), cache, pos, cos, sin)
    last = (n_valid - 1).clamp(min=0)
    h_last = x[torch.arange(s, device=x.device), last][:, None]
    return _keyed_sample(_logits_last(model, h_last), temperature, top_k,
                         seed, rids, tidx)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous batching over `model` (a `models.llama.LlamaModel`, or a
    tp rank's from `generate.place_for_decode`). `device` (default cuda)
    must be where the model lies: the engine runs on CUDA unless the CPU
    is asked for, and never moves the model."""

    def __init__(self, model, serve_cfg: Optional[ServeConfig] = None, *,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 telemetry: Optional[Telemetry] = None, device=None,
                 engine_id: int = 0):
        scfg = serve_cfg or ServeConfig()
        scfg.validate()
        cfg = model.cfg
        if cfg.num_experts:
            raise ValueError(
                "serving does not support MoE models (num_experts > 0): "
                "chunked prefill feeds each chunk through per-call "
                "capacity-bounded expert dispatch, so routing — and "
                "therefore tokens — depends on the chunking; parity with "
                "the offline sampler cannot be guaranteed. Serve dense "
                "models only (the JAX engine refuses them too; "
                "picotron_tpu_torch.generate decodes MoE models).")
        dev = cuda_or_cpu("cuda" if device is None else str(device))
        if model_device(model).type != dev.type:
            raise ValueError(f"the model is on {model_device(model)}, not "
                             f"on the engine's device {dev}")
        self.device = model_device(model)
        self.model = model
        self.cfg = cfg
        self.scfg = scfg
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)

        self.max_len = scfg.max_model_len or cfg.max_position_embeddings
        self.block_size = scfg.block_size
        self.max_blocks = blocks_for(self.max_len, self.block_size)
        self.num_blocks = (scfg.num_blocks
                           or scfg.decode_slots * self.max_blocks)
        self.num_slots = scfg.decode_slots

        self.speculate = scfg.speculator == "ngram"
        self.draft_len = scfg.draft_len if self.speculate else 0
        self._decode_fn = _decode_step_impl
        self._prefill_fn = _prefill_chunk_impl
        if self.speculate:
            from picotron_tpu_torch.serve import spec_decode
            if self.draft_len > spec_decode.max_draft_len():
                raise ValueError(
                    f"serve.draft_len ({self.draft_len}) exceeds the "
                    f"drafter's context window: max "
                    f"{spec_decode.max_draft_len()}")
            self._decode_fn = spec_decode._spec_decode_step_impl

        self.cos, self.sin = model_rope_tables(cfg, max_len=self.max_len,
                                               device=self.device)
        cache = init_paged_cache(cfg, self.num_blocks, self.block_size,
                                 self.num_slots, self.max_blocks,
                                 device=self.device, heads=kv_heads(model))
        self._k, self._v = cache.k, cache.v
        # host mirror of the device block tables; num_blocks = unmapped
        self._tables = np.full((self.num_slots, self.max_blocks),
                               self.num_blocks, np.int64)
        self.pool = BlockPool(self.num_blocks)
        self.sched = Scheduler(self.num_slots, self.pool, self.block_size,
                               self.max_blocks)

        self._owns_telemetry = telemetry is None
        self.telemetry = telemetry or Telemetry(sinks=[])
        self._t0 = time.perf_counter()  # trace clock zero (run() resets)
        self.engine_id = int(engine_id)  # fleet replica index (0 = solo)
        # steady-state decode fast path: device-resident step inputs,
        # valid while the slot roster and block tables are unchanged
        self._decode_state: Optional[dict] = None
        self.results: list = []
        self.shed_results: list = []
        self.stats = {
            "decode_steps": 0, "decode_compiles": 0,
            "prefill_chunks": 0, "occupancy_sum": 0.0,
            "output_tokens": 0, "prefill_tokens": 0,
            "draft_tokens": 0, "accepted_draft_tokens": 0,
            "decode_stall_ticks_max": 0, "cancelled": 0,
        }
        self._stall_streak = 0  # consecutive ticks: work queued, no decode
        self._next_auto_id = 0
        self._hazards: set = set()
        self.variant_report = self._audit_feed()

    # -- intake ------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               req_id: Optional[int] = None, arrival: float = 0.0,
               deadline_ms: Optional[float] = None) -> int:
        if req_id is None:
            req_id = self._next_auto_id
        self._next_auto_id = max(self._next_auto_id, req_id + 1)
        self.sched.submit(Request(req_id, tuple(prompt), max_new_tokens,
                                  arrival, deadline_ms))
        return req_id

    def cancel(self, request_id: int) -> bool:
        """Abandon a request mid-generation: its blocks go straight back
        to the pool and its slot frees for the next admission — no result
        is recorded, nothing leaks. Returns False for an unknown id
        (already retired, shed, or never submitted)."""
        got = self.sched.cancel(request_id)
        if got is None:
            return False
        where, idx, st = got
        if where == "slot":
            self._sync_table(idx)
        elif where == "pslot":  # the disaggregated engine's prefill side
            self._sync_ptable(idx)
        self.stats["cancelled"] += 1
        self.telemetry.emit("serve_cancel", id=request_id, where=where,
                            tokens=len(st.generated))
        return True

    # -- helpers -----------------------------------------------------------

    def _audit_feed(self):
        """`analysis/variants.check_engine_feed` over the engine's inputs;
        each hazard not reported before is a `variant_hazard` event."""
        from picotron_tpu_torch.analysis.variants import check_engine_feed

        rep = check_engine_feed(self)
        for f in rep.warnings():
            if f.path not in self._hazards:
                self._hazards.add(f.path)
                self.telemetry.emit("variant_hazard", category="serve",
                                    path=f.path, message=f.message)
        return rep

    def _up(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """A host array copied to the device (the engine's, or `device`),
        never aliasing the host mirror, which later ticks mutate."""
        return torch.tensor(arr, device=device or self.device)

    def _cache(self, tables: torch.Tensor) -> PagedKVCache:
        return PagedKVCache(self._k, self._v, tables)

    def _sync_table(self, slot: int) -> None:
        st = self.sched.slots[slot]
        row = np.full((self.max_blocks,), self.num_blocks, np.int64)
        if st is not None and st.blocks:
            row[:len(st.blocks)] = st.blocks
        self._tables[slot] = row
        self._decode_state = None  # roster/table changed: slow path next

    def _drain_compile(self) -> float:
        n, secs = self.telemetry.compile_watch.drain()
        if n:
            self.telemetry.emit("compile", category="compile", secs=secs,
                                compiles=n)
        return secs if n else 0.0

    def _emit_retired(self, st, now: float) -> dict:
        req = st.req
        ttft = (st.t_first_token - req.arrival
                if st.t_first_token is not None else None)
        # TPOT: mean inter-token time AFTER the first token — the decode
        # SLO, as distinct from TTFT (the prefill/queueing SLO)
        tpot = None
        if st.t_first_token is not None and len(st.generated) > 1:
            tpot = (max(now - st.t_first_token, 0.0)
                    / (len(st.generated) - 1))
            self.telemetry.registry.histogram("serve/tpot").observe(tpot)
        res = {
            "id": req.id,
            "prompt_len": len(req.prompt),
            "tokens": list(st.generated),
            "output_tokens": len(st.generated),
            "queue_wait_s": max((st.t_admit or 0.0) - req.arrival, 0.0),
            "ttft_s": ttft,
            "latency_s": max(now - req.arrival, 0.0),
            "tpot_s": tpot,
            "n_preempted": st.n_preempted,
        }
        self.results.append(res)
        self.telemetry.emit(
            "serve_request",
            id=req.id, prompt_tokens=res["prompt_len"],
            output_tokens=res["output_tokens"],
            queue_wait_s=round(res["queue_wait_s"], 6),
            ttft_s=round(ttft, 6) if ttft is not None else None,
            latency_s=round(res["latency_s"], 6),
            tpot_s=round(tpot, 6) if tpot is not None else None,
            preempted=st.n_preempted, engine=self.engine_id)
        return res

    def _emit_shed(self, st, now: float) -> dict:
        """Report one deadline-shed request: its queue seconds book to the
        `shed` ledger category and it lands in `shed_results`, never in
        `results`."""
        wait = max(now - st.req.arrival, 0.0)
        res = {"id": st.req.id, "prompt_len": len(st.req.prompt),
               "queue_wait_s": wait, "deadline_ms": st.req.deadline_ms,
               "shed": True}
        self.shed_results.append(res)
        self.telemetry.emit("serve_shed", category="shed", secs=wait,
                            id=st.req.id, deadline_ms=st.req.deadline_ms,
                            queue_wait_s=round(wait, 6),
                            engine=self.engine_id)
        return res

    # -- one engine iteration ---------------------------------------------

    def step(self, now: Optional[float] = None) -> bool:
        """Admit; run ONE prefill chunk per mid-prefill slot (one
        dispatch); run ONE decode dispatch over the slot batch; retire.
        Returns whether any device work ran."""
        if now is None:
            now = time.perf_counter() - self._t0
        reg = self.telemetry.registry

        for slot, st in self.sched.admit(now):
            self._sync_table(slot)
            wait = max(now - st.req.arrival, 0.0)
            # "phase" events carry (category, secs) so a post-hoc sum of
            # the JSONL reproduces the in-process ledger
            self.telemetry.emit("phase", phase="queue_wait",
                                category="queue_wait", secs=wait,
                                id=st.req.id)
            reg.histogram("serve/queue_wait").observe(wait)
        for st in self.sched.drain_shed():
            self._emit_shed(st, now)

        worked = False
        pslots = self.sched.prefill_slots()
        if pslots:
            c = self.scfg.prefill_chunk
            ids = np.zeros((self.num_slots, c), np.int64)
            start = np.zeros((self.num_slots,), np.int64)
            nval = np.zeros((self.num_slots,), np.int64)
            rids = np.zeros((self.num_slots,), np.int64)
            tidx = np.zeros((self.num_slots,), np.int64)
            finals = []
            for s in pslots:
                st = self.sched.slots[s]
                chunk = st.prefill_ids[st.n_prefilled:st.n_prefilled + c]
                ids[s, :len(chunk)] = chunk
                start[s] = st.n_prefilled
                nval[s] = len(chunk)
                rids[s] = st.req.id
                tidx[s] = len(st.generated)
                if st.n_prefilled + len(chunk) >= len(st.prefill_ids):
                    finals.append(s)
            self._drain_compile()
            if watchdog.active():
                watchdog.touch(
                    f"serve engine={self.engine_id} dispatch=prefill")
            t0 = time.perf_counter()
            toks_d = self._prefill_fn(
                self.model, self._cache(self._up(self._tables)),
                self._up(ids), self._up(start), self._up(nval),
                self._up(rids), self._up(tidx), self.seed, self.cos,
                self.sin, temperature=self.temperature, top_k=self.top_k)
            toks = toks_d.cpu().numpy() if finals else None
            dt = time.perf_counter() - t0
            dt -= min(self._drain_compile(), dt)
            n_prefilled = int(nval.sum())
            self.telemetry.emit("phase", phase="prefill",
                                category="prefill", secs=dt,
                                tokens=n_prefilled,
                                ids=[int(rids[s]) for s in pslots])
            for s in pslots:
                self.sched.note_prefilled(s, int(nval[s]))
            self.stats["prefill_chunks"] += len(pslots)
            self.stats["prefill_tokens"] += n_prefilled
            for s in finals:
                st = self.sched.slots[s]
                st.generated.append(int(toks[s]))
                self.stats["output_tokens"] += 1
                if st.t_first_token is None:
                    st.t_first_token = now + dt
                    ttft = max(st.t_first_token - st.req.arrival, 0.0)
                    reg.histogram("serve/ttft").observe(ttft)
                if self.sched.should_retire(s, self.eos_token_id):
                    st = self.sched.retire(s)
                    self._sync_table(s)
                    self._emit_retired(st, now + dt)
            worked = True

        decode_ran = self._decode_tick(now, reg)
        worked = worked or decode_ran
        # max consecutive ticks with work in the system but no decode
        # dispatch (the TTFT/TPOT hazard of a prefill-bound engine)
        if decode_ran:
            self._stall_streak = 0
        elif self.sched.has_work():
            self._stall_streak += 1
            self.stats["decode_stall_ticks_max"] = max(
                self.stats["decode_stall_ticks_max"], self._stall_streak)
        return worked

    def _decode_state_for(self, active: list) -> dict:
        """The decode dispatch's device inputs: the previous dispatch's
        outputs while the roster is unchanged (no upload), else rebuilt
        on the host and uploaded."""
        ds = self._decode_state
        if ds is not None and ds["active"] == active:
            return ds
        toks = np.zeros((self.num_slots,), np.int64)
        positions = np.full((self.num_slots,), -1, np.int64)
        rids = np.zeros((self.num_slots,), np.int64)
        tidx = np.zeros((self.num_slots,), np.int64)
        for s in active:
            st = self.sched.slots[s]
            toks[s] = st.last_token
            positions[s] = st.write_pos
            rids[s] = st.req.id
            tidx[s] = len(st.generated)
        ds = {"active": list(active), "tables": self._up(self._tables),
              "toks": self._up(toks), "positions": self._up(positions),
              "rids": self._up(rids), "tidx": self._up(tidx)}
        if self.speculate:
            from picotron_tpu_torch.serve.spec_decode import context_rows
            ds["ctx"] = self._up(context_rows(self.sched.slots, active,
                                              self.num_slots))
        return ds

    def _decode_tick(self, now: float, reg) -> bool:
        """One decode dispatch over every decode-ready slot. Returns
        whether a dispatch ran."""
        ready = self.sched.decode_ready()
        if not ready:
            return False
        active = []
        dropped: set = set()
        interval = self.scfg.decode_interval
        # a speculative iteration can advance a slot by up to 1 +
        # draft_len positions, so the write horizon (and the block
        # allocation backing it) scales with it
        span = interval * (1 + self.draft_len)
        for s in ready:
            if s in dropped:
                continue
            st = self.sched.slots[s]
            horizon = min(span, st.req.max_new_tokens - len(st.generated))
            n_before = len(st.blocks)
            ok, preempted = self.sched.ensure_block(s, horizon)
            dropped.update(preempted)
            for p in preempted:
                self._sync_table(p)
            if ok:
                if len(self.sched.slots[s].blocks) != n_before:
                    self._sync_table(s)
                active.append(s)
        # a later ensure_block can preempt a slot already activated (it
        # was younger than the one needing the block)
        active = [s for s in active if s not in dropped]
        if not active:
            return False
        ds = self._decode_state_for(active)
        self._drain_compile()
        if watchdog.active():
            watchdog.touch(f"serve engine={self.engine_id} dispatch=decode")
        t0 = time.perf_counter()
        args = (self.model, self._cache(ds["tables"]), ds["toks"],
                ds["positions"], ds["rids"], ds["tidx"])
        kw = dict(temperature=self.temperature, top_k=self.top_k,
                  interval=interval, eos_token_id=self.eos_token_id)
        if self.speculate:
            toks_d, nval_d, last_d, pos_d, tidx_d, ctx_d = self._decode_fn(
                *args, ds["ctx"], self.seed, self.cos, self.sin,
                draft_len=self.draft_len, **kw)
            # the dispatch's one host read: tokens and valid counts
            packed = torch.cat([toks_d, nval_d[..., None]], dim=-1)
            packed = packed.cpu().numpy()      # [S, interval, 2 + d]
            nxt, nval = packed[..., :-1], packed[..., -1]
            state = dict(ds, toks=last_d, positions=pos_d, tidx=tidx_d,
                         ctx=ctx_d)
        else:
            toks_d, last_d, pos_d, tidx_d = self._decode_fn(
                *args, self.seed, self.cos, self.sin, **kw)
            nxt = toks_d.cpu().numpy()         # [S, interval]
            state = dict(ds, toks=last_d, positions=pos_d, tidx=tidx_d)
        # feed outputs forward; any roster/table change below nulls this
        # via _sync_table
        self._decode_state = state
        dt = time.perf_counter() - t0
        csecs = self._drain_compile()
        if csecs:
            self.stats["decode_compiles"] += 1
        dt -= min(csecs, dt)
        # request ids snapshotted before the retire loop frees slots
        dec_ids = [self.sched.slots[s].req.id for s in active]
        n_tokens = 0
        for s in active:
            st = self.sched.slots[s]
            retired = False
            for t in range(interval):
                if retired:
                    break
                if self.speculate:
                    emit = [int(x) for x in nxt[s, t, :int(nval[s, t])]]
                    self.stats["draft_tokens"] += self.draft_len
                    self.stats["accepted_draft_tokens"] += len(emit) - 1
                else:
                    emit = [int(nxt[s, t])]
                for tok in emit:
                    st.generated.append(tok)
                    n_tokens += 1
                    if self.sched.should_retire(s, self.eos_token_id):
                        # tokens past EOS/budget are padding
                        rst = self.sched.retire(s)
                        self._sync_table(s)
                        self._emit_retired(rst, now + dt)
                        retired = True
                        break
        self.telemetry.emit("phase", phase="decode", category="decode",
                            secs=dt, tokens=n_tokens, ids=dec_ids)
        reg.histogram("serve/token_latency").observe(
            dt / max(n_tokens if self.speculate
                     else len(active) * interval, 1))
        self.stats["decode_steps"] += 1
        self.stats["occupancy_sum"] += len(active) / self.num_slots
        self.stats["output_tokens"] += n_tokens
        reg.gauge("serve/slot_occupancy").set(len(active) / self.num_slots)
        reg.gauge("serve/pool_utilization").set(
            self.pool.in_use / self.num_blocks)
        return True

    # -- a whole trace -------------------------------------------------------

    def run(self, requests=(), watchdog_timeout: float = 0.0) -> list:
        """Drive a whole trace: submit each (prompt, max_new_tokens[,
        arrival[, deadline_ms]]) when its arrival time passes on the
        trace clock, loop engine steps until queue and slots drain.
        Returns per-request result dicts sorted by request id (shed
        requests are in `self.shed_results`).

        watchdog_timeout > 0 arms a resilience watchdog for the trace:
        every dispatch heartbeats with a phase naming this engine and
        dispatch kind, so a wedged device call is reported as `serve
        engine=K dispatch=decode`, the flightdeck postmortem's reason is
        `serve_hang`, and the process exits 77."""
        wd = None
        if watchdog_timeout > 0:
            wd = watchdog.Watchdog(watchdog_timeout, reason="serve_hang")
            wd.start()
        try:
            pending = sorted(requests,
                             key=lambda r: r[2] if len(r) > 2 else 0.0)
            self._t0 = t0 = time.perf_counter()
            while pending or self.sched.has_work():
                now = time.perf_counter() - t0
                while pending and (pending[0][2] if len(pending[0]) > 2
                                   else 0.0) <= now:
                    r = pending.pop(0)
                    self.submit(r[0], r[1],
                                arrival=r[2] if len(r) > 2 else 0.0,
                                deadline_ms=r[3] if len(r) > 3 else None)
                if not self.sched.has_work():
                    time.sleep(min(max(pending[0][2] - now, 0.0), 0.01))
                    continue
                self.step(now)
        finally:
            if wd is not None:
                wd.stop()
        self._emit_summary(time.perf_counter() - t0)
        return sorted(self.results, key=lambda r: r["id"])

    def _emit_summary(self, wall: float) -> None:
        self.summary = self._summary_dict(wall)
        self.telemetry.emit("serve_summary", **self.summary)

    def _summary_dict(self, wall: float) -> dict:
        reg = self.telemetry.registry
        ttft = reg.histogram("serve/ttft")
        lat = reg.histogram("serve/token_latency")
        qw = reg.histogram("serve/queue_wait")
        tpot = reg.histogram("serve/tpot")
        steps = max(self.stats["decode_steps"], 1)
        drafted = self.stats["draft_tokens"]
        return {
            "requests": len(self.results),
            "output_tokens": sum(r["output_tokens"] for r in self.results),
            "wall_s": round(wall, 6),
            "tokens_per_sec": round(
                sum(r["output_tokens"] for r in self.results)
                / max(wall, 1e-9), 2),
            "ttft_p50_s": ttft.p50, "ttft_p95_s": ttft.p95,
            "token_latency_p50_s": lat.p50, "token_latency_p95_s": lat.p95,
            "tpot_p50_s": tpot.p50, "tpot_p95_s": tpot.p95,
            "queue_wait_p50_s": qw.p50, "queue_wait_p95_s": qw.p95,
            "slot_occupancy": round(self.stats["occupancy_sum"] / steps, 4),
            "pool_peak_utilization": round(
                self.pool.peak_in_use / self.num_blocks, 4),
            "decode_steps": self.stats["decode_steps"],
            "decode_compiles": self.stats["decode_compiles"],
            "prefill_chunks": self.stats["prefill_chunks"],
            "decode_stall_ticks_max":
                self.stats["decode_stall_ticks_max"],
            "speculator": self.scfg.speculator,
            "draft_len": self.draft_len,
            "draft_tokens": drafted,
            "accepted_draft_tokens": self.stats["accepted_draft_tokens"],
            "acceptance_rate": (
                round(self.stats["accepted_draft_tokens"] / drafted, 4)
                if drafted else None),
            "preemptions": self.sched.n_preempted,
            "shed": self.sched.n_shed,
            "cancelled": self.stats["cancelled"],
            "slots": self.num_slots,
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
        }

    def close(self) -> None:
        if self._owns_telemetry:
            self.telemetry.close()
