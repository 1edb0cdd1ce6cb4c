"""Disaggregated serving: prefill and decode as separately placed pools
(port of picotron_tpu/serve/disagg.py).

Under heavy mixed traffic the colocated engine has one structural
weakness: admission couples a request's PREFILL to a DECODE slot, so a
burst of long prompts occupies decode slots with chunked prefill work
and the in-flight decode batch starves (the TTFT/TPOT SLO killer). This
engine splits the two phases into pools of their own:

- **Prefill pool**: `prefill_slots` slots over `prefill_num_blocks`
  blocks on the device `prefill_device` names, running the colocated
  engine's prefill program (chunked, batched over mid-prefill slots).
  Admission is budgeted against THIS pool only.
- **Decode pool**: `decode_slots` slots over `num_blocks` blocks on
  `decode_device`, running the colocated engine's decode program
  (speculative or not) through the `_decode_tick` it inherits. A burst
  of long prompts cannot touch it: `tools.serve_bench --disagg` measures
  the max consecutive decode-stall ticks dropping against colocated.
- **Handoff** (`_copy_blocks`): a block gather out of the prefill pool
  on its device, ONE explicit `.to(decode device)` of the staging buffer
  (a device-local copy when both pools share a card), and an indexed
  write into the decode pool. The index vectors are always
  [max_blocks] wide: the source padded with block 0, the destination
  with the decode pool's scratch block (serve/paged_cache.py), where
  every padding row lands.

Placement: each pool sits on the device its config field names, an index
into the visible devices (`torch.cuda.device_count()`, or the one CPU);
-1 is the JAX package's default, decode on device 0 and prefill on
device 1 when there is more than one, else on device 0 too. The model
is shared when both pools share a device and copied to the prefill
device when they do not (weight replication is the standard
disaggregation cost); a model the engine is given on another device
than the decode pool's is copied there. A tp rank's model (from
`generate.place_for_decode`) puts both pools on the rank's device: the
pools and the handoff still exist, only the physical separation
collapses (the JAX "mesh" case).

Token parity: both pools run the colocated engine's programs over the
same paged-cache layout, and sampling is keyed by (seed, request id,
token index) alone, so disaggregated tokens equal the colocated
engine's (and, greedy, `generate`'s and the JAX disaggregated engine's)
on any trace, under preemption too.

The JAX engine's variant-hazard check runs over both pools
(`analysis/variants.check_engine_feed`: every persistent input on its
pool's device, each hazard a `variant_hazard` event), and
`analysis/variants.prove_disagg_programs` proves the four programs'
signatures from the config alone. The handoff's worst case is priced by
`analysis/cost_model.price_kv_handoff` (the bench's
`predicted_handoff_*` fields).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.config import ServeConfig
from picotron_tpu_torch.generate import kv_heads, load_for_decode, model_device
from picotron_tpu_torch.models.llama import model_rope_tables
from picotron_tpu_torch.resilience import watchdog
from picotron_tpu_torch.serve.engine import ServeEngine
from picotron_tpu_torch.serve.paged_cache import (
    BlockPool, PagedKVCache, init_paged_cache,
)
from picotron_tpu_torch.serve.scheduler import DisaggScheduler
from picotron_tpu_torch.telemetry import Telemetry
from picotron_tpu_torch.utils import cuda_or_cpu


def model_copy(model, device) -> torch.nn.Module:
    """A whole model's copy of its own on `device`, each tensor copied
    straight there (no second copy on the model's own device)."""
    sd = {n: t.to(device, copy=True) for n, t in model.state_dict().items()}
    return load_for_decode(sd, model.cfg, device)


def pool_devices(scfg: ServeConfig, model, device_type: str):
    """(decode device, prefill device) of the config's indices into the
    visible devices, -1 resolving to the JAX defaults; a tp rank's model
    pins both to its own device."""
    if model.tp is not None:
        return model_device(model), model_device(model)
    n = torch.cuda.device_count() if device_type == "cuda" else 1
    d_idx = scfg.decode_device if scfg.decode_device >= 0 else 0
    p_idx = (scfg.prefill_device if scfg.prefill_device >= 0
             else (1 if n > 1 else 0))
    for name, idx in (("decode_device", d_idx), ("prefill_device", p_idx)):
        if idx >= n:
            raise ValueError(f"serve.{name} = {idx} but only {n} "
                             f"device(s) are visible")
    if device_type == "cpu":
        return torch.device("cpu"), torch.device("cpu")
    return torch.device("cuda", d_idx), torch.device("cuda", p_idx)


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A fresh host array on `device`; to CUDA through pinned memory with
    a non-blocking copy (a pageable copy would wait for the stream)."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@torch.no_grad()
def _handoff_impl(k_p, v_p, k, v, idx_src, idx_dst) -> None:
    """Carry one sequence's K/V across the pool boundary, with no host
    read: gather its blocks out of the prefill pool k_p/v_p [L, N_p + 1,
    bs, Hkv, D] on the prefill device (idx_src [max_blocks], 0-padded),
    copy the staging buffer to the decode device, and write it into the
    decode pool k/v at idx_dst [max_blocks]. The destination's padding is
    the decode pool's scratch block (index N_d), so every padding row
    lands there; with duplicate indices the last writer is unspecified on
    CUDA, and that does not matter: the scratch block only has to stay
    finite, and the padding rows are real pool rows of finite K/V."""
    buf_k = k_p.index_select(1, idx_src).to(k.device)
    buf_v = v_p.index_select(1, idx_src).to(v.device)
    k.index_copy_(1, idx_dst, buf_k)
    v.index_copy_(1, idx_dst, buf_v)


class DisaggServeEngine(ServeEngine):
    """Same public surface as ServeEngine (submit / step / run / cancel /
    summary / results / close: the bench and the tests drive either
    through one code path), backed by two pools. Inherits the decode
    tick, the retirement and telemetry plumbing and the trace loop;
    owns admission -> prefill -> handoff. `device` names the device type
    (default cuda, which must exist); the config's indices pick the
    cards."""

    def __init__(self, model, serve_cfg: Optional[ServeConfig] = None, *,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 telemetry: Optional[Telemetry] = None, device=None,
                 engine_id: int = 0):
        scfg = serve_cfg or ServeConfig()
        scfg.validate()
        dev_type = cuda_or_cpu("cuda" if device is None
                               else str(device)).type
        if model_device(model).type != dev_type:
            raise ValueError(f"the model is on {model_device(model)}, not "
                             f"on the engine's device type {dev_type}")
        dev_d, dev_p = pool_devices(scfg, model, dev_type)
        model_d = (model if model_device(model) == dev_d
                   else model_copy(model, dev_d))
        super().__init__(model_d, scfg, eos_token_id=eos_token_id,
                         temperature=temperature, top_k=top_k, seed=seed,
                         telemetry=telemetry, device=dev_d,
                         engine_id=engine_id)
        self.device_p = dev_p
        self.model_p = (model_d if dev_p == dev_d
                        else model_copy(model_d, dev_p))
        self.cos_p, self.sin_p = (
            (self.cos, self.sin) if dev_p == dev_d
            else model_rope_tables(self.cfg, max_len=self.max_len,
                                   device=dev_p))
        self.num_pslots = scfg.prefill_slots or scfg.decode_slots
        self.pnum_blocks = (scfg.prefill_num_blocks
                            or self.num_pslots * self.max_blocks)
        pcache = init_paged_cache(self.cfg, self.pnum_blocks,
                                  self.block_size, self.num_pslots,
                                  self.max_blocks, device=dev_p,
                                  heads=kv_heads(self.model_p))
        self._k_p, self._v_p = pcache.k, pcache.v
        # host table mirror of the prefill pool; pnum_blocks = unmapped
        self._tables_p = np.full((self.num_pslots, self.max_blocks),
                                 self.pnum_blocks, np.int64)
        self.pool_p = BlockPool(self.pnum_blocks)
        self.sched = DisaggScheduler(self.num_pslots, self.num_slots,
                                     self.pool_p, self.pool,
                                     self.block_size, self.max_blocks)
        self.stats.update(prefill_occupancy_sum=0.0, prefill_ticks=0,
                          handoffs=0, handoff_s=0.0, handoff_blocks=0)
        # the base engine checked the decode pool; now both pools
        self.variant_report = self._audit_feed()

    # -- prefill-pool table mirror ----------------------------------------

    def _sync_ptable(self, pslot: int) -> None:
        st = self.sched.pslots[pslot]
        row = np.full((self.max_blocks,), self.pnum_blocks, np.int64)
        if st is not None and st.blocks:
            row[:len(st.blocks)] = st.blocks
        self._tables_p[pslot] = row

    # -- handoff -----------------------------------------------------------

    def _copy_blocks(self, src: list, dst: list) -> None:
        """One sequence's K/V across the pool boundary: the [max_blocks]
        index vectors uploaded without a host sync (pinned, non-blocking
        on CUDA), then `_handoff_impl`, which reads nothing on the host."""
        idx_src = np.zeros((self.max_blocks,), np.int64)
        idx_src[:len(src)] = src
        idx_dst = np.full((self.max_blocks,), self.num_blocks, np.int64)
        idx_dst[:len(dst)] = dst
        _handoff_impl(self._k_p, self._v_p, self._k, self._v,
                      _upload(idx_src, self.device_p),
                      _upload(idx_dst, self.device))

    # -- one engine iteration ---------------------------------------------

    def step(self, now: Optional[float] = None) -> bool:
        """Admit into the prefill pool; run ONE batched prefill chunk on
        the prefill device; hand finished prefixes across the boundary;
        run ONE decode dispatch on the decode device. Returns whether any
        device work ran."""
        if now is None:
            now = time.perf_counter() - self._t0
        reg = self.telemetry.registry

        for pslot, st in self.sched.admit(now):
            self._sync_ptable(pslot)
            wait = max(now - st.req.arrival, 0.0)
            self.telemetry.emit("phase", phase="queue_wait",
                                category="queue_wait", secs=wait,
                                id=st.req.id)
            reg.histogram("serve/queue_wait").observe(wait)
        for st in self.sched.drain_shed():
            self._emit_shed(st, now)

        worked = False

        # ---- prefill chunks, batched over the PREFILL pool's slots
        pslots = self.sched.prefill_slots()
        if pslots:
            c = self.scfg.prefill_chunk
            ids = np.zeros((self.num_pslots, c), np.int64)
            start = np.zeros((self.num_pslots,), np.int64)
            nval = np.zeros((self.num_pslots,), np.int64)
            rids = np.zeros((self.num_pslots,), np.int64)
            tidx = np.zeros((self.num_pslots,), np.int64)
            finals = []
            for s in pslots:
                st = self.sched.pslots[s]
                chunk = st.prefill_ids[st.n_prefilled:st.n_prefilled + c]
                ids[s, :len(chunk)] = chunk
                start[s] = st.n_prefilled
                nval[s] = len(chunk)
                rids[s] = st.req.id
                tidx[s] = len(st.generated)
                if st.n_prefilled + len(chunk) >= len(st.prefill_ids):
                    finals.append(s)

            def up(a):
                return self._up(a, self.device_p)

            self._drain_compile()
            if watchdog.active():
                watchdog.touch(
                    f"serve engine={self.engine_id} dispatch=prefill")
            t0 = time.perf_counter()
            toks_d = self._prefill_fn(
                self.model_p,
                PagedKVCache(self._k_p, self._v_p, up(self._tables_p)),
                up(ids), up(start), up(nval), up(rids), up(tidx),
                self.seed, self.cos_p, self.sin_p,
                temperature=self.temperature, top_k=self.top_k)
            toks = toks_d.cpu().numpy() if finals else None
            dt = time.perf_counter() - t0
            dt -= min(self._drain_compile(), dt)
            n_prefilled = int(nval.sum())
            self.telemetry.emit("phase", phase="prefill",
                                category="prefill", secs=dt,
                                tokens=n_prefilled, pool="prefill",
                                ids=[int(rids[s]) for s in pslots])
            for s in pslots:
                self.sched.note_prefilled(s, int(nval[s]))
            self.stats["prefill_chunks"] += len(pslots)
            self.stats["prefill_tokens"] += n_prefilled
            for s in finals:
                st = self.sched.pslots[s]
                st.generated.append(int(toks[s]))
                self.stats["output_tokens"] += 1
                if st.t_first_token is None:
                    st.t_first_token = now + dt
                    ttft = max(st.t_first_token - st.req.arrival, 0.0)
                    reg.histogram("serve/ttft").observe(ttft)
                if self.sched.should_retire(s, self.eos_token_id,
                                            pslot=True):
                    # the first token already finishes it: retire straight
                    # from the prefill pool, no handoff needed
                    st = self.sched.retire_prefill(s)
                    self._sync_ptable(s)
                    self._emit_retired(st, now + dt)
            worked = True
        self.stats["prefill_ticks"] += 1
        self.stats["prefill_occupancy_sum"] += (
            sum(s is not None for s in self.sched.pslots)
            / self.num_pslots)

        # ---- handoff: the oldest finished prefixes cross the boundary
        for pslot in self.sched.handoff_ready():
            got = self.sched.handoff(pslot)
            if got is None:
                break  # youngest everywhere: wait for decode capacity
            dslot, src, dst, preempted = got
            t0 = time.perf_counter()
            self._copy_blocks(src, dst)
            # the host's enqueue, as the JAX engine's: no sync to time it
            dt = time.perf_counter() - t0
            dt -= min(self._drain_compile(), dt)
            self._sync_ptable(pslot)
            for p in preempted:
                self._sync_table(p)
            self._sync_table(dslot)
            self.stats["handoffs"] += 1
            self.stats["handoff_s"] += dt
            self.stats["handoff_blocks"] += len(src)
            self.telemetry.emit("phase", phase="handoff",
                                category="handoff", secs=dt,
                                id=self.sched.slots[dslot].req.id,
                                blocks=len(src))
            worked = True

        # ---- one decode dispatch on the decode pool (inherited: the
        # decode-side model, pool and the scheduler's decode half)
        decode_ran = self._decode_tick(now, reg)
        worked = worked or decode_ran
        if decode_ran:
            self._stall_streak = 0
        elif self.sched.has_work():
            self._stall_streak += 1
            self.stats["decode_stall_ticks_max"] = max(
                self.stats["decode_stall_ticks_max"], self._stall_streak)
        return worked

    # -- summary -----------------------------------------------------------

    def _summary_dict(self, wall: float) -> dict:
        pticks = max(self.stats["prefill_ticks"], 1)
        return dict(
            super()._summary_dict(wall),
            disagg=True,
            prefill_slots=self.num_pslots,
            prefill_num_blocks=self.pnum_blocks,
            prefill_slot_occupancy=round(
                self.stats["prefill_occupancy_sum"] / pticks, 4),
            prefill_pool_peak_utilization=round(
                self.pool_p.peak_in_use / self.pnum_blocks, 4),
            handoffs=self.stats["handoffs"],
            handoff_s=round(self.stats["handoff_s"], 6),
            handoff_blocks=self.stats["handoff_blocks"],
        )
