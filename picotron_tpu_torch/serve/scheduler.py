"""Continuous-batching scheduler: request queue, slot lifecycle,
block-budgeted admission and preemption (the port's copy of
picotron_tpu/serve/scheduler.py). Pure host logic, so every policy
decision is unit-testable without touching a device, and the tests hold
it to the JAX package's decision by decision. `DisaggScheduler` splits
the slot set in two, prefill and decode, with a handoff boundary between
their pools (the disaggregated engine's, serve/disagg.py).

Lifecycle: submitted requests wait in a FIFO queue; admission takes the
HEAD request whenever a decode slot is free AND the block pool can cover
its whole prefix (head-of-line, no skipping — a short request can never
starve a long one that arrived first). An admitted request prefills in
chunks (the engine interleaves one chunk per decode step so a long
prompt cannot stall in-flight decodes), then decodes one token per
engine step until EOS or its token budget retires it — the slot and its
blocks return to the pool and the next queued request is admitted into
the still-running decode batch. That refill is the whole point of
continuous batching: finished slots stop idling until the batch drains.

Preemption: decode allocates blocks lazily (one whenever a sequence
crosses a block boundary). When the pool is empty the YOUNGEST live
request is preempted — its blocks are freed and it is requeued at the
FRONT with its generated tokens folded into the prefill prefix
(vLLM-style recompute: no tokens are lost, and because sampling keys are
derived from (request id, token index) the continuation is
token-identical to an uninterrupted run). Preempting youngest-first
means the oldest request always makes progress, so the system cannot
livelock; a single request that cannot fit the pool alone is a
configuration error and raises.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class Request:
    """One generation request. `arrival` is seconds on the trace clock
    (the engine's `run` submits each request once its arrival passes).
    `deadline_ms`, when set, is an ADMISSION deadline: a request still
    queued once its wait exceeds it is shed (rejected, never run) rather
    than admitted late — the load-shedding contract that keeps an
    overload burst from degrading every admitted request's TTFT. None =
    wait forever (the pre-fleet behavior)."""

    id: int
    prompt: tuple
    max_new_tokens: int
    arrival: float = 0.0
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(int(t) for t in self.prompt))
        if not self.prompt:
            raise ValueError(f"request {self.id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.id}: max_new_tokens must be >= 1")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"request {self.id}: deadline_ms must be > 0 (None = no "
                f"deadline), got {self.deadline_ms}")


@dataclass
class RequestState:
    """Queue/slot-resident mutable state. `generated` survives preemption
    (recompute folds it into the next prefill prefix)."""

    req: Request
    generated: list = field(default_factory=list)
    prefill_ids: tuple = ()   # snapshot at admission: prompt + generated
    n_prefilled: int = 0
    blocks: list = field(default_factory=list)
    admit_seq: int = -1
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    n_preempted: int = 0

    @property
    def prefilling(self) -> bool:
        return self.n_prefilled < len(self.prefill_ids)

    @property
    def write_pos(self) -> int:
        """Global position of the newest generated token (where the next
        decode step writes its K/V)."""
        return len(self.req.prompt) + len(self.generated) - 1

    @property
    def last_token(self) -> int:
        return self.generated[-1]


def blocks_for(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


class Scheduler:
    def __init__(self, num_slots: int, pool, block_size: int,
                 max_blocks: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.pool = pool
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.queue: deque = deque()
        self.slots: list = [None] * num_slots
        self._admit_seq = 0
        self.n_admitted = 0
        self.n_preempted = 0
        self.n_retired = 0
        self.n_shed = 0
        self.n_cancelled = 0
        # shed-but-not-yet-reported states; the engine drains this after
        # each admit() and emits the serve_shed telemetry per entry
        self.shed: list = []

    # -- intake ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Reject-at-submit anything that could NEVER run: a request whose
        full prefix + budget exceeds per-slot capacity or the whole pool
        would otherwise deadlock admission forever."""
        need = blocks_for(len(req.prompt) + req.max_new_tokens,
                          self.block_size)
        if need > self.max_blocks:
            raise ValueError(
                f"request {req.id}: {len(req.prompt)} prompt + "
                f"{req.max_new_tokens} new tokens needs {need} blocks, "
                f"over the per-slot table capacity ({self.max_blocks}); "
                f"raise serve.max_model_len")
        if need > self.pool.num_blocks:
            raise ValueError(
                f"request {req.id}: needs {need} blocks but the whole "
                f"pool holds {self.pool.num_blocks}; raise "
                f"serve.num_blocks")
        self.queue.append(RequestState(req))

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    # -- admission ---------------------------------------------------------

    def _shed_expired_head(self, now: float) -> bool:
        """Deadline admission: a head whose queue-wait already exceeds
        its deadline is REJECTED (popped into `self.shed`, never run) —
        decided here, at the admission attempt, so the shed set is a
        pure function of the trace clock and the queue order (no wall
        time, no races: the determinism the overload tests pin). Only
        the head is examined — head-of-line FIFO discipline holds for
        shedding exactly as it does for admission."""
        st = self.queue[0]
        dl = st.req.deadline_ms
        if dl is None or (now - st.req.arrival) * 1e3 <= dl:
            return False
        self.queue.popleft()
        self.shed.append(st)
        self.n_shed += 1
        return True

    def drain_shed(self) -> list:
        out, self.shed = self.shed, []
        return out

    def admit(self, now: float = 0.0) -> list:
        """Head-of-line FIFO admission while a slot is free and the pool
        covers the head's whole prefill prefix. Returns the (slot_index,
        RequestState) pairs admitted this call. Heads past their
        deadline are shed (even when every slot is busy — the queue must
        not back up behind the already-dead)."""
        out = []
        while self.queue:
            if self._shed_expired_head(now):
                continue
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            st = self.queue[0]
            st.prefill_ids = st.req.prompt + tuple(st.generated)
            blocks = self.pool.alloc(
                blocks_for(len(st.prefill_ids), self.block_size))
            if blocks is None:
                break
            self.queue.popleft()
            st.blocks = blocks
            st.n_prefilled = 0
            st.admit_seq = self._admit_seq
            st.t_admit = now
            self._admit_seq += 1
            self.n_admitted += 1
            slot = free[0]
            self.slots[slot] = st
            out.append((slot, st))
        return out

    # -- prefill -----------------------------------------------------------

    def prefill_slots(self) -> list:
        """Every slot still prefilling, oldest-admitted first — the
        engine batches one chunk of each into a single dispatch per
        iteration."""
        cands = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                 if s is not None and s.prefilling]
        return [i for _, i in sorted(cands)]

    def note_prefilled(self, slot: int, n_tokens: int) -> None:
        st = self.slots[slot]
        st.n_prefilled = min(st.n_prefilled + n_tokens,
                             len(st.prefill_ids))

    # -- decode ------------------------------------------------------------

    def decode_ready(self) -> list:
        """Slot indices with a completed prefill (>= 1 generated token)
        and budget left, oldest-admitted first — the order block
        allocation (and therefore preemption pressure) is applied in."""
        cands = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                 if s is not None and not s.prefilling and s.generated]
        return [i for _, i in sorted(cands)]

    def ensure_block(self, slot: int, horizon: int = 1):
        """Make sure the blocks holding positions write_pos ..
        write_pos + horizon - 1 (the K/V slots the next decode dispatch
        writes — horizon = the engine's decode interval) are mapped,
        preempting youngest-first until the allocation fits. Returns
        (ok, preempted_slot_indices); ok=False means this slot itself was
        the youngest and got preempted — skip its decode this round."""
        preempted = []
        st = self.slots[slot]
        # clamp to table capacity: interval padding past a request's
        # budget may point beyond max_model_len — those writes sentinel-
        # drop in the cache, and must not demand unallocatable blocks
        need_upto = min(blocks_for(st.write_pos + horizon, self.block_size),
                        self.max_blocks)
        while len(st.blocks) < need_upto:
            got = self.pool.alloc(1)
            if got is not None:
                st.blocks.extend(got)
                continue
            live = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                    if s is not None]
            if len(live) <= 1:
                raise RuntimeError(
                    f"block pool exhausted with a single live request "
                    f"(id {st.req.id}): serve.num_blocks "
                    f"({self.pool.num_blocks}) cannot hold one sequence; "
                    f"raise it")
            victim = max(live)[1]  # youngest admitted
            preempted.append(victim)
            self._preempt(victim)
            if victim == slot:
                return False, preempted
        return True, preempted

    def _preempt(self, slot: int) -> None:
        st = self.slots[slot]
        self.pool.free(st.blocks)
        st.blocks = []
        st.n_prefilled = 0
        st.prefill_ids = ()
        st.n_preempted += 1
        self.slots[slot] = None
        self.queue.appendleft(st)  # front: it keeps its arrival priority
        self.n_preempted += 1

    # -- cancellation ------------------------------------------------------

    def cancel(self, request_id: int):
        """Abandon a request wherever it lives — decode slot or queue —
        freeing any blocks it holds straight back to the pool (the
        no-leak contract: before this existed the only way to drop a
        request was engine teardown). Returns ("slot", index, state) or
        ("queue", None, state), or None when the id is unknown (already
        retired, shed, or never submitted)."""
        for i, s in enumerate(self.slots):
            if s is not None and s.req.id == request_id:
                self.pool.free(s.blocks)
                s.blocks = []
                self.slots[i] = None
                self.n_cancelled += 1
                return "slot", i, s
        for s in list(self.queue):
            if s.req.id == request_id:
                self.queue.remove(s)
                if s.blocks:  # queued states hold no blocks; defensive
                    self.pool.free(s.blocks)
                    s.blocks = []
                self.n_cancelled += 1
                return "queue", None, s
        return None

    # -- retirement --------------------------------------------------------

    def should_retire(self, slot: int, eos_token_id: Optional[int]) -> bool:
        st = self.slots[slot]
        return (len(st.generated) >= st.req.max_new_tokens
                or (eos_token_id is not None
                    and st.last_token == eos_token_id))

    def retire(self, slot: int) -> RequestState:
        st = self.slots[slot]
        self.pool.free(st.blocks)
        st.blocks = []
        self.slots[slot] = None
        self.n_retired += 1
        return st


class DisaggScheduler:
    """Scheduler for the disaggregated engine (serve/disagg.py): a
    PREFILL slot set backed by its own block pool, a DECODE slot set
    backed by another, and a handoff boundary between them.

    Lifecycle: queue -> prefill slot (chunked prefill against the
    prefill pool) -> handoff-ready (prefill complete, first token
    sampled) -> handoff (decode-pool blocks allocated, K/V copied by the
    engine, prefill blocks + slot freed) -> decode slot -> retirement.
    Admission is the same head-of-line FIFO as the colocated scheduler,
    but budgeted against the PREFILL pool and gated on a free PREFILL
    slot — which is the whole point: a burst of long prompts saturates
    the prefill side and leaves decode slots untouched.

    Preemption stays youngest-first ACROSS the handoff boundary: decode
    block growth preempts the youngest decode resident (as before), and
    a handoff candidate that cannot get a decode slot/blocks may preempt
    decode residents STRICTLY YOUNGER than itself — so the oldest
    request always makes progress whether it is decoding or waiting at
    the boundary, and the no-livelock argument carries over. Preempted
    requests requeue at the front and recompute through the prefill pool
    (generated tokens fold into the prefix; the (request id, token
    index) key fold keeps the continuation token-identical)."""

    def __init__(self, prefill_slots: int, decode_slots: int,
                 prefill_pool, decode_pool, block_size: int,
                 max_blocks: int):
        if prefill_slots < 1 or decode_slots < 1:
            raise ValueError(
                f"prefill_slots and decode_slots must be >= 1, got "
                f"{prefill_slots}/{decode_slots}")
        self.num_pslots = prefill_slots
        self.num_slots = decode_slots
        self.prefill_pool = prefill_pool
        self.pool = decode_pool  # name-compatible with Scheduler users
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.queue: deque = deque()
        self.pslots: list = [None] * prefill_slots
        self.slots: list = [None] * decode_slots
        self._admit_seq = 0
        self.n_admitted = 0
        self.n_preempted = 0
        self.n_retired = 0
        self.n_handoffs = 0
        self.n_shed = 0
        self.n_cancelled = 0
        self.shed: list = []

    # deadline shedding is a queue-head policy, identical on both sides
    # of the disaggregation split — share the colocated implementation
    _shed_expired_head = Scheduler._shed_expired_head
    drain_shed = Scheduler.drain_shed

    def cancel(self, request_id: int):
        """Scheduler.cancel plus the prefill side: a request caught
        mid-prefill frees back to the PREFILL pool."""
        for i, s in enumerate(self.pslots):
            if s is not None and s.req.id == request_id:
                self.prefill_pool.free(s.blocks)
                s.blocks = []
                self.pslots[i] = None
                self.n_cancelled += 1
                return "pslot", i, s
        return Scheduler.cancel(self, request_id)

    # -- intake ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Reject anything that could NEVER be served: the prefill pool
        must hold the whole prefix, the decode pool the prefix plus the
        token budget (each bounded by per-slot table capacity)."""
        prefix = blocks_for(len(req.prompt) + req.max_new_tokens - 1,
                            self.block_size)
        need = blocks_for(len(req.prompt) + req.max_new_tokens,
                          self.block_size)
        if need > self.max_blocks:
            raise ValueError(
                f"request {req.id}: {len(req.prompt)} prompt + "
                f"{req.max_new_tokens} new tokens needs {need} blocks, "
                f"over the per-slot table capacity ({self.max_blocks}); "
                f"raise serve.max_model_len")
        if prefix > self.prefill_pool.num_blocks:
            raise ValueError(
                f"request {req.id}: prefix needs {prefix} blocks but the "
                f"prefill pool holds {self.prefill_pool.num_blocks}; "
                f"raise serve.prefill_num_blocks")
        if need > self.pool.num_blocks:
            raise ValueError(
                f"request {req.id}: needs {need} blocks but the decode "
                f"pool holds {self.pool.num_blocks}; raise "
                f"serve.num_blocks")
        self.queue.append(RequestState(req))

    def has_work(self) -> bool:
        return (bool(self.queue)
                or any(s is not None for s in self.pslots)
                or any(s is not None for s in self.slots))

    # -- admission (into the prefill pool) ---------------------------------

    def admit(self, now: float = 0.0) -> list:
        """Head-of-line FIFO into free PREFILL slots while the prefill
        pool covers the head's whole prefill prefix (prompt + any
        recompute tokens, + 1 growth block for the sampled first token
        when the prefix ends block-aligned)."""
        out = []
        while self.queue:
            if self._shed_expired_head(now):
                continue
            free = [i for i, s in enumerate(self.pslots) if s is None]
            if not free:
                break
            st = self.queue[0]
            st.prefill_ids = st.req.prompt + tuple(st.generated)
            # the final chunk samples the first token, whose K/V lands
            # at position len(prefill_ids) on the NEXT dispatch — but
            # the handoff must carry every written position, so size to
            # the prefix only; the first generated token's write happens
            # decode-side after handoff
            blocks = self.prefill_pool.alloc(
                blocks_for(len(st.prefill_ids), self.block_size))
            if blocks is None:
                break
            self.queue.popleft()
            st.blocks = blocks
            st.n_prefilled = 0
            st.admit_seq = self._admit_seq
            st.t_admit = now
            self._admit_seq += 1
            self.n_admitted += 1
            slot = free[0]
            self.pslots[slot] = st
            out.append((slot, st))
        return out

    # -- prefill -----------------------------------------------------------

    def prefill_slots(self) -> list:
        cands = [(s.admit_seq, i) for i, s in enumerate(self.pslots)
                 if s is not None and s.prefilling]
        return [i for _, i in sorted(cands)]

    def note_prefilled(self, slot: int, n_tokens: int) -> None:
        st = self.pslots[slot]
        st.n_prefilled = min(st.n_prefilled + n_tokens,
                             len(st.prefill_ids))

    def retire_prefill(self, slot: int) -> RequestState:
        """Retire straight out of the prefill pool — a request whose
        FIRST token already hits EOS or exhausts its budget never needs
        a decode slot (or a handoff)."""
        st = self.pslots[slot]
        self.prefill_pool.free(st.blocks)
        st.blocks = []
        self.pslots[slot] = None
        self.n_retired += 1
        return st

    # -- handoff boundary --------------------------------------------------

    def handoff_ready(self) -> list:
        """Prefill-slot indices whose prefill is complete and first token
        sampled, oldest-admitted first — the order handoffs are
        attempted (and therefore the order decode-slot pressure is
        applied in)."""
        cands = [(s.admit_seq, i) for i, s in enumerate(self.pslots)
                 if s is not None and not s.prefilling and s.generated]
        return [i for _, i in sorted(cands)]

    def handoff(self, pslot: int):
        """Move the request in prefill slot `pslot` across the boundary:
        allocate decode-pool blocks for its prefix, free the prefill
        side, install it in a decode slot. May preempt decode residents
        STRICTLY YOUNGER than the candidate (youngest first) to make
        room. Returns (decode_slot, src_blocks, dst_blocks, preempted)
        — src/dst are the physical block ids the engine must copy K/V
        between — or None when the candidate must keep waiting (it is
        the youngest, so someone older is making progress)."""
        st = self.pslots[pslot]
        need = blocks_for(len(st.prefill_ids), self.block_size)
        preempted = []

        def free_slot():
            return next((i for i, s in enumerate(self.slots)
                         if s is None), None)

        def try_alloc():
            return (self.pool.alloc(need)
                    if free_slot() is not None else None)

        dst = try_alloc()
        while dst is None:
            younger = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                       if s is not None and s.admit_seq > st.admit_seq]
            if not younger:
                return None
            victim = max(younger)[1]
            preempted.append(victim)
            self._preempt_decode(victim)
            dst = try_alloc()
        src = list(st.blocks)
        self.prefill_pool.free(st.blocks)
        st.blocks = dst
        self.pslots[pslot] = None
        dslot = free_slot()
        self.slots[dslot] = st
        self.n_handoffs += 1
        return dslot, src, dst, preempted

    # -- decode ------------------------------------------------------------

    def decode_ready(self) -> list:
        cands = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                 if s is not None and s.generated]
        return [i for _, i in sorted(cands)]

    def ensure_block(self, slot: int, horizon: int = 1):
        """Identical policy to Scheduler.ensure_block, over the decode
        pool and decode residents only (prefill residents are never
        preempted by decode growth — their pool is separate, which is
        the isolation the split exists to provide)."""
        preempted = []
        st = self.slots[slot]
        need_upto = min(blocks_for(st.write_pos + horizon,
                                   self.block_size), self.max_blocks)
        while len(st.blocks) < need_upto:
            got = self.pool.alloc(1)
            if got is not None:
                st.blocks.extend(got)
                continue
            live = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                    if s is not None]
            if len(live) <= 1:
                raise RuntimeError(
                    f"decode block pool exhausted with a single live "
                    f"request (id {st.req.id}): serve.num_blocks "
                    f"({self.pool.num_blocks}) cannot hold one "
                    f"sequence; raise it")
            victim = max(live)[1]
            preempted.append(victim)
            self._preempt_decode(victim)
            if victim == slot:
                return False, preempted
        return True, preempted

    def _preempt_decode(self, slot: int) -> None:
        st = self.slots[slot]
        self.pool.free(st.blocks)
        st.blocks = []
        st.n_prefilled = 0
        st.prefill_ids = ()
        st.n_preempted += 1
        self.slots[slot] = None
        self.queue.appendleft(st)
        self.n_preempted += 1

    # -- retirement --------------------------------------------------------

    def should_retire(self, slot: int, eos_token_id: Optional[int],
                      pslot: bool = False) -> bool:
        st = (self.pslots if pslot else self.slots)[slot]
        return (len(st.generated) >= st.req.max_new_tokens
                or (eos_token_id is not None
                    and st.last_token == eos_token_id))

    def retire(self, slot: int) -> RequestState:
        st = self.slots[slot]
        self.pool.free(st.blocks)
        st.blocks = []
        self.slots[slot] = None
        self.n_retired += 1
        return st
