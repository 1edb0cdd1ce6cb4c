"""Serving stack of the port (port of picotron_tpu/serve/): continuous
batching over a paged KV cache on the decode path.

- `paged_cache`: block-pool KV cache (fixed-size blocks, per-slot block
  tables, memory ~ blocks allocated, not batch x max_length, plus one
  scratch block that takes every write that must not land) behind the
  same interface as the offline contiguous `generate.KVCache`.
- `scheduler`: FIFO admission into a fixed decode-slot batch, chunked
  prefill, youngest-first preemption with recompute, retirement — pure
  host logic, held to the JAX package's decision by decision.
- `engine`: `ServeEngine`, two device programs (a decode dispatch of
  `decode_interval` steps over every slot, and one prefill chunk per
  mid-prefill slot) plus telemetry (queue_wait/prefill/decode in the
  GoodputLedger, TTFT/TPOT histograms, serve_request/serve_summary
  JSONL).
- `spec_decode`: self-drafting n-gram speculation, verify-and-accept in
  one dispatch; its tokens are the non-speculative ones.

Not ported yet (the rest of ROADMAP Queue 1 item 11): the JAX package's
`DisaggServeEngine` and `DisaggScheduler` (serve/disagg.py: prefill and
decode as separately placed pools with KV block handoff) and
`FleetSupervisor` (serve/fleet.py: engine replicas behind one queue with
failover, deadline shedding and drain).
"""

from picotron_tpu_torch.serve.engine import ServeEngine
from picotron_tpu_torch.serve.paged_cache import (
    BlockPool, PagedKVCache, init_paged_cache,
)
from picotron_tpu_torch.serve.scheduler import (
    Request, RequestState, Scheduler, blocks_for,
)

__all__ = [
    "BlockPool",
    "PagedKVCache",
    "Request",
    "RequestState",
    "Scheduler",
    "ServeEngine",
    "blocks_for",
    "init_paged_cache",
]
