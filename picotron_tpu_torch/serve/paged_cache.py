"""Block/paged KV cache for the serving decode path (port of
picotron_tpu/serve/paged_cache.py).

The offline `generate.KVCache` pays `batch x max_length` memory for every
sequence; at serving batch sizes with ragged request lengths most of it
is stranded. The paged cache allocates fixed-size BLOCKS from one shared
pool and maps each decode slot's logical positions onto physical blocks
through a per-slot block table (the vLLM arrangement):

- ``k``/``v``: ``[L, num_blocks + 1, block_size, Hkv, D]`` — the pool
  and one SCRATCH block past it, at index ``num_blocks``. Persistent
  cache memory scales with the blocks provisioned, not with ``slots x
  max_length``.
- ``tables``: ``[B, max_blocks]`` int64, logical block -> physical block;
  ``num_blocks`` (the scratch block) marks an unmapped entry.

The JAX pool drops out-of-range scatters (``mode="drop"``) and clamps
out-of-range gathers into the pool. In torch the same index raises on the
CPU and fires a device-side assert on CUDA, so the port routes every write
that must not land (positions < 0: idle slots and chunk padding;
positions past the table; unmapped table entries) to the scratch block,
and an unmapped table entry gathers the scratch block. No dropped write
can reach a live block. The scratch block holds only K/V computed from
real (finite) inputs, so the gathered view stays finite, and the causal
mask screens every slot it surfaces: masked columns softmax to exact
zeros, as in JAX.

Writes use one advanced-indexing scatter for decode (one token per slot,
each at its own position) and chunked prefill (a contiguous span per
slot). The attention view gathers a slot's blocks back into logical
order, so `generate._cached_attention` runs on it unchanged: slot j of the
gathered view holds the token at position j, exactly like the contiguous
cache, which is what makes paged-vs-contiguous greedy parity structural.
The view is a transient copy of ``max_blocks * block_size`` rows per
layer (the JAX design; a paged-attention kernel would be a feature the
JAX package lacks).

`BlockPool` is the host-side allocator: free-list alloc/free with
all-or-nothing semantics and peak accounting.
"""

from __future__ import annotations

from typing import Optional

import torch

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.models.llama import compute_dtype


class PagedKVCache:
    """Pool-backed cache, written in place; same interface as
    `generate.KVCache` (num_layers / slots / write / layer_view)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 tables: torch.Tensor):
        self.k, self.v, self.tables = k, v, tables

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_blocks(self) -> int:
        """Real blocks; index num_blocks is the scratch block."""
        return self.k.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    def slots(self, q_pos):
        """(physical block, offset) [B, s] each of every token at q_pos
        ([s] batch-shared or [B, s] per-slot global positions); positions
        < 0, positions beyond the table's capacity and unmapped table
        entries all resolve to the scratch block."""
        if q_pos.dim() == 1:
            q_pos = q_pos[None].expand(self.tables.shape[0], -1)
        pos = q_pos.clamp(min=0)
        blk = pos // self.block_size
        width = self.tables.shape[1]
        phys = torch.gather(self.tables, 1, blk.clamp(max=width - 1))
        ok = (q_pos >= 0) & (blk < width)
        return (torch.where(ok, phys, self.num_blocks),
                pos % self.block_size)

    def write(self, li: int, k_new, v_new, slots) -> "PagedKVCache":
        """Scatter K/V [B, s, Hkv, D] into layer li at `slots`."""
        phys, off = slots
        self.k[li][phys, off] = k_new
        self.v[li][phys, off] = v_new
        return self

    def layer_view(self, li: int):
        """Layer li's blocks gathered back into logical order:
        ([B, max_blocks * block_size, Hkv, D], same), slot j holding the
        token at position j. Unmapped entries surface the scratch block,
        beyond every live q position and causally masked."""
        b, mb = self.tables.shape
        shape = (b, mb * self.block_size) + self.k.shape[3:]
        return (self.k[li][self.tables].reshape(shape),
                self.v[li][self.tables].reshape(shape))


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     num_slots: int, max_blocks: int, device=None,
                     heads: Optional[int] = None) -> PagedKVCache:
    """Zeroed pool (num_blocks + the scratch block) and all-unmapped
    tables. Pool memory is L * (num_blocks + 1) * block_size * Hkv * D *
    2 tensors, independent of num_slots * max_length; `heads` defaults
    to Hkv (a tp rank's pool holds Hkv/tp)."""
    shape = (cfg.num_hidden_layers, num_blocks + 1, block_size,
             heads or cfg.num_key_value_heads, cfg.head_dim)
    dt = compute_dtype(cfg)
    tables = torch.full((num_slots, max_blocks), num_blocks,
                        dtype=torch.long, device=device)
    return PagedKVCache(torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device), tables)


class BlockPool:
    """Host-side free-list allocator over the physical blocks.

    All-or-nothing `alloc(n)` (a partially-allocated sequence could never
    run and would strand blocks), LIFO reuse, and peak accounting for the
    pool-utilization telemetry."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self.peak_in_use = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[list]:
        """n physical block ids, or None (and no state change) when the
        pool cannot cover all n."""
        if n < 0:
            raise ValueError(f"alloc count must be >= 0, got {n}")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def free(self, blocks) -> None:
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"freeing unknown block {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)
