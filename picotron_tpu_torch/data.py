"""Data pipeline (port of picotron_tpu/data.py).

`SyntheticSource` is the same numpy stream as the JAX package's (a pure
function of (seed, epoch, start)), so both packages read the same tokens.
`MicroBatchDataLoader` keeps the (epoch, cursor) state, `set_state` and
`reset`, drops the epoch tail like the reference, and yields
(input_ids, targets) shaped [grad_acc, mbs, seq] as int64 tensors on the
loader's device. Under a dp (and ep) layout each rank reads the same
global batch ([grad_acc, mbs * dp * ep, seq], the JAX loader's) and keeps
its data index's rows [d * mbs, (d + 1) * mbs) of every microbatch, d =
dp rank * ep + ep rank (the JAX batch sharding over the fused ('dp',
'ep') axis, `P(None, ("dp", "ep"), "cp")`); the cursor and `state` stay
the global ones, so every rank holds the same state. tp ranks read the
same rows. Under context parallelism the ids and targets are permuted along the sequence
after the shift (`cp_sequence_permutation`: the zigzag layout, or none
for the contiguous one), and each rank keeps its cp index's contiguous
slice [c * S/cp, (c + 1) * S/cp) of the permuted sequence (the JAX
loader's P(None, 'dp', 'cp') sharding after its permutation). Under
pipeline parallelism every stage reads its (dp, cp) rows, replicated
over pp, with the same cursor on every stage (the JAX loader's batch
sharding leaves pp out; the first stage reads the ids, the last the
targets). `build_eval_source` is the validation stream. HF datasets, the prefetch
thread, chaos and I/O retry come in a later slice.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from picotron_tpu_torch.config import Config


def cp_sequence_permutation(cfg: Config):
    """The permutation of the sequence axis before the cp slicing, or None
    for the identity (the contiguous layout). Zigzag: of 2*cp equal chunks,
    cp index r receives chunks (r, 2cp-1-r), one early and one late, so
    that the causal work is balanced around the ring (port of
    picotron_tpu/data.py:53-72). The model reads each token's global
    position from the same layout (`parallel/cp.CPLayout`)."""
    d, s = cfg.distributed, cfg.training.seq_length
    if d.cp_size <= 1 or d.cp_layout != "zigzag":
        return None
    half = s // (2 * d.cp_size)
    chunks = []
    for r in range(d.cp_size):
        chunks.append(np.arange(r * half, (r + 1) * half))
        hi = 2 * d.cp_size - 1 - r
        chunks.append(np.arange(hi * half, (hi + 1) * half))
    return np.concatenate(chunks)


class SyntheticSource:
    """Deterministic PRNG token blocks of seq_length + 1 tokens."""

    def __init__(self, vocab_size: int, seq_length: int, seed: int = 0,
                 num_samples: Optional[int] = None):
        self.vocab_size = vocab_size
        self.block = seq_length + 1
        self.seed = seed
        self.num_samples = num_samples or 1 << 30

    def __len__(self) -> int:
        return self.num_samples

    def get_rows(self, epoch: int, start: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, start]))
        return rng.integers(0, self.vocab_size, (n, self.block), dtype=np.int32)


def build_eval_source(cfg: Config) -> SyntheticSource:
    """Validation batch source (training.eval_frequency > 0): a synthetic
    stream on a seed offset disjoint from training's, the JAX package's
    `build_eval_source` for synthetic data."""
    if cfg.dataset.name != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.dataset.name!r}: only the synthetic eval source "
            "is ported (HF datasets are ROADMAP Queue 1 item 5)")
    return SyntheticSource(cfg.model.vocab_size, cfg.training.seq_length,
                           seed=cfg.training.seed + 104729,
                           num_samples=cfg.training.num_samples)


class MicroBatchDataLoader:
    """Infinite iterator of (input_ids, targets) [grad_acc, mbs,
    seq / cp] on `device`: the rows of data index dp_rank * ep + ep_rank
    of the global batch, cp index `cp_rank`'s slice of their (permuted)
    sequence; exhausting the source bumps the epoch. `state` is the
    position after the last batch handed out."""

    def __init__(self, cfg: Config, device, source=None, dp_rank: int = 0,
                 cp_rank: int = 0, ep_rank: int = 0):
        d = cfg.distributed
        for name, r, n in (("dp_rank", dp_rank, d.dp_size),
                           ("cp_rank", cp_rank, d.cp_size),
                           ("ep_rank", ep_rank, d.ep_size)):
            if not 0 <= r < n:
                raise ValueError(f"{name} {r} outside {n}")
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.cp_rank = cp_rank
        self.row = dp_rank * d.ep_size + ep_rank
        self.cp_perm = cp_sequence_permutation(cfg)
        self.device = torch.device(device)
        self.global_batch_size = cfg.global_batch_size
        self.seq_length = cfg.training.seq_length
        self.source = source if source is not None else self._build_source()
        if len(self.source) < self.global_batch_size:
            raise ValueError(
                f"dataset has {len(self.source)} blocks < one step's "
                f"{self.global_batch_size}")
        self.epoch = 0
        self.cursor = 0
        self._consumed_state = {"epoch": 0, "cursor": 0}

    def _build_source(self):
        d = self.cfg.dataset
        if d.name != "synthetic":
            raise NotImplementedError(
                f"dataset {d.name!r}: only the synthetic source is ported "
                "(HF datasets are ROADMAP Queue 1 item 5)")
        return SyntheticSource(self.cfg.model.vocab_size, self.seq_length,
                               seed=self.cfg.training.seed,
                               num_samples=self.cfg.training.num_samples)

    @property
    def state(self) -> dict:
        return dict(self._consumed_state)

    def set_state(self, st: dict) -> None:
        self.epoch = int(st["epoch"])
        self.cursor = int(st["cursor"])
        self._consumed_state = {"epoch": self.epoch, "cursor": self.cursor}

    def reset(self, st: dict) -> None:
        """Reposition mid-run (no prefetch queue to drain in this slice)."""
        self.set_state(st)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        n = self.global_batch_size
        if self.cursor + n > len(self.source):
            self.epoch += 1
            self.cursor = 0
        rows = self.source.get_rows(self.epoch, self.cursor, n)
        self.cursor += n
        t = self.cfg.training
        mbs = t.micro_batch_size
        d = self.cfg.distributed
        blocks = rows.reshape(t.gradient_accumulation_steps,
                              mbs * d.dp_size * d.ep_size,
                              self.seq_length + 1)
        blocks = blocks[:, self.row * mbs:(self.row + 1) * mbs]
        ids, tgt = blocks[..., :-1], blocks[..., 1:]
        if self.cp_perm is not None:
            # permuted after the shift, so each token still predicts its
            # true successor
            ids, tgt = ids[..., self.cp_perm], tgt[..., self.cp_perm]
        s_local = self.seq_length // self.cfg.distributed.cp_size
        sl = slice(self.cp_rank * s_local, (self.cp_rank + 1) * s_local)
        self._consumed_state = {"epoch": self.epoch, "cursor": self.cursor}
        return tuple(torch.from_numpy(np.ascontiguousarray(
            a[..., sl]).astype(np.int64)).to(self.device) for a in (ids, tgt))
