"""Data pipeline (port of picotron_tpu/data.py).

`SyntheticSource` is the same numpy stream as the JAX package's (a pure
function of (seed, epoch, start)), so both packages read the same tokens.
`MicroBatchDataLoader` keeps the (epoch, cursor) state, `set_state` and
`reset`, drops the epoch tail like the reference, and yields
(input_ids, targets) shaped [grad_acc, mbs, seq] as int64 tensors on the
loader's device. Under a dp layout each rank reads the same global batch
([grad_acc, mbs * dp, seq], the JAX loader's) and keeps its dp rank's
rows [r * mbs, (r + 1) * mbs) of every microbatch (the JAX batch
sharding over ('dp', 'ep')); the cursor and `state` stay the global ones,
so every rank holds the same state. tp ranks read the same rows.
`build_eval_source` is the validation stream. HF datasets, the prefetch
thread, chaos and I/O retry come in a later slice.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from picotron_tpu_torch.config import Config


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
    """Infinite iterator of (input_ids, targets) [grad_acc, mbs, seq] on
    `device`: dp rank `dp_rank`'s rows of the global batch; exhausting
    the source bumps the epoch. `state` is the position after the last
    batch handed out."""

    def __init__(self, cfg: Config, device, source=None, dp_rank: int = 0):
        d = cfg.distributed
        if d.ep_size * d.cp_size * d.pp_size != 1:
            raise NotImplementedError(
                "the port's loader shards over dp only; cp, ep and pp "
                "layouts are ROADMAP Queue 1 items 9 and 10")
        if not 0 <= dp_rank < d.dp_size:
            raise ValueError(f"dp_rank {dp_rank} outside dp_size "
                             f"{d.dp_size}")
        self.cfg = cfg
        self.dp_rank = dp_rank
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
        blocks = rows.reshape(t.gradient_accumulation_steps,
                              mbs * self.cfg.distributed.dp_size,
                              self.seq_length + 1)
        blocks = blocks[:, self.dp_rank * mbs:(self.dp_rank + 1) * mbs]
        blocks = torch.from_numpy(blocks.astype(np.int64)).to(self.device)
        self._consumed_state = {"epoch": self.epoch, "cursor": self.cursor}
        return blocks[..., :-1], blocks[..., 1:]
