"""Data pipeline (port of picotron_tpu/data.py).

Sources: `SyntheticSource` is the same numpy stream as the JAX package's
(a pure function of (seed, epoch, start)), so both packages read the same
tokens. `DatasetSource` reads a chunked HF dataset of {"input_ids":
[seq + 1]} rows, shuffled anew each epoch from training.seed + epoch.
`MicroBatchDataLoader._build_source` reads `dataset.name` as the JAX
loader does: a directory is a `datasets.save_to_disk` corpus
(`load_from_disk`; a DatasetDict gives up its `dataset.split`), either
pre-chunked to seq + 1 tokens a row or raw text; anything else is a
`datasets.load_dataset` name. Raw text is tokenized
(`transformers.AutoTokenizer` of `dataset.tokenizer_name`, else the
model's name) and packed into seq + 1 blocks by `tokenize_and_chunk`
through the native packer (`native.make_packer`, csrc/packer.cpp).
`datasets` and `transformers` are imported only on those paths, so a
synthetic run never imports them. `build_eval_source` is the validation
stream: the synthetic stream on a disjoint seed, or the HF dataset's
`dataset.eval_split`, unshuffled.

The loader keeps the (epoch, cursor) state, `set_state` and `reset`,
drops the epoch tail like the reference, and yields (input_ids, targets)
shaped [grad_acc, mbs, seq] as int64 tensors on the loader's device.
Under a dp (and ep) layout each rank reads the same global batch
([grad_acc, mbs * dp * ep, seq], the JAX loader's) and keeps its data
index's rows [d * mbs, (d + 1) * mbs) of every microbatch, d = dp rank *
ep + ep rank (the JAX batch sharding over the fused ('dp', 'ep') axis,
`P(None, ("dp", "ep"), "cp")`); the cursor and `state` stay the global
ones, so every rank holds the same state. tp ranks read the same rows.
Under context parallelism the ids and targets are permuted along the
sequence after the shift (`cp_sequence_permutation`: the zigzag layout,
or none for the contiguous one), and each rank keeps its cp index's
contiguous slice [c * S/cp, (c + 1) * S/cp) of the permuted sequence (the
JAX loader's P(None, 'dp', 'cp') sharding after its permutation). Under
pipeline parallelism every stage reads its (dp, cp) rows, replicated over
pp, with the same cursor on every stage (the first stage reads the ids,
the last the targets).

Batch assembly runs under the resilience config's `RetryPolicy` (OSError
only) with the `data_produce` chaos point inside it, keyed on the global
batch ordinal (1-based, derived from the cursor so that it survives a
resume). `dataset.num_workers > 0` starts a prefetch thread that
assembles up to num_workers batches ahead as host tensors; the copy to
the device happens on the consuming (training) thread, so the batches,
their order and the device stream are those of `num_workers: 0`. A
producer that dies ships its exception through the queue, and this and
every later `next()` raises "dataloader prefetch thread died" from it.
"""

from __future__ import annotations

import itertools
import os
import queue as queue_mod
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.resilience import chaos
from picotron_tpu_torch.resilience.retry import RetryPolicy, retry_call


class _ProducerError:
    """Wrapper shipping a prefetch-thread exception through the queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


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


def tokenize_and_chunk(dataset, tokenizer, seq_length: int,
                       text_column: str = "text", num_proc: int = 1):
    """Tokenize `text_column`, concatenate, and chunk into fixed
    `seq_length + 1`-token blocks (one extra token so the input/target
    shift needs no cross-block state): the reference's
    `tokenizer_group_text` pipeline. Returns a dataset of {"input_ids":
    [seq_length + 1]} rows. One native packer per worker process, shared
    across its map batches, so the partial tail carries over and no
    tokens are lost at batch boundaries; it is built inside the closure,
    as a ctypes handle captured at closure build time could not be
    pickled by the datasets fingerprinting."""
    block = seq_length + 1
    packer_box: list = []

    def tok_group(batch):
        if not packer_box:
            from picotron_tpu_torch.native import make_packer

            packer_box.append(make_packer(block))
        packer = packer_box[0]
        out = tokenizer(batch[text_column])["input_ids"]
        packer.feed(np.fromiter(itertools.chain.from_iterable(out),
                                dtype=np.int32))
        return {"input_ids": packer.take().tolist()}

    return dataset.map(
        tok_group,
        batched=True,
        remove_columns=dataset.column_names,
        num_proc=num_proc if num_proc > 1 else None,
    )


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


class DatasetSource:
    """Adapter over a chunked HF dataset (rows of {"input_ids": [block]}),
    read in numpy format (one ndarray slice of the arrow buffer per read).
    With a `shuffle_seed`, epoch e reads the dataset's lazy shuffle by
    seed shuffle_seed + e (the role of DistributedSampler's set_epoch)."""

    def __init__(self, dataset, shuffle_seed: Optional[int] = None):
        self.dataset = dataset.with_format("numpy", columns=["input_ids"])
        self.shuffle_seed = shuffle_seed
        self._epoch_cache: Optional[tuple[int, Any]] = None

    def __len__(self) -> int:
        return len(self.dataset)

    def _epoch_view(self, epoch: int):
        if self._epoch_cache is not None and self._epoch_cache[0] == epoch:
            return self._epoch_cache[1]
        ds = self.dataset
        if self.shuffle_seed is not None:
            ds = ds.shuffle(seed=self.shuffle_seed + epoch)
        self._epoch_cache = (epoch, ds)
        return ds

    def get_rows(self, epoch: int, start: int, n: int) -> np.ndarray:
        rows = self._epoch_view(epoch)[start:start + n]["input_ids"]
        return np.asarray(rows, dtype=np.int32)


def hf_source(cfg: Config, split: str,
              shuffle_seed: Optional[int]) -> DatasetSource:
    """The `DatasetSource` of `dataset.name`'s `split` (the JAX loader's
    `_build_source` for a non-synthetic name): a directory is read with
    `datasets.load_from_disk` (a DatasetDict gives up `split`, and a
    missing split is a ValueError naming those it holds); a pre-chunked
    table must hold seq_length + 1 tokens a row; raw text goes through
    `tokenize_and_chunk`."""
    import datasets  # lazy: a synthetic run never imports it

    d, seq = cfg.dataset, cfg.training.seq_length
    if os.path.isdir(d.name):
        ds = datasets.load_from_disk(d.name)
        if isinstance(ds, datasets.DatasetDict):
            if split not in ds:
                field = "split" if split == d.split else "eval_split"
                raise ValueError(
                    f"dataset dir {d.name} holds splits {sorted(ds)}; "
                    f"dataset.{field}={split!r} is not one of them")
            ds = ds[split]
        if "input_ids" in ds.column_names:
            block = len(ds[0]["input_ids"])
            if block != seq + 1:
                raise ValueError(
                    f"pre-chunked dataset at {d.name} has blocks of "
                    f"{block} tokens; training.seq_length={seq} needs "
                    f"{seq + 1} (input/target shift) — re-chunk the corpus")
            return DatasetSource(ds, shuffle_seed=shuffle_seed)
        raw = ds
    else:
        raw = datasets.load_dataset(d.name, d.subset_name, split=split)
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(
        d.tokenizer_name or cfg.model.name)
    chunked = tokenize_and_chunk(raw, tokenizer, seq, d.text_column,
                                 d.num_proc)
    return DatasetSource(chunked, shuffle_seed=shuffle_seed)


def build_eval_source(cfg: Config):
    """Validation batch source (training.eval_frequency > 0): a synthetic
    stream on a seed offset disjoint from training's, or the HF dataset's
    `eval_split`, unshuffled (the JAX `build_eval_source`; a directory is
    read as `hf_source` reads it, where the JAX package goes through
    `load_dataset` to the same rows, so a pre-chunked eval split works
    here too)."""
    d = cfg.dataset
    if d.name == "synthetic":
        return SyntheticSource(cfg.model.vocab_size, cfg.training.seq_length,
                               seed=cfg.training.seed + 104729,
                               num_samples=cfg.training.num_samples)
    if d.eval_split is None:
        raise ValueError(
            "training.eval_frequency > 0 with an HF dataset requires "
            "dataset.eval_split (e.g. 'validation')")
    return hf_source(cfg, d.eval_split, shuffle_seed=None)


class MicroBatchDataLoader:
    """Infinite iterator of (input_ids, targets) [grad_acc, mbs,
    seq / cp] on `device`: the rows of data index dp_rank * ep + ep_rank
    of the global batch, cp index `cp_rank`'s slice of their (permuted)
    sequence; exhausting the source bumps the epoch. `state` is the
    position after the last batch handed out (with prefetch it lags the
    production cursor by the queued batches); `set_state` must come
    before the first `next()`."""

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
        self._prefetch_depth = cfg.dataset.num_workers
        self._queue = None  # created on the first next() with prefetch
        self._producer_exc = None  # set once the prefetch thread dies
        self._retry = RetryPolicy.from_config(cfg.resilience)
        self._steps_per_epoch = max(1, len(self.source)
                                    // self.global_batch_size)
        self._batch_index = 0

    def _build_source(self):
        d = self.cfg.dataset
        if d.name == "synthetic":
            return SyntheticSource(self.cfg.model.vocab_size, self.seq_length,
                                   seed=self.cfg.training.seed,
                                   num_samples=self.cfg.training.num_samples)
        return hf_source(self.cfg, d.split,
                         shuffle_seed=self.cfg.training.seed)

    @property
    def state(self) -> dict:
        return dict(self._consumed_state)

    def set_state(self, st: dict) -> None:
        if self._queue is not None:
            raise RuntimeError("set_state must be called before iteration "
                               "starts (prefetch already running)")
        self.epoch = int(st["epoch"])
        self.cursor = int(st["cursor"])
        self._consumed_state = {"epoch": self.epoch, "cursor": self.cursor}
        self._batch_index = (self.epoch * self._steps_per_epoch
                             + self.cursor // self.global_batch_size)

    def reset(self, st: dict) -> None:
        """Reposition mid-run (the guard's rollback: jump past a poison
        data range). Stops the prefetch thread and drops its queue first:
        its batches lie beyond the old cursor."""
        if self._queue is not None:
            self.close()
            # the old thread holds its own (queue, stop) pair
            self._queue = None
            self._producer_exc = None
        self.set_state(st)

    def __iter__(self) -> Iterator:
        return self

    def _assemble_next(self):
        """The next (host batch, post-state) at the production cursor.
        Idempotent under retry: the cursor and the batch index advance
        only after the source read succeeds."""
        idx = self._batch_index + 1
        chaos.fire("data_produce", step=idx)
        n = self.global_batch_size
        if self.cursor + n > len(self.source):
            self.epoch += 1
            self.cursor = 0
        rows = self.source.get_rows(self.epoch, self.cursor, n)
        self.cursor += n
        self._batch_index = idx
        t, d = self.cfg.training, self.cfg.distributed
        mbs = t.micro_batch_size
        blocks = rows.reshape(t.gradient_accumulation_steps,
                              mbs * d.dp_size * d.ep_size,
                              self.seq_length + 1)
        blocks = blocks[:, self.row * mbs:(self.row + 1) * mbs]
        ids, tgt = blocks[..., :-1], blocks[..., 1:]
        if self.cp_perm is not None:
            # permuted after the shift, so each token still predicts its
            # true successor
            ids, tgt = ids[..., self.cp_perm], tgt[..., self.cp_perm]
        s_local = self.seq_length // d.cp_size
        sl = slice(self.cp_rank * s_local, (self.cp_rank + 1) * s_local)
        batch = tuple(torch.from_numpy(np.ascontiguousarray(
            a[..., sl]).astype(np.int64)) for a in (ids, tgt))
        return batch, {"epoch": self.epoch, "cursor": self.cursor}

    def _assemble_with_retry(self):
        """Batch assembly under the transient-I/O retry policy (OSError
        only: a logic error in the source still fails fast)."""
        return retry_call(self._assemble_next, policy=self._retry,
                          describe="batch assembly")

    def _produce(self, queue, stop):
        # queue/stop are arguments, not attributes: after a reset() a
        # previous thread still unwinding (out of a chaos stall) must
        # feed its own stale queue, not the repositioned stream's.
        while not stop.is_set():
            try:
                item = self._assemble_with_retry()
            except BaseException as e:  # noqa: BLE001 — relayed
                item = _ProducerError(e)
            while not stop.is_set():
                try:
                    queue.put(item, timeout=0.5)
                    break
                except queue_mod.Full:
                    continue
            if isinstance(item, _ProducerError):
                return

    def close(self) -> None:
        """Stop the prefetch thread and wait for it, so that no batch is
        assembled (nor a chaos `data_produce` event consumed) after this
        returns; a thread stuck past the timeout is a daemon."""
        if self._queue is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)

    def __next__(self):
        if self._prefetch_depth > 0:
            if self._queue is None:
                self._queue = queue_mod.Queue(maxsize=self._prefetch_depth)
                self._stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._produce, args=(self._queue, self._stop),
                    daemon=True, name="picotron-data-producer")
                self._thread.start()
            if self._producer_exc is not None:
                raise RuntimeError(
                    "dataloader prefetch thread died") from self._producer_exc
            got = self._queue.get()
            if isinstance(got, _ProducerError):
                # the thread has exited: every later call fails loudly too
                self._producer_exc = got.exc
                raise RuntimeError(
                    "dataloader prefetch thread died") from got.exc
            batch, post_state = got
        else:
            batch, post_state = self._assemble_with_retry()
        self._consumed_state = post_state
        return tuple(t.to(self.device) for t in batch)
