"""Host data-pipeline microbench of the port (tools/data_bench.py
ported): does the loader outpace the card?

Benchmarks the host side of the port's on-disk dataset path
(`data.DatasetSource`, `data.tokenize_and_chunk`) on an HF-datasets arrow
table it builds locally from a seed (nothing is downloaded):

1. epoch-view construction (`ds.shuffle(seed).flatten_indices()`, the
   alternative the lazy shuffle was chosen over),
2. steady-state `DatasetSource.get_rows` throughput: the lazy shuffle
   the loader reads (production) vs shuffled + flatten_indices vs
   unshuffled,
3. `tokenize_and_chunk`'s map + pack with a stand-in tokenizer (hashed
   whitespace words: the pipeline around the tokenizer, not a BPE).

It runs on the CPU only. The card's machine has no `datasets` package,
and the tool says so and exits 2 where it is missing.

  python -m picotron_tpu_torch.tools.data_bench [--blocks 20000] [--seq 2048]

Prints one line per measurement and a JSON summary line; the summary's
`vs_card_margin` is the lazy read rate over the main path's measured
24326.5 tokens/s on one H100 (`chip_smoke.py` phase 3, NVIDIA H100 80GB
HBM3 at 700 W).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# the main path's tokens/s on one card (chip_smoke.py phase 3)
CARD_TOKENS_PER_S = 24326.5


def build_chunked_dataset(path: str, blocks: int, seq: int):
    import datasets

    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50257, (blocks, seq + 1), dtype=np.int32)
    ds = datasets.Dataset.from_dict({"input_ids": rows.tolist()})
    ds.save_to_disk(path)
    return datasets.load_from_disk(path)  # memory-mapped arrow, as read


def bench_get_rows(source, blocks: int, label: str,
                   batch_rows: int = 64) -> float:
    t0 = time.perf_counter()
    total = 0
    start = 0
    while start + batch_rows <= blocks:
        rows = source.get_rows(0, start, batch_rows)
        total += rows.size
        start += batch_rows
    dt = time.perf_counter() - t0
    rate = total / dt
    print(f"{label}: {rate / 1e6:.1f}M tokens/s "
          f"({total / 1e6:.1f}M tokens in {dt:.2f}s)")
    return rate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="host data-pipeline microbench (CPU only)")
    ap.add_argument("--blocks", type=int, default=20000)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--keep", action="store_true",
                    help="keep the generated dataset dir")
    args = ap.parse_args(argv)
    try:
        import datasets as hfds
    except ImportError:
        print("data_bench: the `datasets` package is not installed (the "
              "on-disk dataset path needs it; the card's machine has "
              "none): run it on a host that has it", file=sys.stderr)
        return 2

    from picotron_tpu_torch.data import DatasetSource, tokenize_and_chunk

    tmp = tempfile.mkdtemp(prefix="data_bench_")
    out = {}
    try:
        ds = build_chunked_dataset(os.path.join(tmp, "chunked"),
                                   args.blocks, args.seq)

        # 1. the once-per-epoch view construction
        t0 = time.perf_counter()
        flat = ds.shuffle(seed=1).flatten_indices()
        out["epoch_view_s"] = time.perf_counter() - t0
        print(f"epoch view (shuffle+flatten_indices, {args.blocks} blocks): "
              f"{out['epoch_view_s']:.2f}s")
        del flat

        # 2. steady-state reads: the lazy shuffle the loader reads vs the
        # flatten_indices alternative vs unshuffled
        out["read_lazy_tok_s"] = bench_get_rows(
            DatasetSource(ds, shuffle_seed=1), args.blocks,
            "get_rows shuffled lazy (production)")

        class FlatSource(DatasetSource):
            def _epoch_view(self, epoch):
                if self._epoch_cache and self._epoch_cache[0] == epoch:
                    return self._epoch_cache[1]
                v = self.dataset.shuffle(
                    seed=self.shuffle_seed + epoch).flatten_indices()
                self._epoch_cache = (epoch, v)
                return v

        out["read_flat_tok_s"] = bench_get_rows(
            FlatSource(ds, shuffle_seed=1), args.blocks,
            "get_rows shuffled+flatten_indices")
        out["read_seq_tok_s"] = bench_get_rows(
            DatasetSource(ds, shuffle_seed=None), args.blocks,
            "get_rows unshuffled")

        # 3. preprocessing throughput with a stand-in tokenizer
        words = [f"w{i:04d}" for i in range(1000)]
        rng = np.random.default_rng(2)
        texts = [" ".join(words[j] for j in rng.integers(0, 1000, 256))
                 for _ in range(2000)]
        raw = hfds.Dataset.from_dict({"text": texts})

        class StandinTokenizer:
            def __call__(self, texts):
                return {"input_ids": [
                    [hash(w) % 50000 for w in t.split()] for t in texts]}

        t0 = time.perf_counter()
        chunked = tokenize_and_chunk(raw, StandinTokenizer(), args.seq)
        dt = time.perf_counter() - t0
        toks = sum(len(r) for r in chunked["input_ids"])
        out["preproc_tok_s"] = toks / dt
        print(f"tokenize_and_chunk (stand-in tokenizer): "
              f"{out['preproc_tok_s'] / 1e6:.2f}M tokens/s")
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)

    out["vs_card_margin"] = round(out["read_lazy_tok_s"] / CARD_TOKENS_PER_S,
                                  1)
    print(json.dumps({k: (round(v, 1) if isinstance(v, float) else v)
                      for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
