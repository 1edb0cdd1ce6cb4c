"""The port's data pipeline against the JAX package's
(picotron_tpu/data.py, picotron_tpu/native) on `datasets.save_to_disk`
corpora built in a temporary directory:

- the loader over a pre-chunked corpus yields the JAX loader's batches
  token for token, per rank, at dp 2 and at cp 2 zigzag, across epochs
  (each epoch its own shuffle);
- the DatasetDict split pick (and its error), the eval split
  (`build_eval_source`), the block-length check and `tokenize_and_chunk`
  with a stub tokenizer, each against the JAX function;
- prefetch (`num_workers: 2`) yields the batches of `num_workers: 0`, and
  after `data_io@2x2` (two retried failures) the batches of a run
  without chaos; a producer error is re-raised on every later call;
- the native packer (built from csrc/packer.cpp), its plain version
  `PyBlockPacker` and the JAX package's packer give equal blocks on a
  ragged token stream, and a failed build raises;
- a synthetic run imports neither `datasets` nor `transformers`.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

datasets = pytest.importorskip("datasets")

from picotron_tpu import config as jcfg  # noqa: E402
from picotron_tpu import data as jdata  # noqa: E402
from picotron_tpu.mesh import MeshEnv  # noqa: E402
from picotron_tpu.resilience import chaos as jchaos  # noqa: E402
from picotron_tpu_torch import config as tcfg  # noqa: E402
from picotron_tpu_torch import data as tdata  # noqa: E402
from picotron_tpu_torch import native  # noqa: E402
from picotron_tpu_torch.kernels import build  # noqa: E402
from picotron_tpu_torch.resilience import chaos  # noqa: E402
from picotron_tpu_torch.telemetry import bus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, VOCAB = 16, 256


@pytest.fixture(autouse=True)
def _no_chaos(monkeypatch):
    monkeypatch.delenv("PICOTRON_CHAOS", raising=False)
    # the packer's build logs stay this test's (the process-wide dict is
    # what tests/test_torch_isolation.py reads after a bare import)
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    yield
    chaos.uninstall()
    jchaos.install("")


@pytest.fixture(scope="module", autouse=True)
def _offline_uncached(tmp_path_factory):
    """No hub access, caches under the test's own directory, and no map
    results reused between the two packages' runs."""
    old = {k: os.environ.get(k) for k in ("HF_DATASETS_OFFLINE",
                                          "HF_HUB_OFFLINE")}
    os.environ.update(HF_DATASETS_OFFLINE="1", HF_HUB_OFFLINE="1")
    old_cache = datasets.config.HF_DATASETS_CACHE
    datasets.config.HF_DATASETS_CACHE = str(tmp_path_factory.mktemp("hf"))
    datasets.disable_caching()
    yield
    datasets.enable_caching()
    datasets.config.HF_DATASETS_CACHE = old_cache
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _blocks(rows, block=SEQ + 1, seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (rows, block))
    return datasets.Dataset.from_dict({"input_ids": ids.tolist()})


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("corpora")
    paths = {k: str(base / k) for k in ("chunked", "dict", "text",
                                        "short")}
    _blocks(40).save_to_disk(paths["chunked"])
    datasets.DatasetDict({"train": _blocks(24, seed=1),
                          "validation": _blocks(12, seed=2)}).save_to_disk(
        paths["dict"])
    rng = np.random.default_rng(3)

    def texts(n):
        return [" ".join(f"w{int(x)}" for x in rng.integers(
            0, 50, int(rng.integers(1, 30)))) for _ in range(n)]

    datasets.DatasetDict({
        "train": datasets.Dataset.from_dict({"text": texts(60)}),
        "validation": datasets.Dataset.from_dict({"text": texts(30)}),
    }).save_to_disk(paths["text"])
    _blocks(12, block=SEQ).save_to_disk(paths["short"])
    return paths


class StubTokenizer:
    """A deterministic stand-in for an HF tokenizer: each character of a
    text is one token (its code point mod the vocab)."""

    def __call__(self, texts):
        return {"input_ids": [[ord(c) % VOCAB for c in t] for t in texts]}


@pytest.fixture
def stub_tokenizer(monkeypatch):
    transformers = pytest.importorskip("transformers")

    class Auto:
        @staticmethod
        def from_pretrained(name, *args, **kwargs):
            return StubTokenizer()

    monkeypatch.setattr(transformers, "AutoTokenizer", Auto)


def _raw(name, dp=1, cp=1, **dataset):
    return {"model": {"name": "debug-tiny", "dtype": "float32"},
            "training": {"seq_length": SEQ, "micro_batch_size": 2,
                         "gradient_accumulation_steps": 2, "seed": 7},
            "distributed": {"dp_size": dp, "cp_size": cp,
                            "use_cpu": True},
            "resilience": {"retry_base_delay": 0.0,
                           "retry_max_delay": 0.0},
            "dataset": {"name": name, **dataset}}


def _both(raw):
    return jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)


@pytest.mark.parametrize("dp,cp", [(2, 1), (1, 2)], ids=["dp2", "cp2"])
def test_corpus_batches_match_jax_per_rank(corpora, dp, cp):
    """Through three epochs (40 rows, 8 a step at dp 2: 5 steps an
    epoch; 4 at cp 2: 10), each epoch its own shuffle."""
    jc, tc = _both(_raw(corpora["chunked"], dp=dp, cp=cp))
    jl = jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
    ranks = [(r, c) for r in range(dp) for c in range(cp)]
    loaders = {rc: tdata.MicroBatchDataLoader(tc, "cpu", dp_rank=rc[0],
                                              cp_rank=rc[1])
               for rc in ranks}
    mbs, s = tc.training.micro_batch_size, SEQ // cp
    for _ in range(15 if dp == 2 else 25):
        ji, jt = (np.asarray(a) for a in next(jl))
        for (r, c), tl in loaders.items():
            ti, tt = next(tl)
            rows, cols = slice(r * mbs, (r + 1) * mbs), slice(c * s,
                                                              (c + 1) * s)
            np.testing.assert_array_equal(ti.numpy(), ji[:, rows, cols])
            np.testing.assert_array_equal(tt.numpy(), jt[:, rows, cols])
            assert ti.dtype == torch.int64
            assert tl.state == jl.state
    assert jl.state["epoch"] == 2


def test_split_pick_eval_split_and_their_errors_match_jax(corpora):
    jc, tc = _both(_raw(corpora["dict"], split="validation",
                        eval_split="train"))
    jl = jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
    tl = tdata.MicroBatchDataLoader(tc, "cpu")
    assert len(tl.source) == len(jl.source) == 12
    for _ in range(5):
        np.testing.assert_array_equal(next(tl)[0].numpy(),
                                      np.asarray(next(jl)[0]))
    # a pre-chunked eval split, unshuffled: the port reads it as it reads
    # the train split (the JAX `build_eval_source` tokenizes every split,
    # so it takes raw text only: its parity is the raw-text test's)
    src = tdata.build_eval_source(tc)
    want = datasets.load_from_disk(corpora["dict"])["train"]["input_ids"]
    np.testing.assert_array_equal(src.get_rows(0, 0, 24), np.asarray(want))
    for raw in (_raw(corpora["dict"], split="nope"),
                _raw(corpora["short"])):
        jc, tc = _both(raw)
        with pytest.raises(ValueError) as want:
            jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
        with pytest.raises(ValueError) as got:
            tdata.MicroBatchDataLoader(tc, "cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jdata.build_eval_source(_both(_raw(corpora["dict"]))[0])
    with pytest.raises(ValueError) as got:
        tdata.build_eval_source(_both(_raw(corpora["dict"]))[1])
    assert str(got.value) == str(want.value)


def test_raw_text_is_tokenized_and_chunked_as_jax_does(corpora,
                                                       stub_tokenizer):
    """Raw text through the stub tokenizer and each package's packer:
    the same blocks, the same train batches, the same eval source (the
    JAX `build_eval_source` over load_dataset of the directory)."""
    raw = _raw(corpora["text"], eval_split="validation")
    jc, tc = _both(raw)
    jl = jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
    tl = tdata.MicroBatchDataLoader(tc, "cpu")
    assert len(tl.source) == len(jl.source) > 8
    for _ in range(6):
        (ji, jt), (ti, tt) = next(jl), next(tl)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    je, te = jdata.build_eval_source(jc), tdata.build_eval_source(tc)
    assert len(te) == len(je) > 0
    np.testing.assert_array_equal(te.get_rows(0, 0, len(te)),
                                  je.get_rows(0, 0, len(je)))
    text = datasets.load_from_disk(corpora["text"])["train"]
    got = tdata.tokenize_and_chunk(text, StubTokenizer(), SEQ)
    want = jdata.tokenize_and_chunk(text, StubTokenizer(), SEQ)
    assert got["input_ids"] == want["input_ids"]


def _take(loader, n):
    return [tuple(t.clone() for t in next(loader)) + (loader.state,)
            for _ in range(n)]


def _same(a, b):
    assert len(a) == len(b)
    for (ai, at, ast), (bi, bt, bst) in zip(a, b):
        assert torch.equal(ai, bi) and torch.equal(at, bt) and ast == bst


def test_prefetch_yields_the_synchronous_batches(corpora):
    """Under a shortened switch interval (the producer and the consumer
    interleave at every few bytecodes) the prefetched stream is the
    synchronous one, through a reset, and close() ends the thread."""
    base = tdata.MicroBatchDataLoader(
        tcfg.config_from_dict(_raw(corpora["chunked"])), "cpu")
    pre = tdata.MicroBatchDataLoader(
        tcfg.config_from_dict(_raw(corpora["chunked"], num_workers=2)),
        "cpu")
    want = _take(base, 30)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _same(_take(pre, 12), want[:12])
        # a rollback's reset: the queued batches beyond the cursor go
        pre.reset(want[2][2])
        _same(_take(pre, 27), want[3:30])
    finally:
        sys.setswitchinterval(interval)
    with pytest.raises(RuntimeError, match="set_state"):
        pre.set_state(want[0][2])
    pre.close()
    pre._thread.join(timeout=10)
    assert not pre._thread.is_alive()


class _Recorder:
    def __init__(self):
        self.events = []

    def emit(self, kind, category=None, secs=None, **fields):
        self.events.append((kind, fields.get("point")))


@pytest.mark.parametrize("workers", [0, 2])
def test_data_io_chaos_retries_to_the_same_batches(corpora, workers):
    cfg = tcfg.config_from_dict(_raw(corpora["chunked"],
                                     num_workers=workers))
    want = _take(tdata.MicroBatchDataLoader(cfg, "cpu"), 5)
    rec = bus.install(_Recorder())
    try:
        chaos.install("data_io@2x2")
        loader = tdata.MicroBatchDataLoader(cfg, "cpu")
        got = _take(loader, 5)
        loader.close()
    finally:
        bus.install(None)
    _same(got, want)
    assert rec.events == [("chaos", "data_produce"), ("retry", None)] * 2


def test_a_dead_producer_fails_every_later_call(corpora):
    cfg = tcfg.config_from_dict(_raw(corpora["chunked"], num_workers=2))
    chaos.install("data_io@2x99")  # outlasts the 3-attempt budget
    loader = tdata.MicroBatchDataLoader(cfg, "cpu")
    next(loader)
    for _ in range(2):
        with pytest.raises(RuntimeError,
                           match="prefetch thread died") as e:
            next(loader)
        assert isinstance(e.value.__cause__, OSError)
    loader.close()


def _ragged(seed=0, n=200):
    rng = np.random.default_rng(seed)
    lens = rng.choice([0, 1, 5, 16, 17, 33, 100], n)
    return [rng.integers(0, 50_000, int(k), dtype=np.int32) for k in lens]


def test_native_packer_matches_plain_and_jax():
    from picotron_tpu import native as jnative

    block = SEQ + 1
    packers = [native.make_packer(block), native.PyBlockPacker(block),
               jnative.make_packer(block)]
    assert isinstance(packers[0], native.BlockPacker)
    outs = [[] for _ in packers]
    for i, chunk in enumerate(_ragged()):
        for p, out in zip(packers, outs):
            p.feed(chunk)
            if i % 7 == 3:
                out.append(p.take(max_blocks=2))
            elif i % 11 == 5:
                out.append(p.take())
    for p, out in zip(packers, outs):
        out.append(p.take())
    got = [np.concatenate(o) for o in outs]
    assert got[0].shape[0] > 50
    for g in got[1:]:
        np.testing.assert_array_equal(got[0], g)
    assert len({p.carry_len for p in packers}) == 1
    total = sum(c.size for c in _ragged())
    assert got[0].size + packers[0].carry_len == total


def test_native_packer_build_failure_raises(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "packer.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building"):
        native.make_packer(SEQ + 1)


def test_synthetic_run_imports_no_hf_packages(tmp_path):
    cfg = tmp_path / "cfg.json"
    raw = _raw("synthetic")
    raw["training"]["total_train_steps"] = 1
    raw["checkpoint"] = {"save_dir": str(tmp_path / "ckpt")}
    cfg.write_text(json.dumps(raw))
    code = ("import sys\nfrom picotron_tpu_torch import train\n"
            f"train.main(['--config', {str(cfg)!r}, '--device', 'cpu'])\n"
            "bad = [m for m in ('datasets', 'transformers', 'jax') "
            "if m in sys.modules]\nassert not bad, bad\nprint('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
