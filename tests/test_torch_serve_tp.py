"""tp decode in the port: `generate.place_for_decode` at tp 2 (each rank
its shards, its Hkv/2 cache heads, the model's own f/g hooks and
vocab-parallel embedding and head) in one gloo world of 2 ranks, against
tp 1 in this process, fp32 on the CPU, the debug-tiny params from a
seeded init: greedy `generate`, `ServeEngine` (plain and n-gram) and
`DisaggServeEngine` tokens (both pools on the rank's device, a decode
pool cut so that requests are preempted) equal to tp 1's; a sampled `generate` equal on both ranks;
and heads that tp does not divide refused (the JAX package's
`place_for_decode` check). The worker code imports no jax."""

import numpy as np
import pytest
import torch

from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import generate as tgen
from picotron_tpu_torch.models.llama import LlamaModel, init_params
from picotron_tpu_torch.serve import DisaggServeEngine, ServeEngine
from tests.test_torch_parallel import World

RAW = {"model": {"name": "debug-tiny", "dtype": "float32",
                 "max_position_embeddings": 64},
       "training": {"seq_length": 32}}
SCFG = dict(decode_slots=3, block_size=4, num_blocks=24, prefill_chunk=4,
            max_model_len=32, decode_interval=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models run many small ops: one intra-op thread each, so that
    the suite's parallel workers do not oversubscribe the host's cores
    (which slows such ops by two orders of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def state_dict() -> dict:
    """The debug-tiny params from a seeded init, as a state dict."""
    cfg = tcfg.config_from_dict(RAW).model
    model = init_params(LlamaModel(cfg, device="cpu"),
                        torch.Generator().manual_seed(0))
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def requests() -> list:
    rng = np.random.default_rng(0)
    return [(list(map(int, rng.integers(0, 256, size=n))), b)
            for n, b in ((5, 6), (9, 3), (3, 8), (7, 5), (11, 4))]


def decode_all(model) -> dict:
    """Everything one rank (or the tp-1 model) decodes."""
    prompt = np.random.default_rng(1).integers(0, 256, (2, 6))
    out = {"generate": tgen.generate(model, prompt, 10).tolist(),
           "kv_heads": tgen.kv_heads(model)}
    gen = torch.Generator().manual_seed(5)
    out["sampled"] = tgen.generate(model, prompt, 10, temperature=0.8,
                                   top_k=20, generator=gen).tolist()
    for name, cls, extra in (
            ("engine", ServeEngine, {}),
            ("ngram", ServeEngine, {"speculator": "ngram", "draft_len": 3}),
            ("disagg", DisaggServeEngine, {"disagg": True,
                                           "num_blocks": 8})):
        eng = cls(model, tcfg.ServeConfig(**{**SCFG, **extra}), device="cpu")
        out[name] = [r["tokens"] for r in eng.run(requests())]
        out[name + "_pool_heads"] = eng._k.shape[3]
        pools = (eng.pool, getattr(eng, "pool_p", None))
        out[name + "_leaked"] = sum(p.in_use for p in pools if p)
        eng.close()
    return out


def tp_job(job: dict, spec: dict) -> dict:
    cfg = tcfg.config_from_dict(RAW).model
    model = tgen.place_for_decode(spec["sd"], cfg, tp=2, device="cpu")
    return {"tp_rank": model.tp.rank, **decode_all(model)}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    sd = state_dict()
    world = World(tmp_path_factory.mktemp("serve_tp"), 2,
                  {"sd": sd, "jobs": [{"name": "tp2", "kind": "tp"}]},
                  {"tp": tp_job})
    cfg = tcfg.config_from_dict(RAW).model
    tp1 = decode_all(tgen.place_for_decode(sd, cfg, tp=1, device="cpu"))
    return {r: out["tp2"] for r, out in world.results().items()}, tp1


def test_tp2_decode_equals_tp1(tp2):
    ranks, tp1 = tp2
    assert tp1["kv_heads"] == 2
    for r, out in ranks.items():
        assert out["tp_rank"] == r and out["kv_heads"] == 1
        assert out["engine_pool_heads"] == 1
        for key in ("generate", "engine", "ngram", "disagg"):
            assert out[key] == tp1[key], (r, key)
        assert out["disagg"] == tp1["engine"]
        assert out["disagg_pool_heads"] == 1
        assert (out["engine_leaked"] == out["ngram_leaked"]
                == out["disagg_leaked"] == 0)
    assert ranks[0]["sampled"] == ranks[1]["sampled"]


@pytest.mark.parametrize("tp,what", [(4, "num_key_value_heads"),
                                     (3, "num_attention_heads")])
def test_tp_refuses_indivisible_heads(tp, what):
    cfg = tcfg.config_from_dict(RAW).model
    with pytest.raises(ValueError, match=f"{what} must be divisible by "
                                         "tp_size"):
        tgen.place_for_decode({}, cfg, tp=tp, device="cpu")


def test_tp_without_a_group_refused(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    cfg = tcfg.config_from_dict(RAW).model
    with pytest.raises(ValueError, match="nproc_per_node 2"):
        tgen.place_for_decode(state_dict(), cfg, tp=2, device="cpu")
