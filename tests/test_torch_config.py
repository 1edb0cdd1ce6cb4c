"""The PyTorch port's config against the JAX package's: same dataclasses,
same JSON loading, same validation errors."""

import dataclasses
import glob
import json
import os

import pytest

from picotron_tpu import config as jcfg
from picotron_tpu_torch import config as tcfg

RUNS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "runs",
                                     "*", "config.json")))


def test_runs_exist():
    assert len(RUNS) >= 8


@pytest.mark.parametrize("path", RUNS, ids=lambda p: p.split(os.sep)[-2])
def test_runs_configs_load_equal(path):
    j = jcfg.load_config(path)
    t = tcfg.load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.global_batch_size == j.global_batch_size
    assert tcfg.num_params(t.model) == jcfg.num_params(j.model)


@pytest.mark.parametrize("name", sorted(jcfg.MODEL_PRESETS))
def test_presets_and_param_counts_equal(name):
    raw = {"model": {"name": name}}
    j = jcfg.config_from_dict(raw)
    t = tcfg.config_from_dict(raw)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    for active in (False, True):
        assert (tcfg.num_params(t.model, active_only=active,
                                include_tied_head=True)
                == jcfg.num_params(j.model, active_only=active,
                                   include_tied_head=True))


ILLEGAL = [
    {"distributed": {"tp_size": 3}, "model": {"name": "debug-tiny"}},
    {"model": {"name": "no-such-model"}},
    {"model": {"hidden_size": 64}},
    {"model": {"name": "debug-tiny", "attn_impl": "magic"}},
    {"training": {"seq_length": 4096}, "model": {"name": "debug-tiny",
                                                 "max_position_embeddings": 2048}},
    {"training": {"adam_moments_dtype": "float16"}},
    {"training": {"grad_engine": "fused", "remat": False}},
    {"training": {"lr_schedule": "cosine", "lr_warmup_steps": 500,
                  "total_train_steps": 100}},
    {"resilience": {"chaos": "hang@3"}},
    {"resilience": {"chaos": "bogus@1"}},
    {"distributed": {"ep_size": 2}},
    {"distributed": {"cp_size": 2, "cp_layout": "zigzag"},
     "training": {"seq_length": 30}},
]


@pytest.mark.parametrize("raw", ILLEGAL, ids=range(len(ILLEGAL)))
def test_illegal_configs_raise_in_both(raw):
    with pytest.raises((ValueError, KeyError)) as ej:
        jcfg.config_from_dict(raw)
    with pytest.raises((ValueError, KeyError)) as et:
        tcfg.config_from_dict(raw)
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)


def test_chaos_specs_are_parsed_by_the_chaos_module(monkeypatch):
    """The chaos cases above reach `resilience/chaos.parse_spec`, the
    runtime's own grammar (the copied validator is gone)."""
    from picotron_tpu_torch.resilience import chaos

    seen = []
    real = chaos.parse_spec
    monkeypatch.setattr(chaos, "parse_spec",
                        lambda spec: seen.append(spec) or real(spec))
    tcfg.config_from_dict({"resilience": {"chaos": "sigterm@2,hang@3~1"}})
    with pytest.raises(ValueError, match="needs a ~SECS"):
        tcfg.config_from_dict({"resilience": {"chaos": "hang@3"}})
    assert seen == ["sigterm@2,hang@3~1", "hang@3"]
    assert not hasattr(tcfg, "_parse_chaos_spec")


def test_config_json_roundtrip(tmp_path):
    raw = {"model": {"name": "Llama-3.1-8B"}, "training": {"seq_length": 256}}
    t = tcfg.config_from_dict(raw)
    p = tmp_path / "c.json"
    tcfg.save_config(t, str(p))
    back = tcfg.load_config(str(p))
    assert dataclasses.asdict(back) == dataclasses.asdict(t)
    assert back.model.rope_scaling_dict["rope_type"] == "llama3"
    assert json.loads(p.read_text())["model"]["name"] == "Llama-3.1-8B"


def test_adaptive_tp_strategy_waits_for_the_cost_model():
    """(Named when "adaptive" was refused.) "adaptive" resolves through
    the cost model on the h100 tier, deterministically (the same spec on
    every call, megatron winning ties), to a legal per-class spec; on the
    JAX package's v5e descriptor and calibration it is the JAX
    resolution."""
    from picotron_tpu.analysis import cost_model as jcm
    from picotron_tpu_torch.analysis.cost_model import (
        Calibration, IciGeneration,
    )

    raw = {"model": {"name": "debug-tiny", "num_attention_heads": 8,
                     "num_key_value_heads": 4},
           "distributed": {"tp_size": 4, "tp_strategy": "adaptive"}}
    cfg = tcfg.config_from_dict(raw)
    got = tcfg.resolved_tp_strategy(cfg)
    assert got == tcfg.resolved_tp_strategy(cfg)
    assert set(got) == set(tcfg.TP_STRATEGY_CLASSES)
    assert tcfg.parse_tp_strategy(",".join(f"{k}={v}" for k, v in
                                           got.items())) == got
    v5e = IciGeneration(**dataclasses.asdict(jcm.GENERATIONS["v5e"]))
    jcal = Calibration(**dataclasses.asdict(jcm.DEFAULT_CALIBRATION))
    assert tcfg.resolved_tp_strategy(cfg, v5e, jcal) == \
        jcfg.resolved_tp_strategy(jcfg.config_from_dict(raw),
                                  generation="v5e")
    cfg = tcfg.config_from_dict({"model": {"name": "debug-tiny"},
                                 "distributed": {"tp_size": 2}})
    assert tcfg.resolved_tp_strategy(cfg) == jcfg.resolved_tp_strategy(
        jcfg.config_from_dict({"model": {"name": "debug-tiny"},
                               "distributed": {"tp_size": 2}}))