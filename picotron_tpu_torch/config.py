"""Typed configuration for the PyTorch port of picotron-tpu.

A copy of `picotron_tpu/config.py` (same dataclasses, JSON schema, presets,
`validate` errors and `num_params`), kept in the port's own tree because
importing `picotron_tpu.config` runs `picotron_tpu/__init__.py`, which
imports jax. Of the original's three lazy imports, the chaos-spec grammar
check calls the port's own `resilience/chaos.parse_spec`; the fused grad
engine's eligibility rule is inlined, and `resolved_tp_strategy`'s
"adaptive" cost-model branch raises until `analysis/` is ported.
Comments below that name `picotron_tpu/...` modules describe the
reference's subsystems that each field configures.

The rest of this docstring is the original's. One explicit config object threaded through the whole program — this replaces
both of the reference's config channels: the JSON file
(ref: template/base_config.json:1-52) and the shadow environment-variable
channel (`FLASH_ATTEN` / `CONTEXT_PARALLEL` / `DEVICE` / `DTYPE`, ref:
train.py:65-77, model.py:127-158, context_parallel.py:10-12), which SURVEY.md
§5 flags as a design wart.

The JSON schema is compatible with the reference's: a reference config.json
loads unchanged (unknown keys are ignored; the `environment` section is
irrelevant on TPU). Model hyperparameters resolve from a built-in preset
registry instead of a network `AutoConfig` fetch (ref: create_config.py:51-55)
— TPU pods frequently run with zero egress, so presets are first-class and
explicit overrides always win.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Optional


# ---------------------------------------------------------------------------
# Model preset registry (replaces network AutoConfig lookup).
# Hyperparameters are the public ones for each model family.
# ---------------------------------------------------------------------------

MODEL_PRESETS: dict[str, dict[str, Any]] = {
    # SmolLM family (Llama architecture)
    "HuggingFaceTB/SmolLM-135M": dict(
        vocab_size=49152, hidden_size=576, intermediate_size=1536,
        num_hidden_layers=30, num_attention_heads=9, num_key_value_heads=3,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    "HuggingFaceTB/SmolLM-360M": dict(
        vocab_size=49152, hidden_size=960, intermediate_size=2560,
        num_hidden_layers=32, num_attention_heads=15, num_key_value_heads=5,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    "HuggingFaceTB/SmolLM-1.7B": dict(
        vocab_size=49152, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=24, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    # Llama-2
    "meta-llama/Llama-2-7b-hf": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    "meta-llama/Llama-2-13b-hf": dict(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=40,
        max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    "meta-llama/Llama-2-70b-hf": dict(
        vocab_size=32000, hidden_size=8192, intermediate_size=28672,
        num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
        max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    # Llama-3
    "meta-llama/Meta-Llama-3-8B": dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0, rms_norm_eps=1e-5,
    ),
    # Llama-3.1/3.2 (llama3-type RoPE scaling for 128k context)
    "meta-llama/Llama-3.1-8B": dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=500000.0,
        rms_norm_eps=1e-5,
        rope_scaling=dict(rope_type="llama3", factor=8.0,
                          low_freq_factor=1.0, high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    ),
    "meta-llama/Llama-3.1-70B": dict(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=500000.0,
        rms_norm_eps=1e-5,
        rope_scaling=dict(rope_type="llama3", factor=8.0,
                          low_freq_factor=1.0, high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    ),
    "meta-llama/Llama-3.2-1B": dict(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=500000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=True,
        rope_scaling=dict(rope_type="llama3", factor=32.0,
                          low_freq_factor=1.0, high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    ),
    "meta-llama/Llama-3.2-3B": dict(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=28, num_attention_heads=24, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=500000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=True,
        rope_scaling=dict(rope_type="llama3", factor=32.0,
                          low_freq_factor=1.0, high_freq_factor=4.0,
                          original_max_position_embeddings=8192),
    ),
    # TinyLlama
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0": dict(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    # Qwen2 family (Llama-like + attention qkv bias; small ones tie the
    # LM head to the embedding)
    "Qwen/Qwen2-0.5B": dict(
        vocab_size=151936, hidden_size=896, intermediate_size=4864,
        num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
        max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-6,
        attention_bias=True, tie_word_embeddings=True,
    ),
    "Qwen/Qwen2-1.5B": dict(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-6,
        attention_bias=True, tie_word_embeddings=True,
    ),
    "Qwen/Qwen2-7B": dict(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-6,
        attention_bias=True,
    ),
    # Mixtral (MoE family; beyond the reference's dense-only coverage)
    "mistralai/Mixtral-8x7B-v0.1": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-5,
        num_experts=8, num_experts_per_token=2,
    ),
    "mistralai/Mixtral-8x22B-v0.1": dict(
        vocab_size=32768, hidden_size=6144, intermediate_size=16384,
        num_hidden_layers=56, num_attention_heads=48, num_key_value_heads=8,
        max_position_embeddings=65536, rope_theta=1e6, rms_norm_eps=1e-5,
        num_experts=8, num_experts_per_token=2,
    ),
    # Tiny debug model for tests / CI
    "picotron-tpu/debug-tiny": dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
    ),
    # Tiny Qwen2-style debug model (qkv bias + tied embeddings)
    "picotron-tpu/debug-tiny-qwen": dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
        attention_bias=True, tie_word_embeddings=True,
    ),
    # Tiny MoE debug model (8 experts, top-2)
    "picotron-tpu/debug-tiny-moe": dict(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
        num_experts=8, num_experts_per_token=2,
    ),
}

# Aliases so shorthand names in configs resolve too.
_PRESET_ALIASES = {
    "SmolLM-135M": "HuggingFaceTB/SmolLM-135M",
    "SmolLM-360M": "HuggingFaceTB/SmolLM-360M",
    "HuggingFaceTB/SmolLM-360M-Instruct": "HuggingFaceTB/SmolLM-360M",
    "SmolLM-1.7B": "HuggingFaceTB/SmolLM-1.7B",
    "HuggingFaceTB/SmolLM-1.7B-Instruct": "HuggingFaceTB/SmolLM-1.7B",
    "Llama-2-7B": "meta-llama/Llama-2-7b-hf",
    "Llama-2-13B": "meta-llama/Llama-2-13b-hf",
    "Llama-2-70B": "meta-llama/Llama-2-70b-hf",
    "Llama-3-8B": "meta-llama/Meta-Llama-3-8B",
    "Llama-3.1-8B": "meta-llama/Llama-3.1-8B",
    "Llama-3.1-70B": "meta-llama/Llama-3.1-70B",
    "Mixtral-8x22B": "mistralai/Mixtral-8x22B-v0.1",
    "Llama-3.2-1B": "meta-llama/Llama-3.2-1B",
    "Llama-3.2-3B": "meta-llama/Llama-3.2-3B",
    "TinyLlama-1.1B": "TinyLlama/TinyLlama-1.1B-Chat-v1.0",
    "Mixtral-8x7B": "mistralai/Mixtral-8x7B-v0.1",
    "Qwen2-0.5B": "Qwen/Qwen2-0.5B",
    "Qwen2-1.5B": "Qwen/Qwen2-1.5B",
    "Qwen2-7B": "Qwen/Qwen2-7B",
    "debug-tiny": "picotron-tpu/debug-tiny",
    "debug-tiny-qwen": "picotron-tpu/debug-tiny-qwen",
    "debug-tiny-moe": "picotron-tpu/debug-tiny-moe",
}


def resolve_preset(name: str) -> dict[str, Any]:
    key = _PRESET_ALIASES.get(name, name)
    if key in MODEL_PRESETS:
        return dict(MODEL_PRESETS[key])
    raise KeyError(
        f"Unknown model preset {name!r}. Known presets: "
        f"{sorted(MODEL_PRESETS) + sorted(_PRESET_ALIASES)}. "
        "Pass explicit hyperparameters in the `model` config section instead."
    )


def resolve_hf_name(name: str) -> str:
    """Canonical HF hub id for a preset shorthand ('SmolLM-1.7B' ->
    'HuggingFaceTB/SmolLM-1.7B'); unknown names pass through unchanged."""
    return _PRESET_ALIASES.get(name, name)


def model_config_from_hf_json(path_or_dict) -> dict[str, Any]:
    """ModelConfig kwargs from a local HF `config.json` — the OFFLINE
    equivalent of the reference's network AutoConfig fetch
    (ref: create_config.py:51-55): any Llama/Qwen2/Mixtral-family model
    outside the preset registry resolves from its config file instead of
    hand-typed hyperparameters. Pass a path or an already-parsed dict."""
    if isinstance(path_or_dict, dict):
        hf = path_or_dict
    else:
        with open(path_or_dict) as f:
            hf = json.load(f)

    mtype = hf.get("model_type", "llama")
    supported = ("llama", "mistral", "mixtral", "qwen2")
    if mtype not in supported:
        raise ValueError(
            f"model_type {mtype!r} is not a supported architecture family "
            f"({supported}); the model layer (models/llama.py) implements "
            "the Llama lineage")

    heads = hf["num_attention_heads"]
    out: dict[str, Any] = {
        "vocab_size": hf["vocab_size"],
        "hidden_size": hf["hidden_size"],
        "intermediate_size": hf["intermediate_size"],
        "num_hidden_layers": hf["num_hidden_layers"],
        "num_attention_heads": heads,
        "num_key_value_heads": hf.get("num_key_value_heads", heads),
        "max_position_embeddings": hf.get("max_position_embeddings", 2048),
        "rope_theta": float(hf.get("rope_theta", 10000.0)),
        "rms_norm_eps": float(hf.get("rms_norm_eps", 1e-5)),
        "tie_word_embeddings": bool(hf.get("tie_word_embeddings", False)),
        # Qwen2 carries qkv bias as attention_bias=absent + model_type;
        # Llama exposes the flag directly
        "attention_bias": bool(hf.get("attention_bias",
                                      mtype == "qwen2")),
    }
    act = hf.get("hidden_act", "silu")
    if act in ("silu", "swish"):
        out["hidden_act"] = "silu"
    elif act == "gelu":
        # transformers' ACT2FN "gelu" is the EXACT erf GELU — mapping it
        # to the tanh approximation would silently drift logits vs the HF
        # reference (code review r4)
        out["hidden_act"] = "gelu"
    elif act in ("gelu_new", "gelu_pytorch_tanh"):
        out["hidden_act"] = "gelu_tanh"
    else:
        raise ValueError(
            f"hidden_act {act!r} unsupported (silu/gelu gated MLPs only)")
    if hf.get("rope_scaling"):
        out["rope_scaling"] = dict(hf["rope_scaling"])
    if hf.get("num_local_experts"):  # Mixtral-style MoE
        out["num_experts"] = hf["num_local_experts"]
        out["num_experts_per_token"] = hf.get("num_experts_per_tok", 2)
    return out


# ---------------------------------------------------------------------------
# Config sections — mirror the reference JSON sections one-to-one.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DistributedConfig:
    """4D parallel layout (ref: template/base_config.json:2-10)."""

    tp_size: int = 1
    cp_size: int = 1
    pp_size: int = 1
    dp_size: int = 1
    pp_engine: str = "1f1b"  # "1f1b" | "afab"
    # Sequence layout across cp shards: "zigzag" gives each shard one early
    # and one late chunk so causal attention work is balanced around the ring
    # (the reference splits contiguously and carries the known imbalance +
    # a zigzag TODO, ref: data.py:105-109, tests/test_dataloader.py:136).
    # "contiguous" reproduces the reference layout.
    cp_layout: str = "zigzag"
    # Context-parallel attention schedule: "" derives the flavor from
    # model.attn_impl (back-compat: "ring"/"ulysses"/"mesh" there select
    # directly, anything else defaults to the ring). "mesh" is the 2D
    # schedule (ops/mesh_attention.py): cp factors into cp_x x cp_y, an
    # Ulysses-style head scatter runs within cp_y subgroups and a K/V
    # ring over the cp_x rows — same per-hop volume as the ring but only
    # cp_x-1 hops, head divisibility required only by cp_y.
    cp_flavor: str = ""  # "" | "ring" | "ulysses" | "mesh"
    # Mesh-flavor factorization "XxY" (e.g. "2x4": cp_x=2 ring rows,
    # cp_y=4 head-scatter columns); X*Y must equal cp_size. "" picks the
    # most-square feasible factorization (resolved_cp_mesh); the planner
    # enumerates all feasible ones against the ICI cost model.
    cp_mesh: str = ""
    # Expert parallelism: shards MoE expert banks over a dedicated mesh
    # axis; acts as an additional data axis for non-expert computation
    # (batch over the fused ('dp','ep') axes). Requires a MoE model
    # (model.num_experts > 0) when > 1.
    ep_size: int = 1
    # Megatron-style sequence parallelism over the tp axis (the reference
    # leaves this as a TODO, ref: utils.py:66): between blocks the residual
    # stream / norms are sharded [*, S/tp, H] and the TP entry/exit
    # collectives become all_gather / reduce_scatter (same bytes as the
    # psum they replace; tp x less pipeline boundary traffic). Memory: the
    # tp x shrink applies only to the norm/residual tensors BETWEEN g and
    # f — measured ~5% of total activation memory with remat off and ~0
    # under the dots remat policies, whose saved dot outputs sit after the
    # gather and stay full-sequence (tools/memcheck.py --override, PERF.md
    # round 4). Use it for the boundary traffic, not as a memory lever.
    sequence_parallel: bool = False
    # ZeRO-1 optimizer-state sharding (beyond the reference): shards the
    # Adam moments over 'dp' in addition to their param's tp/pp/ep
    # sharding. GSPMD turns the sharding annotation into the per-shard
    # update + all-gather schedule, cutting resident moment memory by
    # ~dp_size — measured on SmolLM-1.7B dp8: 13.5 -> 1.69 GiB/device of
    # moments, 20.25 -> 8.44 GiB/device total state (tools/memcheck.py
    # --override distributed.zero1=true; PERF.md round 4).
    zero1: bool = False
    # Per-layer-class TP partitioning (ATP, arxiv 2301.08658). Presets:
    # "megatron" — the fixed column/row pattern (qkv/up column-parallel,
    # o/down row-parallel + exit psum; today's default); "row" — row-first
    # (qkv/up input-sharded with a psum at the projection exit, o/down
    # column-parallel with a feature all-gather exit; attention runs
    # tp-replicated); "2d" — tp = tp_x x tp_y factorization (subgroup
    # collectives over tp_mesh; see parallel/tp_strategies.py); "adaptive"
    # — per-layer-class cost-model argmin (resolved_tp_strategy). An
    # explicit per-class spec is also accepted:
    # "qkv=col,o=row,up=col,down=row,head=col" (pairings must be legal —
    # parse_tp_strategy).
    tp_strategy: str = "megatron"
    # Activation-sync mode for the TP block exit: "sync" keeps the
    # row-parallel psum (or the SP reduce-scatter) on the critical path;
    # "deferred" replaces it with a reduce-scatter over the sequence whose
    # gather half is hoisted into the NEXT block's entry (ParallelCtx.pre),
    # so the residual stream stays seq-sharded between blocks and XLA can
    # hide the gather behind the block-entry compute (partially-
    # synchronized-activation TP, arxiv 2506.19645). Numerics are exact
    # (RMSNorm is per-token); parity is pinned against the sync path.
    tp_sync: str = "sync"
    # 2D strategy factorization "XxY" (tp_x x tp_y, tp_x * tp_y == tp_size);
    # "" picks the most-square feasible factorization (resolved_tp_mesh).
    tp_mesh: str = ""
    # Multi-slice topology: number of TPU slices joined over DCN (the
    # data-center network). 1 = single slice, everything on ICI. When > 1
    # the slice granules are absorbed into the DCN-tolerant axes (dp first,
    # then pp — mesh._split_axes_over_dcn) and the static slice-boundary
    # auditor (analysis/boundary.py) proves at preflight that only
    # collectives over the declared dcn_axes cross the cut.
    slices: int = 1
    # Which mesh axes are DECLARED as allowed to cross the inter-slice DCN
    # link, comma-separated subset of "dp,pp". The auditor classifies every
    # traced replica group against this declaration: groups on a declared
    # axis that straddle the cut are "boundary" (expected, priced at the
    # dcn tier); groups on any other axis that straddle it are
    # "violating" (a named preflight error).
    dcn_axes: str = "dp,pp"
    # Runtime hierarchical dp gradient reduction across the slice cut:
    # reduce-scatter inside the slice + a shard-per-slice all-reduce over
    # DCN + intra-slice all-gather (parallel/hier_reduce.py), replacing the
    # flat dp all-reduce the single-slice step emits. "auto" turns it on
    # exactly when slices > 1 and dp physically carries a slice granule;
    # "on" requires such a layout (refuses to silently no-op); "off" keeps
    # the flat all-reduce (the A/B twin the parity tests pin against).
    hier_dp_reduce: str = "auto"
    # Accepted for reference-JSON compatibility; ignored (XLA picks transport).
    backend: str = "jax"
    use_cpu: bool = False

    @property
    def world_size(self) -> int:
        return (self.tp_size * self.cp_size * self.pp_size * self.dp_size
                * self.ep_size)

    def validate(self) -> None:
        for name in ("tp_size", "cp_size", "pp_size", "dp_size", "ep_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.pp_engine not in ("1f1b", "afab"):
            raise ValueError(f"pp_engine must be '1f1b' or 'afab', got {self.pp_engine!r}")
        if self.cp_layout not in ("zigzag", "contiguous"):
            raise ValueError(
                f"cp_layout must be 'zigzag' or 'contiguous', got {self.cp_layout!r}")
        if self.cp_flavor not in ("", "ring", "ulysses", "mesh"):
            raise ValueError(
                f"cp_flavor must be one of ring/ulysses/mesh (or empty to "
                f"derive from model.attn_impl), got {self.cp_flavor!r}")
        if self.cp_flavor and self.cp_size == 1:
            raise ValueError(
                f"cp_flavor={self.cp_flavor!r} requires cp_size > 1 (it "
                "names a context-parallel schedule)")
        if self.cp_mesh:
            cp_x, cp_y = parse_cp_mesh(self.cp_mesh)
            if cp_x * cp_y != self.cp_size:
                raise ValueError(
                    f"cp_mesh '{self.cp_mesh}' must factor the cp degree: "
                    f"{cp_x} * {cp_y} != cp_size ({self.cp_size})")
        parse_tp_strategy(self.tp_strategy)  # raises with the field named
        if self.tp_strategy != "megatron" and self.tp_size == 1:
            raise ValueError(
                f"tp_strategy={self.tp_strategy!r} requires tp_size > 1 "
                "(it names a tensor-parallel partitioning)")
        if self.tp_sync not in ("sync", "deferred"):
            raise ValueError(
                f"tp_sync must be 'sync' or 'deferred', got {self.tp_sync!r}")
        if self.tp_sync == "deferred" and self.tp_size == 1:
            raise ValueError(
                "tp_sync='deferred' requires tp_size > 1 (it reschedules "
                "the TP block-exit collective)")
        if self.tp_mesh:
            tp_x, tp_y = parse_cp_mesh(self.tp_mesh)
            if tp_x * tp_y != self.tp_size:
                raise ValueError(
                    f"tp_mesh '{self.tp_mesh}' must factor the tp degree: "
                    f"{tp_x} * {tp_y} != tp_size ({self.tp_size})")
        if self.slices < 1:
            raise ValueError(f"slices must be >= 1, got {self.slices}")
        axes = parse_dcn_axes(self.dcn_axes)
        if self.slices > 1:
            # Mirror mesh._split_axes_over_dcn: the slice count must divide
            # dp*pp so ep/cp/tp collectives stay on ICI. The declaration may
            # be NARROWER than the house rule (that is how a mis-declared
            # layout is caught by the boundary auditor), but it cannot name
            # an ICI-only axis.
            if self.slices > self.dp_size * self.pp_size or (
                    self.dp_size * self.pp_size) % self.slices != 0:
                raise ValueError(
                    f"slices ({self.slices}) must divide dp*pp "
                    f"({self.dp_size}*{self.pp_size}="
                    f"{self.dp_size * self.pp_size}) — ep/cp/tp collectives "
                    "must stay on ICI. Rebalance the layout so dp*pp "
                    "absorbs the slice count.")
            if not axes:
                raise ValueError(
                    "dcn_axes must declare at least one crossing axis "
                    "when slices > 1 (subset of 'dp,pp')")
        if self.hier_dp_reduce not in ("auto", "on", "off"):
            raise ValueError(
                f"hier_dp_reduce must be 'auto', 'on' or 'off', got "
                f"{self.hier_dp_reduce!r}")
        if self.hier_dp_reduce == "on":
            import math

            if (self.slices <= 1 or "dp" not in axes
                    or math.gcd(self.dp_size, self.slices) <= 1):
                raise ValueError(
                    "hier_dp_reduce='on' requires a multi-slice layout "
                    "whose dp axis physically carries a slice granule "
                    "(slices > 1, 'dp' in dcn_axes, gcd(dp_size, slices) "
                    "> 1); use 'auto' to enable it only when the layout "
                    "calls for it")


DCN_TOLERANT_AXES = ("dp", "pp")


def parse_dcn_axes(spec: str) -> tuple[str, ...]:
    """Parse a dcn_axes declaration into an ordered (dp-first) axis tuple.

    Accepts a comma-separated subset of the DCN-tolerant axes ("dp", "pp");
    the empty string means no axis is declared (only legal at slices == 1).
    """
    axes = tuple(a.strip() for a in spec.split(",") if a.strip())
    bad = [a for a in axes if a not in DCN_TOLERANT_AXES]
    if bad:
        raise ValueError(
            f"dcn_axes may only name the DCN-tolerant axes "
            f"{DCN_TOLERANT_AXES} (got {bad} in {spec!r}) — ep/cp/tp "
            "collectives must stay on ICI")
    if len(set(axes)) != len(axes):
        raise ValueError(f"dcn_axes has duplicate axes: {spec!r}")
    return tuple(a for a in DCN_TOLERANT_AXES if a in axes)


def _parse_mesh2(spec: str, field: str) -> tuple[int, int]:
    parts = spec.lower().split("x")
    try:
        m_x, m_y = (int(p) for p in parts)
    except (TypeError, ValueError):
        raise ValueError(
            f"{field} must be 'XxY' (two positive integers, e.g. '2x4'), "
            f"got {spec!r}") from None
    if m_x < 1 or m_y < 1:
        raise ValueError(f"{field} factors must be >= 1, got {spec!r}")
    return m_x, m_y


def parse_cp_mesh(spec: str) -> tuple[int, int]:
    """'XxY' -> (cp_x, cp_y), with a field-naming error (not a bare int
    crash) on malformed input."""
    return _parse_mesh2(spec, "cp_mesh")


def parse_tp_mesh(spec: str) -> tuple[int, int]:
    """'XxY' -> (tp_x, tp_y) for the 2D TP strategy factorization."""
    return _parse_mesh2(spec, "tp_mesh")


# Layer classes a TP strategy assigns a partitioning to, and the legal
# (entry, exit) pairings: the qkv/o and up/down pairs bracket a block, so
# the entry's output layout must be what the exit consumes.
TP_STRATEGY_CLASSES = ("qkv", "o", "up", "down", "head")
_TP_STRATEGY_PRESETS = {
    "megatron": {"qkv": "col", "o": "row", "up": "col", "down": "row",
                 "head": "col"},
    "row": {"qkv": "row", "o": "col", "up": "row", "down": "col",
            "head": "col"},
    "2d": {"qkv": "2d", "o": "2d", "up": "2d", "down": "2d", "head": "col"},
}
_TP_LEGAL_PAIRS = {("col", "row"), ("row", "col"), ("2d", "2d")}


def parse_tp_strategy(spec: str):
    """Parse distributed.tp_strategy into a per-class dict
    {qkv,o,up,down,head} -> {col,row,2d}, or None for "adaptive" (whose
    resolution needs the cost model — resolved_tp_strategy). Presets
    megatron/row/2d expand to full dicts; an explicit "k=v,..." spec may
    name a subset of classes (the rest default to megatron) but must keep
    the (qkv,o) and (up,down) pairings legal and head column-parallel."""
    if spec == "adaptive":
        return None
    if spec in _TP_STRATEGY_PRESETS:
        return dict(_TP_STRATEGY_PRESETS[spec])
    out = dict(_TP_STRATEGY_PRESETS["megatron"])
    for item in spec.split(","):
        if "=" not in item:
            raise ValueError(
                f"tp_strategy must be a preset (megatron/row/2d/adaptive) "
                f"or a 'class=value,...' spec over "
                f"{'/'.join(TP_STRATEGY_CLASSES)}, got {spec!r}")
        k, _, v = item.partition("=")
        k, v = k.strip(), v.strip()
        if k not in TP_STRATEGY_CLASSES:
            raise ValueError(
                f"tp_strategy names unknown layer class {k!r} (classes: "
                f"{', '.join(TP_STRATEGY_CLASSES)})")
        if v not in ("col", "row", "2d"):
            raise ValueError(
                f"tp_strategy value for {k!r} must be col/row/2d, got {v!r}")
        out[k] = v
    if out["head"] != "col":
        raise ValueError(
            "tp_strategy head must be 'col' (the vocab-parallel head/CE is "
            "the only supported head partitioning; row is priced by the "
            "cost model but has no runtime path)")
    for entry, exit_ in (("qkv", "o"), ("up", "down")):
        if (out[entry], out[exit_]) not in _TP_LEGAL_PAIRS:
            raise ValueError(
                f"tp_strategy pairing {entry}={out[entry]}/{exit_}="
                f"{out[exit_]} is not a legal (entry, exit) pair — the "
                f"entry's output layout must feed the exit (legal: "
                f"col/row, row/col, 2d/2d)")
    return out


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family architecture hyperparameters.

    Resolved from a preset by name with explicit overrides on top
    (ref: create_config.py:51-63 does the same via AutoConfig + overrides).
    """

    name: str = "picotron-tpu/debug-tiny"
    vocab_size: int = 256
    hidden_size: int = 64
    intermediate_size: int = 128
    num_hidden_layers: int = 4
    num_attention_heads: int = 4
    num_key_value_heads: int = 2
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    # HF-style rope_scaling config (Llama-3.1/3.2's {"rope_type": "llama3",
    # "factor": 8.0, ...} or {"rope_type": "linear", "factor": N}); None =
    # unscaled. Stored internally as a sorted (key, value) tuple so the
    # frozen config stays hashable (generation jits with the config as a
    # static argument); pass a plain dict, __post_init__ normalizes.
    rope_scaling: Optional[Any] = None
    rms_norm_eps: float = 1e-5
    # Qwen2-style architecture variants: bias on the q/k/v projections, and
    # an LM head tied to the embedding matrix (logits = h @ embedding.T; no
    # separate lm_head parameter — the Llama family unties, ref:
    # checkpoint.py:88-91 force-creates lm_head).
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    # Gated-MLP activation: "silu" (Llama/Qwen/Mixtral SwiGLU), "gelu"
    # (EXACT erf GELU — transformers' "gelu"), or "gelu_tanh" (the tanh
    # approximation — transformers' "gelu_pytorch_tanh"/"gelu_new",
    # the Gemma-style GeGLU) — widens the --from-hf-config long tail
    # beyond pure-SwiGLU families.
    hidden_act: str = "silu"
    dtype: str = "bfloat16"  # compute/activation dtype; master params are fp32
    # Attention implementation: "auto" picks flash on TPU / reference on CPU;
    # CP > 1 always routes through the ring (ref: model.py:148-158 dispatch).
    attn_impl: str = "auto"  # "auto" | "flash" | "reference" | "ring"
    # Mixture-of-experts (beyond the reference, SURVEY §2.2 marks EP absent):
    # num_experts = 0 keeps the dense SwiGLU MLP; > 0 replaces every MLP with
    # a top-k-routed expert bank (Mixtral-style: softmax over the top-k
    # router logits) plus a load-balancing aux loss. Experts shard over the
    # 'ep' mesh axis; dispatch is capacity-bounded (GShard-style) so shapes
    # stay static for XLA.
    num_experts: int = 0
    num_experts_per_token: int = 2
    moe_intermediate_size: Optional[int] = None  # default: intermediate_size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # Router z-loss coefficient (ST-MoE eq. 5; 1e-3 there). 0 disables.
    router_z_coef: float = 0.0
    # Compute router aux statistics (balance f/P, z-loss mean) over the
    # GLOBAL batch via pmean over the data axes — layout-exact losses
    # (identical for any dp/cp/ep factorization). False = per-device
    # statistics (cheaper by two [E]-sized pmeans per layer, differs across
    # layouts by O(shard variance)).
    router_aux_global: bool = True
    # Accepted for reference compat (ref uses them to pick CUDA kernels).
    use_flash_attention: bool = True
    use_fused_adam: bool = True

    def __post_init__(self):
        rs = self.rope_scaling
        if isinstance(rs, dict):
            rs = tuple(sorted(rs.items()))
        elif isinstance(rs, (list, tuple)) and rs:
            # JSON round-trip (to_json_dict -> config_from_dict) turns the
            # tuple of pairs into nested lists — re-normalize so the frozen
            # config stays hashable
            rs = tuple(sorted(tuple(pair) for pair in rs))
        object.__setattr__(self, "rope_scaling", rs or None)

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def expert_ffn_size(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    def validate(self) -> None:
        if self.attn_impl not in ("auto", "flash", "reference", "ring",
                                  "ulysses", "mesh"):
            raise ValueError(
                f"attn_impl must be one of auto/flash/reference/ring/"
                f"ulysses/mesh, got {self.attn_impl!r}"
            )
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError("hidden_size must be divisible by num_attention_heads")
        if self.num_attention_heads % self.num_key_value_heads != 0:
            raise ValueError("num_attention_heads must be divisible by num_key_value_heads")
        if self.head_dim % 2 != 0:
            raise ValueError("head_dim must be even for RoPE")
        if self.hidden_act not in ("silu", "gelu", "gelu_tanh"):
            raise ValueError(
                f"hidden_act must be 'silu', 'gelu', or 'gelu_tanh', got "
                f"{self.hidden_act!r}")


@dataclass(frozen=True)
class TrainingConfig:
    """(ref: template/base_config.json:20-29)."""

    seed: int = 42
    learning_rate: float = 3e-4
    # LR schedule: "constant" (the reference's behavior, ref: train.py:209
    # builds a bare AdamW), "cosine" (linear warmup -> cosine decay to
    # lr * lr_min_ratio over total_train_steps), or "linear" (warmup ->
    # linear decay). Warmup counts from step 0 even on resume — the
    # schedule reads the restored optimizer step count.
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_min_ratio: float = 0.1
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    # "float32" | "bfloat16": bf16 halves Adam-moment memory (update math
    # stays fp32) — the knob that fits SmolLM-1.7B's optimizer on one v5e.
    adam_moments_dtype: str = "float32"
    # ZeRO-Offload-style optimizer-state offload (beyond the reference,
    # whose CUDA path keeps everything in GPU memory): the fp32 master
    # params and both Adam moments live permanently in pinned HOST memory;
    # the device keeps only a bf16 compute copy of the params plus the fp32
    # gradient accumulator. The update streams leaf-by-leaf through the
    # device (host->device DMA, fused AdamW, device->host write-back), so
    # per-step PCIe traffic is params+moments each way — amortize it with
    # gradient_accumulation_steps >= ~16. This is the lever that fits
    # full-depth SmolLM-1.7B (fp32 master + grads + moments ~21 GB) on one
    # 15.75 GB v5e chip with NO numerics compromise: the master update math
    # is identical to the on-device path; only per-microbatch grads are
    # bf16 (they accumulate in fp32, the standard mixed-precision
    # arrangement).
    optimizer_offload: bool = False
    grad_clip_norm: float = 0.0  # 0 disables clipping
    total_train_steps: int = 200
    seq_length: int = 1024
    micro_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    num_samples: Optional[int] = None
    max_tokens: Optional[int] = None
    # Periodic validation: every eval_frequency training steps, run
    # eval_steps batches from the eval source (dataset.eval_split for HF
    # datasets; a disjoint-seed synthetic stream otherwise) and log
    # val_loss. 0 disables (the reference has no eval loop).
    eval_frequency: int = 0
    eval_steps: int = 8
    # Stream the LM-head cross-entropy over vocab chunks of this many
    # columns: the [tokens, vocab] logits never materialize (neither as a
    # forward tensor nor a saved backward residual — chunks recompute),
    # trading one extra chunk matmul in backward for ~tokens*vocab*2 bytes
    # of peak HBM. 0 disables (fused single-matmul CE). Must divide
    # vocab_size / tp_size or it silently falls back to fused.
    ce_chunk_size: int = 0
    # Gradient rematerialization for long-context / big-model memory savings.
    remat: bool = True
    # "full" recomputes everything in backward (max memory savings);
    # "dots" saves matmul outputs and recomputes only elementwise ops —
    # usually within a few % of no-remat speed at a fraction of the memory;
    # "dots_attn" saves only the attention-side dots and recomputes the MLP
    # (~2.6x less activation HBM than "dots" for ~+7% step FLOPs — the
    # memory/speed midpoint that pairs with optimizer_offload);
    # "dots_norms" additionally saves RMSNorm outputs (~2 activations/layer
    # more HBM, less backward recompute).
    remat_policy: str = "dots"
    # Gradient engine for the non-pipeline microbatch loop: "ad"
    # differentiates each microbatch and tree-adds into the fp32
    # accumulator (one whole-tree temp write + one whole-tree add per
    # microbatch — measured 26 ms of serialized roofline HBM traffic per
    # microbatch at SmolLM-1.7B, PERF.md r5); "fused" runs the manual
    # backward layer scan (parallel/fused_bwd.py) that accumulates each
    # layer's dW in-scan, eliminating both passes. "auto" picks "fused"
    # whenever it is supported (any single-pipeline-stage layout —
    # dp/tp/SP/cp ring|ulysses/ep/MoE — under remat dots_attn; see the
    # README eligibility matrix) and gradient accumulation is in play.
    # Numerics match the AD engine (pinned by tests/test_fused_bwd.py).
    grad_engine: str = "auto"


@dataclass(frozen=True)
class DatasetConfig:
    """(ref: template/base_config.json:30-35). `synthetic` replaces network
    datasets in tests/benchmarks (deterministic PRNG token stream)."""

    name: str = "synthetic"
    subset_name: Optional[str] = None
    tokenizer_name: Optional[str] = None
    num_workers: int = 0
    num_proc: int = 1
    split: str = "train"
    # HF split for the validation loader (training.eval_frequency > 0);
    # None with a synthetic source uses a disjoint seed stream.
    eval_split: Optional[str] = None
    text_column: str = "text"


@dataclass(frozen=True)
class CheckpointConfig:
    """(ref: template/base_config.json:36-40)."""

    save_dir: str = "ckpt"
    save_frequency: int = 0  # 0 disables periodic saving
    # Async Orbax save (SURVEY §5): save() stages device->host copies and
    # returns; the disk write overlaps subsequent training steps. The
    # trainer waits for durability at exit. False = blocking saves (the
    # reference's behavior, ref: checkpoint.py:246-260).
    async_save: bool = True
    load_path: str = ""
    # Resume from the newest durable checkpoint in save_dir when no
    # load_path is given (no-op when save_dir holds none). This is the
    # in-process half of preemption recovery: the reference's scheduler
    # resubmits failed jobs (ref: submit_slurm_jobs.py:157-172) but each
    # resubmission restarts from scratch unless resume is hand-configured;
    # with auto_resume a resubmitted/preempted job continues where its
    # last completed save left off — the standard arrangement for
    # preemptible TPU pods.
    auto_resume: bool = False
    # Optional HF safetensors dir to materialize initial weights from (the
    # reference's bootstrap reads safetensors but only as shape templates,
    # ref: checkpoint.py:93-101; we actually load the values).
    init_from_hf: str = ""
    # Retention GC (picotron_tpu/ckpt_integrity): after each durable
    # commit, prune step dirs beyond the keep_last newest. 0 disables
    # (keep everything — the pre-lineage behavior). keep_every
    # additionally pins steps divisible by it forever (sparse anchors
    # under an aggressive keep_last). The last *verified* checkpoint is
    # never deleted regardless of policy — keep_last=1 with a corrupt
    # newest step keeps the restore fallback alive.
    keep_last: int = 0
    keep_every: int = 0
    # Elastic resume (resilience/elastic.py): allow restore into a layout
    # whose dp or pp differs from the one the checkpoint was saved under
    # (e.g. dp=2 -> dp=4 after a fleet resize). Each rank re-splits its
    # share out of the saved per-rank files; the restore validates that
    # global_batch_size is unchanged (the token-exact cursor / loss-parity
    # invariant) and books the restore under the `resize` goodput
    # category. False = a topology mismatch at restore time is a hard
    # error naming the tools.elastic_resize re-stamp that would fix it.
    elastic: bool = False


@dataclass(frozen=True)
class ResilienceConfig:
    """Runtime fault tolerance (picotron_tpu/resilience; beyond the
    reference, whose loop dies on the first NaN, hang, or preemption).
    See README "Fault tolerance" for the recovery matrix."""

    # Fault-injection spec, e.g. "sigterm@3,ckpt_io@2x2" (resilience/
    # chaos.py documents the grammar). Empty = no injection. The
    # PICOTRON_CHAOS env var, when set, overrides this field.
    chaos: str = ""
    # Response to a tripped divergence guard (non-finite loss/grads, loss
    # spike): "skip" drops the batch but keeps optimizer state (the
    # non-finite half runs inside the jitted step), "rollback" restores
    # the last durable checkpoint and skips past the poison data range,
    # "abort" exits EXIT_DIVERGED (76), "off" disables the guards — and
    # with them the per-step host sync they require; use "off" to recover
    # fully-async stepping when logging is sparse.
    guard_policy: str = "abort"
    # Rolling loss-spike detection: trip when the loss sits spike_zscore
    # standard deviations above the mean of the last spike_window healthy
    # steps. 0 disables (non-finite detection stays on).
    spike_zscore: float = 0.0
    spike_window: int = 32
    # Consecutive guard trips before escalating to abort regardless of
    # policy — a guard that keeps tripping is not recovering.
    max_guard_trips: int = 3
    # Retry-with-backoff policy for flaky I/O (checkpoint save/restore,
    # durability probes, dataset reads): total attempts and the
    # exponential-backoff delay bounds in seconds.
    retry_attempts: int = 3
    retry_base_delay: float = 0.5
    retry_max_delay: float = 30.0
    # Seconds without step-loop progress before the watchdog dumps all
    # thread stacks and exits EXIT_WATCHDOG (77) for a supervisor
    # restart. 0 disables. Armed only after the first step completes
    # (step 1 includes unbounded XLA compile time); set it well above a
    # normal step + checkpoint write.
    watchdog_timeout: float = 0.0

    def validate(self) -> None:
        if self.guard_policy not in ("off", "skip", "rollback", "abort"):
            raise ValueError(
                f"guard_policy must be off/skip/rollback/abort, got "
                f"{self.guard_policy!r}")
        if self.spike_zscore < 0:
            raise ValueError(
                f"spike_zscore must be >= 0, got {self.spike_zscore}")
        if self.spike_window < 4:
            # fewer points make the z-score statistically meaningless and
            # trip on ordinary early-training descent
            raise ValueError(
                f"spike_window must be >= 4, got {self.spike_window}")
        if self.max_guard_trips < 1:
            raise ValueError(
                f"max_guard_trips must be >= 1, got {self.max_guard_trips}")
        if self.retry_attempts < 1:
            raise ValueError(
                f"retry_attempts must be >= 1, got {self.retry_attempts}")
        if self.retry_base_delay < 0 or self.retry_max_delay < self.retry_base_delay:
            raise ValueError(
                f"retry delays must satisfy 0 <= base <= max, got "
                f"base={self.retry_base_delay} max={self.retry_max_delay}")
        if self.watchdog_timeout < 0:
            raise ValueError(
                f"watchdog_timeout must be >= 0, got {self.watchdog_timeout}")
        if self.chaos:
            # Parse errors at config load, not at step N mid-run.
            from picotron_tpu_torch.resilience.chaos import parse_spec

            parse_spec(self.chaos)


@dataclass(frozen=True)
class ServeConfig:
    """Serving stack (picotron_tpu/serve): continuous batching + paged KV
    cache on the decode path. Sizing contract: per-slot capacity is
    max_model_len tokens (table width = ceil(max_model_len / block_size));
    the POOL is num_blocks fixed-size blocks shared by every slot — cache
    HBM scales with num_blocks, not decode_slots x max_model_len, which is
    the whole point (ragged request lengths stop stranding cache memory).
    Oversubscribe deliberately: the scheduler preempts youngest-first when
    the pool runs dry."""

    # In-flight decode batch width: the ONE static shape the decode step
    # is compiled for (slots are refilled mid-flight, never reshaped).
    decode_slots: int = 8
    # Tokens per physical cache block. Smaller = less fragmentation waste
    # per sequence (at most block_size - 1 slots), larger = smaller block
    # tables and fewer scatter indices.
    block_size: int = 16
    # Physical blocks in the shared pool. 0 = auto: decode_slots *
    # ceil(max_model_len / block_size) — the no-oversubscription worst
    # case (same HBM as a contiguous cache at max length). Set it
    # explicitly to actually bank the paged-cache memory win.
    num_blocks: int = 0
    # Prompt tokens prefilled per engine iteration; one chunk interleaves
    # with each decode step so a long prompt cannot stall in-flight
    # decodes. Also the prefill program's static shape (prompts pad to a
    # chunk multiple; padded positions are sentinel-dropped).
    prefill_chunk: int = 64
    # Per-sequence capacity (prompt + generated). 0 = the model's
    # max_position_embeddings.
    max_model_len: int = 0
    # Decode steps run INSIDE one dispatch (a lax.scan over the decode
    # step, with in-flight EOS forcing identical to generate.py's scan):
    # amortizes the per-dispatch host overhead over this many tokens per
    # slot. The scheduler only sees tokens every interval, so admission/
    # retirement latency quantizes to it and a request that hits EOS or
    # its budget mid-interval pays the leftover steps as padding — keep
    # it small (2-8) for interactive SLOs, 1 for exact per-token
    # scheduling.
    decode_interval: int = 4

    # --- disaggregated serving (serve/disagg.py): prefill pool / decode
    # pool as separately placed programs with paged-KV block handoff, so
    # a burst of long prefills cannot stall decode dispatches ---
    # Split prefill and decode into two pools (DisaggServeEngine).
    disagg: bool = False
    # Prefill-pool slot width (the prefill program's static batch shape).
    # 0 = decode_slots.
    prefill_slots: int = 0
    # Physical blocks in the prefill pool. 0 = auto: prefill_slots *
    # ceil(max_model_len / block_size) — every prefill slot can hold a
    # full-length prompt without backpressure.
    prefill_num_blocks: int = 0
    # Device placement per pool: an index into jax.devices(). -1 = auto
    # (prefill on the first device, decode on the last — distinct devices
    # whenever the host has more than one, colocated otherwise).
    prefill_device: int = -1
    decode_device: int = -1

    # --- fleet serving (serve/fleet.py): a FleetSupervisor fronting N
    # engine replicas with health/failover/drain — the robustness layer
    # in front of the single-engine stack ---
    # Engine replicas behind the supervisor. 1 = no fleet (the
    # single-engine paths are untouched). Each replica gets its own
    # device (round-robin over jax.devices()), its own KV pool, and the
    # SAME base sampling key, so failover re-dispatch is bit-identical.
    fleet_size: int = 1
    # Default admission deadline applied to requests that do not carry
    # their own: a request still queued once its wait exceeds this many
    # milliseconds is SHED (rejected, serve_shed event, booked to the
    # `shed` ledger category) instead of admitted late. 0 = no deadline.
    deadline_ms: float = 0.0
    # Grace budget for FleetSupervisor.drain(): how long (trace-clock
    # seconds) a draining engine may keep its residents before they are
    # forcibly re-dispatched onto the survivors and the engine retires
    # anyway.
    drain_grace_s: float = 5.0

    # --- speculative decode (serve/spec_decode.py): multi-token decode
    # inside the decode_interval scan, verify-and-accept in one dispatch,
    # sampling keys still derived from (request id, token index) so
    # accept/reject cannot perturb tokens ---
    # 'off' (one token per slot per step) or 'ngram' (self-drafting
    # n-gram speculator over each slot's recent context — no draft
    # model, the prompt-lookup arrangement).
    speculator: str = "off"
    # Tokens drafted (and verified) per decode step when the speculator
    # is on; each step emits 1..draft_len+1 tokens per slot.
    draft_len: int = 3

    def validate(self) -> None:
        for name in ("decode_slots", "block_size", "prefill_chunk",
                     "decode_interval"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"serve.{name} must be >= 1, got {getattr(self, name)}")
        if self.num_blocks < 0:
            raise ValueError(
                f"serve.num_blocks must be >= 0 (0 = auto), got "
                f"{self.num_blocks}")
        if self.max_model_len < 0:
            raise ValueError(
                f"serve.max_model_len must be >= 0 (0 = model limit), got "
                f"{self.max_model_len}")
        for name in ("prefill_slots", "prefill_num_blocks"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"serve.{name} must be >= 0 (0 = auto), got "
                    f"{getattr(self, name)}")
        for name in ("prefill_device", "decode_device"):
            if getattr(self, name) < -1:
                raise ValueError(
                    f"serve.{name} must be a device index or -1 (auto), "
                    f"got {getattr(self, name)}")
        if self.fleet_size < 1:
            raise ValueError(
                f"serve.fleet_size must be >= 1, got {self.fleet_size}")
        if self.deadline_ms < 0:
            raise ValueError(
                f"serve.deadline_ms must be >= 0 (0 = no deadline), got "
                f"{self.deadline_ms}")
        if self.drain_grace_s < 0:
            raise ValueError(
                f"serve.drain_grace_s must be >= 0, got "
                f"{self.drain_grace_s}")
        if self.speculator not in ("off", "ngram"):
            raise ValueError(
                f"serve.speculator must be 'off' or 'ngram', got "
                f"{self.speculator!r}")
        if self.speculator != "off" and self.draft_len < 1:
            raise ValueError(
                f"serve.draft_len must be >= 1 when a speculator is on, "
                f"got {self.draft_len}")
        if self.draft_len < 0:
            raise ValueError(
                f"serve.draft_len must be >= 0, got {self.draft_len}")


@dataclass(frozen=True)
class LoggingConfig:
    """(ref: template/base_config.json:41-45)."""

    use_wandb: bool = False
    project_name: str = "picotron-tpu"
    run_name: Optional[str] = None
    log_frequency: int = 1
    # torch.profiler trace capture (telemetry/profiler.py; the JAX
    # package's jax.profiler window): CPU and CUDA activity, a Chrome
    # trace per rank that tools.trace_summary reads. None disables; a
    # directory enables capture of the run-relative steps
    # [profile_start_step, profile_start_step + profile_num_steps).
    profile_dir: Optional[str] = None
    profile_start_step: int = 3
    profile_num_steps: int = 3
    # Structured telemetry (picotron_tpu/telemetry): write the per-host
    # JSONL event stream — step-phase timings, goodput ledger, resilience
    # events, per-step metrics — to `telemetry.jsonl` next to the
    # checkpoints (telemetry_dir overrides the location). Append-mode, so
    # a supervised restart continues the same stream and
    # tools/telemetry_report.py can account replayed steps across
    # restarts. The stdout log line is unaffected either way (its format
    # is frozen; tools/extract_metrics.py parses it).
    telemetry_jsonl: bool = True
    telemetry_dir: Optional[str] = None
    # Size-capped JSONL rotation: when > 0, a telemetry.jsonl exceeding
    # this many MB is rotated once to `telemetry.jsonl.1` and a fresh
    # segment starts. Readers (tools/telemetry_report.py,
    # tools/extract_metrics.py) read `.1` then the live file, so
    # cross-restart replay accounting survives rotation. 0 = unbounded.
    telemetry_max_mb: float = 0.0
    # flightdeck span tracer (telemetry/flightdeck/tracer.py): a
    # directory enables span recording (train phases, MPMD schedule
    # ticks, serve request lifecycles, resilience instants) exported as
    # Chrome-trace/Perfetto JSON `trace.json` on close. None disables —
    # the disabled path allocates nothing.
    trace_dir: Optional[str] = None
    # flightdeck crash flight recorder (telemetry/flightdeck/flight.py):
    # ring of the last N steps' phase timings + metrics + spans, dumped
    # to `flightdeck_postmortem.json` on abnormal exits (watchdog 77,
    # divergence abort/rollback, preemption 75, unhandled exceptions).
    # 0 disables.
    flight_steps: int = 8
    # flightdeck drift sentinel (telemetry/flightdeck/sentinel.py):
    # online watch of rolling step time, sync share vs the cost model's
    # predicted exposed comm, and data-wait share. A quantity breaching
    # `sentinel_ratio` x baseline (and `sentinel_zscore` sigmas where
    # the window has variance) for `sentinel_patience` consecutive
    # steps emits ONE `sentinel_alert` event and auto-dumps the flight
    # recorder.
    sentinel: bool = False
    sentinel_window: int = 32
    sentinel_zscore: float = 4.0
    sentinel_ratio: float = 1.5
    sentinel_patience: int = 3

    def validate(self) -> None:
        if self.telemetry_max_mb < 0:
            raise ValueError(
                f"logging.telemetry_max_mb must be >= 0 (0 disables "
                f"rotation), got {self.telemetry_max_mb}")
        if self.flight_steps < 0:
            raise ValueError(
                f"logging.flight_steps must be >= 0 (0 disables the "
                f"flight recorder), got {self.flight_steps}")
        if self.sentinel_window < 4:
            raise ValueError(
                f"logging.sentinel_window must be >= 4, got "
                f"{self.sentinel_window}")
        if self.sentinel_ratio <= 1.0:
            raise ValueError(
                f"logging.sentinel_ratio must be > 1.0, got "
                f"{self.sentinel_ratio}")
        if self.sentinel_zscore <= 0.0:
            raise ValueError(
                f"logging.sentinel_zscore must be > 0, got "
                f"{self.sentinel_zscore}")
        if self.sentinel_patience < 1:
            raise ValueError(
                f"logging.sentinel_patience must be >= 1, got "
                f"{self.sentinel_patience}")


@dataclass(frozen=True)
class PipelineConfig:
    """Pipeline executor selection (picotron_tpu/parallel/mpmd.py).

    executor='spmd' is the reference twin: the whole pipeline is one jitted
    program over the full mesh and the schedule is a lockstep lax.scan over
    the 1f1b table — every device runs every tick, so an IDLE tick costs a
    full traced unit (PERF.md r4 measured the implied bubble at 7.0 ticks
    for pp=4). executor='mpmd' compiles one program per stage and drives
    them from the host-side schedule table; idle ticks cost ~0 host time
    (arxiv 2412.14374), which is what makes interleaved schedules
    profitable at all (see the PERF.md "Interleaved-PP rejection" note,
    which is scoped to the SPMD executor)."""

    # 'spmd' (lockstep scan twin, the default) or 'mpmd' (per-stage
    # programs + host-side schedule).
    executor: str = "spmd"
    # Schedule grammar: '1f1b' (one-forward-one-backward, depth-first
    # backward priority), 'gpipe' (all forwards then all backwards — the
    # AFAB dependency shape, useful as a debugging twin), 'interleaved'
    # (virtual stages: each device group owns `interleave` non-contiguous
    # layer chunks, shrinking the bubble to (pp-1)/v units). mpmd only for
    # anything but '1f1b'.
    schedule: str = "1f1b"
    # Virtual pipeline chunks per device group (v). 1 = plain schedules;
    # >= 2 requires schedule='interleaved' and executor='mpmd'.
    interleave: int = 1

    def validate(self) -> None:
        if self.executor not in ("spmd", "mpmd"):
            raise ValueError(
                f"pipeline.executor must be 'spmd' or 'mpmd', got "
                f"{self.executor!r}")
        if self.schedule not in ("1f1b", "gpipe", "interleaved"):
            raise ValueError(
                f"pipeline.schedule must be '1f1b', 'gpipe', or "
                f"'interleaved', got {self.schedule!r}")
        if self.interleave < 1:
            raise ValueError(
                f"pipeline.interleave must be >= 1, got {self.interleave}")


@dataclass(frozen=True)
class Config:
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    # -- derived quantities (ref: data.py:17-20) --

    @property
    def global_batch_size(self) -> int:
        t = self.training
        return (t.micro_batch_size * t.gradient_accumulation_steps
                * self.distributed.dp_size * self.distributed.ep_size)

    @property
    def tokens_per_step(self) -> int:
        return self.global_batch_size * self.training.seq_length

    @property
    def seq_length_per_device(self) -> int:
        return self.training.seq_length // self.distributed.cp_size

    def validate(self) -> None:
        self.distributed.validate()
        self.model.validate()
        self.logging.validate()
        self.resilience.validate()
        self.serve.validate()
        self.pipeline.validate()
        if self.serve.max_model_len > self.model.max_position_embeddings:
            raise ValueError(
                f"serve.max_model_len ({self.serve.max_model_len}) exceeds "
                f"max_position_embeddings "
                f"({self.model.max_position_embeddings})")
        if self.model.num_experts and (self.serve.disagg
                                       or self.serve.speculator != "off"):
            # The serving engines chunk every prefill, and MoE routing is
            # capacity-bounded PER CALL: the same prompt split into chunks
            # routes (and drops) tokens differently than one batched pass,
            # so chunked prefill is not parity-guaranteed for MoE (the
            # PR-7 KNOWN issue, now a hard error instead of a footnote).
            # The engines themselves reject MoE at construction; this
            # catches the intent at config load.
            raise ValueError(
                "serve.disagg / serve.speculator do not support MoE "
                "models (model.num_experts > 0): chunked prefill routes "
                "tokens through per-call capacity-bounded expert dispatch, "
                "which is not parity-guaranteed against the offline "
                "sampler; serve dense models only")
        if self.serve.fleet_size > 1 and self.model.num_experts:
            # Same root cause as the disagg guard above: every fleet
            # replica chunk-prefills, and failover re-dispatch replays a
            # request's prefix through a DIFFERENT chunking on the
            # survivor — for MoE that changes routing, so the
            # bit-identical-failover contract cannot hold.
            raise ValueError(
                "serve.fleet_size > 1 does not support MoE models "
                "(model.num_experts > 0): failover re-dispatch replays "
                "prefixes through per-call capacity-bounded expert "
                "dispatch, which is not parity-guaranteed; serve dense "
                "models only")
        if self.serve.fleet_size > 1 and self.serve.speculator != "off":
            # The n-gram drafter's context is engine-local state that a
            # failover re-dispatch does not carry — tokens stay identical
            # (verify-and-accept guarantees that) but the fleet's
            # redispatch-latency and acceptance accounting would be
            # engine-dependent; keep the combination a hard error until
            # it is pinned.
            raise ValueError(
                "serve.fleet_size > 1 does not support speculative decode "
                "(serve.speculator != 'off'): the drafter's context is "
                "engine-local and is not carried across failover "
                "re-dispatch; set serve.speculator='off' or "
                "serve.fleet_size=1")
        d, m, t = self.distributed, self.model, self.training
        ck = self.checkpoint
        if ck.keep_last < 0 or ck.keep_every < 0:
            raise ValueError(
                f"checkpoint.keep_last/keep_every must be >= 0 (0 "
                f"disables), got keep_last={ck.keep_last} "
                f"keep_every={ck.keep_every}")
        if self.resilience.guard_policy == "skip" and t.optimizer_offload:
            # The in-jit skip selects the pre-update params/opt state,
            # but the offload update streams the host master in place —
            # there is no pre-update tree left to select.
            raise ValueError(
                "resilience.guard_policy='skip' is not supported with "
                "training.optimizer_offload (the streamed host-master "
                "update cannot be un-applied in-step); use 'rollback' "
                "or 'abort'")
        if m.num_attention_heads % d.tp_size != 0:
            raise ValueError("num_attention_heads must be divisible by tp_size")
        if m.num_key_value_heads % d.tp_size != 0:
            raise ValueError("num_key_value_heads must be divisible by tp_size")
        if m.vocab_size % d.tp_size != 0:
            raise ValueError("vocab_size must be divisible by tp_size")
        if d.tp_strategy != "megatron":
            # Non-default strategies rewire the block matmuls through the
            # strategy hooks (parallel/tp_strategies.py); the hook set is
            # dense-model, single-stage, tp-only for now. "adaptive" may
            # resolve to megatron, but its eligibility is the strict set
            # (resolution depends on the ICI generation; gating on the
            # resolved spec would make validity generation-dependent).
            for bad, why in (
                (d.pp_size > 1, "pp_size > 1 (the strategy hooks assume a "
                 "single-stage residual stream)"),
                (d.cp_size > 1, "cp_size > 1 (non-megatron head layouts "
                 "change the tp-local head counts the cp schedules "
                 "divide)"),
                (d.ep_size > 1 or m.num_experts > 0, "MoE models (the "
                 "expert bank keeps the megatron f/g pattern)"),
                (d.sequence_parallel, "sequence_parallel (SP rebinds the "
                 "f/g hooks the strategies replace; use tp_sync='deferred' "
                 "for the seq-sharded residual instead)"),
                (m.attention_bias, "attention_bias (row/2d qkv would need "
                 "a post-collective bias add)"),
            ):
                if bad:
                    raise ValueError(
                        f"tp_strategy={d.tp_strategy!r} does not support "
                        f"{why}")
        if d.tp_sync == "deferred":
            if d.tp_strategy != "megatron":
                raise ValueError(
                    "tp_sync='deferred' composes only with "
                    "tp_strategy='megatron' (the deferred reduce-scatter/"
                    "gather pair reschedules the megatron exit psum; 2d/"
                    "row exits are subgroup collectives with their own "
                    "schedule)")
            if d.pp_size > 1:
                raise ValueError(
                    "tp_sync='deferred' requires pp_size=1 (the seq-sharded "
                    "residual would change the pipeline boundary buffers)")
            if m.num_experts > 0:
                raise ValueError(
                    "tp_sync='deferred' does not support MoE models yet "
                    "(the expert dispatch assumes the sync f/g schedule)")
            if t.seq_length % (d.cp_size * d.tp_size) != 0:
                raise ValueError(
                    "tp_sync='deferred' shards the cp-local sequence over "
                    "tp: seq_length must be divisible by cp_size * tp_size "
                    f"(= {d.cp_size * d.tp_size}), got {t.seq_length}")
        if d.tp_mesh and "2d" not in (parse_tp_strategy(d.tp_strategy)
                                      or {}).values() \
                and d.tp_strategy != "adaptive":
            raise ValueError(
                f"tp_mesh={d.tp_mesh!r} only applies when tp_strategy "
                f"uses the 2d partitioning (got tp_strategy="
                f"{d.tp_strategy!r})")
        if (d.cp_flavor and m.attn_impl in ("ring", "ulysses", "mesh")
                and m.attn_impl != d.cp_flavor):
            raise ValueError(
                f"distributed.cp_flavor={d.cp_flavor!r} contradicts "
                f"model.attn_impl={m.attn_impl!r} — set one of them (or "
                "attn_impl='auto' and let cp_flavor pick the schedule)")
        flavor = resolved_cp_flavor(self)
        if flavor == "ulysses":
            if (m.num_attention_heads // d.tp_size) % d.cp_size != 0 or (
                    m.num_key_value_heads // d.tp_size) % d.cp_size != 0:
                raise ValueError(
                    "the ulysses cp flavor scatters the tp-local heads over "
                    "cp: num_attention_heads/tp and num_key_value_heads/tp "
                    f"must be divisible by cp_size ({d.cp_size}); use the "
                    "ring or mesh flavor for head counts that do not divide")
        if d.cp_mesh and flavor != "mesh":
            raise ValueError(
                f"cp_mesh={d.cp_mesh!r} only applies to the mesh cp flavor "
                f"(resolved flavor here: {flavor or 'none — cp_size is 1'}); "
                "set cp_flavor='mesh' or attn_impl='mesh'")
        if flavor == "mesh":
            cp_x, cp_y = resolved_cp_mesh(self)
            if cp_y > 1 and (
                    (m.num_attention_heads // d.tp_size) % cp_y != 0
                    or (m.num_key_value_heads // d.tp_size) % cp_y != 0):
                raise ValueError(
                    f"mesh cp flavor with cp_mesh {cp_x}x{cp_y} scatters "
                    f"the tp-local heads over the inner factor: "
                    "num_attention_heads/tp and num_key_value_heads/tp "
                    f"must be divisible by cp_y ({cp_y}); pick a smaller "
                    "cp_y (cp_y=1 degenerates to the ring schedule)")
        if d.ep_size > 1 and m.num_experts == 0:
            raise ValueError(
                "ep_size > 1 requires a mixture-of-experts model "
                "(model.num_experts > 0)")
        if m.num_experts:
            if m.num_experts % d.ep_size != 0:
                raise ValueError(
                    f"num_experts ({m.num_experts}) must be divisible by "
                    f"ep_size ({d.ep_size})")
            if not 1 <= m.num_experts_per_token <= m.num_experts:
                raise ValueError(
                    f"num_experts_per_token must be in [1, num_experts], "
                    f"got {m.num_experts_per_token} of {m.num_experts}")
            if m.expert_ffn_size % d.tp_size != 0:
                raise ValueError(
                    "expert ffn size must be divisible by tp_size")
        if t.remat_policy not in ("full", "dots", "dots_attn", "dots_lean",
                                  "dots_norms", "dots_offload"):
            raise ValueError(
                f"remat_policy must be 'full', 'dots', 'dots_attn', "
                f"'dots_lean', 'dots_norms', or 'dots_offload', got "
                f"{t.remat_policy!r}")
        if t.adam_moments_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"adam_moments_dtype must be 'float32' or 'bfloat16', got "
                f"{t.adam_moments_dtype!r}")
        if t.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError(
                f"lr_schedule must be constant/cosine/linear, got "
                f"{t.lr_schedule!r}")
        if t.lr_warmup_steps < 0 or t.lr_warmup_steps > t.total_train_steps:
            raise ValueError(
                f"lr_warmup_steps must be in [0, total_train_steps], got "
                f"{t.lr_warmup_steps}")
        if not 0.0 <= t.lr_min_ratio <= 1.0:
            # a negative ratio would drive the decayed LR below zero and
            # silently ascend the loss late in training
            raise ValueError(
                f"lr_min_ratio must be in [0, 1], got {t.lr_min_ratio}")
        if t.ce_chunk_size < 0:
            raise ValueError(
                f"ce_chunk_size must be >= 0, got {t.ce_chunk_size}")
        if t.ce_chunk_size > 0:
            vshard = m.vocab_size // d.tp_size
            if t.ce_chunk_size >= vshard:
                # a chunk spanning the whole per-shard vocab IS the fused
                # path — the implementation would silently take it, and the
                # user set the knob precisely to avoid that memory (ADVICE
                # r3: the old check let any value >= vshard through)
                raise ValueError(
                    f"ce_chunk_size ({t.ce_chunk_size}) must be smaller "
                    f"than the per-tp-shard vocab (vocab_size/tp_size = "
                    f"{vshard}); at or above it chunking degenerates to "
                    f"the fused CE path")
            if vshard % t.ce_chunk_size != 0:
                # a non-dividing chunk would silently fall back to the
                # fused path — the user set the knob to AVOID that memory
                raise ValueError(
                    f"ce_chunk_size ({t.ce_chunk_size}) must divide the "
                    f"per-tp-shard vocab (vocab_size/tp_size = {vshard})")
        if t.grad_engine not in ("auto", "ad", "fused"):
            raise ValueError(
                f"grad_engine must be auto/ad/fused, got {t.grad_engine!r}")
        if t.grad_engine == "fused":
            # the fused engine's eligibility rule (picotron_tpu/parallel/
            # fused_bwd.py fused_bwd_supported): one pipeline stage, remat
            # with the dots_attn save set
            if not (d.pp_size == 1 and t.remat
                    and t.remat_policy == "dots_attn"):
                raise ValueError(
                    "grad_engine='fused' requires a single pipeline stage "
                    "(pp_size=1) and remat with remat_policy='dots_attn' "
                    "— the save set the manual backward is derived from. "
                    "dp/tp/sequence_parallel/cp (ring and ulysses)/ep/MoE "
                    "all compose (see the README grad-engine eligibility "
                    "matrix); use 'auto' to fall back to the AD engine "
                    "automatically")
        if t.optimizer_offload:
            # zero1 COMPOSES with offload (r5): the host master/moments
            # shard over the fused data axes, each process streams 1/dp
            # of the state, and the update all-gathers the refreshed
            # bf16 params — dp x less host RAM and PCIe per process.
            if self.model.dtype != "bfloat16":
                raise ValueError(
                    "optimizer_offload requires model.dtype='bfloat16' "
                    "(the device-resident compute copy is the model's "
                    "compute dtype; an fp32 compute copy would duplicate "
                    "the master and save nothing)")
            if d.pp_size > 1 and d.pp_engine == "afab":
                # afab differentiates through the pipeline scan, so param
                # cotangents accumulate in the param dtype — bf16 under
                # offload, losing exactly the low bits the fp32 master
                # keeps. The 1f1b manual-VJP path accumulates its grads in
                # fp32 explicitly (pp.py g_zero) and is the supported
                # offload x pp combination (ADVICE r4).
                raise ValueError(
                    "optimizer_offload with pp_engine='afab' would "
                    "accumulate microbatch gradients in bf16 (the AD "
                    "path's cotangent dtype is the bf16 param dtype); "
                    "use pp_engine='1f1b' (the default), whose manual "
                    "VJP accumulates gradients in fp32")
        lg = self.logging
        if lg.profile_dir is not None:
            if lg.profile_start_step < 1:
                raise ValueError(
                    f"profile_start_step must be >= 1 (steps are 1-based), "
                    f"got {lg.profile_start_step}")
            if lg.profile_num_steps < 1:
                raise ValueError(
                    f"profile_num_steps must be >= 1, got "
                    f"{lg.profile_num_steps}")
        if t.seq_length < 1:
            raise ValueError(f"seq_length must be >= 1, got {t.seq_length}")
        if t.seq_length % d.cp_size != 0:
            raise ValueError("seq_length must be divisible by cp_size")
        if (d.sequence_parallel
                and t.seq_length % (d.cp_size * d.tp_size) != 0):
            raise ValueError(
                "sequence_parallel shards the cp-local sequence over tp: "
                "seq_length must be divisible by cp_size * tp_size "
                f"(= {d.cp_size * d.tp_size}), got {t.seq_length}")
        if (d.cp_size > 1 and d.cp_layout == "zigzag"
                and t.seq_length % (2 * d.cp_size) != 0):
            raise ValueError(
                f"zigzag cp_layout needs seq_length divisible by 2*cp_size "
                f"({2 * d.cp_size}); got {t.seq_length}. Use "
                f"cp_layout='contiguous' or adjust seq_length."
            )
        if t.seq_length > m.max_position_embeddings:
            # Same bound the reference applies by construction (ref:
            # train.py:159 sets seq_length == max_position_embeddings).
            raise ValueError(
                f"seq_length ({t.seq_length}) exceeds max_position_embeddings "
                f"({m.max_position_embeddings})"
            )
        if d.pp_size > m.num_hidden_layers:
            raise ValueError(
                f"pp_size ({d.pp_size}) cannot exceed num_hidden_layers ({m.num_hidden_layers})"
            )
        # num_hidden_layers % pp_size may be nonzero: the stacked layer axis
        # is padded with identity (all-zero) layers and the remainder goes to
        # early stages (ref: pipeline_parallel.py:42-51 distribute_layers);
        # see models.llama.pp_layer_placement.
        if t.eval_frequency < 0 or (t.eval_frequency > 0 and t.eval_steps < 1):
            raise ValueError(
                "eval_frequency must be >= 0 and eval_steps >= 1 when "
                f"eval is enabled, got {t.eval_frequency}/{t.eval_steps}")
        if t.gradient_accumulation_steps < 1:
            raise ValueError(
                f"gradient_accumulation_steps must be >= 1, got "
                f"{t.gradient_accumulation_steps}"
            )
        pl = self.pipeline
        if pl.executor == "spmd":
            if pl.schedule != "1f1b" or pl.interleave != 1:
                raise ValueError(
                    "the spmd executor only runs the lockstep 1f1b scan "
                    "(schedule='1f1b', interleave=1); alternative schedules "
                    "require pipeline.executor='mpmd', where an idle tick "
                    f"stops costing a full traced unit — got "
                    f"schedule={pl.schedule!r} interleave={pl.interleave}")
        else:  # mpmd
            if d.pp_size < 2:
                raise ValueError(
                    "pipeline.executor='mpmd' requires pp_size >= 2 (with "
                    "one stage there is nothing to schedule; the single "
                    "jitted program IS the spmd executor)")
            if t.optimizer_offload:
                raise ValueError(
                    "pipeline.executor='mpmd' does not compose with "
                    "training.optimizer_offload yet (the streamed host "
                    "update assumes the monolithic step program); use the "
                    "spmd executor for offload runs")
            if m.num_experts:
                raise ValueError(
                    "pipeline.executor='mpmd' does not support MoE models "
                    "yet (per-stage submeshes drop the 'ep' axis from the "
                    "stage programs); use the spmd executor")
            if d.sequence_parallel:
                raise ValueError(
                    "pipeline.executor='mpmd' does not support "
                    "sequence_parallel yet (the sp grad sync runs over the "
                    "whole-mesh program); use the spmd executor")
            if d.pp_engine != "1f1b":
                raise ValueError(
                    "pipeline.executor='mpmd' drives the host schedule "
                    "table; set pp_engine='1f1b' (the afab engine is an "
                    "spmd-only differentiation strategy)")
        if pl.schedule == "interleaved":
            if pl.interleave < 2:
                raise ValueError(
                    "pipeline.schedule='interleaved' needs interleave >= 2 "
                    "(v=1 interleaving IS plain 1f1b); got "
                    f"{pl.interleave}")
            slots = -(-m.num_hidden_layers // d.pp_size)  # ceil
            if slots % pl.interleave != 0:
                raise ValueError(
                    f"pipeline.interleave ({pl.interleave}) must divide the "
                    f"per-stage layer slot count (ceil(num_hidden_layers / "
                    f"pp_size) = {slots}) so every virtual chunk is the "
                    f"same shape and compiles once")
        elif pl.interleave != 1:
            raise ValueError(
                f"pipeline.interleave > 1 requires "
                f"pipeline.schedule='interleaved', got "
                f"schedule={pl.schedule!r} interleave={pl.interleave}")

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


def resolved_cp_flavor(cfg: "Config") -> str:
    """The context-parallel attention schedule this config runs:
    'ring' | 'ulysses' | 'mesh' when cp_size > 1, '' otherwise. The single
    dispatch key for parallel/api.py, parallel/fused_bwd.py, the
    collective-schedule audit and the cost model — distributed.cp_flavor
    wins, model.attn_impl names a flavor directly for back-compat, and the
    default is the ring (no head-divisibility constraint)."""
    d, m = cfg.distributed, cfg.model
    if d.cp_size <= 1:
        return ""
    if d.cp_flavor:
        return d.cp_flavor
    if m.attn_impl in ("ring", "ulysses", "mesh"):
        return m.attn_impl
    return "ring"


def resolved_cp_mesh(cfg: "Config") -> tuple[int, int]:
    """(cp_x, cp_y) for the mesh cp flavor. An explicit distributed.cp_mesh
    wins; otherwise the most-square FEASIBLE factorization (cp_y must
    divide the tp-local q and kv head counts), tie-broken toward the
    larger cp_y — one all_to_all over more (contiguous, innermost-ICI)
    devices is cheaper than an extra serial ring hop. The planner
    enumerates every feasible factorization against the topology-aware
    cost model instead of trusting this default."""
    d, m = cfg.distributed, cfg.model
    cp = d.cp_size
    if d.cp_mesh:
        return parse_cp_mesh(d.cp_mesh)
    hq = m.num_attention_heads // d.tp_size
    hkv = m.num_key_value_heads // d.tp_size
    feasible = [y for y in range(1, cp + 1)
                if cp % y == 0 and hq % y == 0 and hkv % y == 0]
    cp_y = min(feasible, key=lambda y: (abs(y - cp ** 0.5), -y))
    return cp // cp_y, cp_y


def resolved_tp_strategy(cfg: "Config", generation: str = "v5e"):
    """The concrete per-layer-class TP partitioning this config runs:
    a dict {qkv,o,up,down,head} -> {col,row,2d}. The single dispatch key
    for parallel/tp_strategies.py, parallel/sharding.py, the collective
    audit and the cost model. tp_size==1 always resolves to megatron (the
    hooks compile away); "adaptive" resolves deterministically via the
    cost-model per-class argmin against `generation`'s ICI descriptor
    (choose_tp_strategy — pure analytic, no devices touched)."""
    d = cfg.distributed
    if d.tp_size <= 1:
        return dict(_TP_STRATEGY_PRESETS["megatron"])
    spec = parse_tp_strategy(d.tp_strategy)
    if spec is not None:
        return spec
    raise NotImplementedError(
        "tp_strategy='adaptive' resolves through the cost model "
        "(analysis/cost_model.py), which the PyTorch port has not ported "
        "yet (ROADMAP Queue 1 item 13); name an explicit strategy")


def resolved_tp_mesh(cfg: "Config") -> tuple[int, int]:
    """(tp_x, tp_y) for the 2d TP partitioning. An explicit
    distributed.tp_mesh wins; otherwise the most-square feasible
    factorization (tp_x must divide the q and kv head counts — always true
    when tp does — and both factors must divide tp), tie-broken toward the
    SMALLER tp_y: tp_y is the replication factor of the row-side matmuls
    and the attention, so among equally-square options less replicated
    compute wins."""
    d, m = cfg.distributed, cfg.model
    tp = d.tp_size
    if d.tp_mesh:
        return parse_tp_mesh(d.tp_mesh)
    feasible = [y for y in range(1, tp + 1)
                if tp % y == 0
                and m.num_attention_heads % (tp // y) == 0
                and m.num_key_value_heads % (tp // y) == 0]
    tp_y = min(feasible, key=lambda y: (abs(y - tp ** 0.5), y))
    return tp // tp_y, tp_y


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _filter_kwargs(cls: type, raw: dict[str, Any]) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def config_from_dict(raw: dict[str, Any]) -> Config:
    """Build a Config from a (reference-schema-compatible) dict."""
    model_raw = dict(raw.get("model", {}))
    name = model_raw.get("name")
    if name:
        try:
            preset = resolve_preset(name)
        except KeyError:
            # Unknown name is only acceptable when the JSON itself carries the
            # architecture — otherwise a typo'd name would silently train the
            # tiny debug defaults.
            core = {"vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers"}
            if not core.issubset(model_raw):
                raise
            preset = {}
        # Explicit values in the JSON override the preset (ref:
        # create_config.py:56-63 same precedence for layer/head overrides).
        merged = {**preset, **{k: v for k, v in model_raw.items() if v is not None}}
    else:
        # No name: a partially-specified architecture would silently merge
        # with the tiny debug defaults — require the core fields, or nothing.
        core = {"vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers"}
        arch_keys = {k for k, v in model_raw.items() if v is not None} - {
            "dtype", "attn_impl", "use_flash_attention", "use_fused_adam"
        }
        if arch_keys and not core.issubset(arch_keys):
            raise ValueError(
                "model section specifies architecture fields without a `name`; "
                f"either set `name` to a preset or provide all of {sorted(core)}"
            )
        merged = model_raw
    # The reference allows `num_hidden_layers: null` meaning "use preset".
    merged = {k: v for k, v in merged.items() if v is not None}

    cfg = Config(
        distributed=DistributedConfig(**_filter_kwargs(DistributedConfig, raw.get("distributed", {}))),
        model=ModelConfig(**_filter_kwargs(ModelConfig, merged)),
        training=TrainingConfig(**_filter_kwargs(TrainingConfig, raw.get("training", {}))),
        dataset=DatasetConfig(**_filter_kwargs(DatasetConfig, raw.get("dataset", {}))),
        checkpoint=CheckpointConfig(**_filter_kwargs(CheckpointConfig, raw.get("checkpoint", {}))),
        logging=LoggingConfig(**_filter_kwargs(LoggingConfig, raw.get("logging", {}))),
        resilience=ResilienceConfig(**_filter_kwargs(ResilienceConfig, raw.get("resilience", {}))),
        serve=ServeConfig(**_filter_kwargs(ServeConfig, raw.get("serve", {}))),
        pipeline=PipelineConfig(**_filter_kwargs(PipelineConfig, raw.get("pipeline", {}))),
    )
    cfg.validate()
    return cfg


def load_config(path: str) -> Config:
    """Load a config JSON (reference schema compatible, ref: train.py:62)."""
    with open(path) as f:
        raw = json.load(f)
    return config_from_dict(raw)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cfg.to_json_dict(), f, indent=2)


def num_params(m: ModelConfig, active_only: bool = False,
               include_tied_head: bool = False) -> int:
    """Total parameter count (embedding + untied head counted separately,
    matching the reference's accounting in utils.py:50-79). For MoE,
    `active_only` counts the top-k experts a token actually visits — the N
    that belongs in the 6N FLOPs/token formula. `include_tied_head` counts
    the h*v head term even when tie_word_embeddings shares it with the
    embedding: the head MATMUL executes either way, so the FLOPs accounting
    (utils.flops_per_token) must include it or tied models would
    understate MFU by the head's share."""
    h, i, v, l = m.hidden_size, m.intermediate_size, m.vocab_size, m.num_hidden_layers
    kv = m.num_key_value_heads * m.head_dim
    if m.num_experts:
        e_ffn = 3 * h * m.expert_ffn_size  # gate/up/down per expert
        n_ffn_experts = (m.num_experts_per_token if active_only
                         else m.num_experts)
        ffn = h * m.num_experts + n_ffn_experts * e_ffn  # router + experts
    else:
        ffn = 3 * h * i  # gate/up/down
    per_layer = (
        h * h  # q_proj
        + h * kv * 2  # k/v_proj
        + h * h  # out_proj
        + ffn
        + 2 * h  # two RMSNorm weights
    )
    if m.attention_bias:
        per_layer += h + 2 * kv  # q/k/v biases
    head = (h * v if (not m.tie_word_embeddings or include_tied_head)
            else 0)
    return v * h + l * per_layer + h + head  # embed + layers + final_norm (+ head)
