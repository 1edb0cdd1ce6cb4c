"""Experiment config generator (the port's copy of tools/create_config.py):

    python -m picotron_tpu_torch.tools.create_config --exp-name smol-dp4tp2 \
        --out-dir runs --model SmolLM-1.7B --dp 4 --tp 2 --pp 2 \
        --seq-len 2048 --mbs 4 --grad-acc 8

Writes `<out_dir>/<exp_name>/config.json` in the reference-compatible
JSON schema from the same flags as the JAX tool, the same JSON byte for
byte, validated by the port's `config.config_from_dict`, and prints the
global-batch math. Model hyperparameters come from the preset registry
or, with --from-hf-config, from a local HF config.json: nothing is
fetched. `--download-model` is refused (the port downloads nothing: fetch
the weights with the JAX package's tools/download_model.py and pass
their directory as checkpoint.init_from_hf). The checkpoint save_dir is
pinned inside the run directory, where `tools.extract_metrics` finds the
run's telemetry.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from picotron_tpu_torch.config import config_from_dict, resolve_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="picotron-tpu config generator")
    p.add_argument("--exp-name", required=True)
    p.add_argument("--out-dir", default="runs")
    # parallel layout (ref: create_config.py --tp/--cp/--dp/--pp)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--cp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1,
                   help="expert parallelism (MoE models only)")
    p.add_argument("--pp-engine", default="1f1b", choices=["1f1b", "afab"])
    p.add_argument("--cp-flavor", default=None,
                   choices=["ring", "ulysses", "mesh"],
                   help="context-parallel attention schedule for cp > 1 "
                        "(default: ring, or whatever --attn-impl names); "
                        "'mesh' factors cp into a 2D submesh — see "
                        "--cp-mesh")
    p.add_argument("--cp-mesh", default=None, metavar="XxY",
                   help="mesh-flavor factorization cp = cp_x * cp_y, e.g. "
                        "'2x4' (default: most-square feasible split; "
                        "cp_y must divide the tp-local head counts)")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="Megatron-SP over the tp axis (seq-sharded "
                        "residual stream between blocks)")
    p.add_argument("--tp-strategy", default=None,
                   choices=["megatron", "row", "2d", "adaptive"],
                   help="per-layer TP partitioning (default: megatron "
                        "column-first; 'adaptive' asks the cost model per "
                        "layer class; per-class specs like "
                        "'qkv=2d,up=col' go straight in config.json)")
    p.add_argument("--tp-mesh", default=None, metavar="XxY",
                   help="2D-strategy factorization tp = tp_x * tp_y, e.g. "
                        "'2x2' (default: most-square feasible split; tp_x "
                        "must divide the head counts)")
    p.add_argument("--tp-sync", default=None,
                   choices=["sync", "deferred"],
                   help="TP activation sync schedule: 'deferred' replaces "
                        "the row-parallel exit all_reduce with a "
                        "reduce_scatter whose gather half is hoisted into "
                        "the next block (megatron strategy, pp=1, dense)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard Adam moments over dp")
    p.add_argument("--slices", type=int, default=None,
                   help="multislice topology: the pod spans N TPU slices "
                        "joined by DCN; train.py's slicecheck preflight "
                        "then audits every collective against the cut "
                        "(analysis/boundary.py)")
    p.add_argument("--dcn-axes", default=None, metavar="AXES",
                   help="comma-separated mesh axes allowed to cross the "
                        "DCN boundary with --slices > 1 (subset of "
                        "dp,pp; default dp,pp — pick with "
                        "tools/layout_planner.py --slices)")
    # model
    p.add_argument("--model", default="HuggingFaceTB/SmolLM-1.7B")
    p.add_argument("--from-hf-config", default=None, metavar="CONFIG_JSON",
                   help="resolve model hyperparameters from a local HF "
                        "config.json instead of the preset registry — the "
                        "offline AutoConfig: any Llama/Qwen2/Mixtral-"
                        "family model trains without hand-typing its "
                        "architecture (--model then only names the run)")
    p.add_argument("--num-hidden-layers", type=int, default=None,
                   help="override the preset's layer count "
                        "(ref: create_config.py:56-59)")
    p.add_argument("--num-attention-heads", type=int, default=None)
    p.add_argument("--num-key-value-heads", type=int, default=None)
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "flash", "reference", "ring",
                            "ulysses", "mesh"])
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    # training (ref: create_config.py --mbs/--grad-acc/--seq-len)
    p.add_argument("--mbs", type=int, default=1)
    p.add_argument("--grad-acc", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "linear"])
    p.add_argument("--lr-warmup-steps", type=int, default=0)
    p.add_argument("--total-train-steps", type=int, default=200)
    p.add_argument("--eval-frequency", type=int, default=0,
                   help="run a val-loss pass every N steps (0 = off); HF "
                        "datasets need --eval-split")
    p.add_argument("--eval-steps", type=int, default=8)
    p.add_argument("--eval-split", default=None)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--remat-policy", default="dots",
                   choices=["full", "dots", "dots_attn", "dots_lean", "dots_norms",
                            "dots_offload"])
    p.add_argument("--adam-moments-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bf16 halves optimizer-state memory (update math "
                        "stays fp32) — usually required to fit >1B models "
                        "per 16G chip; check with tools/memcheck.py")
    p.add_argument("--optimizer-offload", action="store_true",
                   help="fp32 master + Adam moments in pinned HOST memory "
                        "(the full-depth-on-one-chip lever; pair with "
                        "--grad-acc >= 16 to amortize the PCIe round "
                        "trip; requires bf16 model dtype)")
    p.add_argument("--grad-engine", default="auto",
                   choices=["auto", "ad", "fused"],
                   help="'fused' accumulates per-layer dW in-scan (no "
                        "per-microbatch grad tree; any pp=1 layout incl. "
                        "tp/SP/cp ring|ulysses/MoE/ep, with "
                        "remat_policy=dots_attn — see the README "
                        "eligibility matrix); 'auto' picks it whenever "
                        "supported")
    # dataset
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--subset", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--tokenizer", default=None)
    # serving (serve/: continuous batching + paged KV cache)
    p.add_argument("--serve-slots", type=int, default=None,
                   help="serving decode batch width (writes the `serve` "
                        "config block; serve/)")
    p.add_argument("--serve-block-size", type=int, default=None,
                   help="tokens per paged-KV-cache block")
    p.add_argument("--serve-num-blocks", type=int, default=None,
                   help="physical blocks in the shared KV pool (0 = "
                        "worst-case auto; set lower to oversubscribe — "
                        "the scheduler preempts youngest-first)")
    p.add_argument("--serve-prefill-chunk", type=int, default=None,
                   help="prompt tokens prefilled per engine iteration")
    p.add_argument("--serve-max-len", type=int, default=None,
                   help="per-sequence serving capacity (0 = the model's "
                        "max_position_embeddings)")
    p.add_argument("--serve-decode-interval", type=int, default=None,
                   help="decode steps scanned per dispatch (amortizes "
                        "host overhead; retirement latency quantizes "
                        "to it)")
    p.add_argument("--serve-disagg", action="store_true",
                   help="disaggregated serving: prefill and decode as "
                        "separately placed pools with paged-KV block "
                        "handoff (picotron_tpu_torch/serve/disagg)")
    p.add_argument("--serve-prefill-slots", type=int, default=None,
                   help="prefill-pool slot count (0 = decode_slots)")
    p.add_argument("--serve-prefill-num-blocks", type=int, default=None,
                   help="prefill-pool KV blocks (0 = worst-case auto)")
    p.add_argument("--serve-prefill-device", type=int, default=None,
                   help="device index for the prefill pool (-1 = auto: "
                        "device 1 when available)")
    p.add_argument("--serve-decode-device", type=int, default=None,
                   help="device index for the decode pool (-1 = auto: "
                        "device 0)")
    p.add_argument("--serve-speculator", default=None,
                   choices=["off", "ngram"],
                   help="speculative decode drafter ('ngram' = "
                        "self-drafting n-gram; token-identical to "
                        "non-speculative decode)")
    p.add_argument("--serve-draft-len", type=int, default=None,
                   help="draft tokens proposed per decode step when the "
                        "speculator is on")
    # checkpoint / logging
    p.add_argument("--save-frequency", type=int, default=0)
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the newest durable checkpoint in the "
                        "save dir when the job (re)starts — pairs with "
                        "submit_jobs' failure resubmission so preempted "
                        "jobs continue instead of restarting")
    p.add_argument("--download-model", action="store_true",
                   help="snapshot the model's HF safetensors (tools/"
                        "download_model.py; ref: create_config.py:134) and "
                        "set checkpoint.init_from_hf so training starts "
                        "from the pretrained weights")
    p.add_argument("--use-wandb", action="store_true")
    p.add_argument("--use-cpu", action="store_true",
                   help="run the layout on simulated host devices (the "
                        "reference's --use_cpu, ref: create_config.py:64-66)")
    return p


def create_single_config(args) -> str:
    model_overrides = {
        k: v for k, v in dict(
            num_hidden_layers=args.num_hidden_layers,
            num_attention_heads=args.num_attention_heads,
            num_key_value_heads=args.num_key_value_heads,
        ).items() if v is not None
    }
    if getattr(args, "from_hf_config", None):
        # offline long-tail resolution: any Llama-family model outside the
        # preset registry, from its local HF config.json (the reference
        # fetches this over the network via AutoConfig,
        # ref: create_config.py:51-55; zero-egress pods can't)
        from picotron_tpu_torch.config import model_config_from_hf_json

        preset = model_config_from_hf_json(args.from_hf_config)
    else:
        preset = resolve_preset(args.model)
    seq_len = args.seq_len
    if seq_len > preset["max_position_embeddings"]:
        preset["max_position_embeddings"] = seq_len

    raw = {
        "distributed": {
            "tp_size": args.tp, "cp_size": args.cp, "pp_size": args.pp,
            "dp_size": args.dp, "ep_size": args.ep,
            "pp_engine": args.pp_engine,
            "sequence_parallel": args.sequence_parallel,
            "zero1": args.zero1,
            "use_cpu": args.use_cpu,
            **({"cp_flavor": args.cp_flavor} if args.cp_flavor else {}),
            **({"cp_mesh": args.cp_mesh} if args.cp_mesh else {}),
            **({"tp_strategy": args.tp_strategy} if args.tp_strategy else {}),
            **({"tp_mesh": args.tp_mesh} if args.tp_mesh else {}),
            **({"tp_sync": args.tp_sync} if args.tp_sync else {}),
            **({"slices": args.slices} if args.slices else {}),
            **({"dcn_axes": args.dcn_axes} if args.dcn_axes else {}),
        },
        "model": {
            "name": args.model, **preset, **model_overrides,
            "dtype": args.dtype, "attn_impl": args.attn_impl,
        },
        "training": {
            "seq_length": seq_len,
            "micro_batch_size": args.mbs,
            "gradient_accumulation_steps": args.grad_acc,
            "learning_rate": args.learning_rate,
            "lr_schedule": args.lr_schedule,
            "lr_warmup_steps": args.lr_warmup_steps,
            "total_train_steps": args.total_train_steps,
            "eval_frequency": args.eval_frequency,
            "eval_steps": args.eval_steps,
            "adam_moments_dtype": args.adam_moments_dtype,
            "optimizer_offload": args.optimizer_offload,
            "remat": not args.no_remat,
            "remat_policy": args.remat_policy,
            "grad_engine": args.grad_engine,
        },
        "dataset": {
            "name": args.dataset, "subset_name": args.subset,
            "split": args.split, "eval_split": args.eval_split,
            "tokenizer_name": args.tokenizer,
        },
        # save_dir pinned INSIDE the run directory: the dataclass default
        # ("ckpt") is relative, and submit_jobs launches trainers with
        # cwd=REPO_ROOT — checkpoints and telemetry.jsonl from every run
        # would otherwise pile into one shared repo-root ckpt/ (and
        # extract_metrics could never pair a run with its telemetry).
        "checkpoint": {"save_frequency": args.save_frequency,
                       "auto_resume": args.auto_resume,
                       "save_dir": os.path.abspath(os.path.join(
                           args.out_dir, args.exp_name, "ckpt"))},
        "logging": {"use_wandb": args.use_wandb, "run_name": args.exp_name},
    }
    serve = {k: v for k, v in dict(
        decode_slots=args.serve_slots,
        block_size=args.serve_block_size,
        num_blocks=args.serve_num_blocks,
        prefill_chunk=args.serve_prefill_chunk,
        max_model_len=args.serve_max_len,
        decode_interval=args.serve_decode_interval,
        disagg=args.serve_disagg or None,
        prefill_slots=args.serve_prefill_slots,
        prefill_num_blocks=args.serve_prefill_num_blocks,
        prefill_device=args.serve_prefill_device,
        decode_device=args.serve_decode_device,
        speculator=args.serve_speculator,
        draft_len=args.serve_draft_len,
    ).items() if v is not None}
    if serve:
        raw["serve"] = serve
    if getattr(args, "download_model", False):
        raise SystemExit("--download-model: the port downloads nothing; "
                         "fetch the weights with tools/download_model.py "
                         "and pass their directory as "
                         "checkpoint.init_from_hf")
    cfg = config_from_dict(raw)  # validates

    exp_dir = os.path.join(args.out_dir, args.exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, "config.json")
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)

    # ref: create_config.py:71-73 prints the same math
    print(f"config -> {path}")
    print(f"  mesh: dp={args.dp} pp={args.pp} ep={args.ep} cp={args.cp} tp={args.tp} "
          f"({cfg.distributed.world_size} chips)")
    dataxes = (f"x dp {args.dp} x ep {args.ep}" if args.ep > 1
               else f"x dp {args.dp}")
    print(f"  global_batch_size = mbs {args.mbs} x grad_acc {args.grad_acc} "
          f"{dataxes} = {cfg.global_batch_size} "
          f"({cfg.tokens_per_step} tokens/step)")
    return path


def main(argv=None) -> str:
    return create_single_config(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
