"""The serving benchmark of the port (the JAX package's `bench.py --serve
--fleet` and `--serve --disagg`, ported): one JSON line per run.

    python -m picotron_tpu_torch.tools.serve_bench --fleet 2 \
        --model SmolLM-1.7B --requests 16 --serve-temperature 0.7 \
        --chaos engine_dead@2
    python -m picotron_tpu_torch.tools.serve_bench --disagg \
        --model debug-tiny --prompt-len 24 --max-new-tokens 16

`--fleet N` runs `FleetSupervisor` over N replicas on a synthetic
arrival trace (`make_serve_trace`: mixed prompt lengths and budgets,
Poisson arrivals at `--rate`, all at t = 0 when it is 0), with optional
serve-side chaos and deadline shedding; its row carries per-request sha1
token digests (the failover-parity oracle `tools.chaos` compares across
fleet sizes and fault legs), the shed ids (deterministic on the virtual
trace clock) and the survivor pools' leaked blocks. `--disagg` runs the
colocated and the disaggregated engine on the long-prefill burst trace
(`make_burst_trace`): the headline is the drop in max consecutive
decode-stall ticks, with an SLO curve over arrival rates and the n-gram
speculator's acceptance sweep. Every number but the wall seconds is
structural: the same on any host.

The model is the preset (`--model`, cut to `--layers` when given) with
random weights from a seed in its compute dtype (bf16), on the card unless `--device cpu` is
given (no CUDA: an error, never a fallback). The `--disagg` row's
`predicted_handoff_*` fields are the cost model's worst-case handoff
(`analysis/cost_model.price_kv_handoff` on the h100 tier: the whole
max_model_len prefix's K and V blocks over one NVLink hop).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.analysis.cost_model import CostModel

WALL_NOTE = ("wall seconds are the host's clock around a whole run and "
             "move with the host's load; the stall ticks, handoffs, "
             "acceptance counts, digests and shed ids are structural")


def make_serve_trace(n_requests: int, rate: float, prompt_len: int,
                     max_new: int, vocab: int, seed: int = 0) -> list:
    """Synthetic arrival trace: prompt lengths in [prompt_len / 8,
    prompt_len], budgets in [max_new / 8, max_new], Poisson arrivals at
    `rate` requests/s (rate <= 0: everything arrives at t = 0, the
    saturation trace). Deterministic per seed (numpy), as the JAX
    bench's."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for _ in range(n_requests):
        plen = int(rng.integers(max(prompt_len // 8, 1), prompt_len + 1))
        olen = int(rng.integers(max(max_new // 8, 1), max_new + 1))
        prompt = rng.integers(0, vocab, size=plen).tolist()
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        out.append((prompt, olen, t))
    return out


def make_burst_trace(slots: int, prompt_len: int, prefill_chunk: int,
                     decode_interval: int, max_new: int, vocab: int,
                     seed: int = 0) -> list:
    """Deterministic long-prefill burst (everything arrives at t = 0):
    `slots` SHORT requests (a tiny prompt, a budget that keeps the
    decode side busy through the whole long-prefill grind), then `slots`
    LONG ones (a `prompt_len` prompt, a small budget). A colocated engine
    admits the shorts into every slot and the longs wait until the shorts
    retire, then every slot turns to chunked prefill at once: the decode
    stall streak is ~ceil(prompt_len / prefill_chunk) ticks. A
    disaggregated engine prefills the longs in its prefill pool while the
    shorts decode, so the streak collapses."""
    rng = np.random.default_rng(seed)
    prefill_ticks = -(-prompt_len // prefill_chunk)
    short_len = max(prompt_len // 8, 2)
    # outlast the long prefill by a few dispatches, so that the decode
    # pool is never the reason the longs look stall-free
    short_budget = min(decode_interval * (prefill_ticks + 4), max_new)
    long_budget = max(max_new // 8, decode_interval)
    out = []
    for _ in range(slots):
        prompt = rng.integers(0, vocab, size=short_len).tolist()
        out.append((prompt, short_budget, 0.0))
    for _ in range(slots):
        prompt = rng.integers(0, vocab, size=prompt_len).tolist()
        out.append((prompt, long_budget, 0.0))
    return out


def bench_model(name: str, layers: int, cap: int, device,
                state_dict: Optional[dict] = None, seed: int = 0):
    """The preset's model (cut to `layers` when nonzero, positions to at
    least `cap`) in its compute dtype (bf16 for every preset) on
    `device`: `state_dict`'s tensors, or random weights from `seed` (an
    fp32 init, rounded)."""
    from picotron_tpu_torch.config import ModelConfig, resolve_preset
    from picotron_tpu_torch.generate import load_for_decode
    from picotron_tpu_torch.models.llama import (
        LlamaModel, compute_dtype, init_params,
    )

    preset = resolve_preset(name)
    preset["max_position_embeddings"] = max(
        preset.get("max_position_embeddings", 0), cap)
    if layers:
        preset["num_hidden_layers"] = layers
    mcfg = ModelConfig(name=name, **preset)
    dt = compute_dtype(mcfg)
    if state_dict is None:
        m32 = LlamaModel(dataclasses.replace(mcfg, dtype="float32"),
                         device=device)
        init_params(m32, torch.Generator(device=device).manual_seed(seed))
        state_dict = {n: t.to(dt) for n, t in m32.state_dict().items()}
        del m32
    return load_for_decode({n: t.to(device=device, dtype=dt)
                            for n, t in state_dict.items()}, mcfg, device)


def device_kind(device) -> str:
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def digest(tokens: list) -> str:
    return hashlib.sha1(" ".join(map(str, tokens)).encode()).hexdigest()[:16]


def _ms(v):
    return round(v * 1e3, 2) if v is not None else None


def run_serve_fleet(model: str, layers, *, fleet: int, slots: int,
                    block_size: int, num_blocks: int, prefill_chunk: int,
                    prompt_len: int, max_new: int, n_requests: int,
                    rate: float, decode_interval: int = 4, seed: int = 0,
                    temperature: float = 0.0, deadline_ms: float = 0.0,
                    chaos_spec: Optional[str] = None, tick_s: float = 0.001,
                    telemetry: Optional[str] = None, device: str = "cuda",
                    state_dict: Optional[dict] = None) -> dict:
    """N replicas behind one queue on a synthetic trace, with optional
    serve-side chaos (engine_dead@REQ, decode_hang@REQ~SECS,
    shed_storm@REQ) and deadline shedding; the JAX bench's row."""
    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.resilience import chaos as chaos_mod
    from picotron_tpu_torch.serve import FleetSupervisor
    from picotron_tpu_torch.telemetry import JsonlSink, Telemetry
    from picotron_tpu_torch.utils import cuda_or_cpu

    dev = cuda_or_cpu(device)
    cap = prompt_len + max_new
    m = bench_model(model, layers, cap, dev, state_dict)
    scfg = ServeConfig(decode_slots=slots, block_size=block_size,
                       num_blocks=num_blocks, prefill_chunk=prefill_chunk,
                       max_model_len=cap, decode_interval=decode_interval,
                       fleet_size=fleet, deadline_ms=deadline_ms)
    trace = make_serve_trace(n_requests, rate, prompt_len, max_new,
                             m.cfg.vocab_size, seed)

    tel = None
    if telemetry:
        from picotron_tpu_torch.telemetry.flightdeck import FlightRecorder

        tel = Telemetry(sinks=[JsonlSink(telemetry)])
        tel.flight = FlightRecorder(
            os.path.dirname(os.path.abspath(telemetry)), max_steps=8)
    if chaos_spec:
        chaos_mod.install(chaos_spec)
    try:
        fl = FleetSupervisor(m, scfg, temperature=temperature, seed=seed,
                             telemetry=tel, tick_s=tick_s, device=dev.type)
        del m  # each replica holds its own copy
        t0 = time.perf_counter()
        results = fl.run(trace)
        wall = time.perf_counter() - t0
    finally:
        if chaos_spec:
            chaos_mod.uninstall()  # one spec, one run
    summary = fl.summary
    shed = fl.all_shed
    row = {
        "metric": f"serve_fleet{fleet}_{model.split('/')[-1]}"
                  f"-{fl.engines[0].cfg.num_hidden_layers}L",
        # headline: every admitted request finished, even with an engine
        # killed mid-burst (completed + shed == submitted)
        "value": len(results),
        "unit": "completed_requests",
        "fleet": fleet,
        "requests": n_requests,
        "completed": len(results),
        "shed": len(shed),
        "shed_ids": sorted(r["id"] for r in shed),
        "redispatched": summary["redispatched"],
        "engines_dead": summary["engines_dead"],
        "drains": summary["drains"],
        "leaked_blocks": summary["leaked_blocks"],
        "output_tokens": summary["output_tokens"],
        "wall_s": round(wall, 4),
        "wall_note": WALL_NOTE,
        "arrival_rate": rate,
        "temperature": temperature,
        "deadline_ms": deadline_ms,
        "chaos": chaos_spec or "",
        "tick_s": tick_s,
        "slots": slots,
        "decode_steps": summary["decode_steps"],
        "decode_compiles": summary["decode_compiles"],
        "preemptions": summary["preemptions"],
        "ttft_p50_ms": _ms(summary["ttft_p50_s"]),
        "ttft_p95_ms": _ms(summary["ttft_p95_s"]),
        "queue_wait_p50_ms": _ms(summary["queue_wait_p50_s"]),
        "queue_wait_p95_ms": _ms(summary["queue_wait_p95_s"]),
        "per_engine_requests": [pe["requests"]
                                for pe in summary["per_engine"]],
        # the parity pin: the same trace and seed give the same digest
        # per id whatever the fleet size, the failovers or the shedding
        # of OTHER requests
        "request_digests": {str(r["id"]): digest(r["tokens"])
                            for r in results},
        "device_kind": device_kind(dev),
    }
    fl.close()
    if tel is not None:
        tel.close()
    return row


def run_serve_disagg(model: str, layers, *, slots: int, block_size: int,
                     num_blocks: int, prefill_chunk: int, prompt_len: int,
                     max_new: int, n_requests: int, rate: float,
                     decode_interval: int = 4, seed: int = 0,
                     draft_lens=(1, 2, 3), telemetry: Optional[str] = None,
                     device: str = "cuda",
                     state_dict: Optional[dict] = None) -> dict:
    """Disaggregated against colocated serving on the burst trace (the
    headline: the drop in max consecutive decode-stall ticks), an SLO
    curve of both engines over arrival rates (from `rate`; 0: the
    saturation point only), and the n-gram speculator's acceptance over
    `draft_lens` on the saturation trace; the JAX bench's row."""
    from picotron_tpu_torch.config import ServeConfig
    from picotron_tpu_torch.serve import DisaggServeEngine, ServeEngine
    from picotron_tpu_torch.telemetry import JsonlSink, Telemetry
    from picotron_tpu_torch.utils import cuda_or_cpu

    dev = cuda_or_cpu(device)
    cap = prompt_len + max_new
    m = bench_model(model, layers, cap, dev, state_dict)
    vocab = m.cfg.vocab_size

    def scfg(**kw):
        return ServeConfig(**{**dict(
            decode_slots=slots, block_size=block_size,
            num_blocks=num_blocks, prefill_chunk=prefill_chunk,
            max_model_len=cap, decode_interval=decode_interval), **kw})

    def run(engine_cls, cfg, trace, tel=None):
        eng = engine_cls(m, cfg, telemetry=tel, device=dev.type)
        t0 = time.perf_counter()
        eng.run(trace)
        wall = time.perf_counter() - t0
        eng.close()
        return eng.summary, wall

    # --- the burst headline: stall ticks, colocated against disagg
    burst = make_burst_trace(slots, prompt_len, prefill_chunk,
                             decode_interval, max_new, vocab, seed)
    # warm both engines (the allocator, cuBLAS) on a 2-request trace
    for cls, cfg in ((ServeEngine, scfg()),
                     (DisaggServeEngine, scfg(disagg=True))):
        run(cls, cfg, [(burst[0][0], 2), (burst[1][0], 2)])

    tel = Telemetry(sinks=[JsonlSink(telemetry)]) if telemetry else None
    colo, colo_wall = run(ServeEngine, scfg(), burst)
    dis, dis_wall = run(DisaggServeEngine, scfg(disagg=True), burst, tel)
    if tel is not None:
        tel.close()

    # --- the SLO curve: both engines on the same Poisson trace
    rates = [rate * f for f in (0.5, 1.0, 2.0)] if rate > 0 else [0.0]
    slo_curve = []
    for r in rates:
        trace = make_serve_trace(n_requests, r, prompt_len, max_new, vocab,
                                 seed)
        point: dict = {"rate": round(r, 3), "requests": n_requests}
        for tag, cls, cfg in (("colocated", ServeEngine, scfg()),
                              ("disagg", DisaggServeEngine,
                               scfg(disagg=True))):
            s, _ = run(cls, cfg, trace)
            point[tag] = {
                "ttft_p50_ms": _ms(s["ttft_p50_s"]),
                "ttft_p95_ms": _ms(s["ttft_p95_s"]),
                "tpot_p50_ms": _ms(s["tpot_p50_s"]),
                "tpot_p95_ms": _ms(s["tpot_p95_s"]),
                "queue_wait_p95_ms": _ms(s["queue_wait_p95_s"]),
                "decode_stall_ticks_max": s["decode_stall_ticks_max"],
            }
        slo_curve.append(point)

    # --- the acceptance sweep: the n-gram speculator per draft length
    sweep_trace = make_serve_trace(n_requests, 0.0, prompt_len, max_new,
                                   vocab, seed)
    acceptance_sweep = []
    for dl in draft_lens:
        s, _ = run(DisaggServeEngine,
                   scfg(disagg=True, speculator="ngram", draft_len=dl),
                   sweep_trace)
        acceptance_sweep.append({
            "draft_len": dl,
            "acceptance_rate": s["acceptance_rate"],
            "draft_tokens": s["draft_tokens"],
            "accepted_draft_tokens": s["accepted_draft_tokens"],
            "decode_steps": s["decode_steps"],
            "output_tokens": s["output_tokens"],
        })

    handoff_s, handoff_bytes = CostModel().price_kv_handoff(
        m.cfg, scfg(disagg=True))
    return {
        "metric": f"serve_disagg_{model.split('/')[-1]}"
                  f"-{m.cfg.num_hidden_layers}L",
        # headline: the deterministic stall-streak drop on the burst
        "value": (colo["decode_stall_ticks_max"]
                  - dis["decode_stall_ticks_max"]),
        "unit": "decode_stall_ticks_drop",
        "colocated_stall_ticks_max": colo["decode_stall_ticks_max"],
        "disagg_stall_ticks_max": dis["decode_stall_ticks_max"],
        "burst_requests": len(burst),
        "prompt_len": prompt_len,
        "max_new": max_new,
        "slots": slots,
        "prefill_slots": dis["prefill_slots"],
        "handoffs": dis["handoffs"],
        "handoff_blocks": dis["handoff_blocks"],
        "handoff_s": dis["handoff_s"],
        "predicted_handoff_ms_worstcase": round(handoff_s * 1e3, 3),
        "predicted_handoff_bytes_worstcase": handoff_bytes,
        "prefill_slot_occupancy": dis["prefill_slot_occupancy"],
        "decode_compiles": dis["decode_compiles"],
        "preemptions": dis["preemptions"],
        "colocated_wall_s": round(colo_wall, 4),
        "disagg_wall_s": round(dis_wall, 4),
        "wall_note": WALL_NOTE,
        "slo_curve": slo_curve,
        "acceptance_sweep": acceptance_sweep,
        "device_kind": device_kind(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="picotron-tpu port serving benchmark: the fleet or the "
                    "disaggregated engine on a synthetic trace, one JSON "
                    "line")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--fleet", type=int, default=0,
                      help="run N engine replicas behind one queue "
                           "(serve/fleet.py): failover re-dispatch, "
                           "deadline shedding, per-request digests")
    mode.add_argument("--disagg", action="store_true",
                      help="disaggregated against colocated engines "
                           "(serve/disagg.py): the decode-stall drop on a "
                           "long-prefill burst, an SLO curve and an n-gram "
                           "acceptance sweep")
    ap.add_argument("--model", default="SmolLM-1.7B",
                    help="preset name (random bf16 weights from a seed)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to N layers (0 = the preset's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (default cuda)")
    ap.add_argument("--prompt-len", type=int, default=512,
                    help="longest prompt of the trace")
    ap.add_argument("--max-new-tokens", type=int, default=128,
                    help="largest token budget of the trace")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests in the synthetic trace")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s (0 = all at "
                         "t=0, the saturation trace)")
    ap.add_argument("--serve-slots", type=int, default=8,
                    help="decode slots per engine")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per paged-cache block")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="blocks in each decode pool (0 = worst-case auto)")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prompt tokens prefilled per engine iteration")
    ap.add_argument("--decode-interval", type=int, default=4,
                    help="decode steps per dispatch")
    ap.add_argument("--draft-lens", type=int, nargs="*", default=[1, 2, 3],
                    help="--disagg: speculator draft lengths to sweep")
    ap.add_argument("--chaos", metavar="SPEC", default=None,
                    help="--fleet: serve-side chaos spec (engine_dead@REQ, "
                         "decode_hang@REQ~SECS, shed_storm@REQ[xN])")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="--fleet: per-request deadline on the virtual "
                         "trace clock (0 = none)")
    ap.add_argument("--serve-temperature", type=float, default=0.0,
                    help="--fleet: sampling temperature")
    ap.add_argument("--tick-s", type=float, default=0.001,
                    help="--fleet: virtual trace-clock seconds per fleet "
                         "iteration")
    ap.add_argument("--serve-seed", type=int, default=0,
                    help="trace and sampling seed")
    ap.add_argument("--telemetry", default=None,
                    help="write the run's telemetry JSONL here (--fleet: "
                         "and a flightdeck postmortem beside it)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.max_new_tokens < 1 or args.requests < 2:
        ap.error("needs --max-new-tokens >= 1 and --requests >= 2")
    if not args.disagg and args.fleet < 1:
        ap.error("--fleet needs N >= 1")
    common = dict(slots=args.serve_slots, block_size=args.block_size,
                  num_blocks=args.num_blocks,
                  prefill_chunk=args.prefill_chunk,
                  prompt_len=args.prompt_len, max_new=args.max_new_tokens,
                  n_requests=args.requests, rate=args.rate,
                  decode_interval=args.decode_interval,
                  seed=args.serve_seed, telemetry=args.telemetry,
                  device=args.device)
    if args.fleet:
        row = run_serve_fleet(
            args.model, args.layers, fleet=args.fleet,
            temperature=args.serve_temperature,
            deadline_ms=args.deadline_ms, chaos_spec=args.chaos,
            tick_s=args.tick_s, **common)
    else:
        row = run_serve_disagg(args.model, args.layers,
                               draft_lens=tuple(args.draft_lens), **common)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
