"""Which layout is fastest? Rank 4D layouts by predicted time on the CPU
(tools/layout_planner.py ported, on the h100 tier).

Enumerates the dp x tp x pp x cp x ep x {sequence_parallel, zero1,
offload} space (and where pp > 1 the pipeline executor and schedule, the
cp flavours where cp > 1, the tp strategies and sync where tp > 1) for
a model and a GPU count, prunes what cannot fit the GPU's memory,
prices the survivors with the cost model
(picotron_tpu_torch/analysis/cost_model.py: NVLink inside a node of 8,
InfiniBand across nodes) and prints a ranked table with the predicted
fastest layout as an overrides line. No card is needed.

  python -m picotron_tpu_torch.tools.layout_planner --chips 8 \\
      --model SmolLM-1.7B --seq 2048
  python -m picotron_tpu_torch.tools.layout_planner --chips 64 \\
      --config runs/llama3-8b-4d-v5p64/config.json --markdown
  python -m picotron_tpu_torch.tools.layout_planner --tp-strategy-table \\
      --model Llama-3.1-8B --seq 8192
  python -m picotron_tpu_torch.tools.layout_planner --validate-sweep
      # rank agreement against the card's measured points

`--validate-sweep` scores the model against the measured points of
`analysis/h100_points.json`. `--trace K` re-costs the top K points from
their recorded schedules (one meta step per pipeline stage at each
point's own shapes, `analysis/trace.py`; seconds per point, no card);
`--verify-hbm` refuses, since tools/memcheck.py is JAX-only (ROADMAP
Queue 1 item 12).

  python -m picotron_tpu_torch.tools.layout_planner --chips 8 \\
      --model SmolLM-1.7B --seq 2048 --trace 3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def build_base_config(args):
    from picotron_tpu_torch.config import (
        Config, ModelConfig, TrainingConfig, load_config, resolve_preset,
    )

    if args.config:
        cfg = load_config(args.config)
        if args.seq:
            cfg = cfg.replace(training=dataclasses.replace(
                cfg.training, seq_length=args.seq))
        return cfg
    preset = resolve_preset(args.model)
    seq = args.seq or 2048
    preset["max_position_embeddings"] = max(
        preset.get("max_position_embeddings", seq), seq)
    if args.layers:
        preset["num_hidden_layers"] = args.layers
    cfg = Config(
        model=ModelConfig(name=args.model, **preset),
        training=TrainingConfig(
            seq_length=seq, micro_batch_size=args.mbs,
            gradient_accumulation_steps=args.grad_acc),
    )
    cfg.validate()
    return cfg


def render_table(points, top, markdown=False):
    rows = []
    for i, p in enumerate(points[:top]):
        d = p.as_dict()
        rows.append((i + 1, d["layout"], d["predicted_step_ms"],
                     d["compute_ms"], d["exposed_comm_ms"],
                     d["bubble_ms"] + d["offload_ms"],
                     d.get("traced_comm_ms", ""), d["hbm_est_gib"]))
    hdr = ("rank", "layout", "step_ms", "compute_ms", "comm_ms",
           "bubble+io_ms", "traced_comm_ms", "hbm_est_gib")
    if markdown:
        lines = ["| " + " | ".join(hdr) + " |",
                 "|" + "---|" * len(hdr)]
        lines += ["| " + " | ".join(str(c) for c in r) + " |"
                  for r in rows]
    else:
        w = [max(len(str(x)) for x in [h] + [r[i] for r in rows])
             for i, h in enumerate(hdr)]
        lines = ["  ".join(h.ljust(w[i]) for i, h in enumerate(hdr))]
        lines += ["  ".join(str(c).ljust(w[i]) for i, c in enumerate(r))
                  for r in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="picotron-tpu layout planner, PyTorch port (CPU only)")
    ap.add_argument("--chips", type=int, default=None,
                    help="GPUs to plan for (required unless "
                         "--validate-sweep or a table)")
    ap.add_argument("--model", default="SmolLM-1.7B",
                    help="model preset (ignored with --config)")
    ap.add_argument("--config", default=None,
                    help="plan around an existing config JSON (its model/"
                         "batch settings seed the search)")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="override the preset's depth")
    ap.add_argument("--mbs", type=int, default=1)
    ap.add_argument("--grad-acc", type=int, default=8,
                    help="grad-accum of the seed point; the planner holds "
                         "the implied global batch constant")
    ap.add_argument("--generation", default="h100", choices=["h100"],
                    help="hardware tier: h100 (NVLink in a node of 8, "
                         "InfiniBand across nodes, 80 GB per GPU, the "
                         "card's own memory where one is present)")
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="override the tier's per-GPU memory")
    ap.add_argument("--slices", type=int, default=None, metavar="N",
                    help="after ranking, price the winner's layout split "
                         "over N slices (nodes): one row per axis (dp/pp) "
                         "that can absorb them, the NVLink and IB legs "
                         "priced apart (analysis/planner.slice_plans)")
    ap.add_argument("--no-flags", action="store_true",
                    help="search only the 5 parallel axes (skip sp/zero1/"
                         "offload toggles)")
    ap.add_argument("--top", type=int, default=10, help="rows to print")
    ap.add_argument("--trace", type=int, default=0, metavar="K",
                    help="re-cost the top K points from their recorded "
                         "collective schedules (a meta step per pipeline "
                         "stage, priced per op; analysis/planner."
                         "reprice_traced)")
    ap.add_argument("--verify-hbm", action="store_true",
                    help="refused: memcheck verification is JAX-only")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per ranked point")
    ap.add_argument("--markdown", action="store_true",
                    help="markdown table (PERF.md format)")
    ap.add_argument("--cp-crossover", action="store_true",
                    help="instead of planning, sweep cp degree and print "
                         "each cp flavor's predicted step time and the "
                         "smallest degree where the 2D mesh flavor wins")
    ap.add_argument("--cp-degrees", type=int, nargs="*", default=None,
                    metavar="CP", help="cp degrees for --cp-crossover "
                         "(default 2 4 8 16 32)")
    ap.add_argument("--tp-strategy-table", action="store_true",
                    help="instead of planning, sweep tp degree and print "
                         "each tp strategy x sync mode's predicted step "
                         "and exposed-comm time, the best 2D "
                         "factorization and the adaptive resolution")
    ap.add_argument("--tp-degrees", type=int, nargs="*", default=None,
                    metavar="TP", help="tp degrees for --tp-strategy-table "
                         "(default 2 4 8 16)")
    ap.add_argument("--validate-sweep", action="store_true",
                    help="score the cost model's rank agreement against "
                         "measured points instead of planning")
    ap.add_argument("--fit", action="store_true",
                    help="with --validate-sweep: refit the calibration "
                         "constants from the points first (FIT_KEYS from "
                         "calibration.FIT_START; on the default points "
                         "this gives the committed defaults)")
    args = ap.parse_args(argv)

    from picotron_tpu_torch.analysis.cost_model import CostModel, h100_tier

    if args.verify_hbm:
        print("layout_planner: --verify-hbm needs tools/memcheck.py, which "
              "is JAX-only (ROADMAP Queue 1 item 12); the port screens "
              "memory analytically (estimate_hbm_gib)", file=sys.stderr)
        return 2
    gen = h100_tier()

    if args.validate_sweep:
        from picotron_tpu_torch.analysis.calibration import (
            FIT_KEYS, FIT_START, fit_calibration, load_measured_rows,
            rank_agreement,
        )

        points = load_measured_rows()
        if not points:
            print("no measured points found", file=sys.stderr)
            return 1
        model = CostModel(gen)
        if args.fit:
            model = CostModel(gen, fit_calibration(
                points, gen, start=FIT_START, keys=FIT_KEYS))
        ra = rank_agreement(points, model)
        if args.fit:
            ra["calibration"] = dataclasses.asdict(model.calib)
        if args.json:
            print(json.dumps(ra))
        else:
            print(f"rank agreement vs measured points "
                  f"({len(points)} rows, {gen.name} tier):")
            for src, rho in ra["per_round"].items():
                print(f"  {src}: spearman {rho}")
            print(f"  pooled: {ra.get('pooled')}")
            if args.fit:
                print(f"  fitted: {ra['calibration']}")
            for r in ra["rows"]:
                print(f"    {r['metric']:42s} measured "
                      f"{r['measured_tps_chip']:>9} predicted "
                      f"{r['predicted_tps_chip']:>9} tok/s/chip")
        return 0

    if args.cp_crossover:
        from picotron_tpu_torch.analysis.cost_model import (
            cp_crossover, cp_crossover_table,
        )

        base = build_base_config(args)
        degrees = tuple(args.cp_degrees or (2, 4, 8, 16, 32))
        m = CostModel(gen)
        rows = cp_crossover_table(m, base, degrees)
        cross = cp_crossover(m, base, degrees)
        if args.json:
            print(json.dumps({"generation": gen.name, "rows": rows,
                              "crossover_cp": cross}), flush=True)
            return 0
        print(f"cp-flavor crossover: {base.model.name} seq "
              f"{base.training.seq_length} (tp={base.distributed.tp_size},"
              f" '-' = flavor infeasible at that degree)")
        hdr = ("gen", "cp", "ring_ms", "ulysses_ms", "mesh_ms",
               "mesh_fact", "winner")
        print("  " + "  ".join(h.rjust(10) for h in hdr))
        for r in rows:
            cells = (gen.name, r["cp"], r["ring_ms"],
                     r.get("ulysses_ms") or "-", r.get("mesh_ms") or "-",
                     r.get("mesh_factorization", "-"), r["winner"])
            print("  " + "  ".join(str(c).rjust(10) for c in cells))
        print(f"predicted mesh crossover on {gen.name}: "
              + (f"cp={cross}" if cross else "never (within swept degrees)"))
        return 0

    if args.tp_strategy_table:
        from picotron_tpu_torch.analysis.cost_model import tp_strategy_table

        base = build_base_config(args)
        degrees = tuple(args.tp_degrees or (2, 4, 8, 16))
        rows = tp_strategy_table(CostModel(gen), base, degrees)
        if args.json:
            print(json.dumps({"generation": gen.name, "rows": rows}),
                  flush=True)
            return 0
        print(f"TP strategy table: {base.model.name} seq "
              f"{base.training.seq_length} ('-' = strategy infeasible at "
              f"that degree; exposed_ms deltas vs megatron-sync)")
        hdr = ("gen", "tp", "megatron_ms", "deferred_ms", "row_ms",
               "2d_ms", "2d_mesh", "defer_dexp", "adaptive", "winner")
        print("  " + "  ".join(h.rjust(11) for h in hdr))
        for r in rows:
            cells = (gen.name, r["tp"], r["megatron_ms"], r["deferred_ms"],
                     r["row_ms"], r.get("2d_ms", "-"),
                     r.get("mesh_factorization", "-"),
                     r["deferred_exposed_delta_ms"], r["adaptive"],
                     r["winner"])
            print("  " + "  ".join(str(c).rjust(11) for c in cells))
        return 0

    if not args.chips:
        ap.error("--chips is required (or use --validate-sweep)")

    from picotron_tpu_torch.analysis.planner import best_point, plan

    base = build_base_config(args)
    model = CostModel(gen)
    cap = args.hbm_gib if args.hbm_gib is not None else gen.hbm_gib
    points = plan(base, args.chips, model, flags=not args.no_flags,
                  hbm_gib=cap)
    if not points:
        print(f"no layout of {base.model.name} fits {args.chips}x"
              f"{gen.name} ({cap:.1f} GiB) — try --hbm-gib, more GPUs, or "
              f"a smaller micro-batch", file=sys.stderr)
        return 1
    if args.trace > 0:
        from picotron_tpu_torch.analysis.planner import reprice_traced

        points = reprice_traced(points, model, top_k=args.trace)
    winner = best_point(points, hbm_gib=cap, model=model)

    slice_rows = []
    if args.slices and args.slices > 1:
        from picotron_tpu_torch.analysis.planner import slice_plans

        slice_rows = slice_plans(winner.cfg, model, args.slices)

    if args.json:
        for p in points[:args.top]:
            print(json.dumps(p.as_dict()), flush=True)
        if args.slices and args.slices > 1:
            print(json.dumps({"slice_plans": slice_rows,
                              "winner": winner.label}), flush=True)
        return 0
    n_all = len(points)
    print(f"layout planner: {base.model.name} seq "
          f"{base.training.seq_length} on {args.chips}x{gen.name} — "
          f"{n_all} memory-feasible layouts, top {min(args.top, n_all)}:")
    print(render_table(points, args.top, markdown=args.markdown))
    print()
    print(f"predicted fastest: {winner.label} "
          f"({winner.cost.as_dict()['predicted_step_ms']} ms/step, "
          f"{winner.cost.as_dict()['tokens_per_sec_per_chip']} "
          f"tok/s/chip)")
    print(f"  run it: {winner.overrides_line()}")
    if args.slices and args.slices > 1:
        print()
        if not slice_rows:
            print(f"slice planning: no axis of {winner.label} can absorb "
                  f"{args.slices} slices (dp and pp must be divisible by "
                  f"the slice count)")
        else:
            print(f"slice planning: {winner.label} over {args.slices} "
                  f"slices [{slice_rows[0]['generation']}]:")
            hdr = ("axis", "crossing_terms", "dcn_bytes", "dcn_ms",
                   "ici_ms", "total_comm_ms")
            print("  " + "  ".join(h.rjust(14) for h in hdr))
            for r in slice_rows:
                cells = (r["axis"], ",".join(r["crossing_terms"]) or "-",
                         r["dcn_bytes"], r["dcn_ms"], r["ici_ms"],
                         r["total_comm_ms"])
                print("  " + "  ".join(str(c).rjust(14) for c in cells))
            print(f"  declare it: --override distributed.slices="
                  f"{args.slices} distributed.dcn_axes="
                  f"{slice_rows[0]['axis']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
