"""Will this config's layout do what you think? — static audit on the CPU
(tools/shardcheck.py ported).

Runs the shardcheck analyzers (picotron_tpu_torch/analysis) for one or
more configs over one recorded step each: the step of every distinct
program (one rank per pipeline stage) runs on the `meta` device at the
config's own shapes, through recording groups in place of the process
groups (`analysis/trace.py`). No card, no process group, no memory:

- spec lint: `parallel/sharding.py`'s placement vs the model's
  parameters vs the layout sizes, and vs what a rank's model holds;
- collective-schedule audit: the grad all-reduce over the data axes,
  the pipeline send/recv, the expert all_to_all, the SP pair, the cp
  ring's hop, the Ulysses all_to_all, the 2d/row strategies' subgroup
  collectives must exist where the layout promises them, and no
  all-gather may exceed the replication byte budget;
- in-place + stability hazards: every parameter, grad buffer, master
  and moment updated in place, and keeping (shape, dtype, device,
  requires_grad) across the step;
- provenance (--provenance): every recorded collective attributed to
  the line that issued it and classified against the schedule contract
  (implicit ops and boundary reshards: 0 by construction);
- signature prover (--variants): the train step's state keeps one input
  signature, the serving engines' programs have one each;
- slice-boundary audit (--slices N, "slicecheck"): every recorded group
  mapped onto the slice (node) partition and classified intra-slice /
  boundary / VIOLATING, priced under --cost on the tier's cross-node
  term;
- source lint: no jax / JAX-package import, no host sync or raw
  torch.distributed collective in step code.

Usage:

  python -m picotron_tpu_torch.tools.shardcheck --config cfg.json
  python -m picotron_tpu_torch.tools.shardcheck --preset tiny-dense
  python -m picotron_tpu_torch.tools.shardcheck --all-presets --verbose
  python -m picotron_tpu_torch.tools.shardcheck --all-presets --json
  python -m picotron_tpu_torch.tools.shardcheck --preset tiny-dense \\
      --slices 2 --dcn-axes dp

--json emits one line per config (findings + the per-check info dict);
a config that cannot be recorded becomes a row with a "fatal" key
instead of ending the sweep. Exit status 0 iff every config is green.
"""

from __future__ import annotations

import argparse
import json
import sys

# (model, distributed kwargs, training kwargs[, pipeline kwargs[, model
# kwargs]]): the JAX tool's presets, by name
PRESETS: dict[str, tuple] = {
    "tiny-1chip": ("debug-tiny", {}, {}),
    "tiny-dense": ("debug-tiny",
                   dict(dp_size=2, tp_size=2, cp_size=2),
                   dict(gradient_accumulation_steps=2)),
    "tiny-dense-pp": ("debug-tiny",
                      dict(pp_size=2, dp_size=2),
                      dict(gradient_accumulation_steps=2)),
    # the mpmd tables: the --variants prover checks each stage boundary
    "tiny-dense-pp-mpmd": ("debug-tiny",
                           dict(pp_size=2, dp_size=2),
                           dict(gradient_accumulation_steps=2),
                           dict(executor="mpmd")),
    "tiny-moe-ep": ("debug-tiny-moe",
                    dict(ep_size=2, dp_size=2),
                    dict(gradient_accumulation_steps=2)),
    "tiny-dense-offload": ("debug-tiny", {},
                           dict(gradient_accumulation_steps=2,
                                optimizer_offload=True)),
    "tiny-moe-offload": ("debug-tiny-moe", dict(ep_size=2),
                         dict(gradient_accumulation_steps=2,
                              optimizer_offload=True)),
    # the fused grad engine: the same per-axis schedule as autograd's
    "tiny-sp-fused": ("debug-tiny",
                      dict(dp_size=2, tp_size=2, sequence_parallel=True),
                      dict(gradient_accumulation_steps=2,
                           grad_engine="fused",
                           remat_policy="dots_attn")),
    "tiny-cp4-fused": ("debug-tiny", dict(dp_size=2, cp_size=4),
                       dict(gradient_accumulation_steps=2,
                            grad_engine="fused",
                            remat_policy="dots_attn")),
    # the mesh cp flavor: row all_to_all on cp_y, hops on cp_x
    "tiny-cp4-mesh": ("debug-tiny",
                      dict(dp_size=2, cp_size=4, cp_flavor="mesh",
                           cp_mesh="2x2"),
                      dict(gradient_accumulation_steps=2)),
    "tiny-cp4-mesh-fused": ("debug-tiny",
                            dict(dp_size=2, cp_size=4, cp_flavor="mesh",
                                 cp_mesh="2x2"),
                            dict(gradient_accumulation_steps=2,
                                 grad_engine="fused",
                                 remat_policy="dots_attn")),
    # the deferred sync: the RS/AG pair over tp without SP
    "tiny-tp-deferred": ("debug-tiny",
                         dict(dp_size=2, tp_size=2, tp_sync="deferred"),
                         dict(gradient_accumulation_steps=2)),
    "tiny-tp-deferred-fused": ("debug-tiny",
                               dict(dp_size=2, tp_size=2,
                                    tp_sync="deferred"),
                               dict(gradient_accumulation_steps=2,
                                    grad_engine="fused",
                                    remat_policy="dots_attn")),
    # the 2d strategy's subgroups (kv heads 4 keep tp 4 divisible)
    "tiny-tp2d": ("debug-tiny",
                  dict(dp_size=2, tp_size=4, tp_strategy="2d",
                       tp_mesh="2x2"),
                  dict(gradient_accumulation_steps=2),
                  {},
                  dict(num_key_value_heads=4)),
    # the slice audit: dp crosses the cut (the hierarchical reduction),
    # every tp/cp collective stays inside a slice
    "tiny-dense-dp-cross": ("debug-tiny",
                            dict(dp_size=2, tp_size=2, cp_size=2,
                                 slices=2, dcn_axes="dp"),
                            dict(gradient_accumulation_steps=2)),
    "tiny-dp-cross-fused": ("debug-tiny",
                            dict(dp_size=2, tp_size=2, cp_size=2,
                                 slices=2, dcn_axes="dp"),
                            dict(gradient_accumulation_steps=2,
                                 grad_engine="fused", remat=True,
                                 remat_policy="dots_attn")),
    # pp crosses the cut under the mpmd tables: the stage boundaries'
    # send/recv are the only crossers
    "tiny-pp-mpmd-cross": ("debug-tiny",
                           dict(pp_size=2, tp_size=2,
                                slices=2, dcn_axes="pp"),
                           dict(gradient_accumulation_steps=2),
                           dict(executor="mpmd")),
}


def preset_config(name: str):
    from picotron_tpu_torch.config import (
        Config, DistributedConfig, ModelConfig, PipelineConfig,
        TrainingConfig, resolve_preset,
    )

    model, dist_kw, train_kw, *rest = PRESETS[name]
    pipe_kw = rest[0] if rest else {}
    model_kw = rest[1] if len(rest) > 1 else {}
    cfg = Config(
        distributed=DistributedConfig(**dist_kw),
        model=ModelConfig(name=model,
                          **{**resolve_preset(model), **model_kw}),
        training=TrainingConfig(seq_length=64, micro_batch_size=1,
                                **train_kw),
        pipeline=PipelineConfig(**pipe_kw),
    )
    cfg.validate()
    return cfg


def _print_report(rep, args, cost_row) -> None:
    print(rep.render(verbose=args.verbose), flush=True)
    trace = rep.info.get("trace")
    if trace:
        print(f"recorded: {len(trace['ranks'])} program(s) on "
              f"{trace['device']}, {trace['ops']} collective(s), "
              f"{trace['seconds']:.2f} s", flush=True)
    prov = rep.info.get("provenance")
    if prov:
        print(f"provenance: {prov['sites']} site(s), "
              f"{prov['ops_attributed']}/{prov['ops_effective']} recorded "
              f"op(s) attributed ({prov['attribution_pct']:.1f}%), "
              f"{prov['implicit_ops']} implicit, "
              f"{prov['boundary_reshards']} predicted reshard(s)",
              flush=True)
        if args.verbose:
            for src, row in sorted(prov.get("by_source", {}).items()):
                roots = ", ".join(row["roots"][:3]) or "<activations>"
                print(f"  {src}: {row['ops']} {'/'.join(row['kinds'])} "
                      f"<- {roots}", flush=True)
    bnd = rep.info.get("boundary")
    if bnd and bnd.get("audited"):
        from picotron_tpu_torch.analysis.boundary import render_table

        line = (f"boundary: {bnd['slices']} slice(s), dcn axes "
                f"[{bnd.get('dcn_axes', '')}] — {bnd.get('intra', 0)} "
                f"intra / {bnd.get('boundary', 0)} boundary / "
                f"{bnd.get('violating', 0)} violating")
        if "dcn_ms" in bnd:
            line += (f"; dcn {bnd['dcn_ms']:.3f} ms, intra-slice "
                     f"{bnd['ici_ms']:.3f} ms [{bnd['dcn_generation']}]")
        print(line, flush=True)
        if args.verbose:
            print(render_table(bnd), flush=True)
    var = rep.info.get("variants")
    if var:
        for entry in ("train_step", "mpmd_stages", "serve"):
            v = var.get(entry) or {}
            if "proven" in v:
                state = "proven one signature" if v["proven"] else \
                    "NOT proven"
                detail = (f"{v['programs']} stage exchange(s)"
                          if "programs" in v else
                          f"{v.get('signatures', '?')} signature(s)")
                print(f"variants[{v.get('entry', entry)}]: {state} "
                      f"({detail})", flush=True)
        lint = (var.get("mpmd_stages") or {}).get("schedule_lint")
        if lint:
            state = ("statically proven" if lint["proven"]
                     else "FAILS the lint")
            print(f"variants[schedule:{lint['kind']}]: table {state} "
                  f"({lint['ops']} op(s) over {lint['ticks']} tick(s), "
                  f"{lint['problems']} problem(s))", flush=True)
    if cost_row:
        line = (f"cost[{cost_row['generation']}]: predicted step "
                f"{cost_row['predicted_step_ms']} ms (exposed comm "
                f"{cost_row['exposed_comm_ms']} ms, recorded schedule "
                f"{cost_row['recorded_comm_ms']} ms)")
        if cost_row["planner_best"]:
            line += (f"; planner best at equal GPUs: "
                     f"{cost_row['planner_best']} "
                     f"({cost_row['planner_best_step_ms']} ms, this config "
                     f"+{cost_row['gap_vs_best_pct']}%)")
        print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="picotron-tpu static layout analysis (shardcheck), "
                    "PyTorch port (CPU only)")
    ap.add_argument("--config", action="append", default=[],
                    help="config JSON path (repeatable)")
    ap.add_argument("--preset", action="append", default=[],
                    choices=sorted(PRESETS),
                    help="built-in tiny config (repeatable)")
    ap.add_argument("--all-presets", action="store_true",
                    help="run the whole preset matrix")
    ap.add_argument("--checks", default=None,
                    help="comma-separated subset of spec,source,"
                         "collectives,boundary,provenance,variants,"
                         "donation,stability (default: all)")
    ap.add_argument("--provenance", action="store_true",
                    help="focus on provenance (the spec lint still runs "
                         "first)")
    ap.add_argument("--variants", action="store_true",
                    help="focus on the signature prover (the spec lint "
                         "still runs first)")
    ap.add_argument("--slices", type=int, default=None,
                    help="audit the schedule against an N-slice (node) "
                         "partition (overrides distributed.slices); a "
                         "config with slices > 1 is audited anyway")
    ap.add_argument("--dcn-axes", default=None,
                    help="comma-separated axes allowed to cross the cut "
                         "(subset of dp,pp; overrides distributed."
                         "dcn_axes)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="all-gather replication budget in MiB (default: "
                         "the largest param / activation block)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per config instead of the report")
    ap.add_argument("--verbose", action="store_true",
                    help="include info-level findings and summary tables")
    ap.add_argument("--cost", action="store_true",
                    help="price the recorded schedule with the cost model "
                         "and compare the config against the layout "
                         "planner's best at equal GPU count")
    ap.add_argument("--generation", default="h100", choices=["h100"],
                    help="hardware tier for --cost (NVLink in a node of "
                         "8, InfiniBand across nodes)")
    args = ap.parse_args(argv)

    names = list(args.preset) + (sorted(PRESETS) if args.all_presets
                                 else [])
    if not names and not args.config:
        ap.error("nothing to check: pass --config, --preset, or "
                 "--all-presets")

    from picotron_tpu_torch.analysis import ALL_CHECKS, run_shardcheck
    from picotron_tpu_torch.config import load_config

    if args.checks:
        checks = tuple(c.strip() for c in args.checks.split(","))
    elif args.provenance or args.variants:
        checks = ("spec",)
        checks += ("provenance",) if args.provenance else ()
        checks += ("variants",) if args.variants else ()
        checks += ("boundary",) if args.slices else ()
    else:
        checks = ALL_CHECKS
    if args.slices and "boundary" not in checks:
        checks += ("boundary",)
    unknown = set(checks) - set(ALL_CHECKS)
    if unknown:
        ap.error(f"unknown checks {sorted(unknown)}; valid: {ALL_CHECKS}")
    budget = (int(args.budget_mb * 1024 * 1024)
              if args.budget_mb is not None else None)

    targets = [(f"preset:{n}", preset_config(n)) for n in names]
    targets += [(path, load_config(path)) for path in args.config]

    cost_model = None
    if args.cost:
        from picotron_tpu_torch.analysis.cost_model import CostModel, h100_tier

        cost_model = CostModel(h100_tier())

    n_bad = 0
    for label, cfg in targets:
        try:
            rep = run_shardcheck(cfg, checks=checks, budget_bytes=budget,
                                 cost_model=cost_model, slices=args.slices,
                                 dcn_axes=args.dcn_axes)
        except Exception as e:  # a layout the recorder cannot build
            n_bad += 1
            if args.json:
                print(json.dumps({"config": label, "ok": False,
                                  "fatal": f"{type(e).__name__}: {e}"}),
                      flush=True)
            else:
                print(f"== {label} ==")
                print(f"FATAL {type(e).__name__}: {e}", flush=True)
            continue
        cost_row = None
        if cost_model is not None:
            from picotron_tpu_torch.analysis.planner import planner_gap

            cur, best, gap = planner_gap(cfg, cost_model)
            recorded_ms = rep.info.get("collectives", {}).get(
                "predicted_comm", {}).get("total_ms")
            cost_row = {
                "generation": cost_model.gen.name,
                "predicted_step_ms": round(cur.total_s * 1e3, 3),
                "exposed_comm_ms": round(cur.exposed_comm_s * 1e3, 3),
                "recorded_comm_ms": recorded_ms,
                "planner_best": best.label if best else None,
                "planner_best_step_ms": (round(best.cost.total_s * 1e3, 3)
                                         if best else None),
                "gap_vs_best_pct": round(gap * 100, 1),
            }
        n_bad += 0 if rep.ok() else 1
        if args.json:
            print(json.dumps({
                "config": label,
                "ok": rep.ok(),
                "errors": len(rep.errors()),
                "warnings": len(rep.warnings()),
                "findings": [f.render() for f in rep.findings
                             if f.severity != "info" or args.verbose],
                "info": rep.info,
                **({"cost": cost_row} if cost_row else {}),
            }, default=str), flush=True)
        else:
            print(f"== {label} ==")
            _print_report(rep, args, cost_row)
    if not args.json:
        status = "green" if n_bad == 0 else f"{n_bad} config(s) with errors"
        print(f"shardcheck: {len(targets)} config(s) checked — {status}")
    return 0 if n_bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
