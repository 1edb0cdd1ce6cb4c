"""Offline elastic re-stamp (the port's copy of tools/elastic_resize.py):
adapt a verified checkpoint to a new dp/pp/slices layout.

    python -m picotron_tpu_torch.tools.elastic_resize CKPT_DIR [--dp M]
        [--pp K] [--slices S] [--step N] [--dry-run]

The restore path (`checkpoint.py`) refuses a checkpoint saved at another
dp or pp unless `checkpoint.elastic` is on or the checkpoint has been
re-stamped by this tool. Re-stamping rewrites the step's meta.json for
the new layout (dp_size, with micro_batch_size and
gradient_accumulation_steps re-factored at a CONSTANT global batch; and
pp_size) and re-commits the manifest with the new topology, so the
resumed run needs no special config.

Where the JAX tool rewrites metadata only (Orbax reshards its global
arrays onto any mesh), the port's state is per-rank files, so this tool
also rewrites `state/`: every ZeRO-1 row set regathered whole and
re-split by the target's `zero1_rows`, the params files renamed to the
target's global ranks, the layers re-bucketed into the target's pipeline
stages (`resilience/elastic.resplit_step`). It writes the new files
under `state.tmp.<pid>/` and swaps them in; a failure before the swap
leaves `state/` as it was. A `--dp` and `--pp` change can go together.
`--slices` (slice-loss recovery: restart the surviving slices as a
smaller multi-slice or a single-slice job) is placement only: it
re-stamps the slice count in the topology and the config meta, after
the JAX tool's check that the count divides the target's dp * pp, and
rewrites no file of `state/` unless `--dp` or `--pp` changes too.

Safety, as the JAX tool's: the step is deep-verified BEFORE anything is
rewritten, and a corrupt step is refused (re-stamping rebuilds the
manifest from the bytes on disk, which would bless the corruption); a
legacy step (no manifest) is rewritten without one. An uneven pp split
whose layer slots differ is refused as the JAX slot check refuses it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from picotron_tpu_torch.ckpt_integrity import (
    atomic_write_text, build_manifest, verify_step_dir, write_manifest,
)
from picotron_tpu_torch.resilience import elastic

STEP_RE = re.compile(r"^step_(\d{8})$")


def list_steps(save_dir: str) -> list[int]:
    try:
        names = os.listdir(save_dir)
    except FileNotFoundError:
        return []
    return sorted(int(m.group(1)) for n in names
                  if (m := STEP_RE.match(n)))


def _fail(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="re-stamp a checkpoint step for a new dp/pp/slices "
                    "layout (constant global batch), re-splitting its "
                    "files")
    ap.add_argument("save_dir", help="checkpoint directory (the trainer's "
                    "checkpoint.save_dir, containing step_XXXXXXXX dirs)")
    ap.add_argument("--dp", type=int, default=None,
                    help="target data-parallel size")
    ap.add_argument("--pp", type=int, default=None,
                    help="target pipeline-parallel size")
    ap.add_argument("--slices", type=int, default=None,
                    help="target slice count (slice-loss recovery: "
                         "restart the surviving slices as a smaller "
                         "multi-slice or single-slice job; placement "
                         "metadata only — pair with --dp/--pp to shrink "
                         "the layout onto the survivors)")
    ap.add_argument("--step", type=int, default=None,
                    help="step to re-stamp (default: newest step that "
                         "passes verification)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the plan without touching the store")
    args = ap.parse_args(argv)
    if args.dp is None and args.pp is None and args.slices is None:
        ap.error("pick a target topology: --dp M, --pp K and/or "
                 "--slices S")
    if args.pp is not None and args.pp < 1:
        ap.error(f"--pp must be >= 1, got {args.pp}")
    if args.slices is not None and args.slices < 1:
        ap.error(f"--slices must be >= 1, got {args.slices}")

    steps = list_steps(args.save_dir)
    if not steps:
        return _fail(f"no checkpoint steps under {args.save_dir}")
    if args.step is not None:
        if args.step not in steps:
            return _fail(f"step {args.step} not found under "
                         f"{args.save_dir}; available: {steps}")
        step = args.step
    else:
        step = next((s for s in reversed(steps)
                     if verify_step_dir(os.path.join(
                         args.save_dir, f"step_{s:08d}")).ok), None)
        if step is None:
            return _fail(f"no step under {args.save_dir} passes "
                         f"verification")
    step_dir = os.path.join(args.save_dir, f"step_{step:08d}")
    if not os.path.isdir(os.path.join(step_dir, "state")):
        return _fail(f"step {step} is not durable (no state/); nothing to "
                     f"re-stamp")

    # Deep-verify BEFORE mutating: a corrupt store would come out
    # "verified" from the re-committed manifest.
    res = verify_step_dir(step_dir, deep=True)
    if res.status == "corrupt":
        return _fail(f"step {step} fails verification "
                     f"({'; '.join(res.failures[:3])}); refusing to "
                     f"re-stamp a corrupt checkpoint")

    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    cfg = meta.get("config") or {}
    tr, dist = cfg.get("training") or {}, cfg.get("distributed") or {}
    if "micro_batch_size" not in tr or "dp_size" not in dist:
        return _fail(f"step {step}'s meta.json records no training/"
                     f"distributed config; cannot plan a "
                     f"constant-global-batch resize")

    saved = elastic.saved_topology(step_dir) or {}
    dp_new = args.dp if args.dp is not None else int(dist["dp_size"])
    try:
        plan = elastic.plan_resize(
            micro_batch_size=int(tr["micro_batch_size"]),
            gradient_accumulation_steps=int(
                tr["gradient_accumulation_steps"]),
            dp_size=int(dist["dp_size"]), dp_new=dp_new,
            ep_size=int(dist.get("ep_size", 1)))
    except ValueError as e:
        return _fail(f"cannot resize step {step}: {e}")

    pp_old = int(saved.get("pp", dist.get("pp_size", 1)))
    pp_new = args.pp if args.pp is not None else pp_old
    layers = (cfg.get("model") or {}).get("num_hidden_layers")
    if pp_new != pp_old:
        if not layers:
            return _fail(f"step {step}'s meta.json records no "
                         f"model.num_hidden_layers; cannot verify the pp "
                         f"slot layout")
        src_padded, src_slots = elastic.pp_slots(layers, pp_old)
        dst_padded, dst_slots = elastic.pp_slots(layers, pp_new)
        if src_padded != dst_padded or list(src_slots) != list(dst_slots):
            return _fail(
                f"cannot re-stamp step {step} to pp={pp_new}: the saved "
                f"padded layer stack ({src_padded} slots at pp={pp_old}) "
                f"and the target's ({dst_padded} slots at pp={pp_new}) "
                f"place the {layers} real layers in different slots — "
                f"only even splits share a stack; pick a pp that "
                f"divides the padded layer count evenly")

    slices_old = int(saved.get("slices", dist.get("slices", 1)) or 1)
    slices_new = args.slices if args.slices is not None else slices_old
    if slices_new > 1 and (slices_new > plan.dp_new * pp_new
                           or (plan.dp_new * pp_new) % slices_new != 0):
        # the config-validation rule at the target sizes: the resumed
        # run would refuse its own config before restoring anything
        return _fail(f"cannot re-stamp step {step} to slices={slices_new}: "
                     f"slices must divide dp*pp = {plan.dp_new * pp_new} "
                     f"(dp={plan.dp_new}, pp={pp_new}) and not exceed it — "
                     f"the resumed run's config validation would refuse "
                     f"this layout")

    dl_state = meta.get("dataloader")
    if dl_state:
        dl_state = elastic.translate_dataloader_state(
            dl_state, gbs_old=plan.global_batch_size,
            gbs_new=plan.global_batch_size)

    state_dir = os.path.join(step_dir, "state")
    src = elastic.step_layout(state_dir, saved or None, meta)
    sizes = {**src.size, "dp": plan.dp_new, "pp": pp_new}
    interleave = src.interleave if pp_new > 1 else 1
    dst = elastic.FileLayout.make(sizes, src.zero1, src.grouped, interleave)
    if pp_new > 1:
        try:
            elastic.pp_stage_check(int(layers), pp_new, interleave)
        except ValueError as e:
            return _fail(f"cannot re-stamp step {step} to pp={pp_new}: {e}")
    new_topo = {ax: dst.size[ax] for ax in elastic.TOPOLOGY_AXES}
    new_topo["slices"] = slices_new
    new_topo["world_size"] = dst.world
    new_topo["process_count"] = dst.world if dst.grouped else 1
    if dst.grouped:
        new_topo["zero1"] = dst.zero1

    print(f"step {step} under {args.save_dir} ({res.status}):")
    print(f"  topology  [{elastic.describe_topology(saved or None)}] -> "
          f"[{elastic.describe_topology(new_topo)}]")
    print(f"  batch     mbs {tr['micro_batch_size']} x ga "
          f"{tr['gradient_accumulation_steps']} x dp {dist['dp_size']} "
          f"-> mbs {plan.micro_batch_size} x ga "
          f"{plan.gradient_accumulation_steps} x dp {plan.dp_new} "
          f"(global batch {plan.global_batch_size}, unchanged)")
    if pp_new != pp_old:
        print(f"  pipeline  pp {pp_old} -> {pp_new} (layers re-bucketed "
              f"into the target's stages by global index)")
    if slices_new != slices_old:
        print(f"  slices    {slices_old} -> {slices_new} (placement "
              f"metadata only — no tensor touches a slice boundary)")
    print(f"  files     {src.world if src.grouped else 1} rank(s) -> "
          f"{dst.world if dst.grouped else 1} rank(s) "
          f"({'per-rank files' if dst.grouped else 'params.pt'}, zero1 "
          f"{dst.zero1})")
    if dl_state:
        print(f"  cursor    epoch {dl_state['epoch']}, sample "
              f"{dl_state['cursor']} (token-exact carry)")
    if args.dry_run:
        print("dry run: store not modified")
        return 0

    same_files = (src.size, src.zero1, src.grouped, src.interleave) == \
        (dst.size, dst.zero1, dst.grouped, dst.interleave)
    timings = None if same_files else elastic.resplit_step(step_dir, src, dst)
    meta["config"]["distributed"]["dp_size"] = plan.dp_new
    meta["config"]["distributed"]["pp_size"] = pp_new
    meta["config"]["distributed"]["slices"] = slices_new
    meta["config"]["training"]["micro_batch_size"] = plan.micro_batch_size
    meta["config"]["training"]["gradient_accumulation_steps"] = \
        plan.gradient_accumulation_steps
    meta["elastic_restamp"] = {"from": saved or None, "to": new_topo,
                               "tool": "picotron_tpu_torch.tools."
                                       "elastic_resize"}
    atomic_write_text(os.path.join(step_dir, "meta.json"),
                      json.dumps(meta, indent=2))
    if timings is None:
        print("  state     unchanged (the same files serve the target)")
    else:
        print(f"  state     re-split in {timings['read_s']:.2f}s read + "
              f"{timings['write_s']:.2f}s write: "
              f"{', '.join(timings['files'])}")
    if res.status == "verified":
        write_manifest(step_dir, build_manifest(step_dir, step=step,
                                                topology=new_topo))
        after = verify_step_dir(step_dir, deep=True)
        if after.status != "verified":
            return _fail(f"re-stamp left step {step} unverified "
                         f"({'; '.join(after.failures[:3])})")
        print("  manifest  re-committed, step re-verified")
    else:
        print("  manifest  none (legacy step) — meta.json rewritten only")
    pp_hint = f" distributed.pp_size={pp_new}" if pp_new != pp_old else ""
    if slices_new != slices_old:
        pp_hint += f" distributed.slices={slices_new}"
    print(f"resume with distributed.dp_size={plan.dp_new}{pp_hint} "
          f"training.micro_batch_size={plan.micro_batch_size} "
          f"training.gradient_accumulation_steps="
          f"{plan.gradient_accumulation_steps} (checkpoint.elastic not "
          f"required: the store now records this topology)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
