"""fsck for a checkpoint save_dir (the port's copy of tools/ckpt_doctor.py):
verify the full lineage, optionally GC.

Walks every `step_<n>` directory and reports a per-step verdict:

  verified     durable (its `state/` renamed into place) and every file
               matches the commit manifest (bytes + content digest)
  legacy       durable, restorable, but without a commit manifest (no
               integrity claim beyond "meta.json parses")
  corrupt      manifest/meta torn, a listed file missing, or bytes/digest
               mismatch — the failing file is named
  not-durable  the save never finished (a crashed or in-flight write)

Exit code: 0 when no step is corrupt, 1 otherwise.

    python -m picotron_tpu_torch.tools.ckpt_doctor SAVE_DIR
    python -m picotron_tpu_torch.tools.ckpt_doctor SAVE_DIR --json
    python -m picotron_tpu_torch.tools.ckpt_doctor SAVE_DIR --markdown
    python -m picotron_tpu_torch.tools.ckpt_doctor SAVE_DIR --shallow
    python -m picotron_tpu_torch.tools.ckpt_doctor SAVE_DIR --gc \
        --keep-last 3 [--keep-every 1000] [--dry-run]

GC applies the trainer's retention policy (`ckpt_integrity.
retention_plan`) with its protection: the last verified step survives
whatever --keep-last says. The topology column is the layout a step
restores at (a step rewritten by `tools.elastic_resize` shows its new
one), as the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from picotron_tpu_torch.checkpoint import CheckpointManager
from picotron_tpu_torch.config import config_from_dict
from picotron_tpu_torch.resilience import elastic


def _manager(save_dir: str, keep_last: int = 0,
             keep_every: int = 0) -> CheckpointManager:
    cfg = config_from_dict({"checkpoint": {
        "save_dir": save_dir, "keep_last": keep_last,
        "keep_every": keep_every}})
    return CheckpointManager(cfg, directory=save_dir)


def scan(save_dir: str, deep: bool = True, only_step=None) -> list[dict]:
    """Per-step verdict rows, oldest first (`deep=False`: sizes only)."""
    mgr = _manager(save_dir)
    rows = []
    for step in mgr.steps():
        if only_step is not None and step != only_step:
            continue
        durable = mgr._is_durable(step)
        res = mgr.verify_step(step, deep=deep)
        if res.status == "corrupt":
            verdict = "corrupt"
        elif not durable:
            verdict = "not-durable"
        else:
            verdict = res.status  # verified | legacy
        man = res.manifest or {}
        rows.append({
            "step": step,
            "verdict": verdict,
            "durable": durable,
            "files": man.get("file_count"),
            "bytes": man.get("total_bytes"),
            "algo": man.get("algo"),
            "topology": elastic.saved_topology(mgr._step_dir(step)),
            "failures": list(res.failures),
        })
    return rows


def render(rows: list[dict], save_dir: str, markdown: bool = False) -> str:
    lines = []
    if markdown:
        lines.append(f"## ckpt_doctor — `{save_dir}`")
        lines.append("")
        lines.append("| step | verdict | topology | files | bytes | "
                     "failures |")
        lines.append("|---:|---|---|---:|---:|---|")
        for r in rows:
            fails = "; ".join(r["failures"][:3]) or ""
            topo = (elastic.describe_topology(r["topology"])
                    if r.get("topology") else "-")
            lines.append(f"| {r['step']} | {r['verdict']} | {topo} | "
                         f"{r['files'] or ''} | {r['bytes'] or ''} | "
                         f"{fails} |")
    else:
        lines.append(f"[ckpt_doctor] {save_dir}: {len(rows)} step dir(s)")
        for r in rows:
            topo = (elastic.describe_topology(r["topology"])
                    if r.get("topology") else "-")
            extra = (f"  ({r['files']} files, {r['bytes']} bytes, "
                     f"{r['algo']})" if r["files"] is not None else "")
            lines.append(f"  step {r['step']:>8d}  {r['verdict']:<11s} "
                         f"[{topo}]{extra}")
            for f in r["failures"][:5]:
                lines.append(f"           !! {f}")
            if len(r["failures"]) > 5:
                lines.append(f"           .. and "
                             f"{len(r['failures']) - 5} more")
    n_corrupt = sum(r["verdict"] == "corrupt" for r in rows)
    valid = [r["step"] for r in rows if r["verdict"] in ("verified",
                                                         "legacy")]
    tail = (f"{n_corrupt} corrupt, {len(valid)} restorable"
            + (f", latest valid step {max(valid)}" if valid else ""))
    lines.append(f"**{tail}**" if markdown else f"[ckpt_doctor] {tail}")
    return "\n".join(lines)


def run_gc(save_dir: str, keep_last: int, keep_every: int,
           dry_run: bool) -> dict:
    mgr = _manager(save_dir, keep_last=keep_last, keep_every=keep_every)
    return mgr.gc(dry_run=dry_run)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="verify a checkpoint save_dir's lineage; optional GC")
    ap.add_argument("save_dir", help="checkpoint directory "
                    "(contains step_<n> subdirs)")
    ap.add_argument("--step", type=int, default=None,
                    help="check only this step")
    ap.add_argument("--shallow", action="store_true",
                    help="existence+size checks only (skip content hashing)")
    fmt = ap.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true", help="JSON report")
    fmt.add_argument("--markdown", action="store_true",
                     help="markdown report")
    ap.add_argument("--gc", action="store_true",
                    help="apply the retention policy after the scan")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="GC: newest steps to keep (default 3)")
    ap.add_argument("--keep-every", type=int, default=0,
                    help="GC: additionally keep steps divisible by this")
    ap.add_argument("--dry-run", action="store_true",
                    help="GC: report the plan, delete nothing")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.save_dir):
        print(f"[ckpt_doctor] no such directory: {args.save_dir}",
              file=sys.stderr)
        return 2
    rows = scan(args.save_dir, deep=not args.shallow, only_step=args.step)
    gc_result = None
    if args.gc:
        if args.keep_last < 1:
            build_parser().error("--gc needs --keep-last >= 1")
        gc_result = run_gc(args.save_dir, args.keep_last, args.keep_every,
                           args.dry_run)
        if not args.dry_run:  # the report shows what survived
            rows = [r for r in rows if r["step"] in gc_result["kept"]]
    if args.json:
        print(json.dumps({"save_dir": args.save_dir, "steps": rows,
                          "gc": gc_result}, indent=2))
    else:
        print(render(rows, args.save_dir, markdown=args.markdown))
        if gc_result is not None:
            verb = "would delete" if args.dry_run else "deleted"
            print(f"[ckpt_doctor] gc: kept {gc_result['kept']}, {verb} "
                  f"{gc_result['deleted']}")
    return 1 if any(r["verdict"] == "corrupt" for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
