"""Log -> CSV benchmark harvester (the port's copy of
tools/extract_metrics.py):

    python -m picotron_tpu_torch.tools.extract_metrics EXP_DIR \
        [--skip-steps 3]

Walks an experiment directory (one subdirectory per run, as
`tools.create_config` writes them) and harvests each run's per-step
metrics: from the run's `telemetry.jsonl` when it has one (the trainer
writes it next to the checkpoints: full float precision, plus the
goodput % from the stream's (category, secs) accounting and the
sentinel's alert count), else by the frozen regex over the console
line of `utils.training_log_line` (byte-compatible with the JAX
trainer's). Either way: the warm-up steps skipped, a per-run
`metrics.csv` and a sweep-level `global_metrics.csv`, the trailing
`extras` of the log line (e.g. `grad_norm`, `moe_drop_frac`) as mean_<key>
columns, and the layout decoded from directory names like
`dp8_tp2_pp1_cp1`. The CSVs are byte for byte the JAX tool's on the same
inputs.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
from statistics import mean

# Matches utils.training_log_line output.
LINE_RE = re.compile(
    r"\[step (?P<step>\d+)\] loss: (?P<loss>[\d.]+|-?nan|-?inf) \| "
    r"tokens/s: (?P<tps>[\d.]+[KMBT]?) \| "
    r"tokens/s/chip: (?P<tpsc>[\d.]+[KMBT]?) \| "
    r"MFU: (?P<mfu>[\d.]+)%"
)

NAME_RE = re.compile(r"(dp|tp|pp|cp)(\d+)")

# Optional trailing step metrics appended by training_log_line's `extras`
# (e.g. "| moe_drop_frac: 0.0123"): harvested into mean_<key> columns.
# The value must end the field (lookahead): the stable suffixed fields
# ("tokens: 10K", "mem: 1.0GB") must NOT be scooped up — their numeric
# prefix alone would be wrong (suffix dropped) and meaningless to average.
EXTRA_RE = re.compile(r"\| (?P<key>[a-z_]+): (?P<val>[\d.]+)(?= \||$)")
_EXTRA_SKIP = {"tokens", "mem"}

# Dedicated eval lines ("[eval  000010] val_loss: 5.6021 (8 batches)").
EVAL_RE = re.compile(r"\[eval  (?P<step>\d+)\] val_loss: (?P<val>[\d.]+)")

_SUFFIX = {"K": 1e3, "M": 1e6, "B": 1e9, "T": 1e12}


def parse_human(s: str) -> float:
    """'13.5K' -> 13500.0 (inverse of utils.human_format)."""
    if s and s[-1] in _SUFFIX:
        return float(s[:-1]) * _SUFFIX[s[-1]]
    return float(s)


def decode_run_name(name: str) -> dict:
    """'dp8_tp2_pp1_cp1_...' -> {'dp': 8, 'tp': 2, ...}
    (ref: extract_metrics.py:8-23)."""
    return {k: int(v) for k, v in NAME_RE.findall(name)}


def process_file(path: str, skip_steps: int = 3) -> dict | None:
    """Mean tokens/s/chip and MFU over post-warmup steps
    (ref: extract_metrics.py:83-89 skips the first 3 steps)."""
    rows = []
    val_losses = []
    with open(path) as f:
        for line in f:
            m = LINE_RE.search(line)
            if m:
                row = {
                    "step": int(m.group("step")),
                    "loss": float(m.group("loss")),
                    "tokens_per_sec": parse_human(m.group("tps")),
                    "tokens_per_sec_per_chip": parse_human(m.group("tpsc")),
                    "mfu_pct": float(m.group("mfu")),
                }
                for em in EXTRA_RE.finditer(line[m.end():].rstrip()):
                    if em.group("key") not in _EXTRA_SKIP:
                        row["extra_" + em.group("key")] = float(em.group("val"))
                rows.append(row)
            ev = EVAL_RE.search(line)
            if ev:
                val_losses.append(float(ev.group("val")))
    rows = [r for r in rows if r["step"] > skip_steps]
    if not rows:
        return None
    # A diverged run must be visible in the sweep, not silently dropped —
    # final_loss will read nan/inf.
    return _aggregate_rows(rows, val_losses)


_STABLE_STEP_FIELDS = {"ts", "kind", "step", "loss", "tokens_per_sec",
                       "tokens_per_sec_per_chip", "mfu", "trained_tokens",
                       "memory_gb", "line"}


# serve_summary fields harvested into serve_* CSV columns — the SLO
# numbers a serving sweep compares across runs (latency seconds scaled
# to ms to match the report tool).
_SERVE_FIELDS = (
    ("requests", "serve_requests", 1),
    ("output_tokens", "serve_output_tokens", 1),
    ("tokens_per_sec", "serve_tokens_per_sec", 1),
    ("ttft_p50_s", "serve_ttft_p50_ms", 1e3),
    ("ttft_p95_s", "serve_ttft_p95_ms", 1e3),
    ("tpot_p50_s", "serve_tpot_p50_ms", 1e3),
    ("tpot_p95_s", "serve_tpot_p95_ms", 1e3),
    ("acceptance_rate", "serve_acceptance_rate", 1),
    ("decode_stall_ticks_max", "serve_decode_stall_ticks_max", 1),
    ("handoffs", "serve_handoffs", 1),
    # fleet serving (serve/fleet.py): overload + failover counters
    ("shed", "serve_shed", 1),
    ("redispatched", "serve_redispatch", 1),
    ("engines_dead", "serve_engines_dead", 1),
    ("fleet_size", "serve_fleet_size", 1),
)


def process_telemetry(path: str, skip_steps: int = 3) -> dict | None:
    """The structured twin of process_file: per-step rows from a
    telemetry.jsonl's "step" records (same schema as the regex rows, so
    the aggregation below is shared) + the goodput % from the stream's
    (category, secs) accounting. Replayed step numbers (rollback /
    restart) keep only their LAST record — the one whose update survived
    into the final weights. Serving streams (no step rows, but a
    serve_summary event) yield serve_* columns instead, so a serving
    sweep harvests TTFT/TPOT/acceptance with the same tool."""
    rows_by_step: dict[int, dict] = {}
    val_losses: list[float] = []
    categories: dict[str, float] = {}
    serve_summary: dict | None = None
    sentinel_alerts = 0
    # A size-rotated stream (logging.telemetry_max_mb) keeps its older
    # half in `<path>.1`; read it first so replayed-step bookkeeping
    # (last record wins) sees events in emission order.
    segments = [p for p in (path + ".1", path) if os.path.exists(p)]
    for seg in segments or [path]:
        with open(seg) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    ev = json.loads(raw)
                except json.JSONDecodeError:
                    continue  # torn tail line of a killed run
                kind = ev.get("kind")
                secs = ev.get("secs")
                if ev.get("category") is not None \
                        and isinstance(secs, (int, float)):
                    categories[ev["category"]] = \
                        categories.get(ev["category"], 0.0) + secs
                if kind == "serve_summary":
                    serve_summary = ev  # last wins (mirrors telemetry_report)
                if kind == "sentinel_alert":
                    sentinel_alerts += 1
                if kind == "step" and "step" in ev:
                    row = {
                        "step": int(ev["step"]),
                        "loss": float(ev.get("loss", float("nan"))),
                        "tokens_per_sec": float(
                            ev.get("tokens_per_sec", 0.0)),
                        "tokens_per_sec_per_chip": float(
                            ev.get("tokens_per_sec_per_chip", 0.0)),
                        "mfu_pct": 100.0 * float(ev.get("mfu", 0.0)),
                    }
                    for k, v in ev.items():
                        if k not in _STABLE_STEP_FIELDS \
                                and isinstance(v, (int, float)):
                            row["extra_" + k] = float(v)
                    rows_by_step[row["step"]] = row
                elif kind == "eval" and "val_loss" in ev:
                    val_losses.append(float(ev["val_loss"]))
    rows = [r for _, r in sorted(rows_by_step.items())
            if r["step"] > skip_steps]
    serve_cols = {}
    if serve_summary:
        for src, dst, scale in _SERVE_FIELDS:
            val = serve_summary.get(src)
            if isinstance(val, (int, float)):
                serve_cols[dst] = round(val * scale, 4)
    if not rows:
        if not serve_cols:
            return None
        return serve_cols  # serving-only stream: no train-step rows
    out = _aggregate_rows(rows, val_losses)
    out.update(serve_cols)
    accounted = sum(categories.values())
    if accounted > 0:
        out["goodput_pct"] = round(
            100.0 * categories.get("compute", 0.0) / accounted, 2)
    # drift-sentinel alert count (telemetry/flightdeck): 0 on a clean
    # run — the column exists either way so sweeps can filter on it
    out["sentinel_alerts"] = sentinel_alerts
    return out


def _aggregate_rows(rows: list[dict], val_losses: list[float]) -> dict:
    """Shared row aggregation (regex and telemetry paths must stay
    column-compatible — global_metrics.csv mixes runs of both kinds)."""
    out = {
        "steps": len(rows),
        "final_loss": rows[-1]["loss"],
        "mean_tokens_per_sec": mean(r["tokens_per_sec"] for r in rows),
        "mean_tokens_per_sec_per_chip": mean(
            r["tokens_per_sec_per_chip"] for r in rows),
        "mean_mfu_pct": mean(r["mfu_pct"] for r in rows),
    }
    extra_keys = {k for r in rows for k in r if k.startswith("extra_")}
    for k in sorted(extra_keys):
        vals = [r[k] for r in rows if k in r]
        out["mean_" + k.removeprefix("extra_")] = mean(vals)
    if val_losses:
        out["final_val_loss"] = val_losses[-1]
    return out


def find_log(run_dir: str) -> str | None:
    for name in ("train.log", "log.txt", "stdout.log"):
        p = os.path.join(run_dir, name)
        if os.path.exists(p):
            return p
    logs = [f for f in os.listdir(run_dir) if f.endswith(".log")]
    return os.path.join(run_dir, logs[0]) if logs else None


def process_run(run_dir: str, skip_steps: int = 3) -> dict | None:
    """telemetry.jsonl when the run has one (checkpoint dir or run root —
    it sits next to the checkpoints), regex over the console log
    otherwise."""
    for sub in ("", "ckpt"):
        tpath = os.path.join(run_dir, sub, "telemetry.jsonl")
        if os.path.exists(tpath):
            stats = process_telemetry(tpath, skip_steps)
            if stats is not None:
                return stats
            break  # present but empty/torn: the log is the fallback
    log = find_log(run_dir)
    return process_file(log, skip_steps) if log else None


def aggregate(exp_dir: str, skip_steps: int = 3) -> list[dict]:
    results = []
    for name in sorted(os.listdir(exp_dir)):
        run_dir = os.path.join(exp_dir, name)
        if not os.path.isdir(run_dir):
            continue
        stats = process_run(run_dir, skip_steps)
        if stats is None:
            continue
        row = {"run": name, **decode_run_name(name), **stats}
        results.append(row)
        # per-run metrics.csv (ref: extract_metrics.py:91-99)
        with open(os.path.join(run_dir, "metrics.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            w.writeheader()
            w.writerow(row)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="harvest metrics from run logs")
    ap.add_argument("exp_dir", help="directory of runs (one subdir per run)")
    ap.add_argument("--skip-steps", type=int, default=3,
                    help="warmup steps to exclude (ref default: 3)")
    args = ap.parse_args(argv)

    results = aggregate(args.exp_dir, args.skip_steps)
    if not results:
        print(f"no parsable logs under {args.exp_dir}")
        return
    fields = sorted({k for r in results for k in r}, key=lambda k: (k != "run", k))
    out = os.path.join(args.exp_dir, "global_metrics.csv")
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in results:
            w.writerow(r)
    print(f"{len(results)} runs -> {out}")
    for r in results:
        if "mean_tokens_per_sec_per_chip" in r:
            print(f"  {r['run']}: {r['mean_tokens_per_sec_per_chip']:.0f} "
                  f"tok/s/chip, {r['mean_mfu_pct']:.1f}% MFU, "
                  f"loss {r['final_loss']:.3f}")
        else:  # serving-only run (serve_summary, no train steps)
            print(f"  {r['run']}: {r.get('serve_tokens_per_sec', 0)} tok/s, "
                  f"TTFT p50 {r.get('serve_ttft_p50_ms', 'n/a')} ms, "
                  f"acceptance {r.get('serve_acceptance_rate', 'n/a')}")


if __name__ == "__main__":
    main()
