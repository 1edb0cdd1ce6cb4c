"""Summarize a torch.profiler trace into a per-kernel device-time table
(the port's copy of tools/trace_summary.py):

    python -m picotron_tpu_torch.tools.trace_summary PROFILE_DIR \
        [--top 25] [--steps N] [--markdown]

Reads the newest `*.pt.trace.json` under the directory (what the
trainer's `logging.profile_dir` writes, `telemetry/profiler.py`), keeps
its device events that are kernels or copies, not ranges (the filter of
`profile_step.device_kernels`: a host range mirrored on the device track
is left out), and prints each kernel's total ms (per step with
--steps), its share of device time and its launch count, after the
steps the capture covers (its `train_step#N` annotations). A trace with
no device events (a CPU run) falls back to the host's operators, as the
JAX tool falls back to every process on a CPU-backend trace.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys
from types import SimpleNamespace

import torch

from picotron_tpu_torch.profile_step import device_kernels
from picotron_tpu_torch.telemetry.profiler import STEP_PREFIX, TRACE_SUFFIX

# Chrome-trace categories of the device track
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def newest_trace(trace_dir: str) -> str:
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", f"*{TRACE_SUFFIX}"),
                  recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", f"*{TRACE_SUFFIX}.gz"),
                    recursive=True),
        key=os.path.getmtime)
    if not paths:
        sys.exit(f"no *{TRACE_SUFFIX} under {trace_dir} — produce one with "
                 f"a training config's logging.profile_dir")
    return paths[-1]


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def summarize(events: list) -> dict:
    """{"steps": the step annotations' numbers, "device": "cuda" or
    "cpu", "kernels": {name: {"us": total, "launches": n}}}."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    recs = [SimpleNamespace(
        name=e["name"], dur=float(e["dur"]),
        device_type=(torch.autograd.DeviceType.CUDA
                     if e.get("cat") in _DEVICE_CATS
                     else torch.autograd.DeviceType.CPU)) for e in spans]
    steps = sorted({int(e["name"][len(STEP_PREFIX):]) for e in spans
                    if e["name"].startswith(STEP_PREFIX)
                    and e.get("cat") not in _DEVICE_CATS})
    chosen = device_kernels(recs)
    device = "cuda"
    if not chosen:
        device = "cpu"
        chosen = [r for r, e in zip(recs, spans) if e.get("cat") == "cpu_op"]
    kernels: dict = collections.defaultdict(lambda: {"us": 0.0,
                                                     "launches": 0})
    for r in chosen:
        kernels[r.name]["us"] += r.dur
        kernels[r.name]["launches"] += 1
    return {"steps": steps, "device": device, "kernels": dict(kernels)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="torch.profiler kernel summary")
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--steps", type=int, default=None,
                    help="divide durations by N to report per-step ms")
    ap.add_argument("--markdown", action="store_true",
                    help="emit the table as GitHub markdown")
    args = ap.parse_args(argv)

    path = newest_trace(args.trace_dir)
    s = summarize(load_events(path))
    if not s["kernels"]:
        sys.exit("no device or operator events found in the trace")
    grand = sum(k["us"] for k in s["kernels"].values())
    div = args.steps or 1
    unit = "ms/step" if args.steps else "ms total"
    rows = sorted(s["kernels"].items(), key=lambda kv: -kv[1]["us"])
    rows = rows[:args.top]
    if args.markdown:
        print(f"| share | {unit} | launches | kernel |")
        print("|---|---|---|---|")
        for name, k in rows:
            print(f"| {k['us'] / grand * 100:.1f}% | "
                  f"{k['us'] / 1e3 / div:.2f} | {k['launches']} "
                  f"| `{name[:90]}` |")
        return 0
    print(f"trace: {path}")
    print(f"steps: {s['steps']}")
    print(f"events: {s['device']} "
          + ("kernels and copies" if s["device"] == "cuda"
             else "operators (no device events in the trace)"))
    print(f"{'share':>6}  {unit:>12}  {'launches':>8}  kernel")
    for name, k in rows:
        print(f"{k['us'] / grand * 100:5.1f}%  {k['us'] / 1e3 / div:12.2f}  "
              f"{k['launches']:8d}  {name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
