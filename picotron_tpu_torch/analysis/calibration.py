"""Fit and validate the cost model against measured steps (port of
picotron_tpu/analysis/calibration.py).

A measured point is a Config and the tokens/s per chip it reached. The
port's own points are the h100 tier's: `h100_points.json` beside this
module, written from one `chip_smoke.py` run on the card (its
`cost_model` line: the main path, the fused path, the remat policies,
the offloaded optimizer and two Mixtral layers, each a config of the
repo with overrides, with the card's name and power limit).
`fit_calibration` fits the four constants single-card steps can
identify (dense-matmul efficiency curve, attention efficiency, offload
PCIe bandwidth) by coordinate descent on log step time, and
`rank_agreement` scores Spearman correlation between predicted and
measured tokens/s per source file: the cost model's job is ordering
layouts. `row_to_point` reads a bench row of the JAX package's format
(`mfu_<Model>-<L>L_seq<S>` metrics, an optional config string) as that
package does; the TPU rows are not a default of the port.
"""

from __future__ import annotations

import json
import math
import os
import re
from dataclasses import dataclass, replace
from typing import Iterable, Optional

from picotron_tpu_torch.analysis.cost_model import (
    Calibration, CostModel, DEFAULT_CALIBRATION, spearman,
)
from picotron_tpu_torch.config import (
    Config, ModelConfig, TrainingConfig, config_from_dict, resolve_preset,
)

_RE_METRIC = re.compile(r"^mfu_(.+)-(\d+)L_seq(\d+)")

# (model, layers, seq) -> training knobs of the JAX package's bench rows
# that predate its per-row config string (its bench.py SWEEP matrix as
# run in its rounds 3-4), so that those rows read as they do there
_LEGACY_SWEEP: dict[tuple, dict] = {
    ("SmolLM-360M", 32, 2048): dict(mbs=6, ga=1),
    ("SmolLM-1.7B", 8, 4096): dict(mbs=2, ga=1),
    ("SmolLM-1.7B", 4, 16384): dict(mbs=1, ga=1),
    ("SmolLM-1.7B", 8, 2048): dict(mbs=5, ga=1),
    ("SmolLM-1.7B", 24, 4096): dict(mbs=1, ga=64, offload=True,
                                    remat_policy="dots_attn"),
    ("SmolLM-1.7B", 24, 2048): dict(mbs=2, ga=64, offload=True,
                                    remat_policy="dots_attn"),
    ("Llama-2-7B", 4, 4096): dict(mbs=2, ga=16, offload=True,
                                  remat_policy="dots_attn"),
    ("Mixtral-8x7B", 1, 2048): dict(mbs=2, ga=64, offload=True,
                                    remat_policy="dots"),
}

# where the h100 tier's fit starts: round numbers near the card's ~30%
# MFU main path at hidden 2048, and pcie_bandwidth the link's pinned-copy
# rate with both directions streaming (chip_smoke.py link_rates, NVIDIA
# H100 80GB HBM3, 700 W), which the fit leaves as it is
FIT_START = Calibration(eff_max=0.6, h_half=2048.0, eff_attn=0.40,
                        pcie_bandwidth=32.8e9)
# the constants the card's points determine: only phase 6c streams over
# PCIe, and its ga-64 step hides the stream, so the fit would push
# pcie_bandwidth to the top of its grid, past the link's own rate
FIT_KEYS = ("eff_max", "h_half", "eff_attn")

H100_POINTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "h100_points.json")


@dataclass(frozen=True)
class MeasuredPoint:
    """One measured configuration: the Config it ran and what it achieved."""

    cfg: Config
    tokens_per_sec_per_chip: float
    metric: str
    source: str      # the file it came from (its rows rank together)
    mfu: Optional[float] = None


def _parse_config_string(s: str) -> dict:
    """mbs/ga/offload/remat out of a row's config string like
    'mbs3 ga43 dots_attn offload + fused grad engine'."""
    out: dict = {}
    m = re.search(r"\bmbs(\d+)\b", s)
    if m:
        out["mbs"] = int(m.group(1))
    m = re.search(r"\bga(\d+)\b", s)
    if m:
        out["ga"] = int(m.group(1))
    if "offload" in s:
        out["offload"] = True
    for pol in ("dots_attn", "dots_norms", "dots_lean", "dots_offload",
                "dots", "full"):
        if re.search(rf"\b{pol}\b", s):
            out["remat_policy"] = pol
            break
    return out


def row_to_point(row: dict, source: str) -> Optional[MeasuredPoint]:
    """A bench row of the JAX package's format -> MeasuredPoint, or None
    for rows that are not mfu measurements (decode rows, error rows)."""
    metric = row.get("metric", "")
    m = _RE_METRIC.match(metric)
    tps = row.get("tokens_per_sec_per_chip")
    if not m or not isinstance(tps, (int, float)) or tps <= 0:
        return None
    model, layers, seq = m.group(1), int(m.group(2)), int(m.group(3))
    try:
        preset = resolve_preset(model)
    except KeyError:
        return None
    knobs = dict(_LEGACY_SWEEP.get((model, layers, seq), {}))
    knobs.update(_parse_config_string(row.get("config", "")))
    preset["num_hidden_layers"] = layers
    preset["max_position_embeddings"] = max(
        preset.get("max_position_embeddings", seq), seq)
    cfg = Config(
        model=ModelConfig(name=model, **preset),
        training=TrainingConfig(
            seq_length=seq,
            micro_batch_size=knobs.get("mbs", 1),
            gradient_accumulation_steps=knobs.get("ga", 1),
            optimizer_offload=knobs.get("offload", False),
            remat_policy=knobs.get("remat_policy", "dots"),
            adam_moments_dtype="bfloat16",  # the bench default
        ),
    )
    cfg.validate()
    return MeasuredPoint(cfg, float(tps), metric, source,
                         mfu=row.get("value"))


def point_config(point: dict, root: Optional[str] = None) -> Config:
    """The Config of an h100 point: the repo config file it names, each
    section of its `overrides` updated over the file's."""
    path = os.path.join(root or _repo_root(), point["config"])
    with open(path) as f:
        raw = json.load(f)
    for section, vals in point.get("overrides", {}).items():
        raw.setdefault(section, {}).update(vals)
    return config_from_dict(raw)


def load_measured_rows(paths: Optional[Iterable[str]] = None,
                       root: Optional[str] = None) -> list[MeasuredPoint]:
    """MeasuredPoints from files of points: an h100 points file (a JSON
    object with a "points" list, each a repo config with overrides and
    its measured tokens/s per chip; default `H100_POINTS`), or lines of
    bench rows in the JAX package's format (`row_to_point`)."""
    points = []
    for path in (paths if paths is not None else [H100_POINTS]):
        name = os.path.basename(path)
        with open(path) as f:
            text = f.read()
        try:
            whole = json.loads(text)
        except json.JSONDecodeError:
            whole = None
        if isinstance(whole, dict) and "points" in whole:
            for p in whole["points"]:
                points.append(MeasuredPoint(
                    point_config(p, root), float(p["tokens_per_sec_per_chip"]),
                    p["label"], name, mfu=p.get("mfu")))
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row.get("parsed"), dict):
                row = row["parsed"]
            pt = row_to_point(row, name)
            if pt is not None:
                points.append(pt)
    return points


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------


def _sq_log_err(model: CostModel, points: list[MeasuredPoint]) -> float:
    err = 0.0
    for p in points:
        pred = model.predict(p.cfg).tokens_per_sec_per_chip
        err += math.log(pred / p.tokens_per_sec_per_chip) ** 2
    return err / len(points)


def fit_calibration(points: list[MeasuredPoint], generation=None,
                    start: Calibration = DEFAULT_CALIBRATION,
                    rounds: int = 3,
                    keys: tuple = ("eff_max", "h_half", "eff_attn",
                                   "pcie_bandwidth")) -> Calibration:
    """Coordinate-descent least squares (on log step time) over `keys`, of
    the four constants single-card rows can identify: eff_max, h_half,
    eff_attn, pcie_bandwidth (the h100 tier fits FIT_KEYS).
    Deterministic, a few hundred predictions."""
    if not points:
        return start
    space = {
        "eff_max": [start.eff_max * f for f in
                    (0.85, 0.95, 1.0, 1.05, 1.15)],
        "h_half": [start.h_half * f for f in (0.6, 0.8, 1.0, 1.25, 1.6)],
        "eff_attn": [0.28, 0.34, 0.40, 0.48, 0.58],
        "pcie_bandwidth": [start.pcie_bandwidth * f for f in
                           (0.6, 0.8, 1.0, 1.3, 1.7)],
    }
    space = {k: space[k] for k in keys}
    best = start
    best_err = _sq_log_err(CostModel(generation, best), points)
    for _ in range(rounds):
        for key, grid in space.items():
            for val in grid:
                cand = replace(best, **{key: val})
                err = _sq_log_err(CostModel(generation, cand), points)
                if err < best_err - 1e-12:
                    best, best_err = cand, err
    return best


# ---------------------------------------------------------------------------
# Validation: rank agreement per source
# ---------------------------------------------------------------------------


def rank_agreement(points: list[MeasuredPoint],
                   model: Optional[CostModel] = None) -> dict:
    """Spearman correlation between predicted and measured tokens/s per
    chip, per source file (each ranks internally) plus pooled. Sources
    with < 3 rows are skipped."""
    model = model or CostModel()
    by_src: dict[str, list[MeasuredPoint]] = {}
    for p in points:
        by_src.setdefault(p.source, []).append(p)
    out: dict = {"per_round": {}, "rows": []}
    all_pred, all_meas = [], []
    for src, pts in sorted(by_src.items()):
        pred = [model.predict(p.cfg).tokens_per_sec_per_chip for p in pts]
        meas = [p.tokens_per_sec_per_chip for p in pts]
        for p, pr in zip(pts, pred):
            out["rows"].append({
                "metric": p.metric, "source": src,
                "measured_tps_chip": round(p.tokens_per_sec_per_chip, 1),
                "predicted_tps_chip": round(pr, 1),
            })
        all_pred += pred
        all_meas += meas
        if len(pts) >= 3:
            out["per_round"][src] = round(spearman(pred, meas), 4)
    if len(all_meas) >= 3:
        out["pooled"] = round(spearman(all_pred, all_meas), 4)
    vals = out["per_round"].values()
    out["min_per_round"] = min(vals) if vals else None
    return out


# ---------------------------------------------------------------------------
# Telemetry-stream calibration hooks
# ---------------------------------------------------------------------------


def measured_step_seconds(events: list[dict]) -> Optional[dict]:
    """Per-step phase medians out of a telemetry.jsonl event list:
    {'step_s': median step-phase secs, 'sync_s': median sync-phase secs,
    'n_steps'} — the measured side of the `comm` row."""
    phases: dict[str, list[float]] = {}
    for e in events:
        if e.get("kind") == "phase" and isinstance(e.get("secs"),
                                                   (int, float)):
            phases.setdefault(e.get("phase", "?"), []).append(e["secs"])

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None

    if not phases.get("step"):
        return None
    return {"step_s": median(phases["step"]),
            "sync_s": median(phases.get("sync", [])),
            "n_steps": len(phases["step"])}
