"""The port's layout planner (picotron_tpu_torch/analysis/planner.py and
`python -m picotron_tpu_torch.tools.layout_planner`), case for case with
tests/test_layout_planner.py where the function is ported, on the CPU:
the search ranks deterministically, holds the global batch, prunes what
cannot fit, and on the JAX package's own torus descriptor gives the JAX
planner's candidates and ranked labels. The memcheck verification and
the traced re-pricing are JAX-only or ROADMAP Queue 1 item 13b: their
cases are replaced by h100 tier cases (the refusal, slice plans on the
IB tier)."""

import dataclasses
import json
import math
import os

import pytest

from picotron_tpu import config as jcfg
from picotron_tpu.analysis import cost_model as jcm
from picotron_tpu.analysis import planner as jplan
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch.analysis.cost_model import (
    Calibration, CostModel, IciGeneration,
)
from picotron_tpu_torch.analysis.planner import (
    _HBM_MARGIN, best_point, candidate_configs, estimate_hbm_gib, plan,
    planner_gap, slice_plans, verify_hbm,
)
from picotron_tpu_torch.config import (
    DistributedConfig, TrainingConfig, config_from_dict, load_config,
)
from picotron_tpu_torch.tools import layout_planner as lp

ROOT = os.path.join(os.path.dirname(__file__), "..")


def tiny_base(ga=8, mbs=1, seq=64, model="debug-tiny", mod=None):
    mod = mod or tcfg
    cfg = mod.Config(
        distributed=mod.DistributedConfig(),
        model=mod.ModelConfig(name=model, **mod.resolve_preset(model)),
        training=mod.TrainingConfig(seq_length=seq, micro_batch_size=mbs,
                                    gradient_accumulation_steps=ga),
    )
    cfg.validate()
    return cfg


def torus(gen="v5e"):
    """The port's model on the JAX package's descriptor and calibration."""
    return CostModel(IciGeneration(**dataclasses.asdict(
        jcm.GENERATIONS[gen])), Calibration(**dataclasses.asdict(
            jcm.DEFAULT_CALIBRATION)))


# ---------------------------------------------------------------------------
# enumeration + ranking
# ---------------------------------------------------------------------------


def test_candidates_cover_axes_and_hold_global_batch():
    base = tiny_base(ga=8)
    gb = base.global_batch_size
    cands = candidate_configs(base, 8)
    assert len(cands) > 20
    layouts = {(c.distributed.dp_size, c.distributed.tp_size,
                c.distributed.pp_size, c.distributed.cp_size)
               for c in cands}
    assert (8, 1, 1, 1) in layouts and (1, 2, 4, 1) in layouts
    for c in cands:
        assert c.distributed.world_size == 8
        assert c.global_batch_size == gb, c
    assert all(c.distributed.ep_size == 1 for c in cands)
    moe = candidate_configs(tiny_base(model="debug-tiny-moe"), 8)
    assert any(c.distributed.ep_size > 1 for c in moe)
    # the JAX planner's candidate set, config for config
    want = jplan.candidate_configs(tiny_base(ga=8, mod=jcfg), 8)
    assert [dataclasses.asdict(c) for c in cands] == \
        [dataclasses.asdict(c) for c in want]


def test_invalid_layouts_are_skipped():
    cands = candidate_configs(tiny_base(), 8)
    assert all(c.distributed.tp_size <= 2 for c in cands)
    assert all(c.distributed.pp_size <= 4 for c in cands)


def test_plan_enumerates_mpmd_and_overrides_round_trip():
    pts = plan(tiny_base(), 8)
    mpmd_pts = [p for p in pts if "mpmd" in p.label]
    assert mpmd_pts, [p.label for p in pts]
    assert any("interleaved" in p.label for p in mpmd_pts)
    assert any("mpmd-1f1b" in p.label for p in mpmd_pts)

    point = next(p for p in mpmd_pts if "interleaved" in p.label)
    line = point.overrides_line()
    assert "pipeline.executor=mpmd" in line
    assert "pipeline.schedule=interleaved" in line
    raw = {"model": {"name": "debug-tiny"},
           "training": {"seq_length": 64, "micro_batch_size": 1,
                        "gradient_accumulation_steps": 8}}
    for ov in line.split()[1:]:
        dotted, _, val = ov.partition("=")
        node = raw
        *path, key = dotted.split(".")
        for part in path:
            node = node.setdefault(part, {})
        try:
            node[key] = json.loads(val)
        except ValueError:
            node[key] = val
    cfg = config_from_dict(raw)  # validates
    assert cfg.pipeline.executor == "mpmd"
    assert cfg.pipeline.schedule == "interleaved"
    assert cfg.pipeline.interleave >= 2
    assert cfg.distributed.pp_size == point.cfg.distributed.pp_size


@pytest.mark.parametrize("gen", ["v5e", "v5p"])
def test_plan_ranks_and_is_deterministic(gen):
    """Ranked by time per token, the same on a second call, and on the JAX
    package's descriptor the JAX planner's labels in its order."""
    base = tiny_base()
    model = torus(gen)
    pts = plan(base, 8, model)
    assert pts, "8 GPUs of debug-tiny must have feasible layouts"
    times = [p.cost.total_s for p in pts]
    assert times == sorted(times)
    assert [p.label for p in pts] == [p.label for p in plan(base, 8, model)]
    for p in pts:
        assert p.hbm_fits
        assert math.isfinite(p.cost.total_s) and p.cost.total_s > 0
    want = jplan.plan(tiny_base(mod=jcfg), 8, jcm.CostModel(gen))
    assert [p.label for p in pts] == [p.label for p in want]
    h100 = plan(base, 8)
    assert [p.cost.total_s for p in h100] == sorted(
        p.cost.total_s for p in h100)


def test_hbm_prune_rejects_what_cannot_fit():
    base = tiny_base()
    assert plan(base, 8, hbm_gib=1e-5) == []
    pts = plan(base, 8, hbm_gib=1e-5, include_infeasible=True)
    assert pts and not any(p.hbm_fits for p in pts)


def test_estimate_hbm_monotone_in_sharding():
    whole = estimate_hbm_gib(tiny_base())
    tp2 = estimate_hbm_gib(tiny_base().replace(
        distributed=DistributedConfig(tp_size=2)))
    assert tp2 < whole
    off = estimate_hbm_gib(tiny_base().replace(
        training=TrainingConfig(seq_length=64, optimizer_offload=True)))
    assert off < whole


def test_planner_gap_flags_slow_layout():
    cfg = tiny_base().replace(
        distributed=DistributedConfig(tp_size=2, cp_size=4))
    cur, best, gap = planner_gap(cfg)
    assert best is not None
    assert gap >= 0.0
    assert best.cost.total_s <= cur.total_s


# ---------------------------------------------------------------------------
# replaced: memcheck (JAX-only) and the traced re-pricing (item 13b)
# ---------------------------------------------------------------------------


def test_winner_passes_memcheck_and_rejected_points_are_skipped(capsys):
    """memcheck is JAX-only: verify_hbm refuses naming it (and so does
    the CLI's --verify-hbm); without it the winner is the first point
    that fits the h100 tier's 80 GB, and a capacity under a point's
    estimate marks it infeasible."""
    pts = plan(tiny_base(ga=2), 8)
    with pytest.raises(NotImplementedError, match="memcheck"):
        verify_hbm(pts[0], 80.0)
    with pytest.raises(NotImplementedError, match="memcheck"):
        best_point(pts, verify=True)
    winner = best_point(pts)
    assert winner is pts[0] and winner.hbm_fits
    assert winner.hbm_est_gib <= CostModel().gen.hbm_gib * _HBM_MARGIN
    assert lp.main(["--chips", "8", "--model", "debug-tiny", "--seq", "64",
                    "--verify-hbm"]) == 2
    assert "memcheck" in capsys.readouterr().err


def test_reprice_traced_top_points():
    """Replaces the traced re-pricing (item 13b): on the h100 tier a slice
    (node) cut on dp prices its cross leg at the IB rate, its in-node leg
    on NVLink, and dp absorbs the cut where pp cannot."""
    cfg = tiny_base().replace(distributed=DistributedConfig(dp_size=16))
    rows = slice_plans(cfg, n_slices=2)
    assert [r["axis"] for r in rows] == ["dp"]
    r = rows[0]
    assert r["generation"] == "h100"
    assert r["crossing_terms"] == ["grad_sync"]
    # the cross leg: an all-reduce of one eighth of the grads (the shard
    # each of the 8 in-node ranks holds) between 2 nodes at 50 GB/s + 5 us
    grads = next(t for t in CostModel().predict(cfg).comm
                 if t.name == "grad_sync").bytes_each
    shard = grads / 8
    assert r["dcn_bytes"] == int(shard)
    assert r["dcn_ms"] == pytest.approx(
        (2 * shard / 2 / 50e9 + 5e-6) * 1e3, abs=1e-4)
    # the in-node leg: the whole buffer over 8 ranks on NVLink
    assert r["ici_ms"] == pytest.approx(
        (2 * grads * 7 / 8 / 450e9 + 7 * 1e-6) * 1e3, abs=1e-4)
    assert slice_plans(tiny_base(), n_slices=2) == []


# ---------------------------------------------------------------------------
# the CLI + the runs/ presets
# ---------------------------------------------------------------------------


def test_cli_plan_chips8(capsys):
    rc = lp.main(["--chips", "8", "--model", "debug-tiny", "--seq", "64",
                  "--top", "5", "--json"])
    assert rc == 0
    rows = [json.loads(l) for l in
            capsys.readouterr().out.strip().splitlines()]
    assert 1 <= len(rows) <= 5
    assert rows[0]["predicted_step_ms"] > 0
    assert rows[0]["generation"] == "h100"
    assert rows[0]["overrides"].startswith("--override ")
    steps = [r["predicted_step_ms"] for r in rows]
    assert steps == sorted(steps)


def test_cli_validate_sweep_reproduces_measured_ranking(capsys):
    """--validate-sweep on the card's points: every point ranked, and
    --fit refits the committed calibration from them."""
    assert lp.main(["--validate-sweep", "--json"]) == 0
    ra = json.loads(capsys.readouterr().out)
    assert list(ra["per_round"]) == ["h100_points.json"]
    assert len(ra["rows"]) >= 10
    assert lp.main(["--validate-sweep", "--fit", "--json"]) == 0
    fit = json.loads(capsys.readouterr().out)["calibration"]
    default = Calibration()
    for key in ("eff_max", "h_half", "eff_attn", "pcie_bandwidth"):
        assert fit[key] == pytest.approx(getattr(default, key), rel=1e-9)


def test_cli_markdown_table(capsys):
    rc = lp.main(["--chips", "8", "--model", "debug-tiny", "--seq", "64",
                  "--markdown", "--top", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "| rank | layout |" in out
    assert "predicted fastest:" in out


RUN_PRESETS = sorted(
    d for d in os.listdir(os.path.join(ROOT, "runs"))
    if os.path.isfile(os.path.join(ROOT, "runs", d, "config.json")))


@pytest.mark.parametrize("preset", RUN_PRESETS)
def test_cost_model_prices_every_runs_preset(preset):
    """Every preset prices to a finite step with a sane decomposition on
    the h100 tier, and the planner finds a layout at its world size."""
    cfg = load_config(os.path.join(ROOT, "runs", preset, "config.json"))
    cost = CostModel().predict(cfg)
    assert math.isfinite(cost.total_s) and cost.total_s > 0
    assert cost.compute_s > 0
    assert cost.exposed_comm_s >= 0
    if cfg.distributed.world_size > 1:
        assert cost.comm, f"{preset}: multi-GPU layout priced zero comm"
        cur, best, gap = planner_gap(cfg)
        assert best is not None, f"{preset}: planner found no layout"
        assert math.isfinite(gap)
        if gap < 0:
            assert estimate_hbm_gib(cfg) > \
                CostModel().gen.hbm_gib * _HBM_MARGIN, preset


def test_shardcheck_cli_cost_smoke(capsys):
    """Replaces the shardcheck --cost smoke (item 13b): the CLI's tables
    on the h100 tier — the tp strategy table with its adaptive column,
    and the cp flavours' crossover."""
    assert lp.main(["--tp-strategy-table", "--model", "Llama-3.1-8B",
                    "--seq", "8192", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert [r["tp"] for r in rows] == [2, 4, 8]
    assert all(r["generation"] == "h100" and r["adaptive"] for r in rows)
    assert lp.main(["--cp-crossover", "--model", "Llama-3.1-8B", "--seq",
                    "8192", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["generation"] == "h100" and out["rows"]
