"""The port's cost model (picotron_tpu_torch/analysis/) against the JAX
package's, case for case with tests/test_cost_model.py where the function
is ported, on the CPU (pure arithmetic).

- The torus tier, built from each of the JAX package's own GENERATIONS
  descriptors and run under the JAX calibration, equals the JAX model to
  1e-12 relative on every runs/ preset and on debug-tiny at several
  layouts: predict's total and comm terms, collective_secs,
  price_kv_handoff, choose_tp_strategy, tp_strategy_table and
  estimate_hbm_gib; fit_calibration gives the JAX constants on the JAX
  package's SWEEP rows (1e-9), rank_agreement its table.
- The h100 tier: an axis inside a node of 8 is one NVLink hop whatever
  its size, an axis that crosses nodes runs at the InfiniBand rate; the
  committed calibration is the fit of analysis/h100_points.json from
  FIT_START over FIT_KEYS (pcie_bandwidth stays the link's measured
  rate), and every measured point there is predicted within 2x (in
  sample: those are the points it was fitted on).
- Cases that pin JAX-only behaviour (TPU device kinds, the traced
  schedule's pricing and its audit, ROADMAP Queue 1 item 13b) are
  replaced by h100 tier cases.
"""

import dataclasses
import glob
import importlib.util
import math
import os

import pytest

from picotron_tpu import config as jcfg
from picotron_tpu.analysis import calibration as jcal
from picotron_tpu.analysis import cost_model as jcm
from picotron_tpu.analysis import planner as jplan
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch.analysis import calibration as tcal
from picotron_tpu_torch.analysis import planner as tplan
from picotron_tpu_torch.analysis.cost_model import (
    H100, AxisLink, Calibration, CostModel, IciGeneration, line_diameter,
    place_axes, resolve_generation, ring_diameter, spearman,
    with_calibration,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = sorted(glob.glob(os.path.join(ROOT, "runs", "*", "config.json")))
GENS = {name: IciGeneration(**dataclasses.asdict(g))
        for name, g in jcm.GENERATIONS.items()}
JCAL = Calibration(**dataclasses.asdict(jcm.DEFAULT_CALIBRATION))


def torus(gen="v5e", calib=JCAL):
    """The port's model on the JAX package's descriptor and calibration."""
    return CostModel(GENS[gen], calib)


def mkcfg(model="debug-tiny", seq=64, mbs=1, ga=1, dist=None, train=None,
          mod=tcfg, heads=None):
    preset = mod.resolve_preset(model)
    if heads:
        preset.update(num_attention_heads=heads[0],
                      num_key_value_heads=heads[1])
    cfg = mod.Config(
        distributed=mod.DistributedConfig(**(dist or {})),
        model=mod.ModelConfig(name=model, **preset),
        training=mod.TrainingConfig(seq_length=seq, micro_batch_size=mbs,
                                    gradient_accumulation_steps=ga,
                                    **(train or {})),
    )
    cfg.validate()
    return cfg


# debug-tiny layouts the parity test prices beside the runs/ presets
TINY_LAYOUTS = [
    dict(dist=dict(dp_size=2, tp_size=2, pp_size=2), ga=4),
    dict(dist=dict(tp_size=2, dp_size=2, sequence_parallel=True), ga=2),
    dict(dist=dict(tp_size=4, tp_strategy="2d", tp_mesh="2x2"),
         heads=(8, 4), ga=2),
    dict(dist=dict(tp_size=4, tp_strategy="adaptive", dp_size=4),
         heads=(8, 4), ga=2),
    dict(dist=dict(tp_size=2, tp_strategy="adaptive"), ga=2),
    dict(dist=dict(cp_size=4, cp_flavor="mesh", cp_mesh="2x2"), ga=2),
    dict(dist=dict(dp_size=2, zero1=True), ga=2,
         train=dict(optimizer_offload=True)),
    dict(model="debug-tiny-moe", dist=dict(ep_size=2, dp_size=2), ga=2),
]


def _pairs():
    """(JAX config, port config) for every runs/ preset and TINY_LAYOUTS."""
    out = [(jcfg.load_config(p), tcfg.load_config(p)) for p in RUNS]
    for kw in TINY_LAYOUTS:
        out.append((mkcfg(mod=jcfg, **kw), mkcfg(**kw)))
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# parity with the JAX model on its own descriptors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen", sorted(jcm.GENERATIONS))
def test_torus_tier_equals_jax(gen):
    jm, tm = jcm.CostModel(gen), torus(gen)
    for jc, tc in _pairs():
        a, b = jm.predict(jc), tm.predict(tc)
        assert _rel(b.total_s, a.total_s) <= 1e-12, (gen, b.config_label)
        assert [(t.name, t.kind, t.axes, t.count) for t in b.comm] == \
            [(t.name, t.kind, t.axes, t.count) for t in a.comm]
        for x, y in zip(b.comm, a.comm):
            assert _rel(x.secs_total, y.secs_total) <= 1e-12, x.name
        assert b.as_dict() == a.as_dict()
        hs, hb = tm.price_kv_handoff(tc.model, n_tokens=300, hops=2)
        js, jb = jm.price_kv_handoff(jc.model, n_tokens=300, hops=2)
        assert hb == jb and _rel(hs, js) <= 1e-12
        assert _rel(tplan.estimate_hbm_gib(tc),
                    jplan.estimate_hbm_gib(jc)) <= 1e-12
        if tc.distributed.tp_size > 1:
            assert tcfg.resolved_tp_strategy(
                tc, generation=GENS[gen], calibration=JCAL) == \
                jcfg.resolved_tp_strategy(jc, generation=gen)
        jl, tl = jm.axes_for(jc), tm.axes_for(tc)
        for ax, link in jl.items():
            for kind in ("all_gather", "all_reduce", "all_to_all",
                         "collective_permute"):
                assert _rel(tm.collective_secs(kind, 3e8, tl[ax]),
                            jm.collective_secs(kind, 3e8, link)) <= 1e-12
    base = jcfg.load_config(os.path.join(ROOT, "runs",
                                         "llama3-8b-4d-v5p64", "config.json"))
    tbase = tcfg.load_config(os.path.join(ROOT, "runs",
                                          "llama3-8b-4d-v5p64",
                                          "config.json"))
    from picotron_tpu_torch.analysis.cost_model import tp_strategy_table

    assert tp_strategy_table(tm, tbase) == [
        dict(r, generation=gen) for r in jcm.tp_strategy_table(jm, base)]


def test_fit_and_rank_agreement_equal_jax_on_its_sweeps():
    jpts = jcal.load_measured_rows()
    tpts = tcal.load_measured_rows(sorted(glob.glob(os.path.join(
        ROOT, "SWEEP_r*.jsonl"))))
    assert [(p.metric, p.source, p.tokens_per_sec_per_chip) for p in tpts] \
        == [(p.metric, p.source, p.tokens_per_sec_per_chip) for p in jpts]
    for jp, tp in zip(jpts, tpts):
        assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(jp.cfg)
    got = tcal.fit_calibration(tpts, GENS["v5e"], start=JCAL)
    want = jcal.fit_calibration(jpts, "v5e")
    for key in ("eff_max", "h_half", "eff_attn", "pcie_bandwidth"):
        assert _rel(getattr(got, key), getattr(want, key)) <= 1e-9, key
    assert tcal.rank_agreement(tpts, torus()) == jcal.rank_agreement(jpts)


# ---------------------------------------------------------------------------
# hop counts + placement (tests/test_cost_model.py's cases)
# ---------------------------------------------------------------------------


def test_ring_vs_line_diameters():
    assert ring_diameter(8) == 4
    assert ring_diameter(16) == 8
    assert ring_diameter(3) == 1
    assert line_diameter(8) == 7
    assert line_diameter(2) == 1


def test_generation_wrap_rule():
    v5e = place_axes({"tp": 8}, GENS["v5e"])["tp"]
    v5p = place_axes({"tp": 8}, GENS["v5p"])["tp"]
    assert v5e.kind == "line" and v5e.diameter == 7
    assert v5p.kind == "ring" and v5p.diameter == 4
    assert place_axes({"tp": 16}, GENS["v5e"])["tp"].kind == "ring"


def test_placement_innermost_axes_get_dedicated_dims():
    links = place_axes({"dp": 2, "tp": 4, "cp": 2, "pp": 1, "ep": 1},
                       GENS["v5e"])
    assert links["tp"].stride == 1 and links["cp"].stride == 1
    assert links["dp"].stride > 1
    assert links["dp"].bandwidth < links["tp"].bandwidth
    assert "pp" not in links and "ep" not in links


def test_v5p_three_axes_fit_without_folding():
    links = place_axes({"dp": 2, "tp": 4, "cp": 2, "pp": 1, "ep": 1},
                       GENS["v5p"])
    assert all(l.stride == 1 for l in links.values())


def test_resolve_generation_from_device_kind():
    """Replaces the JAX TPU-kind case: a card's name, the CPU and any
    unknown kind resolve to the h100 tier; a descriptor passes through."""
    assert resolve_generation("NVIDIA H100 80GB HBM3").name == "h100"
    assert resolve_generation("cpu").name == "h100"
    assert resolve_generation(None) is H100
    assert resolve_generation(GENS["v4"]) is GENS["v4"]
    assert CostModel().gen.name == "h100"


# ---------------------------------------------------------------------------
# per-collective formulas (byte volumes pinned, alpha removed)
# ---------------------------------------------------------------------------


def _no_latency(gen=None):
    return CostModel(gen or GENS["v5e"], Calibration(alpha_link_s=0.0))


def test_collective_byte_volume_factors():
    cm = _no_latency()
    bw = 45e9
    ring = AxisLink("tp", 4, "ring", bw, 1)
    v = 1e9
    ag = cm.collective_secs("all_gather", v, ring)
    assert ag == pytest.approx(v * 3 / 4 / (2 * bw))
    assert cm.collective_secs("reduce_scatter", v, ring) == pytest.approx(ag)
    assert cm.collective_secs("all_reduce", v, ring) == pytest.approx(2 * ag)
    assert cm.collective_secs("collective_permute", v, ring) == \
        pytest.approx(v / bw)
    assert cm.collective_secs("all_to_all", v, ring) == \
        pytest.approx(v * 4 / (4 * 2 * bw))


def test_line_pays_more_than_ring():
    cm = _no_latency()
    bw = 45e9
    ring = AxisLink("cp", 8, "ring", bw, 1)
    line = AxisLink("cp", 8, "line", bw, 1)
    for kind in ("all_gather", "all_reduce", "all_to_all",
                 "collective_permute"):
        assert cm.collective_secs(kind, 1e9, line) > \
            cm.collective_secs(kind, 1e9, ring)
    assert cm.collective_secs("collective_permute", 1e9, line) == \
        pytest.approx(1e9 * 7 / bw)


def test_size_one_axis_costs_nothing():
    cm = _no_latency()
    one = AxisLink("tp", 1, "line", 45e9, 1)
    assert cm.collective_secs("all_reduce", 1e9, one) == 0.0


def test_price_ops_matches_axes():
    """Replaces the traced-op pricing case (item 13b): on the h100 tier an
    axis whose ranks stay in a node of 8 is one NVLink hop whatever its
    size, and the first axis that crosses the node runs at the IB rate
    with its own latency."""
    for n in (2, 4, 8):
        link = place_axes({"tp": n}, H100)["tp"]
        assert (link.kind, link.bandwidth, link.diameter) == (
            "switch", 450e9, 1)
    links = place_axes({"tp": 4, "cp": 2, "dp": 4}, H100)
    assert links["tp"].bandwidth == links["cp"].bandwidth == 450e9
    assert links["dp"].bandwidth == 50e9            # 4 x 2 x 4 > 8
    assert links["dp"].alpha == H100.ib_alpha_s
    assert place_axes({"tp": 16}, H100)["tp"].bandwidth == 50e9
    # priced: an in-node all-reduce at 8 ranks is one hop's volume, the
    # same payload across nodes pays the IB rate
    cm = _no_latency(H100)
    v = 1e9
    in_node = cm.collective_secs("all_reduce", v, place_axes(
        {"tp": 8}, H100)["tp"])
    assert in_node == pytest.approx(2 * v * 7 / 8 / 450e9)
    across = CostModel(H100, Calibration(alpha_link_s=0.0)).collective_secs(
        "all_reduce", v, links["dp"], alpha=0.0)
    assert across == pytest.approx(2 * v * 3 / 4 / 50e9)


def test_priced_schedule_from_lowered_text():
    """Replaces the lowered-schedule case (item 13b): the switched
    formulas — one direction per collective, an all-to-all sends
    (n-1)/n of its payload once, a neighbour shift is one hop."""
    cm = _no_latency(H100)
    sw = AxisLink("cp", 8, "switch", 450e9, 1)
    v = 1e9
    assert cm.collective_secs("all_gather", v, sw) == \
        pytest.approx(v * 7 / 8 / 450e9)
    assert cm.collective_secs("all_to_all", v, sw) == \
        pytest.approx(v * 7 / 8 / 450e9)
    assert cm.collective_secs("collective_permute", v, sw) == \
        pytest.approx(v / 450e9)
    # a 2D split of a switched axis keeps both legs on the full link
    from picotron_tpu_torch.analysis.cost_model import split_cp_link

    outer, inner = split_cp_link(sw, 2, 4, H100)
    assert (outer.size, inner.size) == (2, 4)
    assert outer.bandwidth == inner.bandwidth == 450e9


# ---------------------------------------------------------------------------
# analytic step prediction
# ---------------------------------------------------------------------------


def test_predict_decomposition_consistency():
    cfg = mkcfg(dist=dict(dp_size=2, tp_size=2, pp_size=2), ga=4)
    for cm in (torus(), CostModel()):
        cost = cm.predict(cfg)
        assert cost.n_chips == 8
        assert cost.compute_s > 0
        assert cost.bubble_s == pytest.approx(cost.compute_s * 2 / 4)
        assert cost.total_s >= cost.compute_s + cost.bubble_s
        assert cost.exposed_comm_s <= cost.comm_s
        names = {t.name for t in cost.comm}
        assert "grad_sync" in names and "tp_psum" in names
        assert "pp_boundary" in names
        d = cost.as_dict()
        assert d["predicted_step_ms"] == pytest.approx(cost.total_s * 1e3,
                                                       abs=5e-4)


def test_predict_mpmd_bubble_and_label():
    from picotron_tpu_torch.analysis.cost_model import layout_label
    from picotron_tpu_torch.config import PipelineConfig

    base = mkcfg(dist=dict(dp_size=2, tp_size=2, pp_size=2), ga=4)
    cm = CostModel()
    spmd = cm.predict(base)
    for pl, v in [(PipelineConfig(executor="mpmd"), 1),
                  (PipelineConfig(executor="mpmd", schedule="interleaved",
                                  interleave=2), 2)]:
        cfg = dataclasses.replace(base, pipeline=pl)
        cfg.validate()
        cost = cm.predict(cfg)
        assert cost.compute_s == pytest.approx(spmd.compute_s)
        dispatch = 2 * 4 * 2 * v * cm.calib.host_dispatch_s
        assert cost.bubble_s == pytest.approx(
            cost.compute_s * 1 / (v * 4) + dispatch)
        assert "mpmd" in layout_label(cfg)
    assert "v2" in layout_label(dataclasses.replace(
        base, pipeline=PipelineConfig(executor="mpmd",
                                      schedule="interleaved", interleave=2)))
    free = with_calibration(cm, host_dispatch_s=0.0)
    cfg = dataclasses.replace(base, pipeline=PipelineConfig(executor="mpmd"))
    assert free.predict(cfg).bubble_s == pytest.approx(spmd.bubble_s / 2)


def test_predict_prices_every_promised_axis():
    cfg = mkcfg(model="debug-tiny-moe", dist=dict(ep_size=2, dp_size=2),
                ga=2)
    assert "ep_dispatch" in {t.name for t in CostModel().predict(cfg).comm}
    cfg = mkcfg(dist=dict(cp_size=4), ga=2)
    assert "cp_ring" in {t.name for t in CostModel().predict(cfg).comm}
    cfg = mkcfg(dist=dict(tp_size=2, dp_size=2, sequence_parallel=True),
                ga=2)
    names = {t.name for t in CostModel().predict(cfg).comm}
    assert "sp_gather" in names and "sp_scatter" in names


def test_offload_term_scales_with_params_and_pcie():
    cfg = mkcfg(ga=4, train=dict(optimizer_offload=True))
    base = CostModel().predict(cfg)
    assert base.offload_s > 0
    slow = with_calibration(CostModel(), pcie_bandwidth=1e9).predict(cfg)
    assert slow.offload_s > base.offload_s


def test_dp_weak_scaling():
    one = CostModel().predict(mkcfg())
    eight = CostModel().predict(mkcfg(dist=dict(dp_size=8)))
    assert eight.tokens_per_step == 8 * one.tokens_per_step
    assert eight.compute_s == pytest.approx(one.compute_s)
    assert eight.tokens_per_sec > one.tokens_per_sec


# ---------------------------------------------------------------------------
# spearman + calibration data plumbing
# ---------------------------------------------------------------------------


def test_spearman_basics():
    assert spearman([1, 2, 3, 4], [10, 20, 30, 40]) == pytest.approx(1.0)
    assert spearman([1, 2, 3, 4], [40, 30, 20, 10]) == pytest.approx(-1.0)
    assert abs(spearman([1, 2, 3, 4], [1, 3, 2, 4])) < 1.0
    with pytest.raises(ValueError):
        spearman([1], [1])


def test_row_to_point_parses_metric_and_config_string():
    row = {"metric": "mfu_SmolLM-1.7B-24L_seq2048",
           "tokens_per_sec_per_chip": 8806.1,
           "config": "mbs3 ga43 dots_attn offload + fused grad engine"}
    pt = tcal.row_to_point(row, "t")
    t = pt.cfg.training
    assert t.micro_batch_size == 3
    assert t.gradient_accumulation_steps == 43
    assert t.optimizer_offload and t.remat_policy == "dots_attn"
    assert pt.cfg.model.num_hidden_layers == 24
    assert dataclasses.asdict(pt.cfg) == dataclasses.asdict(
        jcal.row_to_point(row, "t").cfg)
    assert tcal.row_to_point({"metric": "decode_SmolLM-1.7B-24L_batch8",
                              "value": 793.9}, "t") is None


def test_rank_agreement_matches_measured_sweeps():
    """The h100 tier on the card's measured points (the JAX case's
    measured SWEEP rows held to the JAX model in
    `test_fit_and_rank_agreement_equal_jax_on_its_sweeps`): every point
    ranked, the pooled agreement reported, and the committed calibration
    the fit of those points from FIT_START."""
    points = tcal.load_measured_rows()
    assert len(points) >= 10, "analysis/h100_points.json is the fixture"
    ra = tcal.rank_agreement(points)
    assert len(ra["rows"]) == len(points)
    assert -1.0 <= ra["pooled"] <= 1.0
    fit = tcal.fit_calibration(points, H100, start=tcal.FIT_START,
                               keys=tcal.FIT_KEYS)
    default = Calibration()
    for key in ("eff_max", "h_half", "eff_attn", "pcie_bandwidth"):
        assert _rel(getattr(fit, key), getattr(default, key)) <= 1e-9, key


def test_predictions_within_2x_of_measured():
    model = CostModel()
    for p in tcal.load_measured_rows():
        ratio = (model.predict(p.cfg).tokens_per_sec_per_chip
                 / p.tokens_per_sec_per_chip)
        assert 0.5 < ratio < 2.0, (p.metric, ratio)


def test_measured_step_seconds_from_telemetry_events():
    events = [
        {"kind": "phase", "phase": "step", "secs": 0.10, "step": 1},
        {"kind": "phase", "phase": "step", "secs": 0.12, "step": 2},
        {"kind": "phase", "phase": "sync", "secs": 0.01, "step": 1},
        {"kind": "step", "loss": 1.0},
    ]
    m = tcal.measured_step_seconds(events)
    assert m == jcal.measured_step_seconds(events)
    assert m["n_steps"] == 2
    assert m["step_s"] == pytest.approx(0.12)
    assert tcal.measured_step_seconds([{"kind": "step"}]) is None


def test_audit_collectives_cost_info(tmp_path):
    """Replaces the audit's cost table (item 13b): the telemetry report's
    `comm` row has the JAX tool's fields, its measured side equal, its
    predicted side the h100 tier's."""
    spec = importlib.util.spec_from_file_location(
        "jax_telemetry_report", os.path.join(ROOT, "tools",
                                             "telemetry_report.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    from picotron_tpu_torch.tools import telemetry_report as ttool

    cfg = tmp_path / "c.json"
    tcfg.save_config(mkcfg(dist=dict(dp_size=2, tp_size=2,
                                     tp_sync="deferred",
                                     sequence_parallel=True), ga=2),
                     str(cfg))
    events = [{"kind": "phase", "phase": "step", "secs": 0.2},
              {"kind": "phase", "phase": "sync", "secs": 0.01}]
    got = ttool.comm_row(events, str(cfg))
    want = jtool.comm_row(events, str(cfg), "v5e")
    assert set(got) == set(want)
    assert got["generation"] == "h100"
    for key in ("measured_sync_p50_ms", "measured_step_p50_ms"):
        assert got[key] == want[key]
    assert got["predicted_comm_ms"] > 0
    assert got["predicted_tp_comm_overlapped_ms"] > 0
    assert math.isfinite(got["comm_drift_pct"])
    assert "comm [h100]" in ttool.render({**ttool.summarize(events),
                                          "comm": got})
