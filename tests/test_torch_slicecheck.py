"""The port's slice-boundary audit (`analysis/boundary.py`) and the pp
cut's pricing (`parallel/mpmd.boundary_dcn_traffic`) against the JAX
package, on the CPU, with no process group.

The JAX package cannot lower its hierarchical dp reduction or its 2d tp
strategy on this jax (`lax.psum` with `axis_index_groups` raises on the
CPU: the standing red tests/test_boundary.py and
tests/test_tp_strategies.py::test_2d_audit_flags_deleted_subgroup_gather).
So those configs are held to the JAX package through its own audits
over the port's recorded schedule, spelled as StableHLO text
(`tests/test_torch_shardcheck.hlo_text`): JAX's `audit_boundary`
classifies every op and prices the tiers, JAX's `audit_collectives`
applies its presence rules, and each equals the port's.

The verdicts are the JAX package's own (its CHANGES.md, PRs 15-17):
the dp cut audits green with 0 violating, boundary ops that are the
hierarchical schedule's cohort-1 cross-slice legs (plus the flat loss
statistics, in the fused form) and intra-slice reduce-scatter and
all-gather wings; the pp cut's crossers are the stage boundaries'
transfers (and the stage sums over the pp group); the 2d layout shows
its tp_y subgroup gathers and tp_x subgroup sums. The port's counts differ from the JAX ones (one flat
buffer per set of axes where JAX reduces per tensor; one all-reduce per
tensor where XLA fuses), and the tests hold the verdicts, not counts.
Mutations: a deleted intra-slice scatter leg (on the runtime schedule
and on the flat twin's groups), a widened cross-slice group, a
misdeclared crossing axis (named with the line that issued each op),
a deleted 2d subgroup gather.
"""

import dataclasses

import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu.analysis import boundary as jbnd
from picotron_tpu.analysis import collectives as jcoll
from picotron_tpu.analysis import cost_model as jcm
from picotron_tpu.parallel import mpmd as jmpmd
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch.analysis import (
    SliceTopology, audit_boundary, audit_collectives, record_train_step,
    run_shardcheck,
)
from picotron_tpu_torch.analysis.cost_model import (
    Calibration, CostModel, IciGeneration,
)
from picotron_tpu_torch.parallel import mpmd as tmpmd
from tests.test_torch_shardcheck import hlo_text, raw

DP_CROSS = raw(dist=dict(dp_size=2, tp_size=2, cp_size=2, slices=2,
                         dcn_axes="dp"), ga=2)
DP_CROSS_FUSED = raw(dist=dict(dp_size=2, tp_size=2, cp_size=2, slices=2,
                               dcn_axes="dp"), ga=2,
                     train=dict(grad_engine="fused", remat=True,
                                remat_policy="dots_attn"))
PP_CROSS = raw(dist=dict(pp_size=2, tp_size=2, slices=2, dcn_axes="pp"),
               ga=2, pipe=dict(executor="mpmd"))
TP2D = raw(dist=dict(dp_size=2, tp_size=4, tp_strategy="2d",
                     tp_mesh="2x2"), ga=2,
           mkw=dict(num_key_value_heads=4))


def flat(r):
    r = dict(r, distributed=dict(r["distributed"], hier_dp_reduce="off"))
    return r


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recorded():
    """name -> (raw, port config, RecordedStep)."""
    out = {}
    for name, r in {"dp_cross": DP_CROSS, "dp_cross_fused": DP_CROSS_FUSED,
                    "dp_cross_flat": flat(DP_CROSS), "pp_cross": PP_CROSS,
                    "tp2d": TP2D}.items():
        tc = tcfg.config_from_dict(r)
        out[name] = (r, tc, record_train_step(tc))
    return out


def torus():
    gen = IciGeneration(**dataclasses.asdict(jcm.GENERATIONS["v5e"]))
    return CostModel(gen, Calibration(**dataclasses.asdict(
        jcm.DEFAULT_CALIBRATION)))


def both_boundaries(r, ops, **kw):
    """(port report, JAX report) of the boundary audit over `ops`."""
    tc = tcfg.config_from_dict(r)
    cm = kw.pop("cost", False)
    rep = audit_boundary(tc, ops=ops, cost_model=torus() if cm else None,
                         **kw)
    jrep = jbnd.audit_boundary(jcfg.config_from_dict(r), text=hlo_text(ops),
                               cost_model=jcm.CostModel("v5e") if cm
                               else None, **kw)
    return rep, jrep


def rows(info) -> list:
    return [(t["kind"], t["class"], t["axes"], t["slices"], t["group"],
             t["ici_bytes"], t["dcn_bytes"]) for t in info["table"]]


def rules(rep) -> set:
    return {(f.check, f.severity, f.path.split("@")[0])
            for f in rep.findings}


@pytest.mark.parametrize("name", ["dp_cross", "dp_cross_fused",
                                  "dp_cross_flat", "pp_cross"])
def test_crossing_layouts_classify_as_jax(name, recorded):
    r, tc, rec = recorded[name]
    rep, jrep = both_boundaries(r, rec.ops, cost=True)
    info, jinfo = rep.info["boundary"], jrep.info["boundary"]
    assert rep.ok() and jrep.ok(), (rep.render(), jrep.render())
    assert rows(info) == rows(jinfo)
    for k in ("intra", "boundary", "violating", "unattributable",
              "ici_bytes", "dcn_bytes", "cut_axes", "dcn_axes"):
        assert info[k] == jinfo[k], k
    assert info["dcn_ms"] == jinfo["dcn_ms"]
    assert info["ici_ms"] == jinfo["ici_ms"]
    assert rules(rep) == rules(jrep)
    # the JAX verdicts: a green audit with both tiers in use
    assert info["violating"] == info["unattributable"] == 0
    assert info["boundary"] > 0 and info["intra"] > 0
    assert info["dcn_bytes"] > 0 and info["ici_bytes"] > 0
    for row in info["table"]:
        assert (row["dcn_bytes"] == 0) == (row["class"] == "intra")


@pytest.mark.parametrize("name", ["dp_cross", "dp_cross_fused"])
def test_runtime_hier_is_the_explicit_schedule(name, recorded):
    """The recorded crossing step carries the explicit hierarchical
    schedule: cohort-1 cross-slice grad all-reduces, intra-slice
    reduce-scatter and all-gather wings, the flat loss statistics in the
    fused form, nothing violating (JAX CHANGES.md PR 17)."""
    r, tc, rec = recorded[name]
    rep = audit_boundary(tc, recorded=rec)
    info = rep.info["boundary"]
    table = info["table"]
    cohort1 = [t for t, op in zip(table, [o for o in rec.ops
                                          if o.effective])
               if t["class"] == "boundary" and t["kind"] == "all_reduce"
               and op.group_size == 2]
    assert cohort1, table
    intra = {t["kind"] for t in table if t["class"] == "intra"}
    assert {"reduce_scatter", "all_gather"} <= intra
    assert any(t["class"] == "boundary" and t["group"] == 4
               for t in table)  # the loss statistics, dp x cp wide


def test_mutation_deleted_intra_scatter_leg(recorded):
    """Deleting the runtime schedule's intra-slice reduce-scatter leaves
    cohort-1 crossers with no scatter producing their shard:
    hier_intra_scatter, in both audits."""
    r, tc, rec = recorded["dp_cross"]
    ops = [op for op in rec.ops if op.kind != "reduce_scatter"]
    rep, jrep = both_boundaries(r, ops)
    assert any(f.path == "hier_intra_scatter" for f in rep.errors())
    assert rules(rep) == rules(jrep)


def _regroup(ops, old, new):
    out = []
    for op in ops:
        if op.kind == "all_reduce" and op.members == old:
            op = dataclasses.replace(op, members=new, group_size=len(new[0]),
                                     n_groups=len(new))
        out.append(op)
    return out


GRAD_GROUPS = ((0, 2, 4, 6), (1, 3, 5, 7))  # dp x cp at every tp index


def test_mutation_cohort_one_groups_on_the_flat_twin(recorded):
    """The JAX mutation: the flat twin's data groups rewritten to one
    member per slice delete the intra-slice leg of the fused form."""
    r, tc, rec = recorded["dp_cross_flat"]
    assert any(op.members == GRAD_GROUPS for op in rec.ops)
    ops = _regroup(rec.ops, GRAD_GROUPS, ((0, 4), (2, 6), (1, 5), (3, 7)))
    rep, jrep = both_boundaries(r, ops)
    assert any(f.path == "hier_intra_scatter" for f in rep.errors())
    assert rules(rep) == rules(jrep)


def test_mutation_widened_dcn_group(recorded):
    r, tc, rec = recorded["dp_cross_flat"]
    ops = _regroup(rec.ops, GRAD_GROUPS, ((0, 2, 4, 1), (6, 3, 5, 7)))
    rep, jrep = both_boundaries(r, ops)
    assert any(f.path == "hier_dcn_cohort" for f in rep.errors())
    assert rules(rep) == rules(jrep)


def test_misdeclared_axis_is_named_with_its_line(recorded):
    """Declaring pp as the crossing axis while the cut is on dp routes
    every dp collective over the slow tier: each one a named
    ici-axis-over-dcn error with the line that issued it."""
    r, tc, rec = recorded["dp_cross"]
    rep, jrep = both_boundaries(r, rec.ops, dcn_axes="pp")
    errs = [f for f in rep.errors() if "ici-axis-over-dcn" in f.message]
    assert errs and len(errs) == rep.info["boundary"]["violating"]
    assert rep.info["boundary"]["boundary"] == 0
    assert all("issued at picotron_tpu_torch/" in f.message
               and ".py:" in f.message for f in errs)
    assert rep.info["boundary"]["violating"] == \
        jrep.info["boundary"]["violating"]


def test_single_slice_is_a_no_op(recorded):
    r, tc, rec = recorded["tp2d"]
    rep = audit_boundary(tc, recorded=rec)
    assert rep.ok() and rep.info["boundary"] == {"slices": 1,
                                                 "audited": False}


def test_pp_cross_through_shardcheck(recorded):
    r, tc, rec = recorded["pp_cross"]
    rep = run_shardcheck(tc, recorded=rec)
    assert rep.ok(), rep.render(verbose=True)
    info = rep.info["boundary"]
    # the stage boundaries' transfers cross (so do the stage sums of the
    # loss and the grad norm, over the pp group)
    assert "collective_permute" in {t["kind"] for t in info["table"]
                                    if t["class"] == "boundary"}
    lint = rep.info["variants"]["mpmd_stages"]["schedule_lint"]
    assert lint["proven"] and lint["problems"] == 0 and lint["ops"] > 0


def test_slice_topology_equals_jax():
    for r in (DP_CROSS, PP_CROSS):
        topo = SliceTopology.from_config(tcfg.config_from_dict(r))
        jtopo = jbnd.SliceTopology.from_config(jcfg.config_from_dict(r))
        assert (topo.n_slices, topo.declared, topo.grid, topo.dcn_shape) \
            == (jtopo.n_slices, jtopo.declared, jtopo.grid,
                jtopo.dcn_shape)
        assert [topo.slice_of(i) for i in range(topo.world)] == \
            [jtopo.slice_of(i) for i in range(jtopo.world)]
    with pytest.raises(ValueError):
        SliceTopology.from_config(tcfg.config_from_dict(DP_CROSS),
                                  n_slices=3)


# ---------------------------------------------------------------------------
# the 2d tp strategy's subgroups (held through the JAX presence rules)
# ---------------------------------------------------------------------------


def test_2d_schedule_audits_as_jax_and_flags_deleted_subgroup_gather(
        recorded):
    r, tc, rec = recorded["tp2d"]
    jc = jcfg.config_from_dict(r)
    rep = audit_collectives(tc, recorded=rec)
    jrep = jcoll.audit_collectives(jc, text=hlo_text(rec.ops),
                                   budget_bytes=rep.info["collectives"][
                                       "gather_budget_bytes"])
    assert rep.ok() and jrep.ok(), (rep.render(), jrep.render())
    kinds = {(op.kind, op.group_size) for op in rec.ops if op.effective}
    assert ("all_gather", 2) in kinds  # the tp_y subgroup gathers
    assert ("all_reduce", 2) in kinds  # the tp_x subgroup sums
    ops = [op for op in rec.ops
           if not (op.kind == "all_gather" and op.group_size == 2)]
    bad = audit_collectives(tc, recorded=dataclasses.replace(rec, ops=ops))
    jbad = jcoll.audit_collectives(jc, text=hlo_text(ops))
    assert any("inner-subgroup" in f.message for f in bad.errors())
    assert {f.path for f in bad.errors()} == {f.path for f in
                                              jbad.errors()}


def test_2d_under_a_slice_cut_classifies_as_jax(recorded):
    r2 = dict(TP2D, distributed=dict(TP2D["distributed"], slices=2,
                                     dcn_axes="dp", hier_dp_reduce="off"))
    tc = tcfg.config_from_dict(r2)
    rec = record_train_step(tc)
    rep, jrep = both_boundaries(r2, rec.ops)
    assert rows(rep.info["boundary"]) == rows(jrep.info["boundary"])
    assert rep.ok() and rep.info["boundary"]["violating"] == 0


# ---------------------------------------------------------------------------
# the pp cut's transfers, priced
# ---------------------------------------------------------------------------


def test_boundary_dcn_traffic_equals_jax():
    for r in (PP_CROSS, raw(dist=dict(pp_size=2, tp_size=2), ga=2,
                            pipe=dict(executor="mpmd")),
              raw(dist=dict(pp_size=2, dp_size=2, slices=2, dcn_axes="pp"),
                  ga=4, pipe=dict(executor="mpmd", schedule="gpipe"))):
        got = tmpmd.boundary_dcn_traffic(tcfg.config_from_dict(r),
                                         cost_model=torus())
        want = jmpmd.boundary_dcn_traffic(jcfg.config_from_dict(r),
                                          cost_model=jcm.CostModel("v5e"))
        assert got == want
    assert got["crossing"] > 0 and "dcn_secs" in got
