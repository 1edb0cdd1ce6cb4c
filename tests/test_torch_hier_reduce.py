"""The port's hierarchical multi-slice dp reduction
(`parallel/hier_reduce.py`) on the CPU, in one gloo world of 4 ranks:

- `dp_granule`, `use_hier_dp`, `_dp_groups` and `mesh.
  _split_axes_over_dcn` against the JAX functions on a table of layouts,
  the errors included.
- Two steps with the hierarchical reduction on, at dp4 x slices 2 (inner
  2: the intra-slice scatter runs) and at dp2 x cp2 x slices 2 (the cp
  scatter, then the cross-slice leg), `dcn_axes="dp"`: the losses
  against the port's `hier_dp_reduce="off"` twin at rtol 1e-5 / atol
  1e-7 (the JAX package's tolerance, tests/test_boundary.py:487-531) and
  against the JAX driver at the layout tolerance of
  tests/test_torch_parallel.py. The JAX hierarchical schedule sums over
  dp subgroups with `lax.psum(..., axis_index_groups=)`, which the CPU
  backend of some jax releases does not implement (NotImplementedError;
  the JAX package's own `test_hier_flat_loss_parity` then fails the same
  way), so the JAX side is the flat twin of the same layout, whose
  parity with the hierarchical schedule is that test's claim. An MoE
  layout (dp2 x ep2 x slices 2: the banks' axes (dp, cp) and the others'
  (dp, ep, cp)) against its flat twin alone.
- The collectives by kind: one reduce-scatter and one all-gather more per
  step with hier on (the flat buffer's legs), and the per-tensor
  all-reduces replaced by one.
- `stage_slice_placement` and `check_stage_slice_placement` against
  tests/test_boundary.py:534-575.
"""

import numpy as np
import pytest
import torch

from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import mesh
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch.parallel import comm as tcomm
from picotron_tpu_torch.parallel import hier_reduce as thier
from picotron_tpu_torch.parallel import mpmd as tmpmd
from tests.test_torch_context_parallel import (
    build_cp_rank, cp_rows, jax_cp_run,
)
from tests.test_torch_parallel import (
    LOSS_TOL, World, global_batch, jax_init_params, tiny_raw,
)

STEPS = 2
TWIN_TOL = dict(rtol=1e-5, atol=1e-7)    # tests/test_boundary.py:530
LAYOUTS = {
    "dp4_s2": tiny_raw(dp_size=4, slices=2, dcn_axes="dp",
                       training={"micro_batch_size": 1}),
    "dp2_cp2_s2": tiny_raw(dp_size=2, cp_size=2, slices=2, dcn_axes="dp"),
}
MOE = tiny_raw(dp_size=2, ep_size=2, slices=2, dcn_axes="dp",
               model={"name": "debug-tiny-moe", "num_attention_heads": 4,
                      "num_key_value_heads": 2},
               training={"micro_batch_size": 1})


def flat_twin(raw: dict) -> dict:
    return {**raw, "distributed": {**raw["distributed"],
                                   "hier_dp_reduce": "off"}}


def steps(cfg, par, state, batch) -> dict:
    step = tstep.make_train_step(cfg, par)
    losses, counts = [], []
    for _ in range(STEPS):
        tcomm.reset_collective_counts()
        losses.append(float(step(state, batch)["loss"]))
        counts.append(dict(tcomm.collectives))
    return {"losses": losses, "counts": counts,
            "n_params": len(list(state.model.parameters()))}


def train_job(job: dict, spec: dict) -> dict:
    out = {}
    for mode, raw in (("hier", job["raw"]), ("flat", flat_twin(job["raw"]))):
        cfg, par, state = build_cp_rank(raw, spec["params"])
        assert (par.dp_granule[0] > 1) == (mode == "hier")
        out[mode] = steps(cfg, par, state, cp_rows(job["batch"], cfg, par))
    return out


def moe_job(job: dict, spec: dict) -> dict:
    out = {}
    for mode, raw in (("hier", MOE), ("flat", flat_twin(MOE))):
        cfg = tcfg.config_from_dict(raw)
        par = mesh.init_parallel(cfg, torch.device("cpu"))
        state = ttrain.build_state(cfg, torch.device("cpu"), par)[0]
        mbs = cfg.training.micro_batch_size
        r = par.data_rank
        batch = tuple(torch.from_numpy(np.ascontiguousarray(
            a[:, r * mbs:(r + 1) * mbs])).long() for a in job["batch"])
        out[mode] = steps(cfg, par, state, batch)
    return out


JOBS = {"train": train_job, "moe": moe_job}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jax_init_params(LAYOUTS["dp4_s2"])
    batch = global_batch(LAYOUTS["dp4_s2"])
    jobs = [{"name": name, "kind": "train", "raw": raw, "batch": batch}
            for name, raw in LAYOUTS.items()]
    # one row per data rank (dp x ep)
    moe_rows = {**MOE, "distributed": {"use_cpu": True, "dp_size": 4}}
    jobs.append({"name": "moe", "kind": "moe",
                 "batch": global_batch(moe_rows)})
    world = World(tmp_path_factory.mktemp("world4_hier"), 4,
                  {"params": params, "jobs": jobs}, JOBS)
    want = {name: jax_cp_run(flat_twin(raw), batch)["losses"][:STEPS]
            for name, raw in LAYOUTS.items()}
    return {"port": world.results(), "jax": want}


@pytest.mark.parametrize("layout", list(LAYOUTS) + ["moe"])
def test_hier_losses_match_the_flat_twin(runs, layout):
    for rank in range(4):
        res = runs["port"][rank][layout]
        np.testing.assert_allclose(res["hier"]["losses"],
                                   res["flat"]["losses"], **TWIN_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hier_losses_match_jax(runs, layout):
    np.testing.assert_allclose(runs["port"][0][layout]["hier"]["losses"],
                               runs["jax"][layout], **LOSS_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS) + ["moe"])
def test_hier_legs_by_kind(runs, layout):
    for rank in range(4):
        res = runs["port"][rank][layout]
        for on, off in zip(res["hier"]["counts"], res["flat"]["counts"]):
            n = res["flat"]["n_params"]
            # the legs of the non-bank buffer, and the banks' (moe)
            legs = 2 if layout == "moe" else 1
            assert on["reduce_scatter"] == off["reduce_scatter"] + 1
            assert on["all_gather"] == off["all_gather"] + 1
            assert on["all_reduce"] == off["all_reduce"] - n + legs, \
                (on, off, n)
            assert off["reduce_scatter"] == 0


# ---------------------------------------------------------------------------
# units, no world
# ---------------------------------------------------------------------------

UNIT_LAYOUTS = [
    dict(dp_size=4, slices=2, dcn_axes="dp"),
    dict(dp_size=2, cp_size=2, slices=2, dcn_axes="dp"),
    dict(dp_size=8, slices=4, dcn_axes="dp"),
    dict(dp_size=2, pp_size=2, slices=4),
    dict(dp_size=2, pp_size=2, tp_size=2, slices=2, dcn_axes="pp"),
    dict(dp_size=6, slices=3, dcn_axes="dp,pp"),
    dict(dp_size=4, slices=2, dcn_axes="dp", hier_dp_reduce="off"),
    dict(dp_size=4, slices=2, dcn_axes="pp"),
    dict(dp_size=4),
]


def _both(dist_kw: dict):
    from picotron_tpu import config as jcfg

    raw = tiny_raw(**dist_kw, training={"gradient_accumulation_steps": 2})
    return tcfg.config_from_dict(raw), jcfg.config_from_dict(raw)


@pytest.mark.parametrize("dist_kw", UNIT_LAYOUTS,
                         ids=[",".join(f"{k}={v}" for k, v in d.items())
                              for d in UNIT_LAYOUTS])
def test_granule_and_cohorts_match_jax(dist_kw):
    from picotron_tpu.mesh import _split_axes_over_dcn as j_split
    from picotron_tpu.parallel import hier_reduce as jhier

    tc, jc = _both(dist_kw)
    assert thier.dp_granule(tc) == jhier.dp_granule(jc)
    assert thier.use_hier_dp(tc) == jhier.use_hier_dp(jc)
    g_dp, inner = jhier.dp_granule(jc)
    assert thier._dp_groups(g_dp, inner) == jhier._dp_groups(g_dp, inner)
    d = jc.distributed
    grid = (d.dp_size, d.pp_size, d.ep_size, d.cp_size, d.tp_size)
    for n in (1, 2, 4):
        try:
            want = j_split(grid, n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                mesh._split_axes_over_dcn(grid, n)
            assert str(got.value) == str(e)
            continue
        assert mesh._split_axes_over_dcn(grid, n) == want


@pytest.mark.parametrize("dist_kw", [
    dict(dp_size=2, slices=4),          # 4 does not divide dp * pp
    dict(dp_size=4, slices=2, dcn_axes=""),
    dict(dp_size=4, slices=2, dcn_axes="dp", hier_dp_reduce="on",
         cp_size=1, pp_size=1, tp_size=1, ep_size=1),
    dict(pp_size=2, slices=2, dcn_axes="pp", hier_dp_reduce="on"),
])
def test_slice_validation_matches_jax(dist_kw):
    from picotron_tpu import config as jcfg

    raw = tiny_raw(**dist_kw, training={"gradient_accumulation_steps": 2})
    try:
        jcfg.config_from_dict(raw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcfg.config_from_dict(raw)
        assert str(got.value) == str(e)
        return
    tc = tcfg.config_from_dict(raw)
    assert ttrain.unsupported(tc) == []


def test_dp_cohort_process_groups_cover_each_dp_group():
    sizes = {"dp": 4, "pp": 1, "ep": 1, "cp": 2, "tp": 1}
    intra, cross = mesh.dp_cohort_ranks(sizes, 2, 2)
    # dp outermost: a slice of dp is a contiguous block of ranks
    assert intra == [[0, 2], [4, 6], [1, 3], [5, 7]]
    assert cross == [[0, 4], [2, 6], [1, 5], [3, 7]]


def _placement_cfg(**kw):
    raw = tiny_raw(**kw, training={"gradient_accumulation_steps": 2})
    raw["pipeline"] = {"executor": "mpmd"}
    return raw


@pytest.mark.parametrize("dist_kw", [
    dict(pp_size=2, tp_size=2, slices=2, dcn_axes="pp"),
    dict(dp_size=2, pp_size=2, tp_size=2, slices=2, dcn_axes="dp"),
    dict(dp_size=2, pp_size=2, slices=4),
    dict(pp_size=4, slices=2, dcn_axes="pp"),
])
def test_stage_slice_placement_matches_jax(dist_kw):
    from picotron_tpu import config as jcfg
    from picotron_tpu.parallel import mpmd as jmpmd

    raw = _placement_cfg(**dist_kw)
    tc, jc = tcfg.config_from_dict(raw), jcfg.config_from_dict(raw)
    assert tmpmd.stage_slice_placement(tc) == \
        jmpmd.stage_slice_placement(jc)
    assert tmpmd.check_stage_slice_placement(tc) == \
        jmpmd.check_stage_slice_placement(jc)


def test_stage_slice_placement_pp_cut_and_dp_cut():
    pp_cut = tcfg.config_from_dict(_placement_cfg(
        pp_size=2, tp_size=2, slices=2, dcn_axes="pp"))
    assert tmpmd.stage_slice_placement(pp_cut) == [0, 1]
    assert tmpmd.check_stage_slice_placement(pp_cut) == [0, 1]
    dp_cut = tcfg.config_from_dict(_placement_cfg(
        dp_size=2, pp_size=2, tp_size=2, slices=2, dcn_axes="dp"))
    assert tmpmd.stage_slice_placement(dp_cut) == [None, None]
    assert tmpmd.check_stage_slice_placement(dp_cut) == [None, None]


def test_check_stage_slice_placement_raises_on_spanning_group(monkeypatch):
    monkeypatch.setattr(tmpmd, "stage_slice_placement",
                        lambda cfg: [0, None])
    with pytest.raises(RuntimeError, match="span"):
        tmpmd.check_stage_slice_placement(tcfg.config_from_dict(
            _placement_cfg(pp_size=2, tp_size=2, slices=2,
                           dcn_axes="pp")))
