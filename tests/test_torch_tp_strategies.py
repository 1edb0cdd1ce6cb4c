"""The port's tp strategies and deferred sync (`parallel/tp_strategies.py`)
on the CPU, in one gloo world of 4 ranks, against the JAX package on its
simulated host devices (the harness and the tiny config of
tests/test_torch_parallel.py; every layout reads one global batch of 4
rows: mbs 4 at dp 1, mbs 2 at dp 2):

- 3 steps' losses at rtol 2e-4 / atol 2e-5 and every final param at
  rtol 2e-2 / atol 1e-3 (tests/test_parallel.py:124-139), each against
  the JAX driver at the same layout: tp_sync="deferred" at dp2 x tp2 and
  at tp2 x cp2 with SP; "2d" at tp4 with tp_mesh 2x2, 4x1 and 1x4; "row"
  at dp2 x tp2 (both packages get the same full params, so the JAX
  test's init caveat, tests/test_tp_strategies.py:148-190, does not
  arise); "qkv=2d,o=2d" at tp4. At tp4 (no dp) the guard's grad norms
  against the JAX driver's as well.

  The JAX 2d hooks sum over subgroups with `lax.psum(...,
  axis_index_groups=)`, which the CPU backend of some jax releases does
  not implement (NotImplementedError; the JAX package's own
  `test_loss_pin_2d_tp4` then fails the same way). So a layout that uses
  2d is held to the JAX run of its megatron twin, the same layout
  without the strategy knobs, which is the JAX package's own acceptance
  bar for 2d (tests/test_tp_strategies.py `assert_loss_pinned_to_sync_
  twin`: "2d reassociates the exit psum identically").
- Every layout's step-1 grad norm is the whole model's (the JAX tp4
  run's) at rtol 1e-5: Adam hides a grad off by a constant factor (a
  tp_y too many) from losses and params, the norm does not.
- The fused engine against the AD engine (remat "dots_attn") for each
  strategy: one step's reduced grads, the loss at rtol 1e-5 and each
  tensor within 1e-5 of its largest value
  (tests/test_torch_fused_bwd.py's bound).
- A "row" checkpoint at dp2 x tp2 through `train.run`: saved after step
  2 and auto-resumed to step 4, equal to an uninterrupted run bit for
  bit; `restore_params_only` reads its flipped shards whole.
- One forward's tp collectives by kind per rank equal
  `tp_strategies.forward_collectives` (the JAX docstring's schedule).
- Units (no world): `tp_subgroups`, `uses_strategy_hooks` and the hook
  names `tp_strategy_hooks` installs, equal to the JAX package's on a
  table of configs; the subgroup and row-storage shapes.
- `chip_smoke.py` phase 15's thread worlds at debug-tiny size on the
  CPU.
"""

import numpy as np
import pytest
import torch

from picotron_tpu_torch import checkpoint as tckpt
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import mesh
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.parallel import comm as tcomm
from picotron_tpu_torch.parallel import sharding
from picotron_tpu_torch.parallel import tp as ttp
from picotron_tpu_torch.parallel import tp_strategies as tstrat
from picotron_tpu_torch.parallel.cp import cp_context
from tests.test_torch_context_parallel import cp_rows, jax_cp_run
from tests.test_torch_parallel import (
    LOSS_TOL, PARAM_TOL, STEPS, World, global_batch, jax_init_params,
    leaves, tiny_raw, worst_errors,
)

MBS4 = {"micro_batch_size": 4}
LAYOUTS = {
    "deferred_dp2_tp2": tiny_raw(dp_size=2, tp_size=2, tp_sync="deferred"),
    "deferred_tp2_cp2_sp": tiny_raw(tp_size=2, cp_size=2,
                                    sequence_parallel=True,
                                    tp_sync="deferred", training=MBS4),
    "2d_tp4_2x2": tiny_raw(tp_size=4, tp_strategy="2d", tp_mesh="2x2",
                           training=MBS4),
    "2d_tp4_4x1": tiny_raw(tp_size=4, tp_strategy="2d", tp_mesh="4x1",
                           training=MBS4),
    "2d_tp4_1x4": tiny_raw(tp_size=4, tp_strategy="2d", tp_mesh="1x4",
                           training=MBS4),
    "row_dp2_tp2": tiny_raw(dp_size=2, tp_size=2, tp_strategy="row"),
    "qkv2d_o2d_tp4": tiny_raw(tp_size=4, tp_strategy="qkv=2d,o=2d",
                              tp_mesh="2x2", training=MBS4),
}
_STRATEGY_KNOBS = ("tp_strategy", "tp_sync", "tp_mesh")


def jax_reference(raw: dict) -> dict:
    """The layout the JAX driver runs as the reference of `raw`: itself,
    or under 2d its megatron twin (module docstring)."""
    d = raw["distributed"]
    if "2d" not in d.get("tp_strategy", ""):
        return raw
    return {**raw, "distributed": {k: v for k, v in d.items()
                                   if k not in _STRATEGY_KNOBS}}


FUSED = {"remat": True, "remat_policy": "dots_attn", "grad_engine": "fused"}
# one layout per strategy for the engines' comparison
GRAD_LAYOUTS = ("deferred_dp2_tp2", "deferred_tp2_cp2_sp", "2d_tp4_2x2",
                "row_dp2_tp2", "qkv2d_o2d_tp4")


def with_training(raw: dict, training: dict) -> dict:
    return {**raw, "training": {**raw["training"], **training}}


def build_rank(raw: dict, params: dict):
    """(cfg, par, TrainState) of this rank under the config's strategy:
    its tp shards of `params` (flipped where "row" stores them so)."""
    cfg = tcfg.config_from_dict(raw)
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    d = cfg.distributed
    model = tllama.LlamaModel(
        cfg.model, device="cpu",
        tp=ttp.tp_context(par, d.sequence_parallel, cfg),
        cp=cp_context(par, cfg))
    model.load_state_dict(weights.params_from_jax(
        params, cfg.model, par.tp_rank, par.tp_size,
        flips=sharding.tp_flips(cfg)))
    return cfg, par, tstep.init_train_state(cfg, model, par)


def train_job(job: dict, spec: dict) -> dict:
    cfg, par, state = build_rank(job["raw"], spec["params"])
    step = tstep.make_train_step(cfg, par)
    batch = cp_rows(job["batch"], cfg, par)
    # one forward's collectives (an eval step over one microbatch)
    tcomm.reset_collective_counts()
    tstep.make_eval_step(cfg, par)(state.model,
                                   tuple(t[:1] for t in batch))
    forward = dict(tcomm.collectives)
    losses, norms = [], []
    for _ in range(STEPS):
        m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "forward": forward,
            "params": {n: p.detach().float().clone()
                       for n, p in state.model.named_parameters()}}


def grads_job(job: dict, spec: dict) -> dict:
    """{engine: (loss, {name: reduced token-mean grad})} of one step."""
    out = {}
    for engine in ("ad", "fused"):
        raw = with_training(job["raw"], {**FUSED, "grad_engine": engine})
        cfg, par, state = build_rank(raw, spec["params"])
        assert tstep.resolved_grad_engine(cfg) == engine
        opt = state.optimizer
        loss, scale = tstep.make_grads_fn(cfg, par)(
            state.model, cp_rows(job["batch"], cfg, par), opt.grad_of)
        out[engine] = (float(loss), {n: (g * scale).clone()
                                     for n, g in zip(opt.names, opt.grads)})
    return out


def ckpt_job(job: dict, spec: dict) -> dict:
    """A "row" run at dp2 x tp2: save after step 2 and auto-resume to 4,
    and an uninterrupted 4 steps; the checkpoint's params read whole."""
    base = tiny_raw(dp_size=2, tp_size=2, tp_strategy="row",
                    training={"total_train_steps": 4, "seed": 5})
    tokens = tcfg.config_from_dict(base).tokens_per_step

    def cfg(save_dir, **ck):
        raw = dict(base)
        raw["checkpoint"] = {"save_dir": save_dir, **ck}
        return raw

    resumable = cfg(job["dir"] + "/a", save_frequency=2, auto_resume=True)
    first_raw = {**resumable, "training": {**resumable["training"],
                                          "max_tokens": 2 * tokens}}
    first = ttrain.run(tcfg.config_from_dict(first_raw), "cpu")
    second = ttrain.run(tcfg.config_from_dict(resumable), "cpu")
    whole = ttrain.run(tcfg.config_from_dict(cfg(job["dir"] + "/b")), "cpu")
    same = all(torch.equal(p, q) for p, q in zip(
        second["state"].model.parameters(), whole["state"].model.parameters()))
    # step 2's files: the first run's state when it saved them
    params, _ = tckpt.restore_params_only(tcfg.config_from_dict(resumable),
                                          job["dir"] + "/a", step=2)
    return {"resumed": first["losses"] + second["losses"],
            "start_step": second["start_step"], "whole": whole["losses"],
            "params_equal": same,
            "params_only": {n: t.clone() for n, t in params.items()},
            "shards": {n: p.detach().clone() for n, p in
                       first["state"].model.named_parameters()}}


JOBS = {"train": train_job, "grads": grads_job, "ckpt": ckpt_job}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jax_init_params(LAYOUTS["2d_tp4_2x2"])
    batch = global_batch(LAYOUTS["2d_tp4_2x2"])
    jobs = [{"name": name, "kind": "train", "raw": raw, "batch": batch}
            for name, raw in LAYOUTS.items()]
    jobs += [{"name": "grads_" + name, "kind": "grads",
              "raw": LAYOUTS[name], "batch": batch} for name in GRAD_LAYOUTS]
    tmp = tmp_path_factory.mktemp("world4_strategies")
    jobs.append({"name": "ckpt", "kind": "ckpt", "dir": str(tmp / "ckpt")})
    world = World(tmp, 4, {"params": params, "jobs": jobs}, JOBS)
    want = {name: jax_cp_run(jax_reference(raw), batch)
            for name, raw in LAYOUTS.items()}
    return {"port": world.results(), "jax": want}


def full_tree(raw: dict, shards: list) -> dict:
    """The JAX-layout numpy tree of the whole model from every tp rank's
    {name: shard} (in tp order) under the config's storage."""
    cfg = tcfg.config_from_dict(raw)
    flips = sharding.tp_flips(cfg)
    model = tllama.LlamaModel(cfg.model, device="cpu")
    whole = {}
    for n, t in shards[0].items():
        dim = sharding.tp_shard_dim(n, flips)
        whole[n] = (t if dim is None else
                    torch.cat([s[n] for s in shards], dim)).float()
    model.load_state_dict(whole)
    return weights.params_to_numpy(model)


def _tp_ranks(raw: dict) -> list:
    """The global ranks of data rank 0's tp group, in tp order."""
    d = tcfg.config_from_dict(raw).distributed
    return list(range(d.tp_size))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_strategy_layouts_match_jax(runs, layout):
    raw = LAYOUTS[layout]
    got, want = runs["port"][0][layout], runs["jax"][layout]
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    shards = [runs["port"][r][layout]["params"] for r in _tp_ranks(raw)]
    have = leaves(full_tree(raw, shards))
    for k, w in leaves(want["params"]).items():
        np.testing.assert_allclose(have[k], w, err_msg=k, **PARAM_TOL)
    print(f"{layout}: losses max abs diff "
          f"{np.abs(np.subtract(got['losses'], want['losses'])).max():.3g}, "
          f"params (abs, rel-to-max) "
          f"{worst_errors(have, leaves(want['params']))}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forward_collectives_are_the_promised_schedule(runs, layout):
    """One forward's tp collectives by kind are `forward_collectives`'
    (the JAX docstring's schedule per strategy), plus the eval's one
    all-reduce of (NLL sum, count) over the data group."""
    cfg = tcfg.config_from_dict(LAYOUTS[layout])
    want = tstrat.forward_collectives(cfg)
    want["all_reduce"] += 1
    for rank in range(4):
        got = runs["port"][rank][layout]["forward"]
        assert {k: got[k] for k in want} == want, (rank, got)


@pytest.mark.parametrize("layout", [n for n in LAYOUTS if "tp4" in n])
def test_tp4_grad_norms_match_jax(runs, layout):
    for rank in range(4):
        np.testing.assert_allclose(runs["port"][rank][layout]["grad_norms"],
                                   runs["jax"][layout]["grad_norms"],
                                   **LOSS_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step1_grad_norm_is_the_whole_models(runs, layout):
    """Every layout's step-1 grad norm is the whole model's, the JAX tp4
    run's (no dp: its norm is the single device's; tests/test_torch_
    parallel.py's docstring says why not a dp run's). Adam hides a grad
    off by a constant factor from the losses and params; the norm does
    not."""
    want = runs["jax"]["2d_tp4_2x2"]["grad_norms"][0]
    for rank in range(4):
        np.testing.assert_allclose(
            runs["port"][rank][layout]["grad_norms"][0], want, rtol=1e-5)


@pytest.mark.parametrize("layout", GRAD_LAYOUTS)
def test_fused_grads_match_ad_per_tensor(runs, layout):
    for rank in range(4):
        res = runs["port"][rank]["grads_" + layout]
        (l_ad, g_ad), (l_f, g_f) = res["ad"], res["fused"]
        np.testing.assert_allclose(l_f, l_ad, rtol=1e-5)
        for n, a in g_ad.items():
            err = float((g_f[n] - a).abs().max() / (a.abs().max() + 1e-12))
            assert err <= 1e-5, (rank, n, err)


def test_row_checkpoint_resumes_bit_for_bit(runs):
    raw = tiny_raw(dp_size=2, tp_size=2, tp_strategy="row")
    cfg = tcfg.config_from_dict(raw)
    flips = sharding.tp_flips(cfg)
    assert flips == {"q", "k", "v", "o", "gate", "up", "down"}
    for rank in range(4):
        res = runs["port"][rank]["ckpt"]
        assert res["start_step"] == 2
        assert res["resumed"] == res["whole"]
        assert res["params_equal"]
    # the flipped shards read whole: rank 0's and 1's shards (tp 0 and 1
    # of data rank 0) are the whole tensor's halves along the flipped dim
    whole = runs["port"][0]["ckpt"]["params_only"]
    for n, t in whole.items():
        dim = sharding.tp_shard_dim(n, flips)
        parts = [runs["port"][r]["ckpt"]["shards"][n] for r in (0, 1)]
        want = parts[0] if dim is None else torch.cat(parts, dim)
        assert torch.equal(t, want), n


# ---------------------------------------------------------------------------
# units, no world
# ---------------------------------------------------------------------------

UNIT_CFGS = [
    dict(tp_size=2),
    dict(tp_size=2, sequence_parallel=True),
    dict(tp_size=2, tp_sync="deferred"),
    dict(tp_size=2, cp_size=2, sequence_parallel=True, tp_sync="deferred"),
    dict(tp_size=4, tp_strategy="2d", tp_mesh="2x2"),
    dict(tp_size=4, tp_strategy="2d"),
    dict(tp_size=4, tp_strategy="2d", tp_mesh="4x1"),
    dict(tp_size=2, tp_strategy="row"),
    dict(tp_size=4, tp_strategy="qkv=2d,o=2d"),
    dict(tp_size=4, tp_strategy="up=2d,down=2d"),
    dict(tp_size=2, tp_strategy="qkv=row,o=col"),
]


@pytest.mark.parametrize("dist_kw", UNIT_CFGS,
                         ids=[",".join(f"{k}={v}" for k, v in d.items())
                              for d in UNIT_CFGS])
def test_hooks_and_subgroups_match_jax(dist_kw):
    from picotron_tpu import config as jcfg
    from picotron_tpu.config import resolved_tp_mesh as j_mesh
    from picotron_tpu.parallel import tp_strategies as jstrat

    raw = tiny_raw(**dist_kw)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    assert tstrat.uses_strategy_hooks(tc) == jstrat.uses_strategy_hooks(jc)
    assert tcfg.resolved_tp_mesh(tc) == j_mesh(jc)
    tp_x, tp_y = j_mesh(jc)
    assert tstrat.tp_subgroups(tp_x, tp_y) == jstrat.tp_subgroups(tp_x, tp_y)
    # a context without a world: the hooks are built, never called
    sizes = mesh.layout_sizes(tc)
    par = mesh.ParallelEnv(sizes=sizes, rank=0, world_size=1,
                           device=torch.device("cpu"), backend="gloo",
                           tp_group=None, data_group=None, host_group=None,
                           coords=mesh.rank_coords(0, sizes))
    tp = ttp.tp_context(par, tc.distributed.sequence_parallel, tc)
    hooks = tstrat.tp_strategy_hooks(tc, tp)
    want = jstrat.tp_strategy_hooks(jc)
    assert set(hooks) == set(want)
    for k in ("seq_shard", "head_ce_local", "head_ce_merge"):
        if k in want:
            assert hooks[k] == want[k], k


@pytest.mark.parametrize("tp_x,tp_y", [(1, 4), (2, 2), (4, 1), (2, 4),
                                       (4, 2)])
def test_subgroup_process_groups_cover_each_tp_group(tp_x, tp_y):
    sizes = {"dp": 2, "pp": 1, "ep": 1, "cp": 1, "tp": tp_x * tp_y}
    ty, tx = mesh.tp_subgroup_ranks(sizes, tp_x, tp_y)
    tp_lists = mesh.group_ranks(sizes, ("tp",))
    assert sorted(r for g in ty for r in g) == list(range(2 * tp_x * tp_y))
    assert sorted(r for g in tx for r in g) == list(range(2 * tp_x * tp_y))
    for g in ty:   # contiguous within one tp group
        assert any(set(g) <= set(t) for t in tp_lists)
        assert g == list(range(g[0], g[0] + tp_y))
    for g in tx:   # strided by tp_y
        assert g == list(range(g[0], g[0] + tp_x * tp_y, tp_y))


def test_row_storage_flips_the_shapes():
    raw = tiny_raw(tp_size=2, tp_strategy="row")
    cfg = tcfg.config_from_dict(raw)
    sizes = mesh.layout_sizes(cfg)
    par = mesh.ParallelEnv(sizes=sizes, rank=0, world_size=1,
                           device=torch.device("cpu"), backend="gloo",
                           tp_group=None, data_group=None, host_group=None,
                           coords=mesh.rank_coords(0, sizes))
    model = tllama.LlamaModel(cfg.model, device="meta",
                              tp=ttp.tp_context(par, False, cfg))
    m, (h, i) = cfg.model, (cfg.model.hidden_size,
                            cfg.model.intermediate_size)
    lp = model.layers[0]
    assert tuple(lp.q.shape) == (m.num_attention_heads * m.head_dim, h // 2)
    assert tuple(lp.o.shape) == (h // 2, m.num_attention_heads * m.head_dim)
    assert tuple(lp.gate.shape) == (i, h // 2)
    assert tuple(lp.down.shape) == (h // 2, i)
    # the shard dims read the same storage
    full = tllama.LlamaModel(cfg.model, device="meta")
    flips = sharding.tp_flips(cfg)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              full.named_parameters()):
        dim = sharding.tp_shard_dim(n, flips)
        want = list(q.shape)
        if dim is not None:
            want[dim] //= 2
        assert list(p.shape) == want, n


def test_chip_smoke_phase15_thread_worlds_on_the_cpu():
    """chip_smoke.py phase 15's harness at debug-tiny size on the CPU (one
    layer, seq 16): every strategy's 3 fp32 and bf16 steps in a thread
    world of 4 ranks (the joined collectives, one backward for the AD
    twins) within 1e-6 of its twin's losses and step-1 grad norm, one
    forward's collectives the promised schedule; the hierarchical grads
    within 1e-6 of the flat ones, the legs by kind, the cross-slice bytes
    half the flat all-reduce's."""
    import json
    import os

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, chip_smoke.TP_RUN)) as f:
        run = json.load(f)
    tiny = {"name": "debug-tiny", "num_attention_heads": 8,
            "num_key_value_heads": 4}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.tp_strategies_phase(root, "cpu", run={
            **run, "model": tiny}, dev="cpu", seqs=(16, 16), layers=1)
        hier = chip_smoke.hier_phase(root, "cpu", raw={
            "model": dict(tiny), "training": {},
            "dataset": {"name": "synthetic"}}, dev="cpu", seq=16)
    finally:
        torch.set_num_threads(threads)
    assert set(out["layouts"]) == {"megatron", "megatron (AD)", "2d 2x2",
                                   "row", "qkv=2d,o=2d", "megatron sp",
                                   "megatron sp (AD)", "deferred"}
    for key, entry in out["layouts"].items():
        assert entry["rel_err_vs_twin"] <= 1e-6, (key, entry)
        assert entry["forward_collectives"] == \
            entry["forward_collectives_promised"], key
    assert hier["worst_grad_rel_l2"] <= 1e-6
    assert hier["cross_over_flat"] == 0.5
