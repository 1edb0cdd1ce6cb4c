"""The port's pipeline parallelism on the CPU, in one gloo world of 8
ranks, against the JAX package's drivers on its simulated host devices
(the harness and the tiny config of tests/test_torch_parallel.py: fp32,
8 q / 4 kv heads, seq 32, mbs 2; the JAX params transplanted into every
rank, the batch made with numpy from a seed). Each layout fills the
world of 8 with dp:

- spmd afab and 1f1b at pp 2 over an uneven 3-layer split (the JAX stack
  padded with an identity layer, the port's stages holding 2 and 1
  layers), pp 4 1f1b with n_micro 2 < pp, pp 2 x dp 2 x tp 2 with
  sequence parallelism, zero1 and remat (runs/smollm17-cpu-dp2tp2pp2's
  layout, with llama2-7b-dp4tp2pp2-1f1b's options), pp 2 x cp 2 ring
  zigzag, a tied embedding at pp 4 (the first and last stage sum its
  grads; the middle stages hold none), the mpmd executor's 1f1b,
  gpipe and interleaved (v 2, one layer per virtual stage) tables, and
  1f1b over the host-offloaded optimizer (bf16): 3 steps each, the
  losses and every final param against the JAX driver at its layout
  tolerance (tests/test_parallel.py:124-139; the JAX params read back
  through `weights.params_from_jax(..., pp_size=)`, which maps a padded
  stack's slots to the real layers; offload at the bf16 level of
  tests/test_torch_parallel.py);
- against the port's own single-device run on the same global batch:
  the losses, the guard's grad norms and the eval loss on the initial
  params at rtol 1e-5 (offload 3e-4);
- invariants: the graphs in flight on each stage within
  `pp_1f1b_ring_slots` under 1f1b (n_micro under afab and gpipe, the
  lint's budget under interleaving); every stage's loader cursor equal;
  the exchanges per step equal to the tick boundaries at which the
  table moves a tensor to or from the stage, and the data ranks of a
  stage holding the same params;
- a checkpoint at pp 2 x tp 2 (x dp 2) through `train.run`: save at step
  2, auto-resume to 4, equal to an uninterrupted run bit for bit;
- a tied embedding at pp 2 x tp 2 (x dp 2) from the trainer's fresh
  init: the first and the last stage's copies equal after init and after
  two steps;
- the mpmd 1f1b table through `train.run` with a span tracer and the
  chaos event `sigterm@2#1`: one span per op per walk on each stage's
  lane, the SIGTERM fired at tick 1 of step 2's walk, and exit 75 on
  every rank.

One world runs every rank-side check; the JAX side runs in this process
meanwhile. The worker code imports no jax.
"""

import numpy as np
import pytest
import torch

from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import mesh
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.parallel import comm as tcomm
from picotron_tpu_torch.parallel import pp as tpp
from picotron_tpu_torch.parallel.cp import cp_context
from picotron_tpu_torch.parallel.tp import tp_context
from tests.test_torch_context_parallel import cp_rows
from tests.test_torch_parallel import (
    LOSS_TOL, PARAM_TOL, STEPS, World, full_tree, global_batch, jax_run,
    leaves, tiny_raw, worst_errors,
)

WORLD = 8
GA4 = {"gradient_accumulation_steps": 4}
REMAT = {"remat": True, "remat_policy": "dots_attn"}


def mpmd(schedule: str, interleave: int = 1) -> dict:
    return {"executor": "mpmd", "schedule": schedule,
            "interleave": interleave}


def layout(pipeline=None, model=None, training=None, **dist_kw) -> dict:
    raw = tiny_raw(training={**GA4, **(training or {})}, model=model,
                   **dist_kw)
    if pipeline:
        raw["pipeline"] = pipeline
    return raw


LAYOUTS = {
    "pp2_afab_3layers": layout(pp_size=2, dp_size=4, pp_engine="afab",
                               model={"num_hidden_layers": 3}),
    "pp2_1f1b_3layers": layout(pp_size=2, dp_size=4,
                               model={"num_hidden_layers": 3}),
    "pp4_1f1b_ga2": layout(pp_size=4, dp_size=2,
                           training={"gradient_accumulation_steps": 2}),
    "pp2_dp2_tp2_sp_zero1": layout(pp_size=2, dp_size=2, tp_size=2,
                                   sequence_parallel=True, zero1=True,
                                   training=REMAT),
    "pp2_cp2_ring_zigzag": layout(pp_size=2, cp_size=2, dp_size=2),
    "pp4_tied_1f1b": layout(pp_size=4, dp_size=2,
                            model={"tie_word_embeddings": True}),
    "mpmd_1f1b": layout(mpmd("1f1b"), pp_size=2, dp_size=4),
    "mpmd_gpipe": layout(mpmd("gpipe"), pp_size=2, dp_size=4),
    "mpmd_interleaved_v2": layout(mpmd("interleaved", 2), pp_size=2,
                                  dp_size=4, training=REMAT),
    "pp2_offload_1f1b": layout(pp_size=2, dp_size=4,
                               model={"dtype": "bfloat16"},
                               training={"optimizer_offload": True}),
}
# bf16 compute over the host-offloaded optimizer: held at the bf16 level
# of tests/test_torch_parallel.py (its dp2 zero1 offload case)
OFFLOAD = {"pp2_offload_1f1b"}
OFFLOAD_LOSS_RTOL = 3e-4
OFFLOAD_UPDATE_RTOL = 0.25


def batch_of(raw: dict):
    return global_batch(raw, seed=11)


def params_of(raw: dict) -> dict:
    """The JAX package's init from key 0 at the layout's model, numpy."""
    import jax

    from picotron_tpu import config as jcfg
    from picotron_tpu.models.llama import init_params

    jc = jcfg.config_from_dict(raw)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        init_params(jc.model, jax.random.key(0)))


def build_pp_rank(raw: dict, params: dict):
    """(cfg, par, TrainState) of this rank: its tp shards of its stage."""
    cfg = tcfg.config_from_dict(raw)
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    model = tllama.LlamaModel(
        cfg.model, device="cpu",
        tp=tp_context(par, cfg.distributed.sequence_parallel),
        cp=cp_context(par, cfg), stage=ttrain.stage_of(cfg, par))
    model.load_state_dict(weights.stage_params(weights.params_from_jax(
        params, cfg.model, par.tp_rank, par.tp_size), model))
    return cfg, par, tstep.init_train_state(cfg, model, par)


def train_pp_job(job: dict, spec: dict) -> dict:
    """STEPS steps of the layout on its batch: losses, grad norms, the
    eval loss on the initial params, the stage's final params, its walk
    and the send_recv calls of one step."""
    raw = job["raw"]
    cfg, par, state = build_pp_rank(raw, spec["params"][job["name"]])
    step = tstep.make_train_step(cfg, par)
    batch = cp_rows(job["batch"], cfg, par)
    eval0 = float(tstep.make_eval_step(cfg, par)(state.model, batch))
    losses, norms, walks, send_recv = [], [], [], None
    for _ in range(STEPS):
        before = tcomm.collectives["send_recv"]
        m = step(state, batch)
        if send_recv is None:
            send_recv = tcomm.collectives["send_recv"] - before
        st = step.pipeline.stats
        walks.append((st.max_in_flight, st.exchanges))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    opt = state.optimizer
    params = (dict(zip(opt.names, opt.master))
              if cfg.training.optimizer_offload
              else dict(state.model.named_parameters()))
    return {"losses": losses, "grad_norms": norms, "eval0": eval0,
            "walks": walks, "send_recv": send_recv,
            "coords": dict(par.coords),
            "layers": list(state.model.stage.layers),
            "params": {n: p.detach().float().clone()
                       for n, p in params.items()}}


def ckpt_job(job: dict, spec: dict) -> dict:
    """pp2 x tp2 x dp2 through train.run: save after step 2 and
    auto-resume to 4, and an uninterrupted 4 steps."""
    training = {"total_train_steps": 4, "seed": 5, **GA4}
    tokens = tcfg.config_from_dict(
        tiny_raw(pp_size=2, tp_size=2, dp_size=2,
                 training=training)).tokens_per_step

    def cfg(save_dir, **ck):
        raw = tiny_raw(pp_size=2, tp_size=2, dp_size=2,
                       training=dict(training))
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
    return {"resumed": first["losses"] + second["losses"],
            "start_step": second["start_step"], "whole": whole["losses"],
            "params_equal": same, "cursor": whole["dataloader_state"],
            "pipeline": whole["pipeline"],
            "collectives": whole["collectives_per_step"]}


def tied_job(job: dict, spec: dict) -> dict:
    """A tied embedding at pp 2 x tp 2 (x dp 2) from a fresh init: the
    stage's copy as `train.build_state` draws it, and after 2 steps of
    `train.run`."""
    raw = tiny_raw(pp_size=2, tp_size=2, dp_size=2,
                   model={"tie_word_embeddings": True},
                   training={"total_train_steps": 2, "seed": 7, **GA4})
    cfg = tcfg.config_from_dict(raw)
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    state = ttrain.build_state(cfg, torch.device("cpu"), par)[0]
    out = ttrain.run(cfg, "cpu")
    return {"coords": dict(par.coords),
            "init": state.model.embedding.detach().clone(),
            "trained": out["state"].model.embedding.detach().clone()}


def flightdeck_job(job: dict, spec: dict) -> dict:
    """The mpmd 1f1b table at pp 2 (x dp 4) through train.run with a span
    tracer and `sigterm@2#1`: the exit code, this rank's trace and
    stream."""
    import json
    import os

    from picotron_tpu_torch.resilience import chaos

    raw = dict(LAYOUTS["mpmd_1f1b"])
    raw["training"] = {**raw["training"], "total_train_steps": 4}
    raw["checkpoint"] = {"save_dir": job["dir"] + "/ckpt"}
    raw["logging"] = {"trace_dir": job["dir"] + "/trace"}
    raw["resilience"] = {"chaos": "sigterm@2#1"}
    os.environ.pop("PICOTRON_CHAOS", None)
    code = None
    try:
        ttrain.run(tcfg.config_from_dict(raw), "cpu")
    except SystemExit as e:
        code = e.code
    assert not chaos.controller().active
    rank = torch.distributed.get_rank()
    suffix = "" if rank == 0 else f".p{rank}"
    with open(f"{job['dir']}/trace/trace{suffix}.json") as f:
        trace = json.load(f)
    with open(f"{job['dir']}/ckpt/telemetry{suffix}.jsonl") as f:
        events = [json.loads(line) for line in f]
    par_pp = tcfg.config_from_dict(raw).distributed.pp_size
    return {"code": code, "trace": trace, "pp_size": par_pp,
            "events": events,
            "pp_rank": mesh.rank_coords(
                rank, {"dp": 4, "pp": 2, "ep": 1, "cp": 1, "tp": 1})["pp"]}


JOBS = {"train": train_pp_job, "ckpt": ckpt_job, "tied": tied_job,
        "flightdeck": flightdeck_job}


def jax_pp_run(raw: dict, batch) -> dict:
    """The JAX driver on a pp layout (the batch permuted as its loader
    permutes it under cp); its final params unpadded into the port's
    whole-model state dict."""
    from picotron_tpu import config as jcfg
    from picotron_tpu.data import cp_sequence_permutation as jperm

    jc = jcfg.config_from_dict(raw)
    perm = jperm(jc)
    if perm is not None:
        batch = tuple(a[..., perm] for a in batch)
    out = jax_run(raw, batch)
    cfg = tcfg.config_from_dict(raw)
    out["state_dict"] = weights.params_from_jax(
        out["params"], cfg.model, pp_size=cfg.distributed.pp_size)
    return out


def single_run(raw: dict, params: dict, batch) -> dict:
    """The port's single-device run on the whole global batch at the
    layout's model: losses, grad norms, eval loss on the initial
    params."""
    rows = batch[0].shape[1]
    one = tiny_raw(training={**raw["training"], "micro_batch_size": rows},
                   model=raw["model"])
    cfg = tcfg.config_from_dict(one)
    b = tuple(torch.from_numpy(a).long() for a in batch)

    def fresh():
        model = tllama.LlamaModel(cfg.model, device="cpu")
        model.load_state_dict(weights.params_from_jax(params, cfg.model))
        return model

    eval0 = float(tstep.make_eval_step(cfg)(fresh(), b))
    state = tstep.init_train_state(cfg, fresh())
    step = tstep.make_train_step(cfg)
    ms = [step(state, b) for _ in range(STEPS)]
    return {"losses": [float(m["loss"]) for m in ms],
            "grad_norms": [float(m["grad_norm"]) for m in ms],
            "eval0": eval0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = {name: params_of(raw) for name, raw in LAYOUTS.items()}
    jobs = [{"name": name, "kind": "train", "raw": raw,
             "batch": batch_of(raw)} for name, raw in LAYOUTS.items()]
    tmp = tmp_path_factory.mktemp("ppworld")
    jobs.append({"name": "ckpt", "kind": "ckpt", "dir": str(tmp / "ckpt")})
    jobs.append({"name": "tied", "kind": "tied"})
    jobs.append({"name": "flightdeck", "kind": "flightdeck",
                 "dir": str(tmp / "flightdeck")})
    world = World(tmp, WORLD, {"params": params, "jobs": jobs}, JOBS)
    want = {name: jax_pp_run(raw, batch_of(raw))
            for name, raw in LAYOUTS.items()}
    singles = {name: single_run(raw, params[name], batch_of(raw))
               for name, raw in LAYOUTS.items()}
    return {"port": world.results(), "jax": want, "single": singles,
            "params0": params}


def _whole(runs, name: str) -> dict:
    """The port's whole-model numpy tree from the data-rank-0 ranks of
    every (pp, tp) coordinate: each stage's state dict merged, the tp
    shards joined."""
    res = [runs["port"][r][name] for r in range(WORLD)]
    d = LAYOUTS[name]["distributed"]
    tp = d.get("tp_size", 1)
    shards = []
    for t in range(tp):
        merged = {}
        for r in res:
            c = r["coords"]
            if c["tp"] == t and c["dp"] == 0 and c["cp"] == 0:
                merged.update(r["params"])
        shards.append(merged)
    return leaves(full_tree(LAYOUTS[name], shards))


def _tree(raw: dict, state_dict: dict) -> dict:
    """A whole model's state dict as the JAX-layout numpy leaves."""
    cfg = tcfg.config_from_dict(raw)
    model = tllama.LlamaModel(cfg.model, device="cpu")
    model.load_state_dict(state_dict)
    return leaves(weights.params_to_numpy(model))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_layouts_match_jax(runs, name):
    """The losses and every final param (the fp32 master under offload)
    at the JAX driver's layout tolerance; offload at the bf16 level:
    losses within 3e-4 relative and each master's update within 0.25 of
    its L2 norm."""
    got, want = runs["port"][0][name], runs["jax"][name]
    have = _whole(runs, name)
    ref = _tree(LAYOUTS[name], want["state_dict"])
    if name in OFFLOAD:
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=OFFLOAD_LOSS_RTOL)
        cfg = tcfg.config_from_dict(LAYOUTS[name])
        start = _tree(LAYOUTS[name], weights.params_from_jax(
            runs["params0"][name], cfg.model))
        worst = 0.0
        for k, w in ref.items():
            moved = np.linalg.norm(w - start[k])
            assert moved > 0, k
            worst = max(worst, np.linalg.norm(have[k] - w) / moved)
        assert worst <= OFFLOAD_UPDATE_RTOL
        rel = (np.abs(np.subtract(got["losses"], want["losses"]))
               / np.abs(want["losses"]))
        print(f"{name}: losses max rel diff {rel.max():.3g}, worst master "
              f"update rel L2 {worst:.3g}")
        return
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    for k, w in ref.items():
        np.testing.assert_allclose(have[k], w, err_msg=k, **PARAM_TOL)
    print(f"{name}: losses max abs diff "
          f"{np.abs(np.subtract(got['losses'], want['losses'])).max():.3g}, "
          f"params (abs, rel-to-max) {worst_errors(have, ref)}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_matches_the_single_device_port(runs, name):
    one = runs["single"][name]
    rtol = OFFLOAD_LOSS_RTOL if name in OFFLOAD else 1e-5
    for rank in range(WORLD):
        got = runs["port"][rank][name]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=rtol)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=rtol)
        np.testing.assert_allclose(got["eval0"], one["eval0"], rtol=rtol)


def _stages(name: str) -> tuple:
    d = LAYOUTS[name]["distributed"]
    return d["pp_size"], LAYOUTS[name]["training"][
        "gradient_accumulation_steps"]


def _table(name: str) -> list:
    return tpp.schedule_table(tcfg.config_from_dict(LAYOUTS[name]))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_graphs_in_flight_within_the_schedule_bound(runs, name):
    """The most graphs a stage held equals its table's (F ahead of B,
    counted over the stage's ops in walk order) and stays within the
    schedule's bound: `pp_1f1b_ring_slots` under the spmd 1f1b, n_micro
    under afab and gpipe, the lint's min(n, 2 pp v) per virtual stage
    under the mpmd tables."""
    pp, n = _stages(name)
    pl = LAYOUTS[name].get("pipeline", {})
    afab = LAYOUTS[name]["distributed"].get("pp_engine") == "afab"
    v = pl.get("interleave", 1)
    if afab or pl.get("schedule") == "gpipe":
        bound = n
    elif pl:
        bound = v * min(n, 2 * pp * v)
    else:
        bound = tpp.pp_1f1b_ring_slots(n, pp)
    table = _table(name)
    for rank in range(WORLD):
        res = runs["port"][rank][name]
        s = res["coords"]["pp"]
        held = peak = 0
        for o in table:
            if o.group == s:
                held += 1 if o.op == "F" else -1
                peak = max(peak, held)
        assert {w for w, _ in res["walks"]} == {peak}, (rank, res["walks"])
        assert 1 <= peak <= bound, (rank, peak, bound)
        if not (afab or pl):
            assert peak == max(1, min(n, 2 * (pp - 1 - s))), (rank, peak)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_exchanges_per_step(runs, name):
    """Each stage's exchanges: the tick boundaries at which an op of the
    table sends it a tensor or it sends one (F to a later virtual stage,
    B to an earlier one), counted here from the table; send_recv counts
    them plus the cp ring's hops."""
    pp, n = _stages(name)
    table = _table(name)
    V = max(o.vstage for o in table) + 1
    d = LAYOUTS[name]["distributed"]
    for rank in range(WORLD):
        res = runs["port"][rank][name]
        s = res["coords"]["pp"]
        ticks = set()
        for o in table:
            if o.op == "F" and o.vstage < V - 1:
                peer = (o.vstage + 1) % pp
            elif o.op == "B" and o.vstage > 0:
                peer = (o.vstage - 1) % pp
            else:
                continue
            if s in (o.group, peer):
                ticks.add(o.tick)
        assert {e for _, e in res["walks"]} == {len(ticks)}, (rank, name)
        cp_hops = 0
        if d.get("cp_size", 1) > 1:
            cp_hops = (2 * d["cp_size"] - 1) * n * len(res["layers"])
        assert res["send_recv"] == len(ticks) + cp_hops, (rank, name)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_stages_hold_their_layers_and_data_ranks_agree(runs, name):
    cfg = tcfg.config_from_dict(LAYOUTS[name])
    pp = cfg.distributed.pp_size
    v = cfg.pipeline.interleave if cfg.pipeline.executor == "mpmd" else 1
    res = runs["port"]
    held = {}
    for rank in range(WORLD):
        r = res[rank][name]
        c = r["coords"]
        want = tllama.pipeline_stage(cfg.model.num_hidden_layers, pp,
                                     c["pp"], v).layers
        assert r["layers"] == want
        held.setdefault(c["pp"], set()).update(r["layers"])
        assert any(n.startswith(f"layers.{want[0]}.") for n in r["params"])
        base = next(b for b in range(WORLD) if res[b][name]["coords"] == {
            **c, "dp": 0, "cp": 0})
        assert r["losses"] == res[base][name]["losses"]
        for n, t in r["params"].items():
            assert torch.equal(t, res[base][name]["params"][n]), (rank, n)
    assert sorted(i for s in held.values() for i in s) == list(
        range(cfg.model.num_hidden_layers))


def test_pp_uneven_split_holds_no_pad_layer(runs):
    """3 layers over 2 stages: 2 on the first, 1 on the last (the JAX
    stack pads the last stage's second slot with an identity layer)."""
    by_stage = {runs["port"][r]["pp2_1f1b_3layers"]["coords"]["pp"]:
                runs["port"][r]["pp2_1f1b_3layers"]["layers"]
                for r in range(WORLD)}
    assert by_stage == {0: [0, 1], 1: [2]}
    assert tllama.pp_layer_placement(3, 2) == (4, [0, 1, 2])


def test_pp_checkpoint_resumes_bit_for_bit(runs):
    cursors = []
    for rank in range(WORLD):
        res = runs["port"][rank]["ckpt"]
        assert res["start_step"] == 2
        assert res["resumed"] == res["whole"]
        assert res["params_equal"]
        assert res["collectives"]["send_recv"] > 0
        assert res["pipeline"]["exchanges_per_step"] > 0
        cursors.append(res["cursor"])
    assert all(c == cursors[0] for c in cursors)
    assert cursors[0]["cursor"] > 0


def test_pp_tied_embedding_starts_and_stays_tied(runs):
    """The first and the last stage hold one tied embedding: their copies
    (each tp shard) are equal as the trainer draws them, and again after
    two steps that moved them."""
    by = {}
    for rank in range(WORLD):
        res = runs["port"][rank]["tied"]
        c = res["coords"]
        by.setdefault((c["dp"], c["tp"]), {})[c["pp"]] = res
    for key, ends in by.items():
        first, last = ends[0], ends[1]
        assert torch.equal(first["init"], last["init"]), key
        assert torch.equal(first["trained"], last["trained"]), key
        assert not torch.equal(first["init"], first["trained"]), key
    assert not torch.equal(by[(0, 0)][0]["init"], by[(0, 1)][0]["init"])


def test_pp_trace_spans_and_mid_schedule_sigterm(runs):
    """Each rank's trace holds one span per op of its stage's table per
    walk on its stage's lane, named stage/tick/op/mb; `sigterm@2#1`
    fires inside step 2's walk at tick 1 (on the ranks with an op
    there), the walk drains, and every rank exits 75 after step 2."""
    from picotron_tpu_torch.telemetry.flightdeck import TID_PP_BASE

    table = _table("mpmd_1f1b")
    fired_ranks = 0
    for rank in range(WORLD):
        res = runs["port"][rank]["flightdeck"]
        assert res["code"] == 75
        stage = res["pp_rank"]
        spans = [e for e in res["trace"]["traceEvents"]
                 if e.get("ph") == "X" and e["tid"] >= TID_PP_BASE]
        assert {e["tid"] for e in spans} == {TID_PP_BASE + stage}
        mine = [o for o in table if o.group == stage]
        want = [f"stage{o.vstage}/tick{o.tick}/{o.op}/mb{o.mb}"
                for o in mine]
        for step in (1, 2):
            got = [e["name"] for e in spans if e["args"]["step"] == step]
            assert sorted(got) == sorted(want), (rank, step)
        assert {e["args"]["step"] for e in spans} == {1, 2}
        fired = [e for e in res["events"] if e["kind"] == "chaos"]
        for e in fired:
            assert (e["point"], e["step"], e["tick"]) == (
                "schedule_tick", 2, 1)
            assert e["stage"] == stage
        fired_ranks += bool(fired)
        assert [e["step"] for e in res["events"]
                if e["kind"] == "preempted"] == [2]
    assert fired_ranks >= WORLD // 2


def test_pp_neighbours_are_the_rank_grids():
    sizes = {"dp": 2, "pp": 4, "ep": 1, "cp": 1, "tp": 1}
    groups = mesh.group_ranks(sizes, ("pp",))
    for g in groups:
        for s, rank in enumerate(g):
            coords = mesh.rank_coords(rank, sizes)
            assert coords["pp"] == s
            env = mesh.ParallelEnv(sizes=sizes, rank=rank, world_size=8,
                                   device=torch.device("cpu"),
                                   backend="gloo", tp_group=None,
                                   data_group=None, host_group=None,
                                   coords=coords, pp_ranks=tuple(g))
            assert env.pp_next == (g[s + 1] if s < 3 else None)
            assert env.pp_prev == (g[s - 1] if s > 0 else None)
            if env.pp_next is not None:
                assert env.pp_next == env.rank_at(pp=s + 1)
