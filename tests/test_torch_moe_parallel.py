"""The port's expert parallelism and MoE layouts on the CPU, in one gloo
world of 4 ranks, against the JAX package (the layouts and the config of
tests/test_moe.py:110-145: debug-tiny-moe in fp32, 8 q / 4 kv heads, 2
layers, 8 experts top-2, capacity factor 8.0 so that no assignment
drops at any layout, seq 32, mbs 2, ga 2, lr 1e-3; the JAX params
transplanted into every rank, the global batch made with numpy from a
seed, each rank taking its rows, data index dp * ep + ep, and its cp
slice):

- ep 4; ep 2 x tp 2; ep 2 x tp 2 with sequence parallelism; ep 2 x pp 2
  (1f1b and afab); ep 2 x cp 2 ring zigzag; dp 2 x ep 2 with ZeRO-1 (the
  JAX test's layout); and ep 2 under the fused engine (filled to 4 ranks
  with dp 2). Each layout's 3 losses against the JAX single-device step
  on the same global batch at tests/test_moe.py's rtol (2e-4; 1e-3
  under cp, whose split sequence may flip near-tie routes), and its
  step-1 grads (the data-reduced sums, every rank's shards assembled)
  against the port's single-device grads in relative L2 per tensor
  (1e-4; 1e-3 under cp). The router statistics are meaned over the data
  group (router_aux_global), and their mean carries its grad, so the
  grads hold to the single device's, which tests/test_moe.py (losses
  only) does not check. The all-to-alls per step: 2 per layer and
  microbatch forward and 2 backward (the dots_attn recompute of the
  fused engine adds 2 more).
- tests/test_moe.py:277's case: 3 layers at ep 2 x pp 2 with z-loss on
  (stage 0 holds 2 layers, stage 1 one; the port has no pad layers),
  losses against the JAX single device at 2e-4 and no drops reported.
- ZeRO-1 under ep: the banks' moments hold 1/dp of the bank's experts
  (their group is (dp, cp)), every other tensor's 1/(dp ep) of its rows.
- An ep 2 x tp 2 checkpoint through `train.run`: save after step 2,
  auto-resume to 4, equal to an uninterrupted run bit for bit.
- The ep communicator of `chip_smoke.py`'s thread world (the harness
  that runs ep 2 on one card) against `EPComm` on gloo at ep 4:
  `moe_mlp`'s output equal bit for bit, its grads (one backward over the
  joined graphs of the thread ranks) within 1e-6.

Outside the world: the loader's rows at ep 2 and at dp 2 x ep 2 against
the JAX loader's, token for token.

One world runs every rank-side check; the JAX side runs in this process
meanwhile. The worker code imports no jax.
"""

import numpy as np
import pytest
import torch

from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import data as tdata
from picotron_tpu_torch import mesh
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.data import cp_sequence_permutation
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.ops import moe as tmoe
from picotron_tpu_torch.ops.losses import IGNORE_INDEX
from picotron_tpu_torch.parallel import comm as tcomm
from picotron_tpu_torch.parallel import sharding
from picotron_tpu_torch.parallel.cp import cp_context
from picotron_tpu_torch.parallel.ep import ep_context
from picotron_tpu_torch.parallel.tp import tp_context
from tests.test_torch_parallel import STEPS, World, tiny_raw

LOSS_RTOL, CP_LOSS_RTOL = 2e-4, 1e-3    # tests/test_moe.py:180
GRAD_RTOL, CP_GRAD_RTOL = 1e-4, 1e-3    # relative L2 per tensor
MOE = {"name": "debug-tiny-moe", "num_hidden_layers": 2, "num_experts": 8,
       "num_experts_per_token": 2, "capacity_factor": 8.0}
FUSED = {"remat": True, "remat_policy": "dots_attn", "grad_engine": "fused"}


def moe_raw(model=None, training=None, **dist) -> dict:
    return tiny_raw(training=training, model={**MOE, **(model or {})},
                    **dist)


LAYOUTS = {
    "ep4": moe_raw(ep_size=4),
    "ep2_tp2": moe_raw(ep_size=2, tp_size=2),
    "ep2_tp2_sp": moe_raw(ep_size=2, tp_size=2, sequence_parallel=True),
    "ep2_pp2_1f1b": moe_raw(ep_size=2, pp_size=2),
    "ep2_pp2_afab": moe_raw(ep_size=2, pp_size=2, pp_engine="afab"),
    "ep2_cp2_ring": moe_raw(ep_size=2, cp_size=2),
    "dp2_ep2_zero1": moe_raw(dp_size=2, ep_size=2, zero1=True),
    "dp2_ep2_fused": moe_raw(dp_size=2, ep_size=2, training=FUSED),
    # tests/test_moe.py:277: an uneven split with z-loss on
    "ep2_pp2_3layers_zloss": moe_raw(
        model={"num_hidden_layers": 3, "router_z_coef": 1e-3},
        ep_size=2, pp_size=2),
}


def batch_of(raw: dict, seed: int = 7):
    """(ids, targets) [ga, mbs * dp * ep, seq] numpy int64: the global
    batch, the same content for every layout of as many rows, with
    IGNORE_INDEX targets in two rows (so that the ranks' token counts,
    which weigh each rank's router-loss grad, differ)."""
    cfg = tcfg.config_from_dict(raw)
    t, d = cfg.training, cfg.distributed
    toks = np.random.default_rng(seed).integers(
        0, cfg.model.vocab_size, (t.gradient_accumulation_steps,
                                  t.micro_batch_size * d.dp_size * d.ep_size,
                                  t.seq_length + 1))
    ids, tgt = toks[..., :-1].copy(), toks[..., 1:].copy()
    tgt[0, 0, :9] = IGNORE_INDEX
    tgt[-1, -1, -5:] = IGNORE_INDEX
    return ids, tgt


def rank_batch(batch, cfg, par):
    """This rank's rows (data index dp * ep + ep) of the global batch,
    permuted by the cp layout and cut to its cp slice, as torch int64."""
    mbs = cfg.training.micro_batch_size
    d = par.coords["dp"] * par.ep_size + par.ep_rank
    ids, tgt = (a[:, d * mbs:(d + 1) * mbs] for a in batch)
    perm = cp_sequence_permutation(cfg)
    if perm is not None:
        ids, tgt = ids[..., perm], tgt[..., perm]
    s = cfg.training.seq_length // cfg.distributed.cp_size
    c = par.coords["cp"]
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a[..., c * s:(c + 1) * s])).long() for a in (ids, tgt))


def build_rank(raw: dict, params: dict):
    """(cfg, par, TrainState) of this rank: its tp and ep shards of its
    stage."""
    cfg = tcfg.config_from_dict(raw)
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    model = tllama.LlamaModel(
        cfg.model, device="cpu",
        tp=tp_context(par, cfg.distributed.sequence_parallel),
        cp=cp_context(par, cfg), stage=ttrain.stage_of(cfg, par),
        ep=ep_context(par, cfg))
    model.load_state_dict(weights.stage_params(weights.params_from_jax(
        params, cfg.model, par.tp_rank, par.tp_size, ep_rank=par.ep_rank,
        ep_size=par.ep_size), model))
    return cfg, par, tstep.init_train_state(cfg, model, par)


def train_job(job: dict, spec: dict) -> dict:
    cfg, par, state = build_rank(job["raw"], spec["params"][job["name"]])
    step = tstep.make_train_step(cfg, par)
    batch = rank_batch(job["batch"], cfg, par)
    losses, drops, grads, a2a = [], [], None, None
    for _ in range(STEPS):
        before = tcomm.collectives["all_to_all"]
        m = step(state, batch)
        if grads is None:
            a2a = tcomm.collectives["all_to_all"] - before
            grads = {n: g.detach().clone() for n, g in
                     zip(state.optimizer.names, state.optimizer.grads)}
        losses.append(float(m["loss"]))
        drops.append(float(m["moe_drop_frac"]))
    kinds = state.optimizer.state_tensors()
    return {"losses": losses, "drops": drops, "grads": grads,
            "all_to_all": a2a, "coords": dict(par.coords),
            "moment_shapes": {n: tuple(t.shape)
                              for n, t in kinds["mu"].items()}}


def ckpt_job(job: dict, spec: dict) -> dict:
    """ep2 x tp2 through train.run: save after step 2 and auto-resume to
    4, and an uninterrupted 4 steps."""
    training = {"total_train_steps": 4, "seed": 5}
    tokens = tcfg.config_from_dict(
        moe_raw(ep_size=2, tp_size=2, training=training)).tokens_per_step

    def cfg(save_dir, **ck):
        raw = moe_raw(ep_size=2, tp_size=2, training=dict(training))
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
            "params_equal": same, "collectives": whole["collectives_per_step"]}


def op_inputs(seed: int = 2):
    """moe_mlp's inputs at ep 4: every rank's x [2, 8, 16] and dout, the
    router [16, 8] and whole banks [8, 16, 32] / [8, 32, 16]."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: (0.3 * rng.standard_normal(sh)).astype(np.float32)  # noqa: E731
    return {"x": f(4, 2, 8, 16), "dout": f(4, 2, 8, 16),
            "ws": [f(16, 8), f(8, 16, 32), f(8, 16, 32), f(8, 32, 16)]}


def run_op(comm, stats, rank: int, inp: dict):
    """This ep rank's moe_mlp over `comm` (its 2 experts), statistics
    meaned over `stats`: (out, x grad, weight grads)."""
    x = torch.from_numpy(inp["x"][rank]).requires_grad_()
    router, *banks = inp["ws"]
    ws = [torch.from_numpy(router).requires_grad_()] + [
        torch.from_numpy(b[2 * rank:2 * rank + 2]).requires_grad_()
        for b in banks]
    out, aux, _ = tmoe.moe_mlp(x, *ws, num_experts=8, top_k=2,
                               capacity_factor=2.0, ep=comm,
                               router_aux_coef=0.01, router_z_coef=1e-3,
                               stats=stats)
    return out, x, ws, (out * torch.from_numpy(inp["dout"][rank])).sum() + aux


def ops_job(job: dict, spec: dict) -> dict:
    cfg = tcfg.config_from_dict(moe_raw(ep_size=4))
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    ctx = ep_context(par, cfg)
    out, x, ws, loss = run_op(ctx.comm, ctx.stats, par.ep_rank,
                              spec["op_inputs"])
    loss.backward()
    return {"out": out.detach(), "grads": [x.grad] + [w.grad for w in ws]}


JOBS = {"train": train_job, "ckpt": ckpt_job, "ops": ops_job}


def params_of(raw: dict) -> dict:
    import jax

    from picotron_tpu import config as jcfg
    from picotron_tpu.models.llama import init_params

    jc = jcfg.config_from_dict(raw)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        init_params(jc.model, jax.random.key(0)))


def single_raw(raw: dict) -> dict:
    """The layout's config on one device at the global batch's rows."""
    cfg = tcfg.config_from_dict(raw)
    rows = cfg.training.micro_batch_size * cfg.distributed.dp_size \
        * cfg.distributed.ep_size
    out = moe_raw(model={k: v for k, v in raw["model"].items()
                         if k in ("num_hidden_layers", "router_z_coef")},
                  training={**raw["training"], "micro_batch_size": rows})
    return out


def jax_single_losses(raw: dict, params: dict, batch) -> list:
    """The JAX single-device step (tests/test_moe.py's reference)."""
    import jax
    import jax.numpy as jnp

    from picotron_tpu import config as jcfg
    from picotron_tpu import train_step as jstep

    jc = jcfg.config_from_dict(single_raw(raw))
    state = jstep.init_train_state(jc, jax.tree.map(jnp.asarray, params))
    step = jax.jit(jstep.make_train_step(jc))
    b = tuple(jnp.asarray(a, jnp.int32) for a in batch)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, b)
        losses.append(float(loss))
    return losses


def single_grads(raw: dict, params: dict, batch) -> dict:
    """The port's single-device summed grads of step 1 on the global
    batch."""
    cfg = tcfg.config_from_dict(single_raw(raw))
    model = tllama.LlamaModel(cfg.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(params, cfg.model))
    tstep.accumulate_grads(model, tuple(torch.from_numpy(a).long()
                                        for a in batch))
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def assemble(results: dict) -> dict:
    """{name: whole grad} from every rank's shards (the ranks at dp 0 and
    cp 0: the tp shards of each ep index's experts, each stage's
    layers)."""
    parts: dict = {}
    for res in results.values():
        c = res["coords"]
        if c["dp"] or c["cp"]:
            continue
        for n, g in res["grads"].items():
            parts.setdefault(n, {})[(c["ep"], c["tp"])] = g
    whole = {}
    for n, shards in parts.items():
        tdim, edim = sharding.tp_shard_dim(n), sharding.ep_shard_dim(n)
        eps = sorted({e for e, _ in shards})
        tps = sorted({t for _, t in shards})
        rows = []
        for e in eps:
            tp_parts = [shards[(e, t)] for t in tps]
            rows.append(tp_parts[0] if tdim is None
                        else torch.cat(tp_parts, tdim))
        whole[n] = rows[0] if edim is None else torch.cat(rows, edim)
    return whole


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = {name: params_of(raw) for name, raw in LAYOUTS.items()}
    jobs = [{"name": name, "kind": "train", "raw": raw,
             "batch": batch_of(raw)} for name, raw in LAYOUTS.items()]
    tmp = tmp_path_factory.mktemp("moeworld")
    jobs += [{"name": "ops", "kind": "ops"},
             {"name": "ckpt", "kind": "ckpt", "dir": str(tmp / "ckpt")}]
    world = World(tmp, 4, {"params": params, "jobs": jobs,
                           "op_inputs": op_inputs()}, JOBS)
    jax_losses = {name: jax_single_losses(raw, params[name], batch_of(raw))
                  for name, raw in LAYOUTS.items()}
    grads = {name: single_grads(raw, params[name], batch_of(raw))
             for name, raw in LAYOUTS.items()}
    return {"port": world.results(), "jax": jax_losses, "single": grads}


def _rtols(name):
    cp = "cp2" in name
    return (CP_LOSS_RTOL if cp else LOSS_RTOL), (CP_GRAD_RTOL if cp
                                                 else GRAD_RTOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moe_layouts_match_jax_and_the_single_device(runs, name):
    loss_rtol, grad_rtol = _rtols(name)
    ranks = runs["port"]
    for r in range(4):
        res = ranks[r][name]
        np.testing.assert_allclose(res["losses"], runs["jax"][name],
                                   rtol=loss_rtol, atol=2e-5,
                                   err_msg=f"{name} rank {r}")
        # capacity factor 8: nothing drops, and nothing is reported so
        assert res["drops"] == [0.0] * STEPS, res["drops"]
    got = assemble({r: ranks[r][name] for r in range(4)})
    want = runs["single"][name]
    assert set(got) == set(want)
    for n, w in want.items():
        err = float((got[n] - w).norm() / w.norm())
        assert err <= grad_rtol, (name, n, err)


@pytest.mark.parametrize("name", ["ep4", "ep2_tp2", "dp2_ep2_fused"])
def test_all_to_alls_per_step(runs, name):
    cfg = tcfg.config_from_dict(LAYOUTS[name])
    per = 2 * cfg.model.num_hidden_layers * cfg.training.\
        gradient_accumulation_steps
    # forward and backward, and the fused engine's recompute of the block
    want = per * (3 if "fused" in name else 2)
    for r in range(4):
        assert runs["port"][r][name]["all_to_all"] == want


def test_zero1_leaves_the_banks_unsharded_over_ep(runs):
    cfg = tcfg.config_from_dict(LAYOUTS["dp2_ep2_zero1"])
    e_local = cfg.model.num_experts // 2
    for r in range(4):
        shapes = runs["port"][r]["dp2_ep2_zero1"]["moment_shapes"]
        # the banks: 1/dp of the rank's experts
        assert shapes["layers.0.w_gate"][0] == e_local // 2
        # the q projection: 1/(dp ep) of its rows
        assert shapes["layers.0.q"][0] == (cfg.model.num_attention_heads
                                           * cfg.model.head_dim // 4)
        # the router [H, E]: 1/(dp ep) of its rows
        assert shapes["layers.0.router"][0] == cfg.model.hidden_size // 4


def test_ep_checkpoint_resumes_bit_for_bit(runs):
    for rank in range(4):
        res = runs["port"][rank]["ckpt"]
        assert res["start_step"] == 2
        assert res["resumed"] == res["whole"]
        assert res["params_equal"]
        assert res["collectives"]["all_to_all"] > 0


def test_thread_world_matches_gloo(runs):
    import chip_smoke

    inp = op_inputs()
    world = chip_smoke.ThreadWorld(4)
    outs = {}

    def rank(r):
        comm = chip_smoke.ThreadEPComm(world, r)
        out, x, ws, loss = run_op(comm, chip_smoke.ThreadMean(world, r), r,
                                  inp)
        outs[r] = (out, x, ws, loss)

    world.run(rank)
    # the thread world's exchanges are autograd ops between the ranks'
    # graphs: one backward over the sum of the ranks' losses
    sum(o[3] for o in outs.values()).backward()
    for r in range(4):
        got = runs["port"][r]["ops"]
        out, x, ws, _ = outs[r]
        assert torch.equal(out.detach(), got["out"])
        # the grads through the statistics' mean are summed in another
        # order (autograd's against gloo's all-reduce)
        for g, w in zip([x.grad] + [w.grad for w in ws], got["grads"]):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_chip_smoke_ep_phase_on_the_cpu():
    """`chip_smoke.py` phase 11d's check (ep 2 in a thread world against
    ep 1 on the same params and global batch) at the tiny config in fp32
    on the CPU, where it must hold far inside its card limits."""
    import chip_smoke
    from picotron_tpu_torch.ops import flash_attention as fa

    cfg = tcfg.config_from_dict(moe_raw(model={"dtype": "float32"}))
    res = chip_smoke.moe_ep_phase(fa, ".", "cpu", cfg=cfg, dev="cpu",
                                  seq=cfg.training.seq_length)
    assert res["loss_rel_err"] <= 1e-6
    assert res["worst_grad_rel_l2"] <= 1e-5
    assert res["all_to_all_per_rank"] == [2 * cfg.model.num_hidden_layers] * 2


@pytest.mark.parametrize("dist", [dict(ep_size=2), dict(dp_size=2,
                                                        ep_size=2)])
def test_loader_ep_rows_match_the_jax_global_batch(dist):
    from picotron_tpu import config as jcfg
    from picotron_tpu import data as jdata
    from picotron_tpu.mesh import MeshEnv

    raw = moe_raw(training={"num_samples": 40}, **dist)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    jl = jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
    dp, ep = tc.distributed.dp_size, tc.distributed.ep_size
    loaders = {(d, e): tdata.MicroBatchDataLoader(tc, "cpu", dp_rank=d,
                                                  ep_rank=e)
               for d in range(dp) for e in range(ep)}
    mbs = tc.training.micro_batch_size
    for _ in range(6):  # through an epoch boundary
        ji, jt = (np.asarray(a) for a in next(jl))
        assert ji.shape[1] == mbs * dp * ep
        for (d, e), tl in loaders.items():
            ti, tt = next(tl)
            rows = slice((d * ep + e) * mbs, (d * ep + e + 1) * mbs)
            np.testing.assert_array_equal(ti.numpy(), ji[:, rows])
            np.testing.assert_array_equal(tt.numpy(), jt[:, rows])
            assert tl.state == jl.state
    with pytest.raises(ValueError, match="ep_rank 2"):
        tdata.MicroBatchDataLoader(tc, "cpu", ep_rank=2)
