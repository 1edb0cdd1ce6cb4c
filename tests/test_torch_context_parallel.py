"""The port's context parallelism on the CPU, in one gloo world of 4
ranks, against the JAX package on its simulated host devices (the
harness and the tiny config of tests/test_torch_parallel.py: fp32, 8 q /
4 kv heads, 4 layers, seq 32, so that zigzag chunks of 4 tokens sit in
one 64-row kernel tile, mbs 2, ga 2; the JAX params transplanted into
every rank, the batch made with numpy from a seed):

- Op units: ring, Ulysses and mesh (2x2, 4x1, 1x4), zigzag and
  contiguous, GQA, forward (out and the saved lse) and `*_bwd_from_saved`
  (dq, dk, dv) on every rank, against the JAX functions under shard_map
  at fp32 rtol/atol 1e-5; Ulysses through the flash path with RoPE fused
  (the model's), ring and mesh over the plain blocks.
- The thread-world communicator of `chip_smoke.py` (the harness that
  drives the schedules on one card) against `CPComm` on gloo: the same
  schedule gives the same tensors, bit for bit.
- Layouts, 3 steps each: cp4 ring zigzag, cp4 ring contiguous, cp4
  Ulysses, cp4 mesh 2x2 (each under the AD and the fused engine), cp2 x
  tp2 Ulysses with sequence parallelism (both engines), cp2 x dp2 ring
  zigzag zero1 (fused; runs/llama2-7b-cp4-seq8192's shape): losses and
  every final param against the JAX driver at its layout tolerance
  (tests/test_parallel.py:124-139); the guard's grad norms (rtol 1e-5)
  and the eval loss on the initial params (rtol 1e-5) against the
  port's own single-device run on the same global batch; the cp ranks'
  params equal bit for bit; the cp exchanges per step counted.
- The JAX cp driver's grad norm against the single-device one: it
  carries the data-axes factor of ROADMAP Queue 3 item 4 (the cp size
  times the dp size), which the port's does not.
- Checkpoints at cp4 (ring, zigzag, fused, zero1) through `train.run`:
  save after step 2, auto-resume to 4, equal to an uninterrupted run bit
  for bit (losses and every rank's params).

One world runs every rank-side check; the JAX side runs in this process
meanwhile. The worker code imports no jax.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import mesh
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.data import cp_sequence_permutation
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.ops import mesh_attention as tma
from picotron_tpu_torch.ops import ring_attention as tra
from picotron_tpu_torch.ops import ulysses as tul
from picotron_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.rope import rope_tables
from picotron_tpu_torch.parallel import comm as tcomm
from picotron_tpu_torch.parallel.cp import cp_context
from picotron_tpu_torch.parallel.tp import tp_context
from tests.test_torch_parallel import (
    LOSS_TOL, PARAM_TOL, STEPS, UNIT_TOL, World, full_tree, global_batch,
    jax_init_params, jax_run, leaves, rank_rows, single_eval, tiny_raw,
    worst_errors,
)

CP = 4
FUSED = {"remat": True, "remat_policy": "dots_attn", "grad_engine": "fused"}
CONTIG = {"cp_layout": "contiguous"}
ULYSSES = {"cp_flavor": "ulysses"}
MESH = {"cp_flavor": "mesh", "cp_mesh": "2x2"}
LAYOUTS = {
    "cp4_ring_zigzag": tiny_raw(cp_size=4),
    "cp4_ring_zigzag_fused": tiny_raw(cp_size=4, training=FUSED),
    "cp4_ring_contiguous": tiny_raw(cp_size=4, **CONTIG),
    "cp4_ring_contiguous_fused": tiny_raw(cp_size=4, training=FUSED,
                                          **CONTIG),
    "cp4_ulysses": tiny_raw(cp_size=4, **ULYSSES),
    "cp4_ulysses_fused": tiny_raw(cp_size=4, training=FUSED, **ULYSSES),
    "cp4_mesh_2x2": tiny_raw(cp_size=4, **MESH),
    "cp4_mesh_2x2_fused": tiny_raw(cp_size=4, training=FUSED, **MESH),
    "cp2_tp2_ulysses_sp": tiny_raw(cp_size=2, tp_size=2,
                                   sequence_parallel=True, **ULYSSES),
    "cp2_tp2_ulysses_sp_fused": tiny_raw(cp_size=2, tp_size=2,
                                         sequence_parallel=True,
                                         training=FUSED, **ULYSSES),
    "cp2_tp2_ring_sp": tiny_raw(cp_size=2, tp_size=2,
                                sequence_parallel=True),
    "cp2_dp2_zero1_fused": tiny_raw(cp_size=2, dp_size=2, zero1=True,
                                    training=FUSED),
}
# cp exchanges per step: per layer and microbatch, the ring's forward
# takes cp-1 hops and its backward cp (the dk/dv home hop); Ulysses
# scatters q/k/v and gathers out forward, scatters q/k/v/out/dout and
# gathers dq/dk/dv backward; the mesh 2x2 does both within rows of 2
PER_LAYER = {"ring4": {"send_recv": 7, "all_to_all": 0},
             "ulysses": {"send_recv": 0, "all_to_all": 12},
             "mesh2x2": {"send_recv": 3, "all_to_all": 12},
             "ring2": {"send_recv": 3, "all_to_all": 0}}
EXCHANGES = {"cp4_ring_zigzag": "ring4", "cp4_ring_zigzag_fused": "ring4",
             "cp4_ring_contiguous": "ring4",
             "cp4_ring_contiguous_fused": "ring4",
             "cp4_ulysses": "ulysses", "cp4_ulysses_fused": "ulysses",
             "cp4_mesh_2x2": "mesh2x2", "cp4_mesh_2x2_fused": "mesh2x2",
             "cp2_tp2_ulysses_sp": "ulysses",
             "cp2_tp2_ulysses_sp_fused": "ulysses",
             "cp2_tp2_ring_sp": "ring2",
             "cp2_dp2_zero1_fused": "ring2"}

# op units: (flavor, cp_layout, cp_mesh); "_gathered": each rank passes
# only its own positions, which the schedule all-gathers (for Ulysses
# without the static layout, so the inner call takes explicit positions)
OPS = {
    "ring_zigzag": ("ring", "zigzag", ""),
    "ring_contiguous": ("ring", "contiguous", ""),
    "ulysses_zigzag": ("ulysses", "zigzag", ""),
    "ulysses_contiguous": ("ulysses", "contiguous", ""),
    "mesh_2x2_zigzag": ("mesh", "zigzag", "2x2"),
    "mesh_2x2_contiguous": ("mesh", "contiguous", "2x2"),
    "mesh_4x1_zigzag": ("mesh", "zigzag", "4x1"),
    "mesh_1x4_zigzag": ("mesh", "zigzag", "1x4"),
    "ring_zigzag_gathered": ("ring", "zigzag", ""),
    "ulysses_zigzag_gathered": ("ulysses", "zigzag", ""),
    "mesh_2x2_zigzag_gathered": ("mesh", "zigzag", "2x2"),
}
OP_SHAPE = (2, 32, 8, 4, 16)  # B, S, Hq, Hkv, D
OUTPUTS = ("out", "lse", "dq", "dk", "dv")


def op_raw(case: str) -> dict:
    flavor, lay, cp_mesh = OPS[case]
    d = {"cp_size": CP, "cp_flavor": flavor, "cp_layout": lay}
    if cp_mesh:
        d["cp_mesh"] = cp_mesh
    return tiny_raw(**d)


def op_inputs(seed: int = 0):
    b, s, hq, hkv, d = OP_SHAPE
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                            (b, s, hq, d)))


def run_op(case: str, comm, full) -> dict:
    """This rank's {output: tensor} of one op unit: its slice of the
    (permuted) inputs through the schedule and its backward from the
    saved (out, lse), over `comm`."""
    from picotron_tpu_torch.parallel.cp import layout_from_config

    cfg = tcfg.config_from_dict(op_raw(case))
    flavor, _, cp_mesh = OPS[case]
    layout = layout_from_config(cfg)
    idx = torch.as_tensor(layout.positions[comm.index])
    q, k, v, do = (torch.from_numpy(a)[:, idx].contiguous() for a in full)
    pos = ({"q_positions": idx} if case.endswith("_gathered")
           else {"layout": layout})
    if flavor == "ulysses":
        rope = rope_tables(64, OP_SHAPE[-1])
        if "layout" in pos:
            full_pos, seq_sort = tul.ulysses_static_layout(layout.full())
            kw = dict(rope=rope, seq_sort=seq_sort, full_positions=full_pos,
                      positions_static=True)
        else:
            kw = dict(rope=rope, **pos)
        out, lse = tul.ulysses_attention(q, k, v, comm,
                                         attn_fn=flash_attention,
                                         return_lse=True, **kw)
        grads = tul.ulysses_attention_bwd_from_saved(
            q, k, v, out, lse, do, comm,
            attn_bwd=flash_attention_bwd_from_saved, **kw)
    elif flavor == "ring":
        out, lse = tra.ring_attention(q, k, v, comm, return_lse=True, **pos)
        grads = tra.ring_attention_bwd_from_saved(q, k, v, out, lse, do,
                                                  comm, **pos)
    else:
        mesh_xy = tuple(int(x) for x in cp_mesh.split("x"))
        out, lse = tma.mesh_attention(q, k, v, comm, cp_mesh=mesh_xy,
                                      return_lse=True, **pos)
        grads = tma.mesh_attention_bwd_from_saved(
            q, k, v, out, lse, do, comm, cp_mesh=mesh_xy, **pos)
    return dict(zip(OUTPUTS, (out, lse, *grads)))


def jax_op(case: str, full) -> list:
    """The JAX schedule on the same inputs under shard_map: per device
    (cp index) {output: array}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from picotron_tpu import compat
    from picotron_tpu.data import cp_sequence_permutation as jperm
    from picotron_tpu.mesh import MeshEnv
    import importlib

    from picotron_tpu import config as jcfg
    from picotron_tpu.ops.flash_attention import flash_attention as jflash
    from picotron_tpu.ops.rope import rope_tables as jrope

    # the modules (picotron_tpu.ops re-exports functions of these names)
    jma, jra, jul = (importlib.import_module(f"picotron_tpu.ops.{m}")
                     for m in ("mesh_attention", "ring_attention",
                               "ulysses"))

    jc = jcfg.config_from_dict(op_raw(case))
    flavor, _, cp_mesh = OPS[case]
    perm = jperm(jc)
    perm = np.arange(OP_SHAPE[1]) if perm is None else perm
    menv = MeshEnv.create(cp=CP)

    def body(q, k, v, do, pos):
        if flavor == "ulysses":
            kw = dict(q_positions=pos, rope=jrope(64, OP_SHAPE[-1]))
            if not case.endswith("_gathered"):
                full_pos, seq_sort = jul.ulysses_static_layout(jc)
                kw.update(seq_sort=seq_sort, full_positions=full_pos,
                          positions_static=True)
            out, lse = jul.ulysses_attention(q, k, v, attn_fn=jflash,
                                             return_lse=True, **kw)
            grads = jul.ulysses_attention_bwd_from_saved(q, k, v, out, lse,
                                                         do, **kw)
        elif flavor == "ring":
            out, lse = jra.ring_attention(q, k, v, q_positions=pos,
                                          return_lse=True)
            grads = jra.ring_attention_bwd_from_saved(q, k, v, out, lse, do,
                                                      q_positions=pos)
        else:
            mesh_xy = tuple(int(x) for x in cp_mesh.split("x"))
            out, lse = jma.mesh_attention(q, k, v, cp_mesh=mesh_xy,
                                          q_positions=pos, return_lse=True)
            grads = jma.mesh_attention_bwd_from_saved(
                q, k, v, out, lse, do, cp_mesh=mesh_xy, q_positions=pos)
        return tuple(x[None] for x in (out, lse, *grads))

    fn = jax.jit(compat.shard_map(
        body, mesh=menv.mesh, in_specs=(P(None, "cp"),) * 4 + (P("cp"),),
        out_specs=(P("cp"),) * 5))
    res = fn(*(jnp.asarray(a[:, perm]) for a in full),
             jnp.asarray(perm, jnp.int32))
    return [{k: np.asarray(x[r]) for k, x in zip(OUTPUTS, res)}
            for r in range(CP)]


def ops_job(job: dict, spec: dict) -> dict:
    """Every op unit on this rank over `CPComm`: {case: {output}}, and
    the ring neighbours of each layout against the rank grid."""
    out = {"neighbours": []}
    for case in OPS:
        cfg = tcfg.config_from_dict(op_raw(case))
        par = mesh.init_parallel(cfg, torch.device("cpu"))
        out[case] = run_op(case, tcomm.CPComm(par), spec["op_inputs"])
        c = par.cp_rank
        out["neighbours"].append(
            (par.cp_next, par.rank_at(cp=(c + 1) % CP), par.cp_prev,
             par.rank_at(cp=(c - 1) % CP)))
    return out


def cp_rows(batch, cfg, par):
    """This rank's dp rows of the global batch, permuted by the cp layout
    and cut to its cp slice, as torch int64."""
    ids, tgt = rank_rows(batch, cfg, par.coords["dp"])
    perm = cp_sequence_permutation(cfg)
    if perm is not None:
        ids, tgt = ids[..., perm], tgt[..., perm]
    s = cfg.training.seq_length // cfg.distributed.cp_size
    c = par.coords["cp"]
    return ids[..., c * s:(c + 1) * s].contiguous(), \
        tgt[..., c * s:(c + 1) * s].contiguous()


def build_cp_rank(raw: dict, params: dict):
    """(cfg, par, TrainState) of this rank: its tp shards of `params`, its
    cp context."""
    cfg = tcfg.config_from_dict(raw)
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    model = tllama.LlamaModel(
        cfg.model, device="cpu",
        tp=tp_context(par, cfg.distributed.sequence_parallel),
        cp=cp_context(par, cfg))
    model.load_state_dict(weights.params_from_jax(
        params, cfg.model, par.tp_rank, par.tp_size))
    return cfg, par, tstep.init_train_state(cfg, model, par)


def train_cp_job(job: dict, spec: dict) -> dict:
    """STEPS steps of `job["raw"]` on its batch: losses, grad norms, the
    eval loss on the initial params, the final params and the cp
    exchanges of one step."""
    cfg, par, state = build_cp_rank(job["raw"], spec["params"])
    step = tstep.make_train_step(cfg, par)
    batch = cp_rows(job["batch"], cfg, par)
    eval0 = float(tstep.make_eval_step(cfg, par)(state.model, batch))
    losses, norms, exchanges = [], [], None
    for _ in range(STEPS):
        before = dict(tcomm.collectives)
        m = step(state, batch)
        if exchanges is None:
            exchanges = {k: tcomm.collectives[k] - before[k]
                         for k in ("send_recv", "all_to_all")}
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "eval0": eval0,
            "exchanges": exchanges, "coords": dict(par.coords),
            "params": {n: p.detach().float().clone()
                       for n, p in state.model.named_parameters()}}


def ckpt_job(job: dict, spec: dict) -> dict:
    """cp4 ring zigzag, fused, zero1 through train.run: save after step 2
    and auto-resume to 4, and an uninterrupted 4 steps."""
    training = {**FUSED, "total_train_steps": 4, "seed": 5}
    tokens = tcfg.config_from_dict(
        tiny_raw(cp_size=4, zero1=True, training=training)).tokens_per_step

    def cfg(save_dir, **ck):
        raw = tiny_raw(cp_size=4, zero1=True, training=dict(training))
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
            "params_equal": same,
            "collectives": whole["collectives_per_step"]}


JOBS = {"train": train_cp_job, "ops": ops_job, "ckpt": ckpt_job}


def batch_of(raw: dict):
    return global_batch(raw, seed=3)


def jax_cp_run(raw: dict, batch) -> dict:
    """The JAX driver on a cp layout: the batch permuted as its loader
    permutes it (tests/test_parallel.py `run_parallel`)."""
    from picotron_tpu import config as jcfg
    from picotron_tpu.data import cp_sequence_permutation as jperm

    perm = jperm(jcfg.config_from_dict(raw))
    if perm is not None:
        batch = tuple(a[..., perm] for a in batch)
    return jax_run(raw, batch)


def single_run(params: dict, batch) -> dict:
    """The port's single-device run on the whole global batch: losses,
    grad norms, eval loss on the initial params."""
    rows = batch[0].shape[1]
    cfg = tcfg.config_from_dict(tiny_raw(
        training={"micro_batch_size": rows}))
    model = tllama.LlamaModel(cfg.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(params, cfg.model))
    state = tstep.init_train_state(cfg, model)
    step = tstep.make_train_step(cfg)
    b = tuple(torch.from_numpy(a).long() for a in batch)
    ms = [step(state, b) for _ in range(STEPS)]
    return {"losses": [float(m["loss"]) for m in ms],
            "grad_norms": [float(m["grad_norm"]) for m in ms],
            "eval0": single_eval(params, batch)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jax_init_params(LAYOUTS["cp4_ring_zigzag"])
    full = op_inputs()
    jobs = [{"name": name, "kind": "train", "raw": raw,
             "batch": batch_of(raw)} for name, raw in LAYOUTS.items()]
    tmp = tmp_path_factory.mktemp("cpworld")
    jobs += [{"name": "ops", "kind": "ops"},
             {"name": "ckpt", "kind": "ckpt", "dir": str(tmp / "ckpt")}]
    world = World(tmp, 4, {"params": params, "jobs": jobs,
                           "op_inputs": full}, JOBS)
    jax_ops = {case: jax_op(case, full) for case in OPS}
    want = {name: jax_cp_run(raw, batch_of(raw))
            for name, raw in LAYOUTS.items()}
    singles = {}
    for name, raw in LAYOUTS.items():
        rows = batch_of(raw)[0].shape[1]
        if rows not in singles:
            singles[rows] = single_run(params, batch_of(raw))
    return {"port": world.results(), "jax": want, "jax_ops": jax_ops,
            "op_inputs": full, "single": singles}


def _single(runs, layout):
    return runs["single"][batch_of(LAYOUTS[layout])[0].shape[1]]


@pytest.mark.parametrize("case", list(OPS))
def test_cp_ops_match_jax(runs, case):
    for r in range(CP):
        got, want = runs["port"][r]["ops"][case], runs["jax_ops"][case][r]
        for key in OUTPUTS:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       err_msg=f"rank {r} {key}", **UNIT_TOL)


def test_cp_ring_neighbours_are_the_rank_grids(runs):
    for r in range(CP):
        for nxt, want_nxt, prv, want_prv in runs["port"][r]["ops"][
                "neighbours"]:
            assert (nxt, prv) == (want_nxt, want_prv)


@pytest.mark.parametrize("case", list(OPS))
def test_thread_world_matches_gloo(runs, case):
    world = chip_smoke.ThreadWorld(CP)
    got = world.run(lambda r: run_op(case, world.comm(r), runs["op_inputs"]))
    for r in range(CP):
        for key in OUTPUTS:
            assert torch.equal(got[r][key], runs["port"][r]["ops"][case][key]), \
                (r, key)


def _tp_shards(runs, layout):
    """Every tp rank's params of data rank 0 (cp 0, dp 0)."""
    res = runs["port"]
    tp = LAYOUTS[layout]["distributed"].get("tp_size", 1)
    return [res[r][layout]["params"] for r in range(tp)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cp_layouts_match_jax(runs, layout):
    got, want = runs["port"][0][layout], runs["jax"][layout]
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    have = leaves(full_tree(LAYOUTS[layout], _tp_shards(runs, layout)))
    for k, w in leaves(want["params"]).items():
        np.testing.assert_allclose(have[k], w, err_msg=k, **PARAM_TOL)
    print(f"{layout}: losses max abs diff "
          f"{np.abs(np.subtract(got['losses'], want['losses'])).max():.3g}, "
          f"params (abs, rel-to-max) "
          f"{worst_errors(have, leaves(want['params']))}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cp_grad_norms_and_eval_match_one_device(runs, layout):
    one = _single(runs, layout)
    for rank in range(4):
        got = runs["port"][rank][layout]
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["eval0"], one["eval0"], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cp_ranks_hold_the_same_params(runs, layout):
    res = runs["port"]
    for rank in range(4):
        c = res[rank][layout]["coords"]
        base = next(r for r in range(4)
                    if res[r][layout]["coords"] == {**c, "cp": 0, "dp": 0})
        assert res[rank][layout]["losses"] == res[base][layout]["losses"]
        for n, t in res[rank][layout]["params"].items():
            assert torch.equal(t, res[base][layout]["params"][n]), (rank, n)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cp_exchanges_per_step(runs, layout):
    cfg = tcfg.config_from_dict(LAYOUTS[layout])
    t = cfg.training
    per = PER_LAYER[EXCHANGES[layout]]
    n = cfg.model.num_hidden_layers * t.gradient_accumulation_steps
    for rank in range(4):
        assert runs["port"][rank][layout]["exchanges"] == {
            k: v * n for k, v in per.items()}


def test_jax_cp_driver_grad_norm_carries_the_data_axes_factor(runs):
    """ROADMAP Queue 3 item 4 under cp: the JAX trainer's grad norm is the
    single-device one times the size of the data axes (cp x dp); the
    port's is the single-device one (the test above)."""
    for layout, raw in LAYOUTS.items():
        d = raw["distributed"]
        factor = d.get("cp_size", 1) * d.get("dp_size", 1)
        np.testing.assert_allclose(
            runs["jax"][layout]["grad_norms"][0],
            factor * _single(runs, layout)["grad_norms"][0], rtol=1e-4,
            err_msg=layout)


def test_cp_checkpoint_resumes_bit_for_bit(runs):
    for rank in range(4):
        res = runs["port"][rank]["ckpt"]
        assert res["start_step"] == 2
        assert res["resumed"] == res["whole"]
        assert res["params_equal"]
        assert res["collectives"]["send_recv"] > 0


@pytest.mark.parametrize("name", [
    "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
    "ncclKernel_SendRecv_RING_SIMPLE_Sum_int8_t(ncclDevComm*, unsigned long)",
    "ncclDevKernel_AllToAll_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
    "ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage)"])
def test_profile_step_puts_the_cp_exchanges_in_nccl(name):
    from picotron_tpu_torch.profile_step import kernel_class

    assert kernel_class(name) == "nccl"


def _hammer(count, n_threads: int, per: int) -> None:
    """`count()` from n_threads threads, per times each, with more threads
    than cores and a short switch interval (restored after)."""
    import sys
    import threading

    old = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=lambda: [count()
                                                    for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_flash_launch_counts_lose_nothing_under_threads():
    """The thread worlds launch from several threads at once: the flash
    wrappers' counts (read-modify-write under a lock) must lose no
    update, with more threads than cores and a short switch interval.

    The gate can fail: the same harness runs a planted lock-free counter
    that yields the interpreter lock between its read and its write (any
    call there can, on CPython 3.12), and must catch it losing updates.
    `_count`'s own `+=` on a dict entry makes no call between its read
    and its write, so on CPython 3.12 it would lose nothing even without
    its lock; the lock, and this gate, guard a body that can switch
    threads inside the update, which the planted counter stands for."""
    import os
    import time

    from picotron_tpu_torch.ops import flash_attention as fa

    n_threads, per = 2 * (os.cpu_count() or 4) + 1, 2000
    planted = {"flash_fwd": 0}

    def lock_free():
        n = planted["flash_fwd"]
        time.sleep(0)  # yields the interpreter lock mid-update
        planted["flash_fwd"] = n + 1

    _hammer(lock_free, n_threads, 200)
    assert planted["flash_fwd"] < n_threads * 200, \
        "the harness missed the planted lock-free counter's lost updates"

    fa.reset_launch_counts()
    _hammer(lambda: fa._count("flash_fwd", fa.fwd_launches, torch.bfloat16),
            n_threads, per)
    assert fa.launches["flash_fwd"] == n_threads * per
    assert fa.fwd_launches == {"tensor_core": n_threads * per, "cuda_core": 0}
    fa.reset_launch_counts()
