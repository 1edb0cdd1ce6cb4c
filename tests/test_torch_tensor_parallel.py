"""The port's Megatron tensor-parallel layouts on the CPU, in one gloo
world of 4 ranks, against the JAX package on its simulated host devices
(the harness and the tiny config of tests/test_torch_parallel.py):

- tp4 (at mbs 4, so that every layout reads one global batch), tp4 with
  sequence parallelism (also with clipping by the whole model's grad
  norm, bf16 moments, weight decay and a cosine schedule after warmup),
  dp2 x tp2 x SP x zero1 under the AD engine, and
  the same under remat "dots_attn" and the fused grad engine: 3 steps'
  losses at rtol 2e-4 / atol 2e-5 and every final param
  at rtol 2e-2 / atol 1e-3 (tests/test_parallel.py:124-139); the guard's
  grad norms (the whole model's, tp-sharded squares summed over tp) of
  tp4 against the JAX driver's and of the dp2 x tp2 layouts against the
  port's tp4 run (the JAX dp driver's norm grows with dp:
  tests/test_torch_parallel.py's docstring); the dp ranks' params equal
  bit for bit.
- The fused engine (also with the chunked vocab-parallel CE) and the AD
  engine without remat and under each other remat policy, against the
  AD engine under "dots_attn", at dp2 x tp2 x SP on one step's reduced
  grads: the loss at rtol 1e-5 and each grad tensor within 1e-5 of its
  largest value (tests/test_torch_fused_bwd.py's bound).
- Each layout's eval loss on the initial params (`make_eval_step` under
  the layout) against the single-device port's at rtol 1e-5, and an HF
  safetensors init under dp2 x tp2 equal to the transplanted shards bit
  for bit.
- Checkpoints at dp2 x tp2 x zero1 through `train.run`: save after step
  2, auto-resume to step 4, equal to an uninterrupted run bit for bit
  (losses and every rank's params); restoring it under tp4 is refused,
  naming both layouts (tp is not elastic-resizable), and
  `restore_params_only` reads its per-rank tp shards whole.
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
from tests.test_torch_parallel import (
    LOSS_TOL, PARAM_TOL, World, build_rank, full_tree, global_batch,
    jax_init_params, jax_run, leaves, rank_rows, single_eval, tiny_raw,
    train_job, worst_errors,
)

FUSED = {"remat": True, "remat_policy": "dots_attn", "grad_engine": "fused"}
# tp4 at mbs 4: every layout here reads one global batch of 4 rows
MBS4 = {"micro_batch_size": 4}
LAYOUTS = {
    "tp4": tiny_raw(tp_size=4, training=MBS4),
    "tp4_sp": tiny_raw(tp_size=4, sequence_parallel=True, training=MBS4),
    # clipping by the whole model's norm (0.05 is below every step's),
    # bf16 moments, weight decay, cosine after a warmup step
    "tp4_sp_clip": tiny_raw(
        tp_size=4, sequence_parallel=True,
        training={**MBS4, "grad_clip_norm": 0.05, "weight_decay": 0.1,
                  "adam_moments_dtype": "bfloat16", "lr_schedule": "cosine",
                  "lr_warmup_steps": 1, "total_train_steps": 3}),
    "dp2_tp2_sp_zero1": tiny_raw(dp_size=2, tp_size=2,
                                 sequence_parallel=True, zero1=True),
    "dp2_tp2_sp_zero1_fused": tiny_raw(
        dp_size=2, tp_size=2, sequence_parallel=True, zero1=True,
        training=FUSED),
}
TP = {"tp4": 4, "tp4_sp": 4, "tp4_sp_clip": 4, "dp2_tp2_sp_zero1": 2,
      "dp2_tp2_sp_zero1_fused": 2}


# one step's grads at dp2 x tp2 x SP, each against "ad" (AD, dots_attn)
GRAD_VARIANTS = {
    "ad": {**FUSED, "grad_engine": "ad"},
    "fused": FUSED,
    "fused_ce_chunk": {**FUSED, "ce_chunk_size": 32},
    "ad_no_remat": {"remat": False, "grad_engine": "ad"},
    **{f"ad_{p}": {"remat": True, "remat_policy": p, "grad_engine": "ad"}
       for p in ("full", "dots", "dots_lean", "dots_norms")},
}


def grads_job(job: dict, spec: dict) -> dict:
    """One step's reduced token-mean grads at dp2 x tp2 x SP under each
    of GRAD_VARIANTS: {variant: (loss, {name: grad shard})}."""
    out = {}
    for variant, training in GRAD_VARIANTS.items():
        raw = tiny_raw(dp_size=2, tp_size=2, sequence_parallel=True,
                       training=training)
        cfg, par, state = build_rank(raw, spec["params"])
        assert tstep.resolved_grad_engine(cfg) == training["grad_engine"]
        opt = state.optimizer
        loss, scale = tstep.make_grads_fn(cfg, par)(
            state.model, rank_rows(job["batch"], cfg, par.coords["dp"]),
            opt.grad_of)
        out[variant] = (float(loss), {n: (g * scale).clone()
                                      for n, g in zip(opt.names, opt.grads)})
    return out


def hf_job(job: dict, spec: dict) -> bool:
    """An HF safetensors init at dp2 x tp2: every rank's shards equal the
    transplanted ones bit for bit."""
    raw = tiny_raw(dp_size=2, tp_size=2)
    raw["checkpoint"] = {"init_from_hf": job["hf_dir"]}
    cfg = tcfg.config_from_dict(raw)
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    state = ttrain.build_state(cfg, torch.device("cpu"), par)[0]
    want = weights.params_from_jax(spec["params"], cfg.model, par.tp_rank,
                                   par.tp_size)
    return all(torch.equal(p, want[n])
               for n, p in state.model.named_parameters())


def ckpt_job(job: dict, spec: dict) -> dict:
    """Save after step 2 and auto-resume to 4, an uninterrupted 4 steps,
    and a restore of the checkpoint under tp4."""
    base = tiny_raw(dp_size=2, tp_size=2, zero1=True,
                    training={"total_train_steps": 4, "seed": 5})
    tokens = tcfg.config_from_dict(base).tokens_per_step

    def cfg(save_dir, tp4=False, **ck):
        raw = tiny_raw(**({"tp_size": 4} if tp4 else
                          {"dp_size": 2, "tp_size": 2, "zero1": True}),
                       training=dict(base["training"]))
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
    try:
        ttrain.run(tcfg.config_from_dict(
            cfg(job["dir"] + "/c", tp4=True, load_path=job["dir"] + "/a")),
            "cpu")
        refused = None
    except RuntimeError as e:
        refused = str(e)
    whole_params, _ = tckpt.restore_params_only(
        tcfg.config_from_dict(resumable), job["dir"] + "/a")
    whole_params = {n: tuple(t.shape) for n, t in whole_params.items()}
    return {"resumed": first["losses"] + second["losses"],
            "start_step": second["start_step"], "whole": whole["losses"],
            "params_equal": same, "refused": refused,
            "params_only": whole_params}


JOBS = {"train": train_job, "grads": grads_job, "ckpt": ckpt_job,
        "hf": hf_job}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jax_init_params(LAYOUTS["tp4"])
    batch = global_batch(LAYOUTS["tp4"])
    jobs = [{"name": name, "kind": "train", "raw": raw, "batch": batch}
            for name, raw in LAYOUTS.items()]
    tmp = tmp_path_factory.mktemp("world4")
    cfg = tcfg.config_from_dict(LAYOUTS["tp4"])
    model = tllama.LlamaModel(cfg.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(params, cfg.model))
    tckpt.save_hf_safetensors(model, str(tmp / "hf"))
    jobs += [{"name": "grads", "kind": "grads", "batch": batch},
             {"name": "ckpt", "kind": "ckpt", "dir": str(tmp / "ckpt")},
             {"name": "hf", "kind": "hf", "hf_dir": str(tmp / "hf")}]
    world = World(tmp, 4, {"params": params, "jobs": jobs}, JOBS)
    want = {name: jax_run(raw, batch) for name, raw in LAYOUTS.items()}
    return {"port": world.results(), "jax": want,
            "single_eval": single_eval(params, batch)}


def _shards(runs, layout):
    """Every tp rank's params of data rank 0 (ranks 0..tp-1)."""
    return [runs["port"][r][layout]["params"] for r in range(TP[layout])]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_layouts_match_jax(runs, layout):
    got, want = runs["port"][0][layout], runs["jax"][layout]
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    have = leaves(full_tree(LAYOUTS[layout], _shards(runs, layout)))
    for k, w in leaves(want["params"]).items():
        np.testing.assert_allclose(have[k], w, err_msg=k, **PARAM_TOL)
    print(f"{layout}: losses max abs diff "
          f"{np.abs(np.subtract(got['losses'], want['losses'])).max():.3g}, "
          f"params (abs, rel-to-max) "
          f"{worst_errors(have, leaves(want['params']))}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_grad_norms_are_the_whole_models(runs, layout):
    got = runs["port"][0][layout]["grad_norms"]
    want = (runs["jax"][layout]["grad_norms"] if layout.startswith("tp4")
            else runs["port"][0]["tp4"]["grad_norms"])
    if layout == "tp4_sp_clip":
        assert min(got) > 0.05  # every step clipped
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for rank in range(4):
        assert runs["port"][rank][layout]["grad_norms"] == got


@pytest.mark.parametrize("layout", ["dp2_tp2_sp_zero1",
                                    "dp2_tp2_sp_zero1_fused"])
def test_dp_replicas_of_each_tp_shard_are_equal(runs, layout):
    for t in range(2):
        a, b = runs["port"][t][layout], runs["port"][2 + t][layout]
        for n, x in a["params"].items():
            assert torch.equal(x, b["params"][n]), n
        # ZeRO-1: data rank 0 owns the first half of every tensor's rows,
        # data rank 1 the second
        for (lo, hi), (lo2, hi2) in zip(a["own"], b["own"]):
            assert lo == 0 and lo2 == hi and hi2 == 2 * hi


@pytest.mark.parametrize("variant", [v for v in GRAD_VARIANTS if v != "ad"])
def test_engines_and_remat_policies_agree_under_tp_sp(runs, variant):
    for rank in range(4):
        res = runs["port"][rank]["grads"]
        (l_ad, g_ad), (l_v, g_v) = res["ad"], res[variant]
        np.testing.assert_allclose(l_v, l_ad, rtol=1e-5)
        for n, a in g_ad.items():
            err = float((g_v[n] - a).abs().max() / (a.abs().max() + 1e-12))
            assert err <= 1e-5, (rank, n, err)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_under_the_layout_matches_one_device(runs, layout):
    for rank in range(4):
        np.testing.assert_allclose(runs["port"][rank][layout]["eval0"],
                                   runs["single_eval"], rtol=1e-5)


def test_hf_init_under_tp_gives_each_rank_its_shards(runs):
    assert all(runs["port"][rank]["hf"] for rank in range(4))


def test_checkpoint_resumes_bit_for_bit_and_refuses_another_layout(runs):
    for rank in range(4):
        res = runs["port"][rank]["ckpt"]
        assert res["start_step"] == 2
        assert res["resumed"] == res["whole"]
        assert res["params_equal"]
        msg = res["refused"]
        assert msg is not None and "dp2 pp1 ep1 cp1 tp2" in msg \
            and "dp1 pp1 ep1 cp1 tp4" in msg and "not elastic-resizable" \
            in msg, msg
        # the per-rank tp shards read whole (elastic restore)
        whole = tllama.LlamaModel(tcfg.config_from_dict(tiny_raw()).model,
                                  device="meta")
        assert res["params_only"] == {n: tuple(p.shape) for n, p in
                                      whole.named_parameters()}
