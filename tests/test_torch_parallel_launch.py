"""The port's launch of parallel layouts, on the CPU:

- `torchrun --standalone --nproc_per_node 4 -m picotron_tpu_torch.train
  --config <tiny dp2 x tp2> --device cpu` exits 0, prints its log lines
  once (rank 0), the collectives per step, and writes its report;
- the rank grid (`mesh.rank_coords`, `group_ranks`) against the JAX
  package's `MeshEnv.create` for the same sizes;
- the loader's per-rank rows and cursors against the JAX loader's global
  batch, token for token;
- typed errors: heads % tp, a world that is not the layout, a partial
  torchrun environment, and a CUDA run without NCCL (which never becomes
  gloo);
- every option the port still refuses names its ROADMAP item, and the
  layouts ported since (cp, pp, ep, the tp strategies, the deferred
  sync, the slices) are no longer refused;
- `torchrun --nproc_per_node 4 ... --device cpu` under the fused engine
  at tp 4 with the 2d strategy (2 x 2), and at dp 2 x tp 2 with the row
  strategy over 2 slices (the hierarchical dp reduction): each exits 0,
  its layout line naming the strategy or the slices;
- `torchrun --nproc_per_node 4 ... --device cpu` at cp 4: the tiny
  versions of runs/llama2-7b-cp4-seq8192 (ring, zigzag, fused, zero1)
  and runs/llama2-7b-cp4-mesh-seq8192 (mesh 2x2), and Ulysses, each
  exit 0 with the cp exchanges in its report; the loader's cp slices
  against the JAX loader's permuted global batch.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu import data as jdata
from picotron_tpu.mesh import AXES as JAX_AXES, MeshEnv
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import data as tdata
from picotron_tpu_torch import mesh
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch.parallel import fused_bwd
from tests.test_torch_parallel import tiny_raw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torchrun_cli_trains_dp2_tp2_on_cpu(tmp_path):
    raw = tiny_raw(dp_size=2, tp_size=2, sequence_parallel=True, zero1=True,
                   training={"total_train_steps": 2})
    raw["logging"] = {"log_frequency": 1}
    cfg_path, report = tmp_path / "cfg.json", tmp_path / "report.json"
    cfg_path.write_text(json.dumps(raw))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "picotron_tpu_torch.train",
         "--config", str(cfg_path), "--device", "cpu",
         "--report", str(report)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    steps = [line for line in out if line.startswith("[step ")]
    assert [line[:13] for line in steps] == ["[step 000001]", "[step 000002]"]
    assert sum(line.startswith("layout: ") for line in out) == 1
    assert sum(line == "training done" for line in out) == 1
    assert sum(line.startswith("collectives per step") for line in out) == 1
    rep = json.loads(report.read_text())
    assert rep["world_size"] == 4 and len(rep["losses"]) == 2
    assert all(np.isfinite(rep["losses"]))
    per = rep["collectives_per_step"]
    assert per["all_reduce"] > 0 and per["all_gather"] > 0
    assert per["reduce_scatter"] > 0  # sequence parallelism


# the tp strategies and the slices under torchrun (ROADMAP Queue 1 item
# 9, the old refusal cases of test_still_refused_options_name_their_item)
SLICE17_CLI = {
    "2d_2x2_fused": (dict(tp_size=4, tp_strategy="2d", tp_mesh="2x2"),
                     "tp_strategy 2d 2x2"),
    "dp2_tp2_row_slices": (
        dict(dp_size=2, tp_size=2, tp_strategy="row", slices=2,
             dcn_axes="dp"),
        "slices 2 (hierarchical dp reduction, 2 x 1)"),
}


@pytest.mark.parametrize("layout", list(SLICE17_CLI))
def test_torchrun_cli_trains_tp_strategies_and_slices_on_cpu(tmp_path,
                                                            layout):
    dist_kw, marker = SLICE17_CLI[layout]
    raw = tiny_raw(training={"total_train_steps": 2, "remat": True,
                             "remat_policy": "dots_attn",
                             "grad_engine": "fused"}, **dist_kw)
    cfg_path, report = tmp_path / "cfg.json", tmp_path / "report.json"
    cfg_path.write_text(json.dumps(raw))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "picotron_tpu_torch.train",
         "--config", str(cfg_path), "--device", "cpu",
         "--report", str(report)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    layout_lines = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("layout: ")]
    assert len(layout_lines) == 1 and marker in layout_lines[0], \
        layout_lines
    rep = json.loads(report.read_text())
    assert rep["world_size"] == 4 and len(rep["losses"]) == 2
    assert all(np.isfinite(rep["losses"]))
    assert rep["collectives_per_step"]["all_gather"] > 0


# the tiny versions of runs/llama2-7b-cp4-seq8192 (ring, zigzag, fused,
# zero1) and runs/llama2-7b-cp4-mesh-seq8192 (mesh 2x2), and Ulysses
CP_CLI = {
    "ring_zigzag_fused_zero1": dict(cp_size=4, zero1=True),
    "mesh_2x2_fused_zero1": dict(cp_size=4, zero1=True, cp_flavor="mesh",
                                 cp_mesh="2x2"),
    "ulysses_fused": dict(cp_size=4, cp_flavor="ulysses"),
}


@pytest.mark.parametrize("layout", list(CP_CLI))
def test_torchrun_cli_trains_cp4_on_cpu(tmp_path, layout):
    raw = tiny_raw(training={"total_train_steps": 2, "remat": True,
                             "remat_policy": "dots_attn",
                             "grad_engine": "fused"}, **CP_CLI[layout])
    cfg_path, report = tmp_path / "cfg.json", tmp_path / "report.json"
    cfg_path.write_text(json.dumps(raw))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "picotron_tpu_torch.train",
         "--config", str(cfg_path), "--device", "cpu",
         "--report", str(report)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.splitlines()
    flavor = CP_CLI[layout].get("cp_flavor", "ring")
    assert sum(line.startswith("layout: ") and f"cp {flavor}" in line
               for line in out) == 1, out
    assert "grad engine: fused" in proc.stdout
    rep = json.loads(report.read_text())
    assert rep["world_size"] == 4 and len(rep["losses"]) == 2
    assert all(np.isfinite(rep["losses"]))
    per = rep["collectives_per_step"]
    assert (per["send_recv"] > 0) == (flavor != "ulysses")
    assert (per["all_to_all"] > 0) == (flavor != "ring")
    assert per["all_reduce"] > 0


@pytest.mark.parametrize("sizes", [
    dict(dp=2, tp=4), dict(dp=2, pp=2, tp=2), dict(dp=2, cp=2, tp=2),
    dict(dp=8), dict(pp=2, ep=2, cp=2)])
def test_rank_grid_matches_mesh_env(sizes):
    assert mesh.AXES == JAX_AXES
    full = {a: sizes.get(a, 1) for a in mesh.AXES}
    menv = MeshEnv.create(**full)
    grid = np.vectorize(lambda d: d.id)(menv.mesh.devices)
    for rank in range(int(np.prod(list(full.values())))):
        where = dict(zip(mesh.AXES, (int(i[0]) for i in
                                     np.nonzero(grid == rank))))
        assert mesh.rank_coords(rank, full) == where
    # the tp group: the devices along the mesh's tp axis, in order
    want = sorted(sorted(int(d) for d in row)
                  for row in grid.reshape(-1, full["tp"]))
    assert sorted(mesh.group_ranks(full, ("tp",))) == want
    data = mesh.group_ranks(full, mesh.DATA_AXES)
    assert len(data) == full["pp"] * full["tp"]
    for group in data:
        coords = [mesh.rank_coords(r, full) for r in group]
        assert len({(c["pp"], c["tp"]) for c in coords}) == 1


def test_loader_rows_match_the_jax_global_batch():
    raw = tiny_raw(dp_size=2, tp_size=2, training={"num_samples": 20})
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    jl = jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
    loaders = [tdata.MicroBatchDataLoader(tc, "cpu", dp_rank=r)
               for r in range(2)]
    mbs = tc.training.micro_batch_size
    for _ in range(4):  # through an epoch boundary (20 // 8 per epoch)
        ji, jt = (np.asarray(a) for a in next(jl))
        for r, tl in enumerate(loaders):
            ti, tt = next(tl)
            np.testing.assert_array_equal(ti.numpy(),
                                          ji[:, r * mbs:(r + 1) * mbs])
            np.testing.assert_array_equal(tt.numpy(),
                                          jt[:, r * mbs:(r + 1) * mbs])
            assert tl.state == jl.state
    with pytest.raises(ValueError, match="dp_rank 2"):
        tdata.MicroBatchDataLoader(tc, "cpu", dp_rank=2)


@pytest.mark.parametrize("cp_layout", ["zigzag", "contiguous"])
def test_loader_cp_slices_match_the_jax_global_batch(cp_layout):
    """Each (dp, cp) rank's ids and targets are its rows and its cp slice
    of the JAX loader's permuted global batch, token for token."""
    raw = tiny_raw(dp_size=2, cp_size=2, cp_layout=cp_layout,
                   training={"num_samples": 20})
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    jl = jdata.MicroBatchDataLoader(jc, MeshEnv.from_config(jc))
    loaders = {(r, c): tdata.MicroBatchDataLoader(tc, "cpu", dp_rank=r,
                                                  cp_rank=c)
               for r in range(2) for c in range(2)}
    mbs, s = tc.training.micro_batch_size, tc.training.seq_length // 2
    for _ in range(3):
        ji, jt = (np.asarray(a) for a in next(jl))
        for (r, c), tl in loaders.items():
            ti, tt = next(tl)
            rows, cols = slice(r * mbs, (r + 1) * mbs), slice(c * s,
                                                              (c + 1) * s)
            np.testing.assert_array_equal(ti.numpy(), ji[:, rows, cols])
            np.testing.assert_array_equal(tt.numpy(), jt[:, rows, cols])
            assert tl.state == jl.state
    with pytest.raises(ValueError, match="cp_rank 2"):
        tdata.MicroBatchDataLoader(tc, "cpu", cp_rank=2)


def test_layout_errors_are_typed(monkeypatch):
    with pytest.raises(ValueError, match="num_attention_heads"):
        tcfg.config_from_dict(tiny_raw(tp_size=3))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    cfg = tcfg.config_from_dict(tiny_raw(dp_size=2, tp_size=2))
    with pytest.raises(ValueError, match=r"world size 1 != .* = 4"):
        mesh.init_parallel(cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"world size 2 != .* = 4"):
        mesh.check_world(cfg, 2)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="partial torchrun"):
        mesh.init_parallel(cfg, torch.device("cpu"))
    # a CUDA run without NCCL raises; it never falls back to gloo
    for var, val in (("WORLD_SIZE", "4"), ("LOCAL_RANK", "0"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(var, val)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        mesh.init_parallel(cfg, torch.device("cuda"))
    assert not torch.distributed.is_initialized()


# the two context-parallel cases, the pipeline case and the expert-
# parallel case were refusals until cp, pp and MoE were ported; they keep
# their ids and now check that nothing refuses them (match None)
_CP_PORTED = "context parallelism: ROADMAP Queue 1 item 9"
_PP_PORTED = "pipeline parallelism: ROADMAP Queue 1 item 9"
_EP_PORTED = "expert parallelism: ROADMAP Queue 1 item 10"
# so were the tp strategies, the deferred sync and the slices
_TP_PORTED = "tp strategies: ROADMAP Queue 1 item 9"
_DEFERRED_PORTED = "deferred tp sync: ROADMAP Queue 1 item 9"
_SLICES_PORTED = "multi-slice dp reduction: ROADMAP Queue 1 item 9"


@pytest.mark.parametrize("dist_kw,model_kw,match", [
    pytest.param({"pp_size": 2}, {}, None,
                 id=f"dist_kw0-model_kw0-{_PP_PORTED}"),
    pytest.param({"cp_size": 2}, {}, None,
                 id=f"dist_kw1-model_kw1-{_CP_PORTED}"),
    pytest.param({"ep_size": 2}, {"name": "debug-tiny-moe"}, None,
                 id=f"dist_kw2-model_kw2-{_EP_PORTED}"),
    pytest.param({"tp_size": 2, "tp_strategy": "row"}, {}, None,
                 id=f"dist_kw3-model_kw3-{_TP_PORTED}"),
    pytest.param({"tp_size": 2, "tp_sync": "deferred"}, {}, None,
                 id=f"dist_kw4-model_kw4-{_DEFERRED_PORTED}"),
    pytest.param({"dp_size": 2, "slices": 2}, {}, None,
                 id=f"dist_kw5-model_kw5-{_SLICES_PORTED}"),
    pytest.param({"cp_size": 2}, {"attn_impl": "ring"}, None,
                 id=f"dist_kw6-model_kw6-{_CP_PORTED}"),
])
def test_still_refused_options_name_their_item(dist_kw, model_kw, match):
    raw = tiny_raw(**dist_kw)
    raw["model"].update(model_kw)
    cfg = tcfg.config_from_dict(raw)
    if match is None:
        # ported: no refusal names cp or pp; without torchrun the run
        # stops at the world check
        assert ttrain.unsupported(cfg) == []
        with pytest.raises(ValueError, match="world size 1"):
            ttrain.run(cfg, "cpu")
        return
    assert any(match in why for why in ttrain.unsupported(cfg)), \
        ttrain.unsupported(cfg)
    with pytest.raises(NotImplementedError, match="item"):
        ttrain.run(cfg, "cpu")


def test_layouts_the_slice_runs_are_supported():
    for kw in (dict(dp_size=2), dict(tp_size=4, sequence_parallel=True),
               dict(dp_size=2, tp_size=2, zero1=True), dict(cp_size=4),
               dict(cp_size=4, cp_flavor="ulysses"),
               dict(cp_size=4, cp_flavor="mesh", cp_mesh="2x2"),
               dict(cp_size=2, tp_size=2, sequence_parallel=True,
                    cp_flavor="ulysses"),
               dict(tp_size=4, tp_strategy="2d", tp_mesh="2x2"),
               dict(dp_size=2, tp_size=2, tp_strategy="row"),
               dict(tp_size=4, tp_strategy="qkv=2d,o=2d"),
               dict(tp_size=2, cp_size=2, sequence_parallel=True,
                    tp_sync="deferred"),
               dict(dp_size=4, slices=2, dcn_axes="dp")):
        cfg = tcfg.config_from_dict(tiny_raw(**kw))
        assert ttrain.unsupported(cfg) == []
        fused = tcfg.config_from_dict(tiny_raw(
            training={"remat": True, "remat_policy": "dots_attn",
                      "grad_engine": "fused"}, **kw))
        assert fused_bwd.fused_bwd_supported(fused)
        assert callable(tstep.make_grads_fn(fused))


def test_world1_smoke_config_is_runs_smollm17_dp8_cut_to_one_card():
    """The chip smoke's phase-7a config: runs/smollm17-dp8 at full width
    and depth with zero1, dp 8 -> 1 and 3 steps (max_tokens)."""
    path = os.path.join(ROOT, "picotron_tpu_torch", "configs",
                        "smollm17-1gpu-dp-zero1.json")
    cfg = tcfg.load_config(path)
    ref = jcfg.load_config(os.path.join(ROOT, "runs", "smollm17-dp8",
                                        "config.json"))
    assert ttrain.unsupported(cfg) == []
    assert cfg.model == tcfg.config_from_dict(
        {"model": {"name": ref.model.name}}).model
    t, r = cfg.training, ref.training
    assert (t.seq_length, t.micro_batch_size, t.gradient_accumulation_steps,
            t.remat, t.remat_policy, t.learning_rate, t.total_train_steps) \
        == (r.seq_length, r.micro_batch_size, r.gradient_accumulation_steps,
            r.remat, r.remat_policy, r.learning_rate, r.total_train_steps)
    assert cfg.distributed.zero1 and cfg.distributed.dp_size == 1
    assert ref.distributed.dp_size == 8
    assert t.max_tokens == 3 * cfg.tokens_per_step
