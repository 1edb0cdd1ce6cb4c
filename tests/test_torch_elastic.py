"""Elastic resize of the port (picotron_tpu_torch/resilience/elastic.py,
tools/elastic_resize.py, the restore path of checkpoint.py) against the
JAX package (picotron_tpu/resilience/elastic.py, which imports no JAX, and
the JAX trainer), on the CPU.

- The JAX module's functions: `plan_resize` over a grid of (mbs, ga, dp,
  dp_new, ep), the cursor translation, `topology_mismatch`,
  `describe_topology`, `resize_invocation` (the port names its own tool)
  and `check_restore_topology` give equal results, or errors with equal
  text, for the same inputs; the ZeRO-1 arithmetic equal bit for bit;
  the pp slot check refuses exactly what the JAX slot compare refuses.
- The port's file surgery: a state written for one layout, re-split to
  another and back, is the same files byte for byte, over tensors that
  are split at one dp and whole at another, a pp change with a tied
  embedding, and the group/no-group and zero1 changes; `read_whole` gives
  the tensors back bit for bit.
- Gloo worlds of the legs' own sizes (2, 1, 4 and 2 ranks, spawned, each
  process group made once per process: re-forming one inside a process
  raced gloo's mesh set-up under load); the legs without a process group
  run in this process:
  - the JAX `dp_resize` saga: dp 2 zero1 killed after step 3 (an
    exception out of `on_step`: step 2 is the newest save), re-stamped
    to dp 1 offline, resumed at dp 1 WITHOUT a process group (so the
    restore also crosses group -> no group) and killed after step 5
    (step 4 saved), then dp 4 zero1 via checkpoint.elastic from step 4
    to 6 (steps 3 and 5 replayed: the stream's last record of a step
    counts). Per-step losses held to the JAX
    trainer's fault-free dp 2 run and to the port's at rtol 1e-3, atol
    1e-4 (the JAX tool's); final step and tokens equal; `resize` booked
    and `elastic_resize` emitted. The trainer-written dp 2 store,
    re-stamped to dp 1 and back, is byte for byte the original.
  - a pp 2 -> 1 -> 2 saga with a tied embedding, held the same way to the
    JAX trainer's pp 2 run and the port's, and its byte round trip (the
    HF file's untied head is dropped: the tied head is the N(0, 1)
    embedding, so these losses start near 60);
  - the fault as found (ROADMAP Queue 3): a checkpoint saved under a
    one-rank group with zero1 restores without a group with zero1 off,
    and one saved without a group restores under a one-rank group with
    zero1 on, each resuming bit for bit;
  - `restore_params_only` of tp 2, pp 2, ep 2 and dp 2 zero1 offload
    stores saved at step 0 from one HF file equals that file's params bit
    for bit.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import mesh
from picotron_tpu_torch.resilience import elastic
from test_torch_parallel import World

STEPS = 6
LOSS_TOL = dict(rtol=1e-3, atol=1e-4)   # tools/chaos.py:315
JAX_TOOL = "python tools/elastic_resize.py"


def _jel():
    from picotron_tpu.resilience import elastic as jel

    return jel


# ---------------------------------------------------------------------------
# the JAX module's functions
# ---------------------------------------------------------------------------

PLAN_GRID = [(mbs, ga, dp, dp_new, ep)
             for mbs, ga in ((1, 1), (2, 1), (2, 3), (4, 2), (3, 5))
             for dp, dp_new in ((2, 1), (1, 4), (4, 3), (2, 6))
             for ep in (1, 2)]


@pytest.mark.parametrize("mbs,ga,dp,dp_new,ep", PLAN_GRID)
def test_plan_resize_matches_jax(mbs, ga, dp, dp_new, ep):
    kw = dict(micro_batch_size=mbs, gradient_accumulation_steps=ga,
              dp_size=dp, dp_new=dp_new, ep_size=ep)
    try:
        want = _jel().plan_resize(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            elastic.plan_resize(**kw)
        assert str(got.value) == str(e)
        return
    got = elastic.plan_resize(**kw)
    assert (got.dp_old, got.dp_new, got.micro_batch_size,
            got.gradient_accumulation_steps, got.global_batch_size) == (
        want.dp_old, want.dp_new, want.micro_batch_size,
        want.gradient_accumulation_steps, want.global_batch_size)
    assert got.overrides() == want.overrides()
    assert got.overrides_line() == want.overrides_line()


@pytest.mark.parametrize("state,gbs_old,gbs_new", [
    ({"epoch": 0, "cursor": 24}, 8, 8), ({"epoch": 3, "cursor": 0}, 4, 4),
    ({"epoch": 1, "cursor": 12}, 4, 8), ({"epoch": 0, "cursor": 16}, 4, 8)])
def test_translate_cursor_matches_jax(state, gbs_old, gbs_new):
    kw = dict(gbs_old=gbs_old, gbs_new=gbs_new)
    try:
        want = _jel().translate_dataloader_state(state, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            elastic.translate_dataloader_state(state, **kw)
        assert str(got.value) == str(e)
        return
    assert elastic.translate_dataloader_state(state, **kw) == want


def test_topology_helpers_match_jax():
    jel = _jel()
    assert elastic.TOPOLOGY_AXES == jel.TOPOLOGY_AXES
    assert elastic.SUPPORTED_ELASTIC_AXES == jel.SUPPORTED_ELASTIC_AXES
    dists = [{"dp_size": 2, "tp_size": 2}, {"pp_size": 2, "slices": 2},
             {"dp_size": 4, "ep_size": 2, "cp_size": 2}, {}]
    for d in dists:
        got = elastic.topology_from_distributed(d)
        assert got == jel.topology_from_distributed(d)
        cfg = tcfg.config_from_dict({
            "model": {"name": "debug-tiny-moe" if d.get("ep_size", 1) > 1
                      else "debug-tiny"},
            "distributed": {**d, "slices": 1}})
        assert elastic.topology_from_distributed(cfg.distributed) == \
            jel.topology_from_distributed({**d, "slices": 1})
        assert elastic.describe_topology(got) == jel.describe_topology(got)
        for e in dists:
            other = jel.topology_from_distributed(e)
            assert elastic.topology_mismatch(got, other) == \
                jel.topology_mismatch(got, other)
    assert elastic.describe_topology(None) == jel.describe_topology(None)
    assert elastic.topology_mismatch(None, {"dp": 1}) == []
    cur = {"dp": 4, "pp": 2, "slices": 1}
    for axes in (("dp",), ("pp",), ("dp", "pp"), ("dp", "slices")):
        got = elastic.resize_invocation("/s", 3, cur, axes)
        want = jel.resize_invocation("/s", 3, cur, axes)
        assert got.replace(elastic.RESIZE_TOOL, JAX_TOOL) == want


def test_zero1_arithmetic_matches_jax():
    jel = _jel()
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((12, 5)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32),
              rng.standard_normal((4, 6, 3)).astype(np.float32)]
    info = [(0, ("dp",), (4,)), None, (1, ("dp",), (2,))]
    shards = [elastic.split_zero1(leaves[0], 0, 4), leaves[1],
              elastic.split_zero1(leaves[2], 1, 2)]
    for s, w in zip(shards[0], jel.split_zero1(leaves[0], 0, 4)):
        assert np.array_equal(s, w)
    for n_new in (None, lambda place: 1, lambda place: 2):
        got = elastic.resize_zero1_leaves(shards, info, n_new)
        want = jel.resize_zero1_leaves(shards, info, n_new)
        for g, w in zip(got, want):
            if isinstance(w, list):
                assert all(np.array_equal(a, b) for a, b in zip(g, w))
            else:
                assert np.array_equal(g, w)
    back = elastic.resize_zero1(elastic.resize_zero1(shards[0], 0, 3), 0, 4)
    assert all(np.array_equal(a, b) for a, b in zip(back, shards[0]))
    assert np.array_equal(elastic.regather_zero1(shards[0], 0), leaves[0])
    with pytest.raises(ValueError) as got:
        elastic.split_zero1(leaves[0], 0, 5)
    with pytest.raises(ValueError) as want:
        jel.split_zero1(leaves[0], 0, 5)
    assert str(got.value) == str(want.value)


def _fake_step(root, name, *, mbs=1, ga=1, **dist_kw):
    """A meta.json-only step dir recording a saved topology (as the JAX
    test's `_fake_step`)."""
    step = os.path.join(root, name, "step_00000002")
    os.makedirs(step)
    dcfg = {f"{ax}_size": int(dist_kw.get(f"{ax}_size", 1))
            for ax in elastic.TOPOLOGY_AXES}
    dcfg["slices"] = int(dist_kw.get("slices", 1))
    meta = {"config": {"distributed": dcfg, "training": {
        "micro_batch_size": mbs, "gradient_accumulation_steps": ga}}}
    with open(os.path.join(step, "meta.json"), "w") as f:
        json.dump(meta, f)
    return step, meta


RESTORE_CASES = {
    # name: (saved, current, elastic)
    "same": (dict(dp_size=2, mbs=1, ga=1), dict(dp_size=2, mbs=1, ga=1),
             False),
    "dp_elastic_off": (dict(dp_size=2, mbs=1, ga=1),
                       dict(dp_size=1, mbs=1, ga=2), False),
    "dp_elastic_on": (dict(dp_size=2, mbs=1, ga=1),
                      dict(dp_size=1, mbs=1, ga=2), True),
    "pp_elastic_off": (dict(pp_size=2, mbs=2, ga=2),
                       dict(mbs=2, ga=2), False),
    "dp_pp_elastic_on": (dict(dp_size=2, pp_size=2, mbs=1, ga=2),
                         dict(dp_size=4, mbs=1, ga=1), True),
    "global_batch": (dict(dp_size=2, mbs=1, ga=1),
                     dict(dp_size=1, mbs=1, ga=1), True),
    "tp": (dict(tp_size=2, mbs=1, ga=1), dict(mbs=1, ga=1), True),
    "cp": (dict(cp_size=2, mbs=1, ga=1), dict(mbs=1, ga=1), True),
    "ep": (dict(ep_size=2, dp_size=2, mbs=1, ga=1),
           dict(dp_size=4, mbs=1, ga=1), True),
    "slices_off": (dict(dp_size=2, slices=2, mbs=1, ga=1),
                   dict(mbs=1, ga=2), False),
    "slices_on": (dict(dp_size=2, slices=2, mbs=1, ga=1),
                  dict(mbs=1, ga=2), True),
}


def _restore_cfg(pkg, current: dict, elastic_on: bool):
    cur = dict(current)
    mbs, ga = cur.pop("mbs"), cur.pop("ga")
    model = {"name": "debug-tiny-moe" if cur.get("ep_size", 1) > 1
             else "debug-tiny"}
    return pkg.config_from_dict({
        "model": model, "distributed": cur,
        "training": {"micro_batch_size": mbs,
                     "gradient_accumulation_steps": ga},
        "checkpoint": {"elastic": elastic_on}})


@pytest.mark.parametrize("case", sorted(RESTORE_CASES))
def test_check_restore_topology_matches_jax(tmp_path, case):
    """Each refusal (tp/cp/ep even elastic, elastic off with its re-stamp
    line, a changed global batch with its overrides, slices) and each
    allowed resize: the same record, or an error of the same text but
    for the tool's name."""
    from picotron_tpu import config as jcfg

    saved, current, on = RESTORE_CASES[case]
    saved = dict(saved)
    mbs, ga = saved.pop("mbs"), saved.pop("ga")
    step, meta = _fake_step(str(tmp_path), "saved", mbs=mbs, ga=ga, **saved)
    out = {}
    for side, pkg, mod in (("jax", jcfg, _jel()),
                           ("port", tcfg, elastic)):
        cfg = _restore_cfg(pkg, current, on)
        try:
            out[side] = ("ok", mod.check_restore_topology(
                step, meta, cfg, step=2, save_dir="/store"))
        except RuntimeError as e:
            out[side] = ("raised", str(e).replace(elastic.RESIZE_TOOL,
                                                  JAX_TOOL))
    assert out["port"] == out["jax"]
    if case in ("tp", "cp", "ep"):
        assert "not elastic-resizable" in out["port"][1]
    if case == "dp_elastic_off":
        assert elastic.RESIZE_TOOL not in out["port"][1]  # replaced above


@pytest.mark.parametrize("layers,pp_src,pp_dst", [
    (4, 2, 1), (4, 1, 2), (4, 4, 2), (5, 2, 1), (5, 1, 2), (6, 3, 2),
    (10, 3, 4), (8, 2, 4)])
def test_pp_slot_check_refuses_what_jax_refuses(layers, pp_src, pp_dst):
    from picotron_tpu.models.llama import pp_layer_placement

    src = pp_layer_placement(layers, pp_src)
    dst = pp_layer_placement(layers, pp_dst)
    jax_refuses = src[0] != dst[0] or not np.array_equal(src[1], dst[1])
    meta = {"config": {"model": {"num_hidden_layers": layers},
                       "distributed": {"pp_size": pp_src}}}
    cfg = tcfg.config_from_dict({"model": {"name": "debug-tiny",
                                           "num_hidden_layers": layers},
                                 "distributed": {"pp_size": pp_dst}})
    if jax_refuses:
        with pytest.raises(ValueError, match="uneven PP layer split"):
            elastic.check_pp_slots(meta, cfg)
    else:
        elastic.check_pp_slots(meta, cfg)


# ---------------------------------------------------------------------------
# the file surgery, without a world
# ---------------------------------------------------------------------------


def _model_whole(tied: bool = False, offload: bool = False) -> dict:
    """read_whole's form of a model's state for one (ep, tp) coordinate:
    random tensors of debug-tiny's shapes."""
    from picotron_tpu_torch.models.llama import LlamaModel

    raw = {"model": {"name": "debug-tiny", "tie_word_embeddings": tied}}
    cfg = tcfg.config_from_dict(raw)
    gen = torch.Generator().manual_seed(1)
    names = [(n, tuple(p.shape)) for n, p in LlamaModel(
        cfg.model, device="meta").named_parameters()]
    rand = lambda s: torch.randn(s, generator=gen)  # noqa: E731
    params = {n: rand(s) for n, s in names}
    kinds = ("master", "mu", "nu") if offload else ("mu", "nu")
    opt = {k: {n: rand(s) for n, s in names} for k in kinds}
    return {(0, 0): {"params": params, "opt": opt, "count": 3, "step": 3}}


def _write_layout(step_dir, whole, layout) -> dict:
    state = os.path.join(step_dir, "state")
    os.makedirs(state)
    for name, obj in elastic.layout_files(whole, layout).items():
        elastic._save_file(obj, os.path.join(state, name))
    return _bytes(state)


def _bytes(state_dir) -> dict:
    return {f: open(os.path.join(state_dir, f), "rb").read()
            for f in sorted(os.listdir(state_dir))}


def _L(**kw):
    zero1 = kw.pop("zero1", False)
    grouped = kw.pop("grouped", False)
    return elastic.FileLayout.make(kw, zero1, grouped)


ROUND_TRIPS = {
    # name: (source layout, target layout, tied)
    "dp2_zero1->dp3_zero1": (_L(dp=2, zero1=True), _L(dp=3, zero1=True),
                             False),
    "dp4_zero1->dp1_group": (_L(dp=4, zero1=True),
                             _L(dp=1, zero1=True, grouped=True), False),
    "dp1_group->dp1_no_group": (_L(dp=1, zero1=True, grouped=True),
                                _L(dp=1), False),
    "dp2->dp2_zero1": (_L(dp=2), _L(dp=2, zero1=True), False),
    "pp2_tied->pp1": (_L(pp=2, dp=2, zero1=True), _L(pp=1, dp=2, zero1=True),
                      True),
    "pp2->pp4_dp2": (_L(pp=2, zero1=True), _L(pp=4, dp=2, zero1=True),
                     False),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_resplit_round_trip_is_the_same_files(tmp_path, case):
    src, dst, tied = ROUND_TRIPS[case]
    whole = _model_whole(tied=tied, offload=case.startswith("dp4"))
    step_dir = str(tmp_path / "step_00000003")
    before = _write_layout(step_dir, whole, src)
    elastic.resplit_step(step_dir, src, dst)
    mid = _bytes(os.path.join(step_dir, "state"))
    assert set(mid) == set(elastic.layout_files(whole, dst))
    got = elastic.read_whole(os.path.join(step_dir, "state"), dst)[(0, 0)]
    for kind in ("params", "opt"):
        want = whole[(0, 0)][kind]
        flat = (lambda d: {(k, n): t for k, ts in d.items()
                           for n, t in ts.items()}) if kind == "opt" else (
            lambda d: d)
        assert flat(got[kind]).keys() == flat(want).keys()
        assert all(torch.equal(flat(got[kind])[k], flat(want)[k])
                   for k in flat(want))
    elastic.resplit_step(step_dir, dst, src)
    assert _bytes(os.path.join(step_dir, "state")) == before
    assert sorted(os.listdir(step_dir)) == ["state"]  # no tmp left


def test_zero1_rows_differ_between_the_layouts_of_the_round_trips():
    """The dp 2 <-> dp 3 case crosses tensors that are split at one dp and
    whole at the other (so the re-split is not a uniform reshape)."""
    whole = _model_whole()[(0, 0)]["params"]
    rows2 = {n: elastic._rows(t.shape, 2, 0) for n, t in whole.items()}
    rows3 = {n: elastic._rows(t.shape, 3, 0) for n, t in whole.items()}
    assert any(rows2[n] is None and rows3[n] is not None for n in whole) \
        or any(rows2[n] is not None and rows3[n] is None for n in whole)


def test_failed_resplit_leaves_the_old_state(tmp_path, monkeypatch):
    src, dst = _L(dp=2, zero1=True), _L(dp=1)
    step_dir = str(tmp_path / "step_00000003")
    before = _write_layout(step_dir, _model_whole(), src)

    def broken(obj, path):
        raise OSError("disk full (planted)")

    monkeypatch.setattr(elastic, "_save_file", broken)
    with pytest.raises(OSError, match="planted"):
        elastic.resplit_step(step_dir, src, dst)
    assert _bytes(os.path.join(step_dir, "state")) == before
    assert sorted(os.listdir(step_dir)) == ["state"]


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _raw(save_dir, hf, model=None, training=None, **dist_kw) -> dict:
    t = dict(seq_length=32, micro_batch_size=2, gradient_accumulation_steps=1,
             total_train_steps=STEPS, learning_rate=1e-3, lr_warmup_steps=1,
             remat=False, seed=5)
    t.update(training or {})
    return {"model": {"name": "debug-tiny", "dtype": "float32",
                      **(model or {})},
            "training": t, "distributed": {"use_cpu": True, **dist_kw},
            "checkpoint": {"save_dir": save_dir, "async_save": False,
                           "init_from_hf": hf, "save_frequency": 2,
                           "auto_resume": True},
            "resilience": {"retry_base_delay": 0.01,
                           "retry_max_delay": 0.02},
            "logging": {"log_frequency": 1}}


class _Killed(Exception):
    pass


def _train(raw, killed_after=None):
    """`train.run` on `raw` (under the process's group, if any); with
    `killed_after`, the run dies right after that step (its periodic
    save, if any, made): None is returned."""
    from picotron_tpu_torch import train as ttrain

    def on_step(step, metrics):
        if step == killed_after:
            raise _Killed(step)

    os.environ.pop("PICOTRON_CHAOS", None)
    try:
        res = ttrain.run(tcfg.config_from_dict(raw), "cpu", on_step=on_step)
    except _Killed:
        return None
    return {"losses": res["losses"], "start_step": res["start_step"]}


def _stopped_at(raw, steps: int) -> dict:
    """`raw` stopped after `steps` steps (max_tokens): the step-`steps`
    save is its last."""
    out = json.loads(json.dumps(raw))
    out["training"]["max_tokens"] = (
        steps * tcfg.config_from_dict(raw).tokens_per_step)
    return out


def _stream(save_dir) -> dict:
    """{"losses": {step: loss} (last wins), "resize_s", "resize_events"}
    of rank 0's telemetry stream."""
    losses, resize_s, events = {}, 0.0, 0
    with open(os.path.join(save_dir, "telemetry.jsonl")) as f:
        for line in f:
            e = json.loads(line)
            if e["kind"] == "step":
                losses[e["step"]] = e["loss"]
            if e.get("category") == "resize":
                resize_s += e.get("secs", 0.0)
            events += e["kind"] == "elastic_resize"
    return {"losses": losses, "resize_s": resize_s, "resize_events": events}


def _restamp(save_dir, *flags) -> int:
    from picotron_tpu_torch.tools import elastic_resize

    return elastic_resize.main([save_dir, *flags])


def _byte_round_trip(save_dir, step, there, back) -> bool:
    """A copy of the step re-stamped `there` and `back`: the same state
    files byte for byte."""
    copy = save_dir + ".roundtrip"
    shutil.copytree(save_dir, copy)
    state = os.path.join(copy, f"step_{step:08d}", "state")
    before = _bytes(state)
    ok = _restamp(copy, "--step", str(step), *there) == 0
    ok &= _restamp(copy, "--step", str(step), *back) == 0
    return ok and _bytes(state) == before


def train_job(job: dict, spec: dict):
    """One trainer run of the world's layout (rank 0's result kept)."""
    res = _train(job["raw"], job.get("killed_after"))
    return res if dist.get_rank() == 0 else None


def store_job(job: dict, spec: dict) -> None:
    """A store saved at step 0 (the HF params) by the world's layout."""
    from picotron_tpu_torch import train as ttrain
    from picotron_tpu_torch.checkpoint import CheckpointManager

    cfg = tcfg.config_from_dict(job["raw"])
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    state = ttrain.build_state(cfg, torch.device("cpu"), par)[0]
    mgr = CheckpointManager(cfg, par=par)
    mgr.save(state, 0)
    mgr.wait_until_finished()


JOBS = {"train": train_job, "store": store_job}

TIED = {"tie_word_embeddings": True}
GA4 = {"gradient_accumulation_steps": 4}
SAGAS = {  # name: [(world, distributed, training, model) of legs 1-3]
    "dp": [(2, {"dp_size": 2, "zero1": True}, {}, None),
           (0, {"zero1": True}, {"gradient_accumulation_steps": 2}, None),
           (4, {"dp_size": 4, "zero1": True}, {"micro_batch_size": 1},
            None)],
    "pp": [(2, {"pp_size": 2}, GA4, TIED), (0, {}, GA4, TIED),
           (2, {"pp_size": 2}, GA4, TIED)],
}
STORES = {  # name: (HF file, model, distributed, training); world 2 each
    "tp2": ("hf", None, {"tp_size": 2}, None),
    "pp2": ("hf", None, {"pp_size": 2}, None),
    "ep2": ("hf_moe", {"name": "debug-tiny-moe"}, {"ep_size": 2}, None),
    "offload": ("hf", {"dtype": "bfloat16"}, {"dp_size": 2, "zero1": True},
                {"optimizer_offload": True}),
}

def _hf_files(tmp) -> dict:
    """One HF file per model (both trainers start from it)."""
    import jax

    from picotron_tpu import checkpoint as jckpt
    from picotron_tpu import config as jcfg
    from picotron_tpu.models import llama as jllama
    from picotron_tpu_torch.checkpoint import save_hf_safetensors
    from picotron_tpu_torch.models.llama import LlamaModel, init_params

    out = {"hf": str(tmp / "hf"), "hf_moe": str(tmp / "hf_moe")}
    cfg = jcfg.config_from_dict({"model": {"name": "debug-tiny"}})
    jckpt.save_hf_safetensors(
        jax.tree.map(np.asarray,
                     jllama.init_params(cfg.model, jax.random.key(11))),
        out["hf"])
    mcfg = tcfg.config_from_dict({"model": {"name": "debug-tiny-moe"}})
    save_hf_safetensors(init_params(
        LlamaModel(mcfg.model, device="cpu"),
        torch.Generator().manual_seed(12)), out["hf_moe"])
    return out


def _jax_losses(raw: dict, path: str) -> list:
    """The JAX trainer on `raw`, in process: its per-step losses."""
    from picotron_tpu import train as jtrain
    from picotron_tpu.resilience import chaos as jchaos

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(raw, f)
    saved = os.environ.get("PICOTRON_PREFLIGHT")
    os.environ["PICOTRON_PREFLIGHT"] = "0"
    try:
        jtrain.main(["--config", path])
    finally:
        if saved is None:
            os.environ.pop("PICOTRON_PREFLIGHT", None)
        else:
            os.environ["PICOTRON_PREFLIGHT"] = saved
        jchaos.install("")
    return _stream(raw["checkpoint"]["save_dir"])["losses"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The sagas' legs, the toggles and the stores, each leg in a gloo
    world of its own size (spawned worlds of 2, 1, 4 and 2 ranks) or in
    this process without a group; the JAX runs meanwhile."""
    tmp = tmp_path_factory.mktemp("elasticworld")
    for w in ("wa", "wd", "w3dp", "w3pp"):
        (tmp / w).mkdir()
    spec = _hf_files(tmp)
    hf, d = spec["hf"], str(tmp)

    def leg(name, i, **ck):
        n, dist_kw, training, model = SAGAS[name][i]
        r = _raw(f"{d}/{name}/fault", hf, model, training, **dist_kw)
        r["checkpoint"].update(ck)
        return r

    def base(name):
        n, dist_kw, training, model = SAGAS[name][0]
        return _raw(f"{d}/{name}/base", hf, model, training, **dist_kw)

    steps4 = {"total_train_steps": 4, "gradient_accumulation_steps": 2}
    toggle = {c: _raw(f"{d}/toggle/{c}", hf, training=steps4,
                      zero1=c == "a") for c in "ab"}
    toggle_back = {c: _raw(f"{d}/toggle/{c}", hf, training=steps4,
                           zero1=c == "b") for c in "ab"}
    stores = {name: _raw(f"{d}/stores/{name}", spec[hf_key], model,
                         training, **dist_kw)
              for name, (hf_key, model, dist_kw, training) in STORES.items()}
    out = {"toggle": {}, "dir": d, "spec": spec}
    # b: saved without a group, then (world D) restored under one
    out["toggle"]["b"] = _train(_stopped_at(toggle["b"], 2))["losses"]
    jobs_a = ([{"name": f"{n}_base", "kind": "train", "raw": base(n)}
               for n in SAGAS]
              + [{"name": f"{n}_leg1", "kind": "train", "raw": leg(n, 0),
                  "killed_after": 3} for n in SAGAS]
              + [{"name": n, "kind": "store", "raw": r}
                 for n, r in stores.items()])
    world_a = World(tmp / "wa", 2, {"jobs": jobs_a}, JOBS)
    world_d = World(tmp / "wd", 1, {"jobs": [
        {"name": "a", "kind": "train", "raw": _stopped_at(toggle["a"], 2)},
        {"name": "b", "kind": "train", "raw": toggle_back["b"]}]}, JOBS)
    jax = {}
    for name in SAGAS:
        raw = _raw(f"{d}/jax/{name}/ckpt", hf, SAGAS[name][0][3],
                   SAGAS[name][0][2], **SAGAS[name][0][1])
        raw["checkpoint"]["save_frequency"] = 0
        jax[name] = _jax_losses(raw, f"{d}/jax/{name}/cfg.json")
    out["toggle"]["whole"] = _train(_raw(f"{d}/toggle/whole", hf,
                                         training=steps4,
                                         zero1=True))["losses"]
    ra, rd = world_a.results()[0], world_d.results()[0]
    # a: saved under a one-rank group with zero1, restored without one
    res = _train(toggle_back["a"])
    out["toggle"]["a"] = rd["a"]["losses"] + res["losses"]
    out["toggle"]["a_start"] = res["start_step"]
    out["toggle"]["b"] += rd["b"]["losses"]
    out["toggle"]["b_start"] = rd["b"]["start_step"]
    for c in "ab":
        out["toggle"][c + "_files"] = sorted(os.listdir(
            f"{d}/toggle/{c}/step_00000002/state"))
    sagas = {}
    for name, (there, back) in (("dp", (("--dp", "1"), ("--dp", "2"))),
                                ("pp", (("--pp", "1"), ("--pp", "2")))):
        fault = f"{d}/{name}/fault"
        sagas[name] = {"baseline": ra[f"{name}_base"]["losses"],
                       "roundtrip": _byte_round_trip(fault, 2, there, back),
                       "restamp_rc": _restamp(fault, *there)}
        # leg 2: without a group, resumed at step 2, killed after step 5
        _train(leg(name, 1), killed_after=5)
    worlds = {name: World(tmp / f"w3{name}", SAGAS[name][2][0], {"jobs": [
        {"name": "leg3", "kind": "train", "raw": leg(name, 2, elastic=True)}
    ]}, JOBS) for name in SAGAS}
    for name, w in worlds.items():
        fault = f"{d}/{name}/fault"
        sagas[name]["leg3_start"] = w.results()[0]["leg3"]["start_step"]
        sagas[name].update(_stream(fault))
        for key, path in (("meta", fault), ("base_meta", f"{d}/{name}/base")):
            with open(os.path.join(path, f"step_{STEPS:08d}",
                                   "meta.json")) as f:
                m = json.load(f)
            sagas[name][key] = {k: m[k] for k in ("step", "trained_tokens")}
    out.update(sagas=sagas, jax=jax)
    return out


def _saga(world, name):
    return world["sagas"][name]


@pytest.mark.parametrize("name", ["dp", "pp"])
def test_resize_saga_holds_the_fault_free_losses(world, name):
    res = _saga(world, name)
    assert res["restamp_rc"] == 0
    assert res["leg3_start"] == 4
    steps = list(range(1, STEPS + 1))
    assert sorted(res["losses"]) == steps
    got = [res["losses"][s] for s in steps]
    np.testing.assert_allclose(got, res["baseline"], **LOSS_TOL)
    want = [world["jax"][name][s] for s in steps]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert res["meta"] == res["base_meta"]


@pytest.mark.parametrize("name", ["dp", "pp"])
def test_resize_saga_books_the_resize(world, name):
    res = _saga(world, name)
    assert res["resize_events"] == 1
    assert res["resize_s"] > 0.0


@pytest.mark.parametrize("name", ["dp", "pp"])
def test_restamp_there_and_back_writes_the_same_files(world, name):
    assert _saga(world, name)["roundtrip"]


def test_zero1_and_group_changes_restore_bit_for_bit(world):
    """The fault as found: both restores raised on the parent commit (a
    missing params.pt; a zero1 'topology' mismatch)."""
    res = world["toggle"]
    assert res["a_files"] == ["opt_state.rank00000.pt",
                              "params.rank00000.pt"]
    assert res["b_files"] == ["opt_state.pt", "params.pt"]
    for case in ("a", "b"):
        assert res[case + "_start"] == 2
        assert res[case] == res["whole"], case


@pytest.mark.parametrize("store", sorted(STORES))
def test_restore_params_only_reads_a_layout_whole(world, store):
    from picotron_tpu_torch.checkpoint import (
        load_hf_safetensors, restore_params_only,
    )

    hf_key, model, dist_kw, training = STORES[store]
    raw = _raw(os.path.join(world["dir"], "stores", store),
               world["spec"][hf_key], model, training, **dist_kw)
    cfg = tcfg.config_from_dict(raw)
    params, step = restore_params_only(cfg, raw["checkpoint"]["save_dir"])
    want = load_hf_safetensors(world["spec"][hf_key], cfg.model)
    assert step == 0
    assert list(params) == list(want) or sorted(params) == sorted(want)
    for n, t in want.items():
        assert params[n].dtype == torch.float32, n
        assert torch.equal(params[n], t), n


# ---------------------------------------------------------------------------
# --slices: the slice-loss recovery's re-stamp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slices_store(tmp_path_factory):
    """A one-rank store (debug-tiny, 2 steps, saved at step 2) re-stamped
    to dp 2 x slices 2 offline: the shape a 2-slice job leaves."""
    from picotron_tpu_torch import train as ttrain
    from picotron_tpu_torch.tools import elastic_resize

    d = tmp_path_factory.mktemp("slices")
    raw = {"model": {"name": "debug-tiny", "dtype": "float32"},
           "training": dict(seq_length=16, micro_batch_size=2,
                            gradient_accumulation_steps=2,
                            total_train_steps=2, remat=False),
           "distributed": {"use_cpu": True},
           "checkpoint": {"save_dir": str(d / "ckpt"), "async_save": False,
                          "save_frequency": 2}}
    os.environ.pop("PICOTRON_CHAOS", None)
    ttrain.run(tcfg.config_from_dict(raw), "cpu")
    assert elastic_resize.main([str(d / "ckpt"), "--dp", "2",
                                "--slices", "2"]) == 0
    return str(d / "ckpt")


def test_elastic_resize_slices_restamps_topology_and_meta(
        tmp_path, slices_store, capsys):
    """--slices 2 -> 1: the plan names the change and the resume line the
    new slice count; the manifest topology and the config meta record it,
    the step re-verifies, and state/ is untouched (placement only)."""
    from picotron_tpu_torch.ckpt_integrity import verify_step_dir
    from picotron_tpu_torch.tools import elastic_resize

    store = str(tmp_path / "ckpt")
    shutil.copytree(slices_store, store)
    step_dir = os.path.join(store, "step_00000002")
    assert elastic.saved_topology(step_dir)["slices"] == 2
    state = os.path.join(step_dir, "state")
    before = {f: open(os.path.join(state, f), "rb").read()
              for f in os.listdir(state)}
    capsys.readouterr()
    assert elastic_resize.main([store, "--slices", "1", "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "slices    2 -> 1 (placement metadata only" in out
    assert "dry run: store not modified" in out
    assert elastic.saved_topology(step_dir)["slices"] == 2
    assert elastic_resize.main([store, "--slices", "1"]) == 0
    out = capsys.readouterr().out
    assert "distributed.slices=1" in out
    topo = elastic.saved_topology(step_dir)
    assert topo["slices"] == 1 and topo["dp"] == 2
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["config"]["distributed"]["slices"] == 1
    assert meta["elastic_restamp"]["to"]["slices"] == 1
    assert verify_step_dir(step_dir, deep=True).status == "verified"
    assert {f: open(os.path.join(state, f), "rb").read()
            for f in os.listdir(state)} == before


@pytest.mark.parametrize("flags,why", [
    (("--slices", "3"), "slices must divide dp*pp = 2 (dp=2, pp=1)"),
    (("--slices", "4"), "slices must divide dp*pp = 2 (dp=2, pp=1)"),
    (("--dp", "1", "--slices", "2"),
     "slices must divide dp*pp = 1 (dp=1, pp=1)"),
])
def test_elastic_resize_slices_refused_with_the_jax_wording(
        tmp_path, slices_store, capsys, flags, why):
    """A slice count the target's dp x pp cannot absorb is refused in the
    JAX tool's words (tools/elastic_resize.py:197-205), the store
    untouched."""
    from picotron_tpu_torch.tools import elastic_resize

    store = str(tmp_path / "ckpt")
    shutil.copytree(slices_store, store)
    step_dir = os.path.join(store, "step_00000002")
    meta = open(os.path.join(step_dir, "meta.json")).read()
    capsys.readouterr()
    assert elastic_resize.main([store, *flags]) == 1
    err = capsys.readouterr().err
    assert err.startswith(f"cannot re-stamp step 2 to slices={flags[-1]}: ")
    assert why + " and not exceed it — the resumed run's config " \
        "validation would refuse this layout" in err
    assert open(os.path.join(step_dir, "meta.json")).read() == meta
