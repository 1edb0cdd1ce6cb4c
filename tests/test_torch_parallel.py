"""The port's data-parallel layouts on the CPU, in gloo worlds of one
process per rank, against the JAX package on its 8 simulated host
devices (the same calls as `run_parallel` of tests/test_parallel.py:
`init_sharded_state`, `parallel.api.make_train_step`), at the tiny
config of tests/test_parallel.py:23-37 (fp32, 8 q heads and 4 kv heads,
4 layers, seq 32, mbs 2, ga 2). The JAX params are transplanted into
every rank and the global batch is made from a seed with numpy; each dp
rank takes its rows.

- dp2, dp2 zero1 (AD): 3 steps' losses at the JAX package's own layout
  tolerance, losses rtol 2e-4 / atol 2e-5, and every final param at
  rtol 2e-2 / atol 1e-3 (tests/test_parallel.py:124-139); the dp ranks'
  params equal bit for bit; dp2 against the port's own single-device run
  on the same global batch, losses and the guard's grad norms at rtol
  1e-5, and the eval loss on the initial params (summed over the data
  group) at 1e-5; ZeRO-1's moments per rank half of each tensor's.

  The grad norms are held to the single-device run, not to the JAX dp
  driver: its `metrics["grad_norm"]` grows with dp (0.589 at one device
  and tp 2, 1.178 at dp 2, 2.357 at dp 4 on step 1 of this config), its
  grads being summed over dp twice (the transpose of the dp-invariant
  params' use already sums them before `_data_axes_psum` does). Adam's
  scale invariance hides it from the losses and params; clipping under
  dp would not.
- dp2 zero1 optimizer_offload (bf16): against the JAX offload driver at
  the bf16 level of tests/test_torch_offload.py (its docstring says why
  not 1e-5): losses within 3e-4 relative and each master's update within
  0.25 of its L2 norm; the pinned-host state per rank half of the whole.
- Units at tp 2 (a gloo world of 2): `vocab_parallel_embed` (and under
  sequence parallelism) and `vocab_parallel_ce_sum_count` (whole and
  chunked) with their grads against the dense versions at 1e-5
  (tests/test_parallel.py:183-235 is the pattern).

One world runs every check of this file: it starts first and the JAX
runs go on in this process while it trains. The worker code here
imports no jax, so the spawned ranks never load it; the JAX imports are
inside the functions that run in the pytest process.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import mesh
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.models import llama as tllama
from picotron_tpu_torch.ops.losses import IGNORE_INDEX, cross_entropy_sum_count
from picotron_tpu_torch.parallel import sharding
from picotron_tpu_torch.parallel import tp as ttp

STEPS = 3
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)    # tests/test_parallel.py:124
PARAM_TOL = dict(rtol=2e-2, atol=1e-3)   # tests/test_parallel.py:133-139
UNIT_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# shared by this file and tests/test_torch_tensor_parallel.py
# ---------------------------------------------------------------------------


def tiny_raw(training=None, model=None, **dist_kw) -> dict:
    """tests/test_parallel.py's tiny_cfg as a config dict for both
    packages."""
    t = dict(seq_length=32, micro_batch_size=2, gradient_accumulation_steps=2,
             learning_rate=1e-3, remat=False)
    t.update(training or {})
    m = {"name": "debug-tiny", "dtype": "float32", "num_attention_heads": 8,
         "num_key_value_heads": 4, "num_hidden_layers": 4}
    m.update(model or {})
    return {"model": m, "training": t,
            "distributed": {"use_cpu": True, **dist_kw}}


def global_batch(raw: dict, seed: int = 0):
    """(ids, targets) [ga, dp * mbs, seq] numpy int64, the same global
    content for every layout, with IGNORE_INDEX targets in two rows."""
    cfg = tcfg.config_from_dict(raw)
    t = cfg.training
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.model.vocab_size,
                        (t.gradient_accumulation_steps,
                         t.micro_batch_size * cfg.distributed.dp_size,
                         t.seq_length + 1))
    ids, tgt = toks[..., :-1].copy(), toks[..., 1:].copy()
    tgt[0, 0, :5] = IGNORE_INDEX
    tgt[-1, -1, -3:] = IGNORE_INDEX
    return ids, tgt


def jax_init_params(raw: dict) -> dict:
    """The JAX package's init from key 0 (what init_sharded_state places),
    as numpy."""
    import jax

    from picotron_tpu import config as jcfg
    from picotron_tpu.models.llama import init_params

    jc = jcfg.config_from_dict(raw)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        init_params(jc.model, jax.random.key(0)))


def jax_run(raw: dict, batch, steps: int = STEPS) -> dict:
    """The JAX driver on the layout of `raw`: {"losses", "grad_norms",
    "params" (the master under offload), "params0"}."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from picotron_tpu import config as jcfg
    from picotron_tpu.mesh import MeshEnv
    from picotron_tpu.parallel import api as japi

    jc = jcfg.config_from_dict(raw)
    menv = MeshEnv.from_config(jc)
    state = japi.init_sharded_state(jc, menv, jax.random.key(0))
    step = japi.make_train_step(jc, menv)
    sh = NamedSharding(menv.mesh, P(None, "dp", "cp"))
    b = tuple(jax.device_put(np.asarray(a, np.int32), sh) for a in batch)
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]) if "grad_norm" in m else None)
    tree = (state.opt_state.master if jc.training.optimizer_offload
            else state.params)
    return {"losses": losses, "grad_norms": norms,
            "params": jax.tree.map(lambda a: np.asarray(a, np.float32), tree)}


def leaves(tree) -> dict:
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def full_tree(raw: dict, shards: list) -> dict:
    """The JAX-layout numpy tree of the whole model from every tp rank's
    {name: shard}, in tp order."""
    cfg = tcfg.config_from_dict(raw)
    model = tllama.LlamaModel(cfg.model, device="cpu")
    whole = {}
    for n, t in shards[0].items():
        dim = sharding.tp_shard_dim(n)
        whole[n] = (t if dim is None else
                    torch.cat([s[n] for s in shards], dim)).float()
    model.load_state_dict(whole)
    return weights.params_to_numpy(model)


def worst_errors(got: dict, want: dict) -> tuple:
    """(max abs error, max error relative to the leaf's largest value)
    over every leaf."""
    w_abs = w_rel = 0.0
    for k, w in want.items():
        d = float(np.abs(got[k] - w).max())
        w_abs = max(w_abs, d)
        w_rel = max(w_rel, d / (float(np.abs(w).max()) + 1e-12))
    return w_abs, w_rel


def rank_rows(batch, cfg, dp_rank: int):
    """This dp rank's rows of the global batch, as torch int64."""
    mbs = cfg.training.micro_batch_size
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a[:, dp_rank * mbs:(dp_rank + 1) * mbs])).long() for a in batch)


def build_rank(raw: dict, params: dict):
    """(cfg, par, TrainState) of this rank: its tp shards of `params`."""
    cfg = tcfg.config_from_dict(raw)
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    model = tllama.LlamaModel(cfg.model, device="cpu", tp=ttp.tp_context(
        par, cfg.distributed.sequence_parallel))
    model.load_state_dict(weights.params_from_jax(
        params, cfg.model, par.tp_rank, par.tp_size))
    return cfg, par, tstep.init_train_state(cfg, model, par)


def single_eval(params: dict, batch) -> float:
    """The single-device port's eval loss of `params` on the whole global
    batch (tiny_raw's model at mbs = the batch's rows)."""
    cfg = tcfg.config_from_dict(tiny_raw(
        training={"micro_batch_size": batch[0].shape[1]}))
    model = tllama.LlamaModel(cfg.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(params, cfg.model))
    return float(tstep.make_eval_step(cfg)(
        model, tuple(torch.from_numpy(a).long() for a in batch)))


def whole_rows(opt, tensors, par) -> dict:
    """{name: this tp rank's whole tensor} from ZeRO-1 rows, gathered over
    the data group (test-side assembly)."""
    out = {}
    for i, (n, t) in enumerate(zip(opt.names, tensors)):
        if opt.own[i] is None:
            out[n] = t.detach().float().clone()
            continue
        parts = [torch.empty_like(t) for _ in range(par.data_size)]
        dist.all_gather(parts, t.contiguous(), group=par.data_group)
        out[n] = torch.cat(parts).float()
    return out


def train_job(job: dict, spec: dict) -> dict:
    """STEPS steps of `job["raw"]` on the spec's batch."""
    cfg, par, state = build_rank(job["raw"], spec["params"])
    step = tstep.make_train_step(cfg, par)
    batch = rank_rows(job["batch"], cfg, par.coords["dp"])
    eval0 = float(tstep.make_eval_step(cfg, par)(state.model, batch))
    losses, norms = [], []
    for _ in range(STEPS):
        m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]) if "grad_norm" in m else None)
    opt = state.optimizer
    kinds = opt.state_tensors()
    res = {"losses": losses, "grad_norms": norms, "eval0": eval0,
           "params": {n: p.detach().float().clone()
                      for n, p in state.model.named_parameters()},
           "moment_shapes": {n: tuple(t.shape)
                             for n, t in kinds["mu"].items()},
           "own": list(opt.own)}
    if cfg.training.optimizer_offload:
        res["master"] = whole_rows(opt, opt.master, par)
        res["host_bytes"] = opt.host_bytes
    return res


def _world(rank, world, init_file, spec_path, out_dir, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        spec = torch.load(spec_path, weights_only=False)
        out = {job["name"]: jobs[job["kind"]](job, spec)
               for job in spec["jobs"]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


class World:
    """A gloo world of `n` spawned ranks running `spec["jobs"]` (each
    {"name", "kind", ...}; `jobs` maps a kind to its function), started
    at once; `results()` joins it and returns {rank: {name: result}}."""

    def __init__(self, tmp, n: int, spec: dict, jobs: dict):
        self.tmp, self.n = str(tmp), n
        spec_path = os.path.join(self.tmp, "spec.pt")
        torch.save(spec, spec_path)
        self.ctx = mp.start_processes(
            _world, args=(n, os.path.join(self.tmp, "init"), spec_path,
                          self.tmp, jobs),
            nprocs=n, join=False, start_method="spawn")
        self._out = None

    def results(self, timeout: float = 600.0) -> dict:
        if self._out is None:
            deadline = time.monotonic() + timeout
            while not self.ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    raise TimeoutError(f"the gloo world of {self.n} ranks "
                                       f"ran past {timeout} s")
            self._out = {r: torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                                       weights_only=False)
                         for r in range(self.n)}
        return self._out


# ---------------------------------------------------------------------------
# the world of this file: dp layouts and the tp units
# ---------------------------------------------------------------------------

LAYOUTS = {
    "dp2": tiny_raw(dp_size=2),
    "dp2_zero1": tiny_raw(dp_size=2, zero1=True),
    "dp2_zero1_offload": tiny_raw(
        dp_size=2, zero1=True, model={"dtype": "bfloat16"},
        training={"optimizer_offload": True}),
}


def units_job(job: dict, spec: dict) -> dict:
    """The vocab-parallel pieces at tp 2 against their dense versions:
    {check: (got, want)} per rank."""
    cfg = tcfg.config_from_dict(tiny_raw(tp_size=2))
    par = mesh.init_parallel(cfg, torch.device("cpu"))
    tp = ttp.tp_context(par)
    tp_sp = ttp.TPContext(tp.group, tp.rank, tp.size, True)
    g = torch.Generator().manual_seed(0)
    vocab, hidden = 64, 16
    w = torch.randn(vocab, hidden, generator=g)
    head = torch.randn(vocab, hidden, generator=g)
    ids = torch.randint(0, vocab, (2, 8), generator=g)
    tgt = torch.randint(0, vocab, (2, 8), generator=g)
    tgt[0, :2] = IGNORE_INDEX
    h = torch.randn(2, 8, hidden, generator=g)
    dout = torch.randn(2, 8, hidden, generator=g)
    out = {}
    sl = slice(tp.rank * vocab // 2, (tp.rank + 1) * vocab // 2)

    # embedding, and its grad (the rows of this rank's shard)
    w_d = w.clone().requires_grad_()
    w_d[ids].backward(dout)
    for name, ctx, want in (("embed", tp, w[ids]),
                            ("embed_sp", tp_sp, w[ids][:, tp.rank * 4:
                                                        (tp.rank + 1) * 4])):
        w_s = w[sl].clone().requires_grad_()
        got = ttp.vocab_parallel_embed(w_s, ids, ctx)
        out[name] = (got.detach(), want)
        d = dout if ctx is tp else dout[:, tp.rank * 4:(tp.rank + 1) * 4]
        got.backward(d)
        out[name + "_grad"] = (w_s.grad, w_d.grad[sl])

    # CE, whole and in chunks, and its grads (h enters through f)
    h_d, head_d = h.clone().requires_grad_(), head.clone().requires_grad_()
    want_total, want_count = cross_entropy_sum_count(h_d @ head_d.t(), tgt)
    want_total.backward()
    for chunk in (0, 16):
        h_s = h.clone().requires_grad_()
        head_s = head[sl].clone().requires_grad_()
        total, count = ttp.vocab_parallel_ce_sum_count(
            tp.f(h_s), head_s, tgt, tp, chunk)
        total.backward()
        out[f"ce_{chunk}"] = (total.detach(), want_total.detach())
        out[f"ce_{chunk}_count"] = (count, want_count)
        out[f"ce_{chunk}_dh"] = (h_s.grad, h_d.grad)
        out[f"ce_{chunk}_dhead"] = (head_s.grad, head_d.grad[sl])
    out["gather_logits"] = (ttp.gather_logits(h @ head[sl].t(), tp),
                            h @ head.t())
    return out


JOBS = {"train": train_job, "units": units_job}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the world, runs the JAX side meanwhile, then joins:
    {"port": {rank: {job: result}}, "jax": {layout: result}, ...}."""
    params = jax_init_params(LAYOUTS["dp2"])
    batch = global_batch(LAYOUTS["dp2"])
    jobs = [{"name": name, "kind": "train", "raw": raw, "batch": batch}
            for name, raw in LAYOUTS.items()]
    jobs.append({"name": "units", "kind": "units"})
    world = World(tmp_path_factory.mktemp("world2"), 2,
                  {"params": params, "jobs": jobs}, JOBS)
    want = {name: jax_run(raw, batch) for name, raw in LAYOUTS.items()}
    # the port's own single-device run on the same global batch
    single = tiny_raw(training={"micro_batch_size": 4})
    cfg = tcfg.config_from_dict(single)
    model = tllama.LlamaModel(cfg.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(params, cfg.model))
    state = tstep.init_train_state(cfg, model)
    step = tstep.make_train_step(cfg)
    b = tuple(torch.from_numpy(a).long() for a in batch)
    one = [step(state, b) for _ in range(STEPS)]
    return {"port": world.results(), "jax": want, "params0": params,
            "single": {k: [float(m[k]) for m in one]
                       for k in ("loss", "grad_norm")},
            "single_eval": single_eval(params, batch)}


@pytest.mark.parametrize("layout", ["dp2", "dp2_zero1"])
def test_dp_layouts_match_jax(runs, layout):
    got, want = runs["port"][0][layout], runs["jax"][layout]
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS_TOL)
    have = leaves(full_tree(LAYOUTS[layout], [got["params"]]))
    for k, w in leaves(want["params"]).items():
        np.testing.assert_allclose(have[k], w, err_msg=k, **PARAM_TOL)
    print(f"{layout}: losses max abs diff "
          f"{np.abs(np.subtract(got['losses'], want['losses'])).max():.3g}, "
          f"params (abs, rel-to-max) "
          f"{worst_errors(have, leaves(want['params']))}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_under_the_layout_matches_one_device(runs, layout):
    """The eval loss on the initial params, summed over the data group,
    against the single-device port's (bf16 offload at the bf16 level)."""
    tol = 3e-4 if "offload" in layout else 1e-5
    for rank in (0, 1):
        np.testing.assert_allclose(runs["port"][rank][layout]["eval0"],
                                   runs["single_eval"], rtol=tol)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dp_ranks_hold_the_same_params(runs, layout):
    a, b = runs["port"][0][layout], runs["port"][1][layout]
    assert a["losses"] == b["losses"]
    for n, t in a["params"].items():
        assert torch.equal(t, b["params"][n]), n


@pytest.mark.parametrize("layout", ["dp2", "dp2_zero1"])
def test_dp_matches_the_single_device_port(runs, layout):
    got = runs["port"][0][layout]
    np.testing.assert_allclose(got["losses"], runs["single"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], runs["single"]["grad_norm"],
                               rtol=1e-5)


def test_zero1_keeps_half_of_each_moment_per_rank(runs):
    whole = runs["port"][0]["dp2"]["moment_shapes"]
    for rank in (0, 1):
        z1 = runs["port"][rank]["dp2_zero1"]
        assert all(o is not None for o in z1["own"])
        for n, shape in whole.items():
            assert shape[0] % 2 == 0, n
            assert z1["moment_shapes"][n] == (shape[0] // 2,) + shape[1:], n
        per_rank = sum(np.prod(s) for s in z1["moment_shapes"].values())
        assert 2 * per_rank == sum(np.prod(s) for s in whole.values())


def test_zero1_offload_matches_the_jax_offload_driver(runs):
    """bf16 compute: losses within 3e-4 relative and each master's update
    within 0.25 of its L2 norm (tests/test_torch_offload.py's bounds)."""
    layout = "dp2_zero1_offload"
    got, want = runs["port"][0][layout], runs["jax"][layout]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=3e-4)
    have = leaves(full_tree(LAYOUTS[layout], [got["master"]]))
    start = leaves(runs["params0"])
    worst = 0.0
    for k, w in leaves(want["params"]).items():
        moved = np.linalg.norm(w - start[k])
        assert moved > 0, k
        worst = max(worst, np.linalg.norm(have[k] - w) / moved)
    assert worst <= 0.25
    rel = (np.abs(np.subtract(got["losses"], want["losses"]))
           / np.abs(want["losses"]))
    print(f"{layout}: losses max rel diff {rel.max():.3g}, "
          f"worst master update rel L2 {worst:.3g}")


def test_zero1_offload_keeps_half_of_the_host_state_per_rank(runs):
    from picotron_tpu_torch.optimizer import offload_host_bytes

    cfg = tcfg.config_from_dict(LAYOUTS["dp2_zero1_offload"])
    model = tllama.LlamaModel(cfg.model, device="cpu")
    whole = offload_host_bytes([tuple(p.shape) for p in model.parameters()],
                               torch.float32)
    for rank in (0, 1):
        res = runs["port"][rank]["dp2_zero1_offload"]
        assert 2 * res["host_bytes"] == whole
        for n, t in res["master"].items():
            assert t.shape == dict(model.named_parameters())[n].shape


@pytest.mark.parametrize("check", [
    "embed", "embed_grad", "embed_sp", "embed_sp_grad", "ce_0", "ce_0_count",
    "ce_0_dh", "ce_0_dhead", "ce_16", "ce_16_count", "ce_16_dh",
    "ce_16_dhead", "gather_logits"])
def test_vocab_parallel_units_match_dense(runs, check):
    for rank in (0, 1):
        got, want = runs["port"][rank]["units"][check]
        torch.testing.assert_close(got, want, **UNIT_TOL)
