"""The port's host-offloaded AdamW (`optimizer.OffloadAdamW`) and the
update every AdamW path runs (`optimizer.adamw_update`, whose CPU branch
is the kernel's plain version) against the JAX package on the CPU, where
offload runs the JAX package's placement-free `transfer=False` path.

- One update against `picotron_tpu.optimizer.offload_adam_update` (master,
  mu, nu and the bf16 compute copy; grad_scale, clipping; both moment
  dtypes) at fp32 rtol/atol 1e-5.
- Three trainer steps on debug-tiny under the AD and the fused engine:
  each step's update against `offload_adam_update` fed the port's own
  grads at 1e-5, and the whole run against the JAX driver
  (`parallel/api.make_train_step`) at the bf16-compute level measured
  below.
- Offload against the resident AdamW: step 1's loss and matmul masters
  bit for bit, and the resident model computing as offload does
  (chip_smoke's `offload_roundings`) equal to offload bit for bit over
  3 steps.
- Checkpoints of the offload state, HF init, the trainer and its config,
  and the plain version equal to the pre-kernel `AdamW.step` bit for bit.

Why the driver comparison is not at 1e-5: optimizer_offload requires
bf16 compute (config.py), and XLA and PyTorch round bf16 products and
elementwise chains at different points. The resident bf16 path shows the
same spread (debug-tiny, ga 2, 3 steps: losses 1.5e-4 to 6.1e-4 apart,
grads ~1e-2 of each tensor's largest element, update differences up to
0.09 of the update's L2 norm); the offload path measures the same (losses
8.0e-4, updates 0.104). So the driver test holds the losses to 3e-4
relative and each master's update to 0.25 of its L2 norm, and the exact
offload math is held at 1e-5 by the per-step test on identical grads."""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from picotron_tpu import config as jcfg
from picotron_tpu.ckpt_integrity import preflight as jpreflight
from picotron_tpu.mesh import MeshEnv
from picotron_tpu.optimizer import OffloadAdamState, offload_adam_update
from picotron_tpu.parallel import api as japi
from picotron_tpu_torch import checkpoint as tckpt
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch import optimizer as topt
from picotron_tpu_torch import train as ttrain
from picotron_tpu_torch import train_step as tstep
from picotron_tpu_torch import weights
from picotron_tpu_torch.ckpt_integrity import checkpoint_nbytes
from picotron_tpu_torch.data import MicroBatchDataLoader
from picotron_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-5, atol=1e-5)
HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(HERE, "..", "picotron_tpu_torch", "configs")


def _raw(engine="ad", offload=True, moments="bfloat16", **training):
    t = dict(seq_length=16, micro_batch_size=2, gradient_accumulation_steps=2,
             total_train_steps=3, lr_schedule="cosine", lr_warmup_steps=1,
             learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
             adam_moments_dtype=moments, num_samples=10,
             remat=engine == "fused", remat_policy="dots_attn",
             grad_engine=engine, optimizer_offload=offload)
    t.update(training)
    return {"model": {"name": "debug-tiny", "dtype": "bfloat16"},
            "training": t, "distributed": {"use_cpu": True},
            "logging": {"log_frequency": 1}}


def _model_from(tc, tensors: dict):
    """A fp32 port model holding {name: tensor} (a master or grads)."""
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict({n: t.float() for n, t in tensors.items()})
    return model


def _tree(tc, names, tensors):
    """The JAX-layout numpy tree of per-param tensors."""
    return weights.params_to_numpy(_model_from(tc, dict(zip(names,
                                                           tensors))))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _fresh_state(tc, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = tllama.init_params(tllama.LlamaModel(tc.model, device="cpu"), gen)
    return tstep.init_train_state(tc, model)


# -- one update -------------------------------------------------------------

class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            self.register_parameter(
                name, torch.nn.Parameter(torch.from_numpy(a.copy())))


@pytest.mark.parametrize("clip", [0.0, 1.0, 1e4],
                         ids=["no_clip", "clipped", "under_clip"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_one_update_matches_offload_adam_update(moments, clip):
    rng = np.random.default_rng(0)
    shapes = {"rows": (1100, 24), "vector": (37,), "small": (8, 5)}
    master = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (3 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    # earlier moments, so the update reads them (bf16 values when bf16)
    mdt = jnp.bfloat16 if moments == "bfloat16" else jnp.float32
    mu = {k: np.asarray(jnp.asarray(0.1 * rng.standard_normal(s), mdt))
          for k, s in shapes.items()}
    nu = {k: np.asarray(jnp.asarray(rng.random(s), mdt))
          for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=clip,
              adam_moments_dtype=moments)
    jt, tt = jcfg.TrainingConfig(**kw), tcfg.TrainingConfig(**kw)
    scale = np.float32(1 / 7)
    jstate = OffloadAdamState(
        count=jnp.asarray(4, jnp.int32),
        master={k: jnp.asarray(v) for k, v in master.items()},
        mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()})
    jcopy, jstate = offload_adam_update(
        {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jt,
        jnp.bfloat16, transfer=False, grad_scale=jnp.float32(scale))

    module = _Params(master)
    opt = topt.OffloadAdamW(module, tt)
    assert not opt.master[0].is_pinned()  # the CPU: no placement
    opt.count = 4
    for i, k in enumerate(opt.names):
        opt.mu[i].copy_(torch.from_numpy(np.array(mu[k], np.float32)))
        opt.nu[i].copy_(torch.from_numpy(np.array(nu[k], np.float32)))
        opt.grads[i].copy_(torch.from_numpy(grads[k]))
    topt.reset_launch_counts()
    opt.step(torch.tensor(scale))
    assert topt.launches["adamw"] == 0  # the plain version ran
    assert opt.count == 5
    for i, k in enumerate(opt.names):
        p = getattr(module, k)
        assert p.dtype == torch.bfloat16
        assert opt.mu[i].dtype == (torch.bfloat16 if moments == "bfloat16"
                                   else torch.float32)
        for what, got, want in (
                ("master", opt.master[i], jstate.master[k]),
                ("mu", opt.mu[i], jstate.mu[k]),
                ("nu", opt.nu[i], jstate.nu[k]),
                ("compute copy", p.detach(), jcopy[k])):
            np.testing.assert_allclose(
                got.float().numpy(),
                np.asarray(jnp.asarray(want, jnp.float32)),
                err_msg=f"{k} {what}", **TOL)
        assert torch.equal(p.detach(), opt.master[i].to(torch.bfloat16))


def test_row_groups_follow_the_jax_package():
    """Vocab-sized axes stream in groups near 32 MB (the JAX docstring:
    49152/151936/128256 all do; GPT-2's 50257 in groups of 1733 rows); a
    prime axis 0 has no usable divisor and streams whole."""
    for vocab in (49152, 151936, 128256):
        grp = topt.row_group((vocab, 2048))
        assert grp and vocab % grp == 0
        assert topt.MIN_SLICE_BYTES <= grp * 2048 * 4 <= 4 * 32 * 2 ** 20
    assert topt.row_group((49152, 2048)) == 4096
    assert topt.row_group((50257, 2048)) == 1733
    assert topt.row_group((50261, 2048)) == 0
    assert topt.row_group((1024, 2048)) == 0
    assert topt.row_group((2048,)) == 0


def test_offload_slices_one_layer_tensor_at_a_time(monkeypatch):
    """Layer tensors stream whole, even with more than 1024 rows (gate,
    up); the embedding and head in row groups that cover them exactly
    (the group size shrunk so that debug size is grouped)."""
    monkeypatch.setattr(topt, "ROW_GROUP_BYTES", 4096)
    monkeypatch.setattr(topt, "MIN_SLICE_BYTES", 1024)
    raw = _raw()
    raw["model"].update(vocab_size=2048, intermediate_size=2048)
    tc = tcfg.config_from_dict(raw)
    opt = _fresh_state(tc).optimizer
    rows = {}
    for i, lo, hi in opt.slices:
        rows.setdefault(opt.names[i], []).append((lo, hi))
    for name, ranges in rows.items():
        n = opt.master[opt.names.index(name)].shape[0]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if name.startswith("layers."):
            assert len(ranges) == 1, name
    assert len(rows["embedding"]) == len(rows["lm_head"]) == 128
    assert set(rows) == set(opt.names)


# -- the kernel's plain version against the pre-kernel step -----------------

def _pre_kernel_step(params, grads, moments, t, count, grad_norm, ok):
    """AdamW.step's body before the kernel (its ten torch ops per tensor
    and the guard's clones), kept here as the reference."""
    lr = topt.make_lr(t)
    lr = lr(count) if callable(lr) else lr
    b1, b2, eps, wd = t.adam_beta1, t.adam_beta2, t.adam_eps, t.weight_decay
    cnt = torch.tensor(float(count + 1), dtype=torch.float32)
    c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** cnt)
    c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** cnt)
    for p, g, st in zip(params, grads, moments):
        if t.grad_clip_norm > 0:
            trigger = grad_norm < t.grad_clip_norm
            g = torch.where(trigger, g, (g / grad_norm) * t.grad_clip_norm)
        old = ((p.clone(), st["mu"].clone(), st["nu"].clone())
               if ok is not None else None)
        g = g.float()
        if st["mu"].dtype == torch.bfloat16:
            mu = b1 * st["mu"].float() + (1 - b1) * g
            nu = b2 * st["nu"].float() + (1 - b2) * (g * g)
            st["mu"].copy_(mu)
            st["nu"].copy_(nu)
        else:
            mu = st["mu"].mul_(b1).add_((1 - b1) * g)
            nu = st["nu"].mul_(b2).add_((1 - b2) * (g * g))
        upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        upd = upd + wd * p
        p.add_(upd * -lr)
        if old is not None:
            topt.guard_nonfinite(ok, (p, st["mu"], st["nu"]), old)


@pytest.mark.parametrize("ok", [None, True, False])
@pytest.mark.parametrize("clip", [0.0, 0.5, 1e4])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_plain_version_equals_the_pre_kernel_step(moments, clip, ok):
    t = tcfg.TrainingConfig(learning_rate=3e-3, weight_decay=0.1,
                            grad_clip_norm=clip, adam_moments_dtype=moments,
                            lr_schedule="cosine", lr_warmup_steps=2,
                            total_train_steps=10)
    gen = torch.Generator().manual_seed(4)
    shapes = [(33, 7), (101,), (16, 16)]  # ragged, not multiples of 8

    def state():
        g = torch.Generator().manual_seed(5)
        ps = [torch.randn(s, generator=g) for s in shapes]
        mdt = torch.bfloat16 if moments == "bfloat16" else torch.float32
        ms = [{"mu": (0.1 * torch.randn(s, generator=g)).to(mdt),
               "nu": torch.rand(s, generator=g).to(mdt)} for s in shapes]
        return ps, ms

    grads = [2 * torch.randn(s, generator=gen) for s in shapes]
    norm = topt.global_norm(grads)
    okt = None if ok is None else torch.tensor(ok)
    ref_p, ref_m = state()
    _pre_kernel_step(ref_p, grads, ref_m, t, 3, norm, okt)
    new_p, new_m = state()
    old_p = [p.clone() for p in new_p]
    h = topt.step_hyper(t, topt.make_lr(t), 3)
    for p, g, st in zip(new_p, grads, new_m):
        topt.adamw_update(p, g, st["mu"], st["nu"], h,
                          grad_norm=norm if clip else None, ok=okt)
    for a, b in zip(new_p, ref_p):
        assert torch.equal(a, b)
    for a, b in zip(new_m, ref_m):
        assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["nu"], b["nu"])
    if ok is False:
        assert all(torch.equal(a, b) for a, b in zip(new_p, old_p))
    else:
        assert not torch.equal(new_p[0], old_p[0])


def test_plain_version_writes_the_compute_copy_unless_skipped():
    t = tcfg.TrainingConfig(learning_rate=1e-2)
    h = topt.step_hyper(t, topt.make_lr(t), 0)
    g = torch.Generator().manual_seed(1)
    p, grad = torch.randn(45, generator=g), torch.randn(45, generator=g)
    mu, nu = torch.zeros(45), torch.zeros(45)
    out = torch.zeros(45, dtype=torch.bfloat16)
    topt.adamw_update(p, grad, mu, nu, h, ok=torch.tensor(False), out=out)
    assert torch.equal(out, torch.zeros(45, dtype=torch.bfloat16))
    topt.adamw_update(p, grad, mu, nu, h, out=out)
    assert torch.equal(out, p.to(torch.bfloat16))


def test_update_refuses_what_it_cannot_take():
    t = tcfg.TrainingConfig()
    h = topt.step_hyper(t, topt.make_lr(t), 0)
    p, g = torch.zeros(8), torch.zeros(8)
    with pytest.raises(ValueError, match="fp32"):
        topt.adamw_update(p, g.half(), torch.zeros(8), torch.zeros(8), h)
    with pytest.raises(ValueError, match="mu and nu"):
        topt.adamw_update(p, g, torch.zeros(8), torch.zeros(8).bfloat16(), h)
    with pytest.raises(ValueError, match=r"\(8,\)"):
        topt.adamw_update(p, g, torch.zeros(9), torch.zeros(9), h)
    # a device with neither the kernel nor the plain version (a fake xpu
    # tensor stands in for one)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.zeros(8, device="xpu")
        with pytest.raises(ValueError, match="no kernel"):
            topt.adamw_update(x, x.clone(), x.clone(), x.clone(), h)
    # meta (the shapes-only step analysis/trace.py records) takes the plain
    # version and launches nothing
    launches = dict(topt.launches)
    topt.adamw_update(p.to("meta"), g.to("meta"), torch.zeros(
        8, device="meta"), torch.zeros(8, device="meta"), h)
    assert topt.launches == launches


# -- three trainer steps ----------------------------------------------------

@pytest.mark.parametrize("engine", ["ad", "fused"])
def test_trainer_updates_match_offload_adam_update(engine, monkeypatch):
    """Three offload trainer steps; each step's grads (the buffers'
    sums, undivided) and grad_scale are handed to the JAX package's
    offload_adam_update as well, and the two states must agree after
    every step: master, moments and the compute copy at 1e-5."""
    tc = tcfg.config_from_dict(_raw(engine))
    jc = jcfg.config_from_dict(_raw(engine))
    assert tstep.resolved_grad_engine(tc) == engine
    state = _fresh_state(tc)
    opt = state.optimizer
    names = opt.names
    jstate = OffloadAdamState(
        count=jnp.zeros([], jnp.int32),
        master=jax.tree.map(jnp.asarray, _tree(tc, names, opt.master)),
        mu=jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.bfloat16),
                        _tree(tc, names, opt.master)),
        nu=jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.bfloat16),
                        _tree(tc, names, opt.master)))
    seen = {}
    real_step = opt.step

    def spy(grad_scale, grad_norm=None, ok=None):
        seen["grads"] = [g.clone() for g in opt.grads]
        seen["scale"] = float(grad_scale)
        real_step(grad_scale, grad_norm=grad_norm, ok=ok)

    monkeypatch.setattr(opt, "step", spy)
    step_fn = tstep.make_train_step(tc)
    loader = MicroBatchDataLoader(tc, "cpu")
    for _ in range(3):
        metrics = step_fn(state, next(loader))
        gtree = _tree(tc, names, seen["grads"])
        jcopy, jstate = offload_adam_update(
            jax.tree.map(jnp.asarray, gtree), jstate, jc.training,
            jnp.bfloat16, transfer=False,
            grad_scale=jnp.float32(seen["scale"]))
        # the guard's norm is the buffers' norm times the scale
        want = np.sqrt(sum(float(np.sum(np.square(g)))
                           for g in jax.tree.leaves(gtree))) * seen["scale"]
        np.testing.assert_allclose(float(metrics["grad_norm"]), want,
                                   **TOL)
        for kind, got in (("master", opt.master), ("mu", opt.mu),
                          ("nu", opt.nu)):
            have = _leaves(_tree(tc, names, got))
            for path, w in _leaves(getattr(jstate, kind)).items():
                np.testing.assert_allclose(
                    have[path], np.asarray(jnp.asarray(w, jnp.float32)),
                    err_msg=f"{kind} {jax.tree_util.keystr(path)}", **TOL)
        copy = _leaves(weights.params_to_numpy(state.model))
        for path, w in _leaves(jcopy).items():
            np.testing.assert_array_equal(
                copy[path], np.asarray(jnp.asarray(w, jnp.float32)))
    assert opt.count == 3 and int(jstate.count) == 3
    for p, m in zip(state.model.parameters(), opt.master):
        assert p.dtype == torch.bfloat16 and p.grad is None
        assert torch.equal(p.detach(), m.to(torch.bfloat16))


@pytest.mark.parametrize("engine", ["ad", "fused"])
def test_trainer_tracks_the_jax_offload_driver(engine):
    """The port's offload trainer against the JAX driver's offload step
    (parallel/api.make_train_step) from one master, 3 steps: losses
    within 3e-4 relative and each master's update within 0.25 of its L2
    norm (the bf16-compute spread of the module docstring)."""
    raw = _raw(engine)
    jc, tc = jcfg.config_from_dict(raw), tcfg.config_from_dict(raw)
    menv = MeshEnv.from_config(jc)
    jstate = japi.init_sharded_state(jc, menv, jax.random.key(0))
    master0 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jstate.opt_state.master)
    model = tllama.LlamaModel(tc.model, device="cpu")
    model.load_state_dict(weights.params_from_jax(master0, tc.model))
    state = tstep.init_train_state(tc, model)
    step_fn = tstep.make_train_step(tc)
    jstep = japi.make_train_step(jc, menv)
    loader = MicroBatchDataLoader(tc, "cpu")
    sh = menv.batch_sharding()
    for _ in range(3):
        ids, tgt = next(loader)
        metrics = step_fn(state, (ids, tgt))
        jstate, jm = jstep(jstate, (
            jax.device_put(jnp.asarray(ids.numpy()), sh),
            jax.device_put(jnp.asarray(tgt.numpy()), sh)))
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=3e-4)
    opt = state.optimizer
    have = _leaves(_tree(tc, opt.names, opt.master))
    start = _leaves(master0)
    for path, w in _leaves(jstate.opt_state.master).items():
        w = np.asarray(w, np.float32)
        moved = np.linalg.norm(w - start[path])
        assert moved > 0, jax.tree_util.keystr(path)
        assert np.linalg.norm(have[path] - w) <= 0.25 * moved, (
            jax.tree_util.keystr(path))


def test_offload_step_one_equals_resident_and_grads_agree():
    """Offload changes where the state lives, not the step: from one
    init, step 1's loss equals the resident AdamW's bit for bit, and the
    grads agree (the buffers' sums times the scale against p.grad): the
    matmul weights' at fp32 round-off; the norm weights' and the
    embedding's within 1e-2 of their largest value, as the JAX package's
    offload takes them in bf16 (the grad of a bf16 param: the norms' fp32
    product rounded once, the embedding's scatter-add of repeated tokens
    summed in bf16)."""
    states = {}
    for offload in (False, True):
        tc = tcfg.config_from_dict(_raw("ad", offload=offload))
        states[offload] = (tc, _fresh_state(tc))
    batch = next(MicroBatchDataLoader(states[True][0], "cpu"))
    res_tc, res = states[False]
    loss_res, scale_res = tstep.make_grads_fn(res_tc)(
        res.model, batch, res.optimizer.grad_of)
    off_tc, off = states[True]
    loss_off, scale = tstep.make_grads_fn(off_tc)(off.model, batch,
                                                  off.optimizer.grad_of)
    assert float(loss_off) == float(loss_res)
    assert torch.equal(scale, scale_res)
    for n, p in res.model.named_parameters():
        buf = off.optimizer.grads[off.optimizer.names.index(n)]
        want = p.grad * scale_res
        if n.endswith("norm") or n == "embedding":
            err = float((buf * scale - want).abs().max())
            assert err <= 1e-2 * float(want.abs().max()), (n, err)
        else:
            torch.testing.assert_close(buf * scale, want, rtol=1e-5,
                                       atol=1e-7)


def test_first_step_masters_match_resident():
    """One step from one init under the resident AdamW and under offload
    (constant lr 3e-4, ga 2): the matmul masters equal bit for bit (both
    take the same grads, scaled by 1 / count in the update), and every
    norm-weight and embedding element within 2.5 lr (their grads are
    rounded to bf16 under offload, which can flip the sign of a
    near-cancelling sum and so of Adam's first update)."""
    masters = {}
    for offload in (False, True):
        tc = tcfg.config_from_dict(_raw(
            "ad", offload=offload, lr_schedule="constant", lr_warmup_steps=0,
            learning_rate=3e-4, grad_clip_norm=0.0, weight_decay=0.0))
        state = _fresh_state(tc)
        tstep.make_train_step(tc)(state, next(MicroBatchDataLoader(tc,
                                                                    "cpu")))
        opt = state.optimizer
        masters[offload] = (dict(zip(opt.names, opt.master)) if offload
                            else dict(state.model.named_parameters()))
    for n, want in masters[False].items():
        got = masters[True][n]
        if n.endswith("norm") or n == "embedding":
            assert float((got - want).abs().max()) <= 2.5 * 3e-4, n
        else:
            assert torch.equal(got, want.detach()), n


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_resident_with_offload_roundings_equals_offload(moments):
    """What sets offload apart from the resident AdamW, shown: the
    resident model computing as the offload one does (chip_smoke's
    `offload_roundings`: the norm weights and the embedding used through
    their bf16 cast, so their grads round as a bf16 param's do) trains 3
    steps (constant lr 1e-3, clipping on) to the same losses, masters and
    moments as offload, bit for bit."""
    runs, real = {}, (tllama.rms_norm, tllama.embed)
    for offload in (False, True):
        tc = tcfg.config_from_dict(_raw(
            "ad", offload=offload, moments=moments, lr_schedule="constant",
            lr_warmup_steps=0, learning_rate=1e-3))
        state = _fresh_state(tc)
        step_fn = tstep.make_train_step(tc)
        loader = MicroBatchDataLoader(tc, "cpu")
        with (contextlib.nullcontext() if offload
              else chip_smoke.offload_roundings()):
            losses = [float(step_fn(state, next(loader))["loss"])
                      for _ in range(3)]
        tensors = state.optimizer.state_tensors()
        tensors.setdefault("master", dict(state.model.named_parameters()))
        runs[offload] = losses, tensors
    (res_losses, res), (off_losses, off) = runs[False], runs[True]
    assert res_losses == off_losses
    assert (tllama.rms_norm, tllama.embed) == real  # the context undid it
    for kind in ("master", "mu", "nu"):
        for n, want in off[kind].items():
            assert torch.equal(res[kind][n].detach(), want), (kind, n)


# -- checkpoints and the trainer --------------------------------------------

def _ckpt_raw(tmp_path, offload=True, **training):
    raw = _raw("fused", offload=offload, total_train_steps=4, **training)
    raw["checkpoint"] = {"save_dir": str(tmp_path / "ckpt"),
                         "async_save": True}
    return raw


def _offload_tensors(state):
    opt = state.optimizer
    out = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for kind in ("master", "mu", "nu"):
        out.update({f"{kind}.{n}": t.clone()
                    for n, t in zip(opt.names, getattr(opt, kind))})
    return out


def test_offload_checkpoint_round_trip_and_resume(tmp_path):
    cfg = tcfg.config_from_dict(_ckpt_raw(tmp_path))
    state = _fresh_state(cfg)
    dl = MicroBatchDataLoader(cfg, "cpu")
    step_fn = tstep.make_train_step(cfg)
    for _ in range(2):
        step_fn(state, next(dl))
    want = _offload_tensors(state)
    mgr = tckpt.CheckpointManager(cfg)
    mgr.save(state, 128, dl.state)
    # the next steps update the master and moments in place at once
    after = [float(step_fn(state, next(dl))["loss"]) for _ in range(2)]
    mgr.wait_until_finished()
    opt_file = torch.load(os.path.join(mgr._step_dir(2), "state",
                                       tckpt.OPT_FILE), weights_only=True)
    assert set(opt_file) == {"master", "mu", "nu", "count", "step"}
    assert opt_file["master"]["embedding"].dtype == torch.float32
    params_file = torch.load(os.path.join(mgr._step_dir(2), "state",
                                          tckpt.PARAMS_FILE),
                             weights_only=True)
    assert params_file["embedding"].dtype == torch.bfloat16

    restored, meta = tckpt.CheckpointManager(cfg).restore(
        _fresh_state(cfg, seed=9))
    got = _offload_tensors(restored)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert restored.step == 2 and restored.optimizer.count == 2
    dl2 = MicroBatchDataLoader(cfg, "cpu")
    dl2.set_state(meta["dataloader"])
    step2 = tstep.make_train_step(cfg)
    assert [float(step2(restored, next(dl2))["loss"])
            for _ in range(2)] == after

    # params-only restore returns the fp32 master, not the bf16 copy
    params, step = tckpt.restore_params_only(cfg, cfg.checkpoint.save_dir)
    assert step == 2
    for n in state.optimizer.names:
        assert params[n].dtype == torch.float32
        assert torch.equal(params[n], want["master." + n])


@pytest.mark.parametrize("saved_offload", [True, False])
def test_checkpoint_of_the_other_mode_is_refused(tmp_path, saved_offload):
    cfg = tcfg.config_from_dict(_ckpt_raw(tmp_path, offload=saved_offload))
    state = _fresh_state(cfg)
    mgr = tckpt.CheckpointManager(cfg)
    mgr.save(state)
    mgr.wait_until_finished()
    other = tcfg.config_from_dict(_ckpt_raw(tmp_path,
                                            offload=not saved_offload))
    with pytest.raises(ValueError, match="optimizer_offload"):
        tckpt.CheckpointManager(other).restore(_fresh_state(other))
    if saved_offload is False:
        with pytest.raises(ValueError, match="optimizer_offload"):
            tckpt.restore_params_only(other, other.checkpoint.save_dir)


@pytest.mark.parametrize("offload", [True, False])
@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_checkpoint_bytes_match_jax(offload, moments):
    raw = {"model": {"name": "SmolLM-1.7B", "dtype": "bfloat16"},
           "training": {"optimizer_offload": offload,
                        "adam_moments_dtype": moments}}
    assert checkpoint_nbytes(tcfg.config_from_dict(raw)) == (
        jpreflight.checkpoint_nbytes(jcfg.config_from_dict(raw)))


def test_hf_init_fills_master_and_compute_copy(tmp_path):
    src = tcfg.config_from_dict(_raw(offload=False))
    gen = torch.Generator().manual_seed(7)
    model = tllama.init_params(tllama.LlamaModel(src.model, device="cpu"),
                               gen)
    tckpt.save_hf_safetensors(model, str(tmp_path / "hf"))
    raw = _raw()
    raw["checkpoint"] = {"init_from_hf": str(tmp_path / "hf")}
    cfg = tcfg.config_from_dict(raw)
    state, *_ = ttrain.build_state(cfg, torch.device("cpu"))
    opt = state.optimizer
    for n, p in model.named_parameters():
        m = opt.master[opt.names.index(n)]
        assert torch.equal(m, p.detach())
        live = dict(state.model.named_parameters())[n]
        assert torch.equal(live.detach(), p.detach().to(torch.bfloat16))


def test_cli_trains_an_offload_config_on_cpu(tmp_path, capsys):
    with open(os.path.join(CONFIGS, "smollm17-1gpu-offload.json")) as f:
        raw = json.load(f)
    raw["model"] = {"name": "debug-tiny", "dtype": "bfloat16"}
    raw["training"].update(seq_length=16, gradient_accumulation_steps=2,
                           total_train_steps=2, lr_warmup_steps=0)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    result = ttrain.main(["--config", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "optimizer: offload (host " in out
    assert "grad engine: fused" in out
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert isinstance(result["state"].optimizer, topt.OffloadAdamW)


def test_offload_config_is_the_jax_run_config():
    path = os.path.join(CONFIGS, "smollm17-1gpu-offload.json")
    with open(path) as f, open(os.path.join(
            HERE, "..", "runs", "smollm17-offload-1chip", "config.json")) as g:
        assert json.load(f) == json.load(g)
    cfg = tcfg.load_config(path)
    assert ttrain.unsupported(cfg) == []
    assert tstep.resolved_grad_engine(cfg) == "fused"
    t, m = cfg.training, cfg.model
    assert (t.optimizer_offload, t.gradient_accumulation_steps,
            t.micro_batch_size, t.seq_length, t.remat_policy,
            t.adam_moments_dtype, t.lr_warmup_steps) == (
        True, 64, 2, 2048, "dots_attn", "bfloat16", 100)
    assert (m.num_hidden_layers, m.hidden_size) == (24, 2048)


def test_pinning_needs_cuda_and_room(monkeypatch):
    tc = tcfg.config_from_dict(_raw())
    model = tllama.LlamaModel(tc.model, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pinned host memory needs"):
            topt.OffloadAdamW(model, tc.training, pin=True)
    monkeypatch.setattr(topt, "host_available_bytes", lambda: 1000)
    with pytest.raises(RuntimeError, match="GiB available"):
        topt.check_host_room(10 ** 6)
    topt.check_host_room(500)
    monkeypatch.setattr(topt, "host_available_bytes", lambda: None)
    topt.check_host_room(10 ** 15)  # nothing readable: no check
    assert topt.offload_host_bytes([(10, 3), (4,)], torch.bfloat16) == 34 * 8
    assert topt.offload_host_bytes([(10, 3), (4,)], torch.float32) == 34 * 12


def test_guard_rollback_restores_an_offload_run(monkeypatch, tmp_path,
                                                capsys):
    """A NaN grad at step 3 under "rollback": the streamed update has
    already written the poisoned master, and the restore of step 2 puts
    master, moments and compute copy back."""
    real = tstep.loss_sum_count
    calls = [0]

    def poisoned(model, ids, tgt, *args):
        # the trainer's preflight records a step on meta: count the CPU's
        calls[0] += ids.device.type == "cpu"
        total, count, extras = real(model, ids, tgt, *args)
        if calls[0] in (5, 6):  # the two microbatches of step 3
            total = total + torch.sqrt(model.final_norm.float().sum() * 0.0)
        return total, count, extras

    monkeypatch.setattr(tstep, "loss_sum_count", poisoned)
    raw = _raw("ad", total_train_steps=4)
    raw["checkpoint"] = {"save_dir": str(tmp_path / "ckpt"),
                         "save_frequency": 2, "async_save": False}
    raw["resilience"] = {"guard_policy": "rollback"}
    result = ttrain.run(tcfg.config_from_dict(raw), "cpu")
    out = capsys.readouterr().out
    assert "rolled back to step 2" in out
    state = result["state"]
    assert state.step == 4 and len(result["losses"]) == 5
    for p, m in zip(state.model.parameters(), state.optimizer.master):
        assert torch.isfinite(m).all()
        assert torch.equal(p.detach(), m.to(torch.bfloat16))
