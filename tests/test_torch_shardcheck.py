"""The port's shardcheck (`picotron_tpu_torch/analysis/`, the audit half)
against the JAX package's, on the CPU. No process group, no subprocess:
the port records one step per distinct program on meta
(`analysis/trace.py`), the JAX package lowers its step on the simulated
host devices (once per config, in a module fixture).

- The presence matrix: tests/test_shardcheck.py's MATRIX plus the fused
  SP, cp ring and Ulysses configs, at debug-tiny. The port's verdicts
  (checks passed, findings by (check, severity, rule)) equal the JAX
  package's run of the same checks (spec, collectives, boundary,
  variants, donation, stability; provenance is compared in its own test
  below), and so do the effective (kind, group size) sets, but for one
  documented kind of op: the JAX step reduces the grads of parameters
  it replicates over pp (the embedding, the final norm and the head) or
  holds partial over tp (the norms under SP) in one all-reduce over the
  data axes and that axis together; the port holds those parameters on
  their own stage and reduces the tp partials over tp, then the data
  group (`parallel/api.GradSync`), so its schedule has both smaller
  groups and never one mixing a data axis with tp or pp.
- Every rank of the dp, tp, cp (ring zigzag and contiguous, Ulysses,
  mesh), ep and pp layouts issues its program representative's schedule
  (the recorder records one rank per program).
- The JAX mutation tests, each on the port's recorded schedule: a
  dropped grad sync, an oversized all-gather, MoE without its
  all_to_all, fused SP without its reduce-scatter, the cp ring without
  its hop, Ulysses without its all_to_all; each mutated schedule is also
  spelled as StableHLO text for the JAX audit, which flags the same rule.
- The spec-lint plants (a non-divisible dim, a missing and an extra
  leaf, a rank and a duplicate axis, an unknown axis, a misspecced
  placement with its fix named), the source-lint plants in tmp_path, a
  replaced state tensor, dtype drift, a CPU tensor in a device feed, the
  preflight raising and its escape hatch, the trainer's preflight lines.
- `price_ops` on the torus tier equals the JAX method on the same
  schedule; `layout_planner --trace` re-prices from recorded schedules.

tests/test_torch_slicecheck.py holds the slice-boundary audit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from picotron_tpu import config as jcfg
from picotron_tpu.analysis import collectives as jcoll
from picotron_tpu.analysis import cost_model as jcm
from picotron_tpu.analysis.boundary import audit_boundary as jaudit_boundary
from picotron_tpu.analysis.hazards import (
    check_donation as jcheck_donation,
    check_state_stability as jcheck_stability,
)
from picotron_tpu.analysis.report import Report as JReport
from picotron_tpu.analysis.spec_lint import lint_param_specs as jlint_specs
from picotron_tpu.analysis.trace import lower_train_step
from picotron_tpu.analysis.variants import audit_variants as jaudit_variants
from picotron_tpu_torch import config as tcfg
from picotron_tpu_torch.analysis import (
    ShardcheckError, audit_collectives, audit_dataflow, audit_feeds,
    check_donation, check_engine_feed, check_recorded_stability,
    lint_sources, lint_specs, param_specs, preflight, prove_serve_programs,
    record_train_step, run_shardcheck,
)
from picotron_tpu_torch.analysis.cost_model import (
    Calibration, CostModel, IciGeneration,
)
from picotron_tpu_torch.analysis.dataflow import group_axes
from picotron_tpu_torch.analysis.trace import (
    program_ranks, program_schedule,
)
from picotron_tpu_torch.mesh import layout_sizes, rank_coords

CHECKS = ("spec", "collectives", "boundary", "variants", "donation",
          "stability")


def raw(model="debug-tiny", ga=1, dist=None, train=None, pipe=None,
        mkw=None, seq=64):
    """tests/test_shardcheck.py's mkcfg as a config dict for both
    packages (seq 64, mbs 1)."""
    return {"model": {"name": model, **(mkw or {})},
            "training": {"seq_length": seq, "micro_batch_size": 1,
                         "gradient_accumulation_steps": ga, **(train or {})},
            "distributed": dict(dist or {}), "pipeline": dict(pipe or {})}


FUSED = dict(grad_engine="fused", remat_policy="dots_attn")
MATRIX = {
    # tests/test_shardcheck.py MATRIX
    "dense-1chip": raw(),
    "dense-dp2tp2cp2": raw(dist=dict(dp_size=2, tp_size=2, cp_size=2),
                           ga=2),
    "dense-pp2dp2": raw(dist=dict(pp_size=2, dp_size=2), ga=2),
    "dense-pp2dp2-mpmd": raw(dist=dict(pp_size=2, dp_size=2), ga=2,
                             pipe=dict(executor="mpmd")),
    "moe-ep2dp2": raw(model="debug-tiny-moe",
                      dist=dict(ep_size=2, dp_size=2), ga=2),
    "dense-offload": raw(ga=2, train=dict(optimizer_offload=True)),
    "moe-ep2-offload": raw(model="debug-tiny-moe", dist=dict(ep_size=2),
                           ga=2, train=dict(optimizer_offload=True)),
    # its fused SP, cp ring and Ulysses tests
    "sp-fused": raw(dist=dict(dp_size=2, tp_size=2, sequence_parallel=True),
                    ga=2, train=FUSED),
    "cp4-ring-fused": raw(dist=dict(dp_size=2, cp_size=4), ga=2,
                          train=FUSED),
    "ulysses-fused": raw(dist=dict(dp_size=2, cp_size=2), ga=2,
                         train=FUSED,
                         mkw=dict(attn_impl="ulysses", num_attention_heads=8,
                                  num_key_value_heads=4)),
}


def effective_kinds(ops) -> set:
    """{(kind, group size)} of a schedule's effective ops (the JAX
    tests' view of a schedule)."""
    return {(op.kind, op.group_size) for op in ops if op.effective}


def rule(f) -> tuple:
    """A finding's (check, severity, rule): its path up to '@' (the JAX
    path names an HLO line, the port's a source line)."""
    return (f.check, f.severity, f.path.split("@")[0])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_matrix():
    """name -> (JAX report of CHECKS, effective (kind, size, members)
    ops), each config lowered once."""
    out = {}
    for name, r in MATRIX.items():
        jc = jcfg.config_from_dict(r)
        low = lower_train_step(jc)
        rep = JReport()
        rep.extend(jlint_specs(jc))
        rep.extend(jcoll.audit_collectives(jc, text=low.text,
                                           state=low.state))
        rep.extend(jaudit_boundary(jc, low=low))
        rep.extend(jaudit_variants(jc, low=low))
        rep.extend(jcheck_donation(low.lowered, low.state, low.batch))
        rep.extend(jcheck_stability(low.step_fn, low.state, low.batch))
        ops = [op for op in jcoll.parse_collectives(low.text)
               if op.effective]
        out[name] = (rep, ops)
    return out


@pytest.fixture(scope="module")
def port_matrix():
    """name -> (port config, RecordedStep)."""
    out = {}
    for name, r in MATRIX.items():
        tc = tcfg.config_from_dict(r)
        out[name] = (tc, record_train_step(tc))
    return out


# ---------------------------------------------------------------------------
# the presence matrix against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_verdicts_equal_jax(name, jax_matrix, port_matrix):
    jrep, _ = jax_matrix[name]
    tc, rec = port_matrix[name]
    rep = run_shardcheck(tc, checks=CHECKS, recorded=rec)
    assert rep.ok() == jrep.ok(), rep.render(verbose=True)
    assert rep.ok(), rep.render(verbose=True)
    assert {rule(f) for f in rep.findings} == \
        {rule(f) for f in jrep.findings}, (rep.render(verbose=True),
                                           jrep.render(verbose=True))
    # every state leaf updated in place: the JAX "all donated"
    don = rep.info["donation"]
    assert don["donated"] == don["state_leaves"] > 0
    assert rep.info["collectives"]["grad_engine"] == \
        jcoll.resolved_grad_engine(jcfg.config_from_dict(MATRIX[name]))
    assert rep.info["trace"]["device"] == "meta"


def _mixes_data_with_tp_or_pp(cfg, op) -> bool:
    axes, _ = group_axes(cfg, op.members[0])
    return (op.kind == "all_reduce" and set(axes) & {"dp", "ep", "cp"}
            and set(axes) & {"tp", "pp"})


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_effective_kinds_equal_jax(name, jax_matrix, port_matrix):
    _, jops = jax_matrix[name]
    tc, rec = port_matrix[name]
    mixed = {(op.kind, op.group_size) for op in jops
             if _mixes_data_with_tp_or_pp(tc, op)}
    want = {(op.kind, op.group_size) for op in jops
            if not _mixes_data_with_tp_or_pp(tc, op)}
    got = effective_kinds(rec.ops)
    assert got == want, (sorted(got, key=str), sorted(want, key=str))
    d = tc.distributed
    if mixed:  # the port's two smaller reductions are there instead
        other = d.pp_size if d.pp_size > 1 else d.tp_size
        assert mixed == {("all_reduce", d.dp_size * d.ep_size * d.cp_size
                          * other)}
        assert ("all_reduce", other) in got
    assert not any(_mixes_data_with_tp_or_pp(tc, op) for op in rec.ops
                   if op.effective and op.kind != "collective_permute")


@pytest.mark.parametrize("name", ["dense-dp2tp2cp2", "sp-fused",
                                  "moe-ep2dp2", "dense-pp2dp2-mpmd"])
def test_provenance_attributes_every_op(name, port_matrix):
    """Every recorded op has its authored site (100%, the JAX bar is 90);
    implicit ops and boundary reshards are 0 by construction, with the
    reason stated; every site is an intended rule of the contract."""
    tc, rec = port_matrix[name]
    rep = audit_dataflow(tc, recorded=rec)
    info = rep.info["provenance"]
    assert info["attribution_pct"] == 100.0
    assert info["ops_attributed"] == info["ops_effective"] > 0
    assert info["implicit_ops"] == info["boundary_reshards"] == 0
    assert "no partitioner" in info["why_zero"]
    assert info["unexplained_sites"] == 0, rep.render(verbose=True)
    for src in info["by_source"]:
        assert src.startswith("picotron_tpu_torch/") and ".py:" in src
    if name == "dense-dp2tp2cp2":  # the grad sync names its parameters
        roots = {r for row in info["by_source"].values()
                 for r in row["roots"]}
        assert "grads/embedding" in roots


# ---------------------------------------------------------------------------
# one schedule per program
# ---------------------------------------------------------------------------

PROGRAMS = {
    "dp2tp2": raw(dist=dict(dp_size=2, tp_size=2), seq=32),
    "cp4-zigzag": raw(dist=dict(cp_size=4), seq=32),
    "cp4-contiguous": raw(dist=dict(cp_size=4, cp_layout="contiguous"),
                          seq=32),
    "cp2-ulysses-dp2": raw(dist=dict(dp_size=2, cp_size=2), seq=32,
                           mkw=dict(attn_impl="ulysses")),
    "cp4-mesh": raw(dist=dict(cp_size=4, cp_flavor="mesh", cp_mesh="2x2"),
                    seq=32),
    "moe-ep2dp2": raw(model="debug-tiny-moe",
                      dist=dict(ep_size=2, dp_size=2), seq=32),
    "pp2tp2": raw(dist=dict(pp_size=2, tp_size=2), ga=2, seq=32),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_every_rank_issues_its_programs_schedule(name):
    cfg = tcfg.config_from_dict(PROGRAMS[name])
    sizes = layout_sizes(cfg)
    reps = {rank_coords(r, sizes)["pp"]: program_schedule(
        record_train_step(cfg, rank=r).programs[r])
        for r in program_ranks(cfg)}
    for r in range(cfg.distributed.world_size):
        if r in program_ranks(cfg):
            continue
        got = program_schedule(record_train_step(cfg, rank=r).programs[r])
        assert got == reps[rank_coords(r, sizes)["pp"]], r


# ---------------------------------------------------------------------------
# mutation tests (the JAX ones), each also through the JAX audit
# ---------------------------------------------------------------------------


def hlo_text(ops) -> str:
    """A schedule spelled as StableHLO lines the JAX parser reads: its
    kinds, groups (or pairs) and result bytes."""
    lines = []
    for op in ops:
        n = (op.nbytes or 0) // jcoll._DTYPE_BYTES[op.dtype]
        groups = ", ".join("[" + ", ".join(map(str, g)) + "]"
                           for g in op.members)
        if op.kind == "collective_permute":
            attr = (f"source_target_pairs = dense<[{groups}]> : "
                    f"tensor<{len(op.members)}x2xi64>")
        else:
            attr = (f"replica_groups = dense<[{groups}]> : tensor<"
                    f"{len(op.members)}x{op.group_size}xi64>")
        lines.append(f'%{op.line} = "stablehlo.{op.kind}"(%x) {{{attr}}} : '
                     f'(tensor<{n}x{op.dtype}>) -> tensor<{n}x{op.dtype}>')
    return "\n".join(lines)


def both_audits(name, ops, port_matrix, budget=None):
    """(port report, JAX report) of the collective audit over `ops`."""
    tc, rec = port_matrix[name]
    mutated = dataclasses.replace(rec, ops=ops)
    rep = audit_collectives(tc, recorded=mutated, budget_bytes=budget)
    jrep = jcoll.audit_collectives(jcfg.config_from_dict(MATRIX[name]),
                                   text=hlo_text(ops), budget_bytes=budget)
    return rep, jrep


def errors_by_rule(rep) -> set:
    return {rule(f) for f in rep.errors()}


def test_unmutated_schedule_audits_green_in_jax(port_matrix):
    for name in ("dense-dp2tp2cp2", "sp-fused", "moe-ep2dp2",
                 "cp4-ring-fused", "ulysses-fused", "dense-pp2dp2"):
        rep, jrep = both_audits(name, port_matrix[name][1].ops,
                                port_matrix)
        assert rep.ok() and jrep.ok(), (name, jrep.render())


@pytest.mark.parametrize("name,kind,size,needle", [
    ("dense-dp2tp2cp2", "all_reduce", 4, "NOT being synchronized"),
    ("moe-ep2dp2", "all_to_all", 2, "expert dispatch"),
    ("sp-fused", "reduce_scatter", 2, "Megatron-SP"),
    ("cp4-ring-fused", "collective_permute", None, "K/V ring"),
    ("ulysses-fused", "all_to_all", 2, "Ulysses"),
])
def test_mutation_is_named_by_both_audits(name, kind, size, needle,
                                          port_matrix):
    ops = [op for op in port_matrix[name][1].ops
           if not (op.kind == kind and op.group_size == size)]
    rep, jrep = both_audits(name, ops, port_matrix)
    assert any(needle in f.message for f in rep.errors()), rep.render()
    assert errors_by_rule(rep) == errors_by_rule(jrep), (rep.render(),
                                                         jrep.render())


def test_oversized_all_gather_flagged_by_both(port_matrix):
    ops = port_matrix["sp-fused"][1].ops
    rep, jrep = both_audits("sp-fused", ops, port_matrix, budget=64)
    errs = [f for f in rep.errors() if f.path.startswith("all_gather@")]
    assert errs and "replication budget" in errs[0].message
    assert ".py:" in errs[0].path  # named with the line that issued it
    assert errors_by_rule(rep) == errors_by_rule(jrep)
    ok = audit_collectives(port_matrix["sp-fused"][0],
                           recorded=port_matrix["sp-fused"][1])
    assert ok.ok(), ok.render()


# ---------------------------------------------------------------------------
# spec lint
# ---------------------------------------------------------------------------


def _spec_fixture(tp=2):
    from picotron_tpu_torch.analysis.spec_lint import whole_shapes

    cfg = tcfg.config_from_dict(raw(dist=dict(tp_size=tp)))
    shapes = whole_shapes(cfg)
    sizes = {"dp": 1, "pp": 1, "ep": 1, "cp": 1, "tp": tp}
    return param_specs(cfg, shapes), shapes, sizes


@pytest.mark.parametrize("r", [
    raw(dist=dict(tp_size=2, pp_size=2)),
    raw(model="debug-tiny-moe", dist=dict(ep_size=2, tp_size=2)),
    raw(dist=dict(dp_size=2, tp_size=2, tp_strategy="row")),
], ids=["tp2pp2", "moe-ep2tp2", "row-dp2tp2"])
def test_spec_lint_clean_as_jax(r):
    """Clean on the port's placement and the model's shards (the MoE
    banks split over ep on dim 0 and tp on another, the row strategy's
    flipped storage), as the JAX lint is on the same config."""
    rep = run_shardcheck(tcfg.config_from_dict(r), checks=("spec",))
    assert rep.ok(), rep.render()
    assert jlint_specs(jcfg.config_from_dict(r)).ok()


def test_spec_lint_rejects_non_divisible_tp():
    specs, shapes, sizes = _spec_fixture()
    sizes["tp"] = 3  # hidden 64, vocab 256: nothing divides by 3
    rep = lint_specs(specs, shapes, sizes)
    errs = [f for f in rep.errors() if f.path == "layers.0.q"]
    assert errs and "not divisible" in errs[0].message


def test_spec_lint_rejects_missing_and_extra_leaves():
    specs, shapes, sizes = _spec_fixture()
    del specs["embedding"]
    specs["bogus_extra"] = (None,)
    rep = lint_specs(specs, shapes, sizes)
    msgs = {f.path: f.message for f in rep.errors()}
    assert "no placement" in msgs["embedding"]
    assert "no matching param" in msgs["bogus_extra"]


def test_spec_lint_rejects_rank_and_duplicate_axis():
    specs, shapes, sizes = _spec_fixture()
    specs["final_norm"] = (None, "tp")
    specs["lm_head"] = ("tp", "tp")
    msgs = {f.path: f.message for f in lint_specs(specs, shapes,
                                                  sizes).errors()}
    assert "rank" in msgs["final_norm"]
    assert "at most one" in msgs["lm_head"]


def test_spec_lint_rejects_unknown_axis():
    specs, shapes, sizes = _spec_fixture()
    specs["embedding"] = ("tpp", None)
    rep = lint_specs(specs, shapes, sizes)
    assert any("unknown layout axis" in f.message
               and f.path == "embedding" for f in rep.errors())


def test_misspecced_placement_names_the_fix(monkeypatch):
    """The JAX misspecced input, eager: the placement says the o-proj is
    sharded on dim 0 while the model builds it on dim 1; the lint names
    the parameter and the fix."""
    from picotron_tpu_torch.parallel import sharding

    real = sharding.tp_shard_dim

    def misspecced(name, flips=frozenset()):
        return 0 if name.endswith(".o") else real(name, flips)

    monkeypatch.setattr(sharding, "tp_shard_dim", misspecced)
    cfg = tcfg.config_from_dict(raw(dist=dict(tp_size=2)))
    rep = run_shardcheck(cfg, checks=("spec",))
    errs = {f.path: f.message for f in rep.errors()}
    assert "layers.0.o" in errs, rep.render()
    assert "fix parallel/sharding.py" in errs["layers.0.o"]
    assert "(None, 'tp')" in errs["layers.0.o"]


# ---------------------------------------------------------------------------
# source lint
# ---------------------------------------------------------------------------


def test_source_lint_repo_is_clean_with_reasons():
    rep = lint_sources()
    assert not rep.findings, rep.render(verbose=True)
    assert rep.info["source_lint"]["files"] > 80
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "picotron_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            lines = open(path).read().splitlines()
            for i, line in enumerate(lines):
                if "# shardcheck: ok" in line and "ok\"" not in line:
                    # a reason on the line or in the comment above it
                    said = line.split("# shardcheck: ok", 1)[1].strip()
                    above = lines[i - 1].strip() if i else ""
                    assert said or above.startswith("#"), (path, i + 1)


def test_source_lint_catches_planted_violations(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "models").mkdir(parents=True)
    (pkg / "tools.py").write_text(
        "import jax\n"                                      # 1 error
        "from picotron_tpu.config import Config\n"          # 2 error
        "import torch\n"
        "import torch.distributed as dist\n"
        "def f(t, g):\n"
        "    dist.all_reduce(t, group=g)\n"                 # 6 error
        "    torch._foreach_norm([t])\n"                    # 7 warning
        "    dist.barrier()  # shardcheck: ok (set-up)\n"   # 8 suppressed
        "    return t.item()\n")                            # 9: not step
    (pkg / "models" / "step.py").write_text(
        "import torch\n"
        "def step(xs, comm):\n"
        "    s = torch.zeros(3)\n"                          # 3 warning
        "    for x in xs:\n"
        "        comm.all_reduce(x)\n"                      # 5 warning
        "    for x in xs:\n"
        "        def later(y):\n"
        "            return comm.all_reduce(y)\n"           # in a fn: no
        "    z = torch.zeros(3, device=s.device)\n"         # ok
        "    w = torch.zeros_like(s)\n"                     # ok
        "    torch.cuda.synchronize()\n"                    # 11 error
        "    return s.sum().item() + z.tolist()[0]\n")      # 12 errors
    rep = lint_sources([str(pkg)])
    by_line = {}
    for f in rep.findings:
        by_line.setdefault(f.path, []).append(f.severity)
    assert by_line == {
        "pkg/tools.py:1": ["error"], "pkg/tools.py:2": ["error"],
        "pkg/tools.py:6": ["error"], "pkg/tools.py:7": ["warning"],
        "pkg/models/step.py:3": ["warning"],
        "pkg/models/step.py:5": ["warning"],
        "pkg/models/step.py:11": ["error"],
        "pkg/models/step.py:12": ["error", "error"],
    }, rep.render(verbose=True)


# ---------------------------------------------------------------------------
# in-place and stability hazards
# ---------------------------------------------------------------------------


def test_replaced_state_tensor_is_named():
    rec = record_train_step(tcfg.config_from_dict(raw(seq=32)))
    state = rec.states[0]
    p = dict(state.model.named_parameters())["layers.1.up"]
    p.data = p.data.clone()  # the same Parameter over new storage
    opt = state.optimizer
    rep = check_donation(rec)
    errs = {f.path: f.message for f in rep.errors()}
    assert list(errs) == ["params/layers.1.up"], rep.render()
    assert "new storage" in errs["params/layers.1.up"]
    assert rep.info["donation"]["donated"] == \
        rep.info["donation"]["state_leaves"] - 1
    # dtype drift: a moment leaves the step in bf16
    name = next(iter(opt.state_tensors()["mu"]))
    mu = opt.state_tensors()["mu"][name]
    mu.data = mu.data.to(torch.bfloat16)
    srep = check_recorded_stability(rec)
    assert [f.path for f in srep.errors()] == [f"mu/{name}"], srep.render()
    assert "dtype torch.float32 -> torch.bfloat16" in srep.errors()[0].message


@pytest.mark.parametrize("policy", ["off", "skip", "rollback"])
def test_every_guard_policy_records_on_meta(policy):
    """The guard's policies record as "abort" does (under "skip" the
    update reads its flag on the host, which a meta step has not)."""
    r = raw(seq=32, ga=2)
    r["resilience"] = {"guard_policy": policy}
    rep = run_shardcheck(tcfg.config_from_dict(r),
                         checks=("donation", "stability", "variants"))
    assert rep.ok(), rep.render(verbose=True)


def test_cpu_tensor_in_a_device_feed_is_flagged():
    """A host tensor joining a device program: two signatures, and the
    host leaf flagged (meta stands in for the card here)."""
    dev = {"x": torch.empty(8, device="meta")}
    host = {"x": torch.empty(8)}
    clean = audit_feeds([dev, dev], entry="clean")
    assert clean.ok() and clean.info["variants"]["proven"]
    rep = audit_feeds([dev, host], entry="dirty", device="meta")
    assert not rep.ok() and rep.info["variants"]["signatures"] == 2
    assert any("cpu" in f.message and f.path == "dirty/x"
               for f in rep.warnings())
    mc = tcfg.config_from_dict(raw()).model
    srep = prove_serve_programs(mc, params={"embedding": torch.zeros(4)},
                                device="cuda")
    info = srep.info["variants"]
    assert not info["proven"] and info["uncommitted"] == ["embedding"]
    assert any("place_for_decode" in f.message for f in srep.warnings())
    assert prove_serve_programs(mc).info["variants"]["proven"]


def test_engine_feed_check_on_a_live_engine():
    """The engine proves its feed at construction; a model with a leaf
    off the engine's device emits a `variant_hazard` event."""
    from picotron_tpu_torch.models.llama import LlamaModel, init_params
    from picotron_tpu_torch.serve.engine import ServeEngine
    from picotron_tpu_torch.telemetry import Telemetry
    from picotron_tpu_torch.telemetry.sinks import Sink

    class Keep(Sink):
        def __init__(self):
            self.events = []

        def emit(self, event):
            self.events.append(event)

    cfg = tcfg.config_from_dict(raw(mkw=dict(max_position_embeddings=64)))
    model = init_params(LlamaModel(cfg.model, device="cpu"),
                        torch.Generator().manual_seed(0))
    scfg = tcfg.ServeConfig(decode_slots=2, block_size=4, num_blocks=16,
                            prefill_chunk=4, max_model_len=32)
    eng = ServeEngine(model, scfg, device="cpu")
    assert eng.variant_report.ok()
    assert eng.variant_report.info["variants"]["proven"]
    assert check_engine_feed(eng).info["variants"]["uncommitted"] == []
    eng.close()
    model.embedding = torch.nn.Parameter(model.embedding.data.to("meta"))
    keep = Keep()
    eng = ServeEngine(model, scfg, device="cpu",
                      telemetry=Telemetry(sinks=[keep]))
    hazards = [e for e in keep.events if e["kind"] == "variant_hazard"]
    assert [e["path"] for e in hazards] == ["decode/model/embedding"]
    assert not eng.variant_report.info["variants"]["proven"]
    eng.close()


# ---------------------------------------------------------------------------
# preflight, the trainer, the CLIs, pricing
# ---------------------------------------------------------------------------


def test_preflight_raises_on_broken_spec(monkeypatch):
    from picotron_tpu_torch.parallel import sharding

    real = sharding.tp_shard_dim

    def broken(name, flips=frozenset()):
        if name == "embedding":
            raise KeyError(name)
        return real(name, flips)

    monkeypatch.setattr(sharding, "tp_shard_dim", broken)
    cfg = tcfg.config_from_dict(raw(ga=3))
    with pytest.raises(ShardcheckError, match="embedding"):
        preflight(cfg, checks=("spec",))


def test_preflight_env_escape_hatch(monkeypatch):
    from picotron_tpu_torch.analysis import runner

    monkeypatch.setenv("PICOTRON_PREFLIGHT", "0")
    monkeypatch.setattr(runner, "run_shardcheck",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("preflight must be skipped")))
    rep = preflight(tcfg.config_from_dict(raw()))
    assert rep.ok() and not rep.findings


def test_trainer_prints_the_preflight(tmp_path, capsys):
    from picotron_tpu_torch import train

    r = raw(dist=dict(use_cpu=True), ga=2, seq=32)
    r["training"].update(total_train_steps=1, num_samples=64)
    r["checkpoint"] = {"save_dir": str(tmp_path / "ckpt")}
    r["logging"] = {"telemetry_dir": str(tmp_path)}
    train.run(tcfg.config_from_dict(r), device="cpu")
    out = capsys.readouterr().out
    assert "shardcheck preflight: ok (0 warning(s); 1 program(s) " \
           "recorded on meta" in out
    assert "shardflow: " in out and "0 implicit" in out


def test_cli_json_row_and_focus_flags(capsys):
    from picotron_tpu_torch.tools import shardcheck

    rc = shardcheck.main(["--preset", "tiny-dense", "--provenance",
                          "--variants", "--json"])
    assert rc == 0
    import json

    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["ok"] and row["config"] == "preset:tiny-dense"
    assert row["info"]["provenance"]["attribution_pct"] == 100.0
    assert row["info"]["variants"]["train_step"]["proven"]
    assert "collectives" not in row["info"]  # the focus flags restrict
    rc = shardcheck.main(["--preset", "tiny-moe-ep", "--checks",
                          "spec,collectives", "--cost"])
    out = capsys.readouterr().out
    assert rc == 0 and "cost[h100]" in out and "recorded schedule" in out


def _torus():
    gen = IciGeneration(**dataclasses.asdict(jcm.GENERATIONS["v5e"]))
    return CostModel(gen, Calibration(**dataclasses.asdict(
        jcm.DEFAULT_CALIBRATION)))


@pytest.mark.parametrize("name", ["dense-dp2tp2cp2", "moe-ep2dp2",
                                  "sp-fused", "dense-pp2dp2"])
def test_price_ops_equals_jax_on_the_torus_tier(name, port_matrix):
    tc, rec = port_matrix[name]
    got = _torus().price_ops(tc, rec.ops)
    jops = jcoll.parse_collectives(hlo_text(rec.ops))
    want = jcm.CostModel("v5e").price_ops(jcfg.config_from_dict(
        MATRIX[name]), jops)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["kind"], g["bytes"], g["axes"], g["axis_guess"]) == \
            (w["kind"], w["bytes"], w["axes"], w["axis_guess"])
        np.testing.assert_allclose(g["secs"], w["secs"], rtol=1e-12)


def test_layout_planner_trace_reprices_from_recorded_schedules(capsys):
    from picotron_tpu_torch.tools import layout_planner

    rc = layout_planner.main(["--chips", "4", "--model", "debug-tiny",
                              "--seq", "64", "--grad-acc", "4",
                              "--no-flags", "--trace", "2", "--json",
                              "--top", "100"])
    assert rc == 0
    import json

    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    traced = [r for r in rows if "traced_comm_ms" in r]
    assert len(traced) == 2, rows
    assert all(r["traced_comm_ms"] >= 0 for r in traced)
