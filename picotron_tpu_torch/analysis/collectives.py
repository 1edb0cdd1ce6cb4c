"""Collective-schedule audit over a recorded step (port of
picotron_tpu/analysis/collectives.py).

The JAX audit parses the lowered module's collectives; this one reads the
collectives `analysis/trace.py` records for one step of each distinct
program (`record_train_step`: a recording group for every process
group, the whole step on meta). The rules are the JAX package's:

- **presence**: the schedule a config promises must exist — a grad-sync
  all-reduce whose group size is dp*ep*cp (the data group,
  `mesh.DATA_AXES`), a pipeline send/recv when pp > 1, an expert
  all_to_all when ep > 1, the Megatron-SP all-gather/reduce-scatter pair
  over tp under sequence_parallel (and under tp_sync "deferred"), the 2d
  and row-first strategies' subgroup collectives, the cp ring's hop,
  the Ulysses all_to_all and the mesh flavor's row all_to_all and hops.
  They hold under either grad engine: the fused engine's manual
  backward issues the same per-axis schedule as autograd's transposes,
  so `grad_engine: fused` configs are audited, not skipped.
- **budget**: no all-gather may produce more bytes than the largest
  tensor the step legitimately gathers (`default_gather_budget`).

Only effective ops count (group size > 1, or a permute with pairs): the
port runs its seam over the data group at world 1 too, as size-1 calls.
The port's grad sync is one all-reduce per tensor (`parallel/api.py`),
where XLA issues few; the report counts the ops of one step and rules on
presence, not on count.
"""

from __future__ import annotations

from picotron_tpu_torch.analysis.report import ERROR, INFO, Report
from picotron_tpu_torch.analysis.trace import KINDS

CHECK = "collectives"


def default_gather_budget(cfg, recorded=None) -> int:
    """Largest tensor the step legitimately all-gathers in one op: the
    biggest parameter of the whole model (its fp32 master), or one
    microbatch of full-sequence activations (the SP and Ulysses gathers
    restore [mbs, S, H]) — the JAX rule. Under the hierarchical dp
    reduction the port also gathers a rank's grads back as one flat fp32
    buffer (`parallel/hier_reduce.hier_sum_`), which `recorded` sizes."""
    from picotron_tpu_torch.analysis.spec_lint import shape_model
    from picotron_tpu_torch.models.llama import compute_dtype

    whole = shape_model(cfg)
    param_max = max((p.numel() * p.element_size()
                     for p in whole.parameters()), default=0)
    itemsize = compute_dtype(cfg.model).itemsize
    act = (cfg.training.micro_batch_size * cfg.training.seq_length
           * cfg.model.hidden_size * itemsize)
    flat = 0
    if recorded is not None and any(
            st.optimizer.par is not None and st.optimizer.par.dp_granule[0] > 1
            for st in recorded.states.values()):
        d = cfg.distributed
        pad = d.dp_size * d.ep_size * d.cp_size * 4
        flat = max(sum(b.numel() * 4 for b in st.optimizer.grad_of.values())
                   + pad for st in recorded.states.values())
    return max(param_max, act, flat, 1)


def audit_collectives(cfg, *, recorded=None, budget_bytes: int = None,
                      cost_model=None) -> Report:
    """Audit a config's collective schedule: `recorded` (a
    `trace.RecordedStep`), or one recorded here. With `cost_model`, the
    ops are priced on the tier's links and the info table gains the JAX
    `predicted_comm` breakdown."""
    from picotron_tpu_torch.train_step import resolved_grad_engine

    if recorded is None:
        from picotron_tpu_torch.analysis.trace import record_train_step

        recorded = record_train_step(cfg)
    ops = recorded.ops
    eff = [op for op in ops if op.effective]
    d = cfg.distributed
    rep = Report()

    counts = {k: sum(1 for op in eff if op.kind == k) for k in KINDS}
    rep.info[CHECK] = {
        **counts,
        "total_effective": len(eff),
        "size-1 groups": len(ops) - len(eff),
        "grad_engine": resolved_grad_engine(cfg),
        "recorded_on": recorded.device,
        "ranks_recorded": sorted(recorded.programs),
    }

    # -- presence rules ----------------------------------------------------
    grad_group = d.dp_size * d.ep_size * d.cp_size
    if grad_group > 1:
        grad_ars = [op for op in eff if op.kind == "all_reduce"
                    and op.group_size == grad_group]
        if not grad_ars:
            rep.add(CHECK, ERROR, "all_reduce",
                    f"no all-reduce over the data axes found (expected "
                    f"groups of size dp*ep*cp = {grad_group}): gradients "
                    f"are NOT being synchronized across data-parallel "
                    f"shards")
        else:
            rep.add(CHECK, INFO, "all_reduce",
                    f"{len(grad_ars)} all-reduce op(s) over the data axes "
                    f"(group size {grad_group}) — gradient/loss sync")
    if d.pp_size > 1 and not any(op.kind == "collective_permute"
                                 for op in eff):
        rep.add(CHECK, ERROR, "collective_permute",
                f"pp_size={d.pp_size} but the recorded step contains no "
                f"send/recv: the pipeline boundary exchange is missing")
    if (d.ep_size > 1 and cfg.model.num_experts
            and not any(op.kind == "all_to_all" for op in eff)):
        rep.add(CHECK, ERROR, "all_to_all",
                f"ep_size={d.ep_size} with {cfg.model.num_experts} experts "
                f"but no all_to_all: expert dispatch is not crossing the "
                f"ep group (tokens only ever reach local experts)")

    tp_rs = [op for op in eff if op.kind == "reduce_scatter"
             and op.group_size == d.tp_size]
    tp_ag = [op for op in eff if op.kind == "all_gather"
             and op.group_size == d.tp_size]
    if d.sequence_parallel and d.tp_size > 1:
        if not tp_rs:
            rep.add(CHECK, ERROR, "reduce_scatter",
                    f"sequence_parallel with tp_size={d.tp_size} but no "
                    f"reduce-scatter over tp: the Megatron-SP row-parallel "
                    f"exit (g) is missing — partial block outputs are "
                    f"never reduced across tp shards")
        if not tp_ag:
            rep.add(CHECK, ERROR, "all_gather",
                    f"sequence_parallel with tp_size={d.tp_size} but no "
                    f"all-gather over tp: the SP column-parallel entry "
                    f"(f) is missing — the seq-sharded residual stream "
                    f"never re-assembles the full sequence")
        if tp_rs and tp_ag:
            rep.add(CHECK, INFO, "sp_pair",
                    f"SP f/g pair present over tp ({len(tp_ag)} "
                    f"all-gather, {len(tp_rs)} reduce-scatter ops of "
                    f"group size {d.tp_size})")
    # the deferred sync (parallel/tp_strategies.py): the row-parallel
    # exit becomes a reduce-scatter whose gather half moves into the next
    # block's entry — the SP pair's signature, without sequence_parallel
    if d.tp_sync == "deferred" and d.tp_size > 1:
        if not tp_rs:
            rep.add(CHECK, ERROR, "reduce_scatter",
                    f"tp_sync=deferred with tp_size={d.tp_size} but no "
                    f"reduce-scatter over tp: the deferred schedule's "
                    f"block-exit RS is missing — partial row-parallel "
                    f"outputs are never reduced across tp shards")
        if not tp_ag:
            rep.add(CHECK, ERROR, "all_gather",
                    f"tp_sync=deferred with tp_size={d.tp_size} but no "
                    f"all-gather over tp: the gather half hoisted into "
                    f"the next block's entry is missing — the seq-sharded "
                    f"residual stream never re-assembles the full "
                    f"sequence")
        if tp_rs and tp_ag:
            rep.add(CHECK, INFO, "deferred_pair",
                    f"deferred-sync RS/AG pair present over tp "
                    f"({len(tp_ag)} all-gather, {len(tp_rs)} "
                    f"reduce-scatter ops of group size {d.tp_size})")

    if d.tp_size > 1 and d.tp_strategy != "megatron":
        from picotron_tpu_torch.config import (
            resolved_tp_mesh, resolved_tp_strategy,
        )

        strat = resolved_tp_strategy(cfg)
        if "2d" in strat.values():
            # the inner tp_y gathers and the outer tp_x partial sums (a
            # full-tp all-reduce stays legitimate: the vocab-parallel CE)
            tp_x, tp_y = resolved_tp_mesh(cfg)
            if tp_y > 1 and not any(
                    op.kind == "all_gather" and op.group_size == tp_y
                    for op in eff):
                rep.add(CHECK, ERROR, "all_gather",
                        f"2d tp strategy {tp_x}x{tp_y} but no all-gather "
                        f"of group size {tp_y}: the inner-subgroup "
                        f"activation/weight gather is missing")
            if tp_x > 1 and tp_x != d.tp_size and not any(
                    op.kind == "all_reduce" and op.group_size == tp_x
                    for op in eff):
                rep.add(CHECK, ERROR, "all_reduce",
                        f"2d tp strategy {tp_x}x{tp_y} but no all-reduce "
                        f"of group size {tp_x}: the row-matmul partial "
                        f"sum over the outer subgroup is missing")
        if "row" in (strat["qkv"], strat["up"]):
            if not any(op.kind == "all_reduce"
                       and op.group_size == d.tp_size for op in eff):
                rep.add(CHECK, ERROR, "all_reduce",
                        f"row-first tp strategy but no all-reduce of "
                        f"group size {d.tp_size}: the block-entry "
                        f"projection psum is missing")
            if not tp_ag:
                rep.add(CHECK, ERROR, "all_gather",
                        f"row-first tp strategy but no all-gather of "
                        f"group size {d.tp_size}: the column-parallel "
                        f"exit's feature gather is missing")

    if d.cp_size > 1:
        from picotron_tpu_torch.config import (
            resolved_cp_flavor, resolved_cp_mesh,
        )

        flavor = resolved_cp_flavor(cfg)
        if flavor == "ulysses":
            if not any(op.kind == "all_to_all"
                       and op.group_size == d.cp_size for op in eff):
                rep.add(CHECK, ERROR, "all_to_all",
                        f"cp flavor 'ulysses' with cp_size={d.cp_size} "
                        f"but no all_to_all of group size {d.cp_size}: "
                        f"the Ulysses seq<->head trade is missing")
        elif flavor == "mesh":
            cp_x, cp_y = resolved_cp_mesh(cfg)
            if cp_y > 1 and not any(
                    op.kind == "all_to_all" and op.group_size == cp_y
                    for op in eff):
                rep.add(CHECK, ERROR, "all_to_all",
                        f"mesh cp flavor {cp_x}x{cp_y} but no all_to_all "
                        f"of group size {cp_y}: the head scatter over the "
                        f"inner submesh factor is missing")
            if cp_x > 1 and not any(op.kind == "collective_permute"
                                    for op in eff):
                rep.add(CHECK, ERROR, "collective_permute",
                        f"mesh cp flavor {cp_x}x{cp_y} but the recorded "
                        f"step contains no send/recv: the row ring over "
                        f"the outer submesh factor is missing")
            if cp_x > 1 and cp_y > 1 and any(
                    op.kind == "all_to_all" and op.group_size == d.cp_size
                    for op in eff):
                rep.add(CHECK, ERROR, "all_to_all",
                        f"mesh cp flavor {cp_x}x{cp_y} but an all_to_all "
                        f"spans the FULL cp group (size {d.cp_size}): the "
                        f"2D schedule's subgroup collective was widened")
        elif not any(op.kind == "collective_permute" for op in eff):
            rep.add(CHECK, ERROR, "collective_permute",
                    f"cp_size={d.cp_size} (ring attention) but the "
                    f"recorded step contains no send/recv: the K/V ring "
                    f"is missing")

    # -- budget rule: the accidental-replication detector ------------------
    if budget_bytes is None:
        budget_bytes = default_gather_budget(cfg, recorded)
    for op in eff:
        if op.kind == "all_gather" and (op.nbytes or 0) > budget_bytes:
            rep.add(CHECK, ERROR, f"all_gather@{op.source}",
                    f"all-gather output {op.dtype}{list(op.shape)} is "
                    f"{op.nbytes} bytes, over the replication budget of "
                    f"{budget_bytes} bytes — something sharded is being "
                    f"materialized fully replicated")
    rep.info[CHECK]["gather_budget_bytes"] = budget_bytes

    # -- optional cost pricing ---------------------------------------------
    if cost_model is not None:
        priced = cost_model.price_ops(cfg, eff)
        by_kind: dict = {}
        for p in priced:
            by_kind[p["kind"]] = by_kind.get(p["kind"], 0.0) + p["secs"]
        rep.info[CHECK]["predicted_comm"] = {
            "generation": cost_model.gen.name,
            "total_ms": round(sum(p["secs"] for p in priced) * 1e3, 4),
            "by_kind_ms": {k: round(v * 1e3, 4)
                           for k, v in sorted(by_kind.items())},
            "unattributed_ops": sum(1 for p in priced if p["axis_guess"]),
        }
    return rep

