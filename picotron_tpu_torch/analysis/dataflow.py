"""Collective provenance — WHY each recorded collective exists (port of
picotron_tpu/analysis/dataflow.py).

The JAX module walks the traced jaxpr for every collective primitive,
matches the lowered module's ops back to those sites by (kind, group
size), calls an op no site explains *implicit* (minted by the GSPMD
partitioner where two PartitionSpecs disagree), and predicts the
reshards at the program's sharding boundaries. In the port every
collective is a call the rank makes, so the recorder (`analysis/
trace.py`) already holds each op's authored site:

- **Provenance** (`collect_sites`): every recorded op becomes a
  `CollectiveSite` — its kind, the layout axes its group spans (the
  axes whose coordinate varies inside the group; a smaller group than
  those axes' product is a subgroup, `group`, as `axis_index_groups`
  is in JAX), the issuing `picotron_tpu_torch/<file>:<line>` and
  function, and the root parameter path of the state leaf it reads or
  writes where it has one (a grad buffer's all-reduce, ZeRO-1's
  gather into a parameter).
- **Classification** (`intended_rule`): a site is *intended* when it
  matches the schedule contract `analysis/collectives.py` audits for
  presence — the JAX rules, plus the legs of the port's hierarchical dp
  reduction. Anything else is surfaced for a human.
- **Implicit ops and boundary reshards: 0 by construction.** Eager
  PyTorch has no partitioner: no collective runs that a line of the
  package did not call, and a tensor's layout is whatever its producer
  made, so nothing is resharded at a boundary. The report states both
  counts as 0 with that reason; there is no search to run. The JAX
  misspecced-input case (a tensor committed under one spec, consumed
  under another) is the spec lint's `held_splits` check here
  (`analysis/spec_lint.py`), an error that names the fix.

`audit_dataflow` composes them into the `provenance` check. Its
findings are info only: nothing here can be implicit.
"""

from __future__ import annotations

from dataclasses import dataclass

from picotron_tpu_torch.analysis.report import INFO, Report

CHECK = "provenance"

NO_PARTITIONER = ("eager PyTorch has no partitioner: every collective is a "
                  "call a line of the package makes, and no tensor is "
                  "resharded at a boundary")


@dataclass(frozen=True)
class CollectiveSite:
    """One recorded collective's authored site."""

    kind: str        # a trace.KINDS member
    primitive: str   # the comm hook that received it
    axes: tuple      # layout axes its group spans
    source: str      # 'picotron_tpu_torch/<file>:<line>'
    scope: str       # the issuing function
    roots: tuple     # state leaves it reads or writes
    group: int = 0   # subgroup size (0 = the axes' whole product)

    def describe(self, max_roots: int = 3) -> str:
        roots = ", ".join(self.roots[:max_roots])
        if len(self.roots) > max_roots:
            roots += f", +{len(self.roots) - max_roots} more"
        return (f"{self.primitive}{self.axes} at {self.source} "
                f"[{self.scope}] <- {roots or '<activations>'}")


_PRIMITIVE = {"all_reduce": "all_reduce_into",
              "all_gather": "all_gather_into",
              "reduce_scatter": "reduce_scatter_into",
              "all_to_all": "all_to_all_into",
              "collective_permute": "send_recv_into"}


def group_axes(cfg, members) -> tuple:
    """(axes, subgroup size) of a group of ranks (or of a permute's
    pairs): the axes whose coordinate varies inside it, and its size
    when that is less than their product (else 0)."""
    import math

    from picotron_tpu_torch.mesh import AXES, layout_sizes, rank_coords

    sizes = layout_sizes(cfg)
    coords = [rank_coords(m, sizes) for m in members]
    axes = tuple(a for a in AXES if len({c[a] for c in coords}) > 1)
    full = math.prod(sizes[a] for a in axes)
    n = len(set(members))
    return axes, (n if 0 < n < full else 0)


def leaf_roots(states: dict) -> dict:
    """{operand key: (leaf names)} over the recorded ranks' states."""
    from picotron_tpu_torch.analysis.trace import operand_key, state_leaves

    out: dict = {}
    for state in states.values():
        for name, t in state_leaves(state).items():
            out.setdefault(operand_key(t), set()).add(name)
    return {k: tuple(sorted(v)) for k, v in out.items()}


def collect_sites(cfg, recorded) -> list:
    """One `CollectiveSite` per recorded op of the union schedule, in
    order."""
    from picotron_tpu_torch.mesh import AXES

    roots = leaf_roots(recorded.states)
    sites = []
    for op in recorded.ops:
        if op.kind == "collective_permute":
            # the axes a transfer crosses, over every pair
            spans = {a for pair in op.members
                     for a in group_axes(cfg, pair)[0]}
            axes, sub = tuple(a for a in AXES if a in spans), 0
        else:
            axes, sub = group_axes(cfg, op.group)
        sites.append(CollectiveSite(
            op.kind, _PRIMITIVE[op.kind], axes, op.source, op.scope,
            roots.get(op.operand, ()), sub))
    return sites


def intended_rule(cfg, site):
    """The schedule-contract rule a site satisfies (None = unexplained):
    the JAX rules, on the port's groups."""
    from picotron_tpu_torch.config import resolved_cp_flavor

    d = cfg.distributed
    ax = set(site.axes)
    if not ax:
        return None
    data = {"dp", "ep", "cp"}
    tp2d = False
    if d.tp_size > 1 and d.tp_strategy not in ("megatron", ""):
        from picotron_tpu_torch.config import resolved_tp_strategy

        tp2d = "2d" in resolved_tp_strategy(cfg).values()
    if site.kind == "all_reduce":
        if ax <= data:
            return "data-axes grad/loss sync"
        if ax == {"tp"}:
            if tp2d and site.group:
                return "2d TP outer-subgroup psum"
            return "TP boundary psum"
        if ax == {"pp"} and d.pp_size > 1:
            return "pp replicated-grad/loss-stat sync"
    mesh_cp = d.cp_size > 1 and resolved_cp_flavor(cfg) == "mesh"
    if site.kind in ("all_gather", "reduce_scatter"):
        if ax == {"tp"} and d.sequence_parallel:
            return "Megatron-SP f/g pair"
        if ax == {"tp"} and d.tp_sync == "deferred":
            return "deferred-sync RS/AG pair"
        if ax == {"tp"} and tp2d and site.group:
            return "2d TP inner-subgroup gather"
        if ax == {"tp"} and d.tp_strategy not in ("megatron", ""):
            return "TP strategy feature gather"
        if ax <= data and d.zero1 and site.kind == "all_gather":
            return "ZeRO-1 shard round-trip"
        if ax <= data and d.slices > 1:
            return "hierarchical dp reduction leg"
        if ax == {"cp"} and mesh_cp and site.group:
            return "mesh row position gather"
    if site.kind == "collective_permute":
        if ax == {"cp"}:
            return ("mesh row-ring K/V shift" if mesh_cp
                    else "ring-attention K/V shift")
        if ax == {"pp"}:
            return "pipeline boundary exchange"
    if site.kind == "all_to_all":
        if ax == {"ep"}:
            return "expert dispatch/combine"
        if ax == {"cp"}:
            return ("mesh head scatter (cp_y subgroup)"
                    if mesh_cp and site.group
                    else "Ulysses seq<->head trade")
    return None


def audit_dataflow(cfg, *, recorded=None, cost_model=None) -> Report:
    """The `provenance` check: every effective recorded op attributed to
    its site and classified; implicit ops and boundary reshards stated
    as 0 (module docstring)."""
    rep = Report()
    if recorded is None:
        from picotron_tpu_torch.analysis.trace import record_train_step

        recorded = record_train_step(cfg)
    pairs = [(op, site) for op, site in zip(recorded.ops,
                                            collect_sites(cfg, recorded))
             if op.effective]
    by_rule: dict = {}
    unexplained = []
    by_source: dict = {}
    for op, site in pairs:
        rule = intended_rule(cfg, site)
        if rule is None:
            unexplained.append(site)
        else:
            by_rule[rule] = by_rule.get(rule, 0) + 1
        row = by_source.setdefault(site.source, {"ops": 0, "kinds": set(),
                                                 "roots": set()})
        row["ops"] += 1
        row["kinds"].add(op.kind)
        row["roots"].update(site.roots)
    for site in list({s.source: s for s in unexplained}.values())[:8]:
        rep.add(CHECK, INFO, site.source,
                f"collective outside the declared schedule contract: "
                f"{site.describe()}")
    n_ops = len(pairs)
    info = {
        "sites": len(by_source),
        "ops_effective": n_ops,
        "ops_attributed": n_ops,
        "attribution_pct": 100.0,
        "implicit_ops": 0,
        "boundary_reshards": 0,
        "why_zero": NO_PARTITIONER,
        "intended_by_rule": dict(sorted(by_rule.items())),
        "unexplained_sites": len(unexplained),
        "by_source": {src: {"ops": row["ops"],
                            "kinds": sorted(row["kinds"]),
                            "roots": sorted(row["roots"])[:4]}
                      for src, row in sorted(by_source.items())},
    }
    if cost_model is not None:
        # the JAX keys: the unintended traffic is priced like the rest,
        # and here there is none
        secs, nbytes = cost_model.price_reshards(cfg, [])
        info["implicit_comm_ms"] = round(secs * 1e3, 4)
        info["implicit_bytes"] = nbytes
    rep.info[CHECK] = info
    return rep
