"""Slice-boundary audit — which recorded collectives cross the slice cut
(port of picotron_tpu/analysis/boundary.py).

A multi-slice layout joins groups of devices over a network far slower
than the links inside a group: TPU slices over DCN in the JAX package;
on H100s under torchrun, nodes over InfiniBand, with NVLink inside a
node (`parallel/hier_reduce.py`). The house rule
(`mesh._split_axes_over_dcn`) absorbs the slice granules into the
outermost axes, dp first, then pp: the gradient reduction and the
pipeline's point-to-point exchanges tolerate the slow tier, ep, cp and
tp collectives must not leave a slice.

`SliceTopology` holds the slice count and the declared crossing axes
(`distributed.dcn_axes`); `classify_ops` maps every member of every
recorded group (`analysis/trace.py`: each record carries its groups) to
its slice and classifies each effective collective:

- **intra** — every group stays inside one slice;
- **boundary** — groups straddle the cut, only via declared axes
  (expected traffic, priced on the tier's cross-node term: the h100
  tier's InfiniBand, the torus tier's DCN);
- **violating** — groups straddle the cut via an undeclared axis (the
  named `ici-axis-over-dcn` error, with the line that issued it);
- **unattributable** — the JAX class for a dialect that elided the
  membership. It cannot happen here: every record has its members.

Two hierarchical presence rules ride along, as in the JAX package:
every crossing reduction must spell the hierarchical decomposition,
either fused (one wide op keeping full per-slice cohorts) or explicit
(cohort-1 cross-slice groups riding an intra-slice reduce-scatter leg:
the schedule `parallel/hier_reduce.py` issues), and every boundary
group must split into equal per-slice cohorts.

Per-tier bytes follow the hierarchical algorithm: a crossing collective
of group size n over s slices (cohort m = n/s) does its wide legs inside
the slice and moves only shard-width payloads across the cut.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from picotron_tpu_torch.analysis.report import ERROR, INFO, WARNING, Report
# the rank grid's axis order: ranks are row-major positions in it
from picotron_tpu_torch.mesh import AXES

CHECK = "boundary"

CLASSES = ("intra", "boundary", "violating", "unattributable")



@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """Slice count + declared DCN-crossing axes, resolved against a mesh
    grid. `dcn_shape` holds the per-axis slice granules the house rule
    actually assigns (dp absorbs first, then pp) — the *physical* cut the
    declaration is checked against."""

    n_slices: int
    declared: tuple       # user-declared crossing axes, dp-first order
    grid: tuple           # (dp, pp, ep, cp, tp) axis sizes
    dcn_shape: tuple      # slice granules per grid axis (house rule)

    @classmethod
    def from_config(cls, cfg, n_slices: Optional[int] = None,
                    dcn_axes: Optional[str] = None) -> "SliceTopology":
        from picotron_tpu_torch.config import parse_dcn_axes
        from picotron_tpu_torch.mesh import _split_axes_over_dcn

        d = cfg.distributed
        s = d.slices if n_slices is None else n_slices
        declared = parse_dcn_axes(
            d.dcn_axes if dcn_axes is None else dcn_axes)
        grid = (d.dp_size, d.pp_size, d.ep_size, d.cp_size, d.tp_size)
        if s > 1:
            dcn_shape, _ = _split_axes_over_dcn(grid, s)
        else:
            dcn_shape = (1,) * len(grid)
        return cls(s, declared, grid, dcn_shape)

    @property
    def cut_axes(self) -> tuple:
        """Axes that physically carry a slice granule (the real cut)."""
        return tuple(a for a, g in zip(AXES, self.dcn_shape) if g > 1)

    @property
    def world(self) -> int:
        out = 1
        for n in self.grid:
            out *= n
        return out

    def coords(self, device_id: int) -> tuple:
        """Row-major (dp, pp, ep, cp, tp) grid coordinates of a flat id."""
        c = []
        rem = device_id
        for n in reversed(self.grid):
            c.append(rem % n)
            rem //= n
        return tuple(reversed(c))

    def slice_of(self, device_id: int) -> int:
        """Slice index of a rank: the granule (outermost) coordinate of
        each split axis, row-major (`parallel/mpmd.slice_of`)."""
        idx = 0
        for coord, g, size in zip(self.coords(device_id), self.dcn_shape,
                                  self.grid):
            idx = idx * g + coord // (size // g)
        return idx


@dataclasses.dataclass(frozen=True)
class ClassifiedOp:
    """One effective collective, classified against the slice cut."""

    kind: str
    line: int
    cls: str              # a CLASSES member
    cross_axes: tuple     # axes whose granule coordinate varies in-group
    slices_touched: int   # max distinct slices any one group spans
    group_size: Optional[int]
    ici_bytes: int        # bytes on intra-slice ICI links
    dcn_bytes: int        # bytes crossing the DCN cut (hierarchical form)
    cohorts: tuple = ()   # per-slice member counts of the worst group

    def as_row(self) -> dict:
        return {"kind": self.kind, "line": self.line, "class": self.cls,
                "axes": list(self.cross_axes),
                "slices": self.slices_touched,
                "group": self.group_size,
                "ici_bytes": self.ici_bytes, "dcn_bytes": self.dcn_bytes}


def _wire_bytes(kind: str, nbytes: int, n: int) -> int:
    """Bytes a flat collective of `kind` moves over its links (ring
    algorithms — the same volumes cost_model.collective_secs prices)."""
    if n <= 1 or not nbytes:
        return 0
    if kind == "all_reduce":
        return int(2 * nbytes * (n - 1) / n)
    return int(nbytes * (n - 1) / n)


def classify_ops(ops, topo: SliceTopology) -> list[ClassifiedOp]:
    """Classify every effective parsed op against the slice topology."""
    out = []
    for op in ops:
        if not op.effective:
            continue
        nbytes = op.nbytes or 0
        if op.members is None:
            out.append(ClassifiedOp(op.kind, op.line, "unattributable",
                                    (), 0, op.group_size,
                                    _wire_bytes(op.kind, nbytes,
                                                op.group_size or 2), 0))
            continue
        if op.kind == "collective_permute":
            crossing = sum(1 for src, tgt in op.members
                           if topo.slice_of(src) != topo.slice_of(tgt))
            axes = _varying_granule_axes(
                [p for p in op.members
                 if topo.slice_of(p[0]) != topo.slice_of(p[1])], topo)
            if crossing == 0:
                cls = "intra"
            elif set(axes) <= set(topo.declared):
                cls = "boundary"
            else:
                cls = "violating"
            out.append(ClassifiedOp(
                op.kind, op.line, cls, axes,
                2 if crossing else 1, None,
                nbytes * (len(op.members) - crossing), nbytes * crossing))
            continue
        worst = None  # ((slices, cohort spread), sorted cohort sizes)
        axes: set = set()
        for group in op.members:
            per_slice: dict = {}
            for m in group:
                sl = topo.slice_of(m)
                per_slice[sl] = per_slice.get(sl, 0) + 1
            if len(per_slice) > 1:
                cohorts = tuple(sorted(per_slice.values()))
                key = (len(per_slice), cohorts[-1] - cohorts[0])
                if worst is None or key > worst[0]:
                    worst = (key, cohorts)
                axes |= set(_varying_granule_axes([group], topo))
        n = op.group_size or 1
        if worst is None:
            out.append(ClassifiedOp(op.kind, op.line, "intra", (), 1, n,
                                    _wire_bytes(op.kind, nbytes, n), 0))
            continue
        s, worst_cohorts = worst[0][0], worst[1]
        m = max(n // s, 1)
        # hierarchical split: wide legs stay on ICI at cohort width m;
        # only the shard-per-slice leg crosses DCN
        if op.kind == "all_reduce":
            ici = int(2 * nbytes * (m - 1) / m)
            dcn = int(2 * (nbytes / m) * (s - 1) / s)
        elif op.kind in ("all_gather", "reduce_scatter"):
            ici = int(nbytes * (m - 1) / m)
            dcn = int((nbytes / m) * (s - 1) / s)
        else:  # all_to_all: per-pair payloads, crossing fraction over DCN
            ici = int(nbytes * (m - 1) / n)
            dcn = int(nbytes * m * (s - 1) / n)
        cls = ("boundary" if axes <= set(topo.declared) else "violating")
        out.append(ClassifiedOp(op.kind, op.line, cls,
                                tuple(a for a in AXES if a in axes),
                                s, n, ici, dcn, worst_cohorts))
    return out


def _varying_granule_axes(groups, topo: SliceTopology) -> tuple:
    """Axes whose slice-granule coordinate varies within any given group —
    the axes that CAUSE a straddle (an axis varying only inside its
    per-slice block never changes the slice index)."""
    varying = set()
    for group in groups:
        coord_sets: list = [set() for _ in topo.grid]
        for m in group:
            for i, (c, g, size) in enumerate(zip(topo.coords(m),
                                                 topo.dcn_shape,
                                                 topo.grid)):
                if g > 1:
                    coord_sets[i].add(c // (size // g))
        for i, cs in enumerate(coord_sets):
            if len(cs) > 1:
                varying.add(AXES[i])
    return tuple(a for a in AXES if a in varying)


def audit_boundary(cfg, *, recorded=None, ops=None,
                   n_slices: Optional[int] = None,
                   dcn_axes: Optional[str] = None,
                   cost_model=None) -> Report:
    """Audit a config's collective schedule against its slice topology.

    `ops` (a recorded schedule, or a planted one), else `recorded`'s (a
    `trace.RecordedStep`), else one recorded here. `n_slices`/`dcn_axes`
    override the config's `distributed.slices`/`distributed.dcn_axes`
    (`tools/shardcheck.py --slices N [--dcn-axes dp,pp]`). A violating op
    is named with the line that issued it. With `cost_model`, the
    per-tier byte totals are priced: the intra-slice legs on the placed
    axis links, the crossing leg on the tier's cross-node (dcn) term."""
    rep = Report()
    try:
        topo = SliceTopology.from_config(cfg, n_slices, dcn_axes)
    except ValueError as e:
        rep.add(CHECK, ERROR, "topology", str(e))
        return rep
    if topo.n_slices <= 1:
        rep.info[CHECK] = {"slices": 1, "audited": False}
        rep.add(CHECK, INFO, "topology",
                "single slice — no DCN cut to audit")
        return rep

    if ops is None:
        if recorded is None:
            from picotron_tpu_torch.analysis.trace import record_train_step

            recorded = record_train_step(cfg)
        ops = recorded.ops
    classified = classify_ops(ops, topo)
    op_bytes = {op.line: op.nbytes for op in ops}
    counts = {c: sum(1 for r in classified if r.cls == c) for c in CLASSES}
    info = {
        "slices": topo.n_slices,
        "audited": True,
        "dcn_axes": ",".join(topo.declared),
        "cut_axes": ",".join(topo.cut_axes),
        **counts,
        "ici_bytes": sum(r.ici_bytes for r in classified),
        "dcn_bytes": sum(r.dcn_bytes for r in classified),
        "table": [r.as_row() for r in classified],
    }
    rep.info[CHECK] = info

    d = cfg.distributed
    sources = {op.line: op.source for op in ops}
    for r in classified:
        if r.cls == "violating":
            src = sources.get(r.line)
            rep.add(CHECK, ERROR, f"{r.kind}@L{r.line}",
                    f"ici-axis-over-dcn: replica group (size "
                    f"{r.group_size}) straddles {r.slices_touched} slices "
                    f"via axis/axes {list(r.cross_axes)} not declared in "
                    f"dcn_axes={info['dcn_axes']!r}"
                    + (f" (issued at {src})" if src else "")
                    + f" — an ICI-only collective is routed over the DCN "
                    f"cut; declare the axis or rebalance the layout so "
                    f"{list(topo.cut_axes)} absorbs the slice count")
        elif r.cls == "unattributable":  # a record without members
            rep.add(CHECK, WARNING, f"{r.kind}@L{r.line}",
                    "group membership unknown — this op cannot be proven "
                    "intra-slice")

    # -- hierarchical presence rules (mutation-tested) ---------------------
    # The hierarchical decomposition of a crossing reduction is a
    # reduce-scatter inside the slice, a small shard-per-slice all-reduce
    # across the cut and an all-gather inside the slice. EVERY crossing
    # reduction must spell it in one of its two forms, per op (an
    # any-pass rule would let the flat loss all-reduce mask a grad path
    # whose intra leg was deleted):
    #
    # - fused form — one wide op whose groups keep full per-slice cohorts
    #   (min cohort >= m_expected), decomposed by the library inside;
    # - explicit form — cohort-1 groups (one member per slice: the
    #   schedule parallel/hier_reduce.py issues), valid only when an
    #   intra-slice reduce-scatter leg is in the schedule AND some intra
    #   scatter produced exactly this op's shard (the "one shard per
    #   slice" size claim).
    #
    # tests/test_torch_shardcheck.py mutates each leg away.
    boundary_ops = [r for r in classified if r.cls == "boundary"]
    if "dp" in topo.declared and "dp" in topo.cut_axes:
        g_dp = topo.dcn_shape[AXES.index("dp")]
        m_expected = (d.dp_size // g_dp) * d.ep_size * d.cp_size
        grad_crossers = [r for r in boundary_ops
                         if r.kind in ("all_reduce", "reduce_scatter")
                         and r.cohorts]
        intra_rs = [r for r in classified
                    if r.cls == "intra" and r.kind == "reduce_scatter"]
        intra_rs_bytes = {op_bytes.get(r.line) for r in intra_rs}
        intra_rs_bytes.discard(None)
        if m_expected > 1:
            for r in grad_crossers:
                if min(r.cohorts) >= m_expected:
                    continue  # fused form
                nb = op_bytes.get(r.line)
                if (max(r.cohorts) == 1 and intra_rs
                        and (nb is None or not intra_rs_bytes
                             or nb in intra_rs_bytes)):
                    continue  # explicit form
                rep.add(
                    CHECK, ERROR, "hier_intra_scatter",
                    f"{r.kind}@L{r.line}: dp crosses DCN but this "
                    f"crossing reduction (cohorts "
                    f"{'|'.join(str(c) for c in r.cohorts)}) neither "
                    f"keeps an intra-slice cohort of {m_expected} (the "
                    f"per-slice width of the fused data axes) nor rides "
                    f"a matching intra-slice reduce-scatter leg: the "
                    f"hierarchical decomposition's intra-slice "
                    f"reduce-scatter is missing — full-width gradients "
                    f"would cross DCN instead of one shard per slice")
    for r in boundary_ops:
        if r.cohorts and len(set(r.cohorts)) > 1:
            rep.add(CHECK, ERROR, "hier_dcn_cohort",
                    f"{r.kind}@L{r.line}: a DCN-crossing group splits "
                    f"{'|'.join(str(c) for c in r.cohorts)} across slices "
                    f"— the hierarchical decomposition's DCN leg must "
                    f"carry equal per-slice cohorts of "
                    f"{(r.group_size or 0) // max(r.slices_touched, 1)}; "
                    f"an unequal split widens the inter-slice transfer "
                    f"past one shard per slice")

    if not rep.errors():
        rep.add(CHECK, INFO, "summary",
                f"{counts['intra']} intra-slice, {counts['boundary']} "
                f"boundary op(s) over declared axes "
                f"[{info['dcn_axes']}], 0 violating — "
                f"{info['dcn_bytes']} B cross DCN (hierarchical), "
                f"{info['ici_bytes']} B stay on ICI")

    if cost_model is not None:
        dcn_s = 0.0
        for r in classified:
            if r.dcn_bytes:
                dcn_s += cost_model.dcn_secs(
                    "all_reduce" if r.kind == "all_reduce" else
                    ("collective_permute"
                     if r.kind == "collective_permute" else "all_gather"),
                    r.dcn_bytes, topo.n_slices)
        links = cost_model.axes_for(cfg)
        worst = min((l.bandwidth for l in links.values()), default=None)
        ici_s = (info["ici_bytes"] / worst) if worst else 0.0
        info["dcn_ms"] = round(dcn_s * 1e3, 4)
        info["ici_ms"] = round(ici_s * 1e3, 4)
        info["dcn_generation"] = cost_model.gen.name
    return rep


def render_table(info: dict) -> str:
    """Human classification table for the shardcheck CLI."""
    if not info.get("audited"):
        return "boundary: single slice — no DCN cut to audit"
    rows = info.get("table", [])
    head = (f"boundary: {info['slices']} slice(s), cut on "
            f"[{info['cut_axes']}], declared [{info['dcn_axes']}] — "
            f"{info['intra']} intra / {info['boundary']} boundary / "
            f"{info['violating']} violating / "
            f"{info['unattributable']} unattributable")
    lines = [head]
    lines.append(f"  {'kind':<20}{'line':>6}  {'class':<15}"
                 f"{'axes':<10}{'ici_bytes':>12}{'dcn_bytes':>12}")
    for r in rows:
        lines.append(
            f"  {r['kind']:<20}{r['line']:>6}  {r['class']:<15}"
            f"{','.join(r['axes']) or '-':<10}"
            f"{r['ici_bytes']:>12}{r['dcn_bytes']:>12}")
    if "dcn_ms" in info:
        lines.append(f"  priced[{info['dcn_generation']}]: "
                     f"dcn {info['dcn_ms']} ms, ici {info['ici_ms']} ms")
    return "\n".join(lines)
