"""Analytic communication and step-time model of a layout (port of
picotron_tpu/analysis/cost_model.py, its arithmetic).

The JAX module prices a dp x tp x pp x cp x ep layout on a TPU torus;
this one keeps that arithmetic and makes the hardware a parameter, so
that the port states no TPU figure of its own and the tests can still
hold it to the JAX package:

- **the torus tier** (`IciGeneration`): the JAX descriptor's fields and
  placement (innermost axes own a torus dimension, outer axes fold with a
  stride; an axis wraps into a ring from `wrap_min`, else it is a line)
  and its DCN tier across slices. There is no built-in table of TPU
  generations: the tests build the descriptors from the JAX package's own
  `GENERATIONS`.
- **the h100 tier** (`SwitchedGeneration`, the port's default): an
  8-GPU node behind NVSwitch, where every axis whose ranks stay inside a
  node is one hop at the GPU's NVLink bandwidth whatever its size, and an
  axis that crosses the node boundary (axes placed innermost first: tp,
  cp, ep, pp, dp) is priced on the InfiniBand tier, one NIC per GPU, the
  way the JAX model prices its DCN tier. A switched link streams one way
  per collective (directions 1) and its all-to-all sends (n-1)/n of the
  payload once.

Per collective (`collective_secs`): the ring formulas (all-reduce
2(n-1)/n V, all-gather and reduce-scatter (n-1)/n V, all-to-all n/4 V
per direction on a torus, a neighbour shift V) plus a per-hop latency.
Per step (`CostModel.predict`): compute from the calibrated dense and
attention efficiencies, the pipeline bubble of the executor, the
optimizer offload's PCIe streaming, and the comm terms weighted by how
much of each stays exposed. "dots_offload" is priced as the JAX package
prices it, a FLOP multiplier with no activation PCIe term (PERF.md
records how far that is from the card). A recorded schedule is priced
op by op (`price_ops`, `priced_schedule`: the collectives
`analysis/trace.py` records for one step, on their placed axes), as the
JAX model prices a traced one; `price_reshards` prices predicted
reshards, of which eager PyTorch has none (`analysis/dataflow.py`).

The h100 tier's figures and their sources:
- NVLink 4: 18 links x 25 GB/s = 450 GB/s per direction per GPU, and
  989.5 TFLOP/s dense bf16 (NVIDIA's H100 SXM5 data sheet; `utils.py`
  H100_BF16_PEAK is the same constant);
- InfiniBand NDR: 400 Gb/s per GPU = 50 GB/s per direction (one
  ConnectX-7 per GPU in NVIDIA's DGX H100 reference node), 5 us per hop
  (an analytic default, unmeasured: the card's machine has one GPU);
- HBM: 80 GB (the data sheet), or `torch.cuda.get_device_properties` of
  the card where one is present (`h100_tier()`);
- PCIe: the calibration's `pcie_bandwidth`, pinned at 32.8 GB/s each
  way with both directions streaming at once, the pinned-copy rate
  `chip_smoke.py`'s `link_rates` measured on an NVIDIA H100 80GB HBM3 at
  700 W (52.5 GB/s to the card and 54.2 from it alone): the card's
  points do not determine it (`calibration.FIT_KEYS`).

Everything here is arithmetic on a Config: no device is touched (only
`h100_tier()` asks torch for the card's memory), so it runs in the
trainer's preflight, the report tools and the planner's sweeps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Union

from picotron_tpu_torch.config import (
    Config, ServeConfig, num_params, parse_tp_strategy, resolved_cp_flavor,
    resolved_cp_mesh, resolved_tp_mesh,
)
from picotron_tpu_torch.utils import H100_BF16_PEAK, flops_per_token

# ---------------------------------------------------------------------------
# Hardware tiers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IciGeneration:
    """A TPU torus (the JAX package's descriptor, field for field)."""

    name: str
    phys_axes: int          # independent torus dims a logical axis can own
    link_bandwidth: float   # bytes/s per link per direction
    wrap_min: int           # smallest axis size that closes into a ring
    hbm_gib: float          # per-chip HBM capacity
    peak_flops: float       # per-chip bf16 peak FLOP/s
    pcie_bandwidth: float   # host<->device streaming fallback
    dcn_bandwidth: float = 6.25e9   # across the slice cut, per direction
    dcn_alpha_s: float = 2.0e-5     # per-transfer DCN latency


@dataclass(frozen=True)
class SwitchedGeneration:
    """GPUs in nodes behind a switch (NVSwitch inside, InfiniBand across):
    the h100 tier (module docstring for the figures' sources)."""

    name: str = "h100"
    node_size: int = 8
    link_bandwidth: float = 450e9   # NVLink 4, per GPU per direction
    ib_bandwidth: float = 50e9      # NDR 400 Gb/s per GPU per direction
    ib_alpha_s: float = 5.0e-6
    hbm_gib: float = 80.0
    peak_flops: float = H100_BF16_PEAK

    # the JAX DCN tier's role: the network between nodes
    @property
    def dcn_bandwidth(self) -> float:
        return self.ib_bandwidth

    @property
    def dcn_alpha_s(self) -> float:
        return self.ib_alpha_s


Generation = Union[IciGeneration, SwitchedGeneration]

H100 = SwitchedGeneration()


def h100_tier() -> SwitchedGeneration:
    """The h100 tier with the card's own memory when a card is present
    (`torch.cuda.get_device_properties`), the data sheet's 80 GB
    otherwise."""
    import torch

    if torch.cuda.is_available():
        total = torch.cuda.get_device_properties(0).total_memory
        return replace(H100, hbm_gib=total / 2 ** 30)
    return H100


def resolve_generation(name_or_kind=None) -> Generation:
    """A tier from a descriptor (returned as it is) or a name: "h100",
    `torch.cuda.get_device_name()` of a card, or any kind the port does
    not know (the CPU) resolves to the h100 tier. The port carries no
    TPU figures: a torus tier is built from its descriptor."""
    if isinstance(name_or_kind, (IciGeneration, SwitchedGeneration)):
        return name_or_kind
    return H100


def _switched(gen: Generation) -> bool:
    return isinstance(gen, SwitchedGeneration)


# ---------------------------------------------------------------------------
# Hop counts + axis placement
# ---------------------------------------------------------------------------


def ring_diameter(n: int) -> int:
    """Max hop distance on a bidirectional ring of n chips."""
    return n // 2


def line_diameter(n: int) -> int:
    """Max hop distance on a line (torus slice without wraparound)."""
    return max(n - 1, 0)


@dataclass(frozen=True)
class AxisLink:
    """One mesh axis' modeled placement."""

    axis: str
    size: int
    kind: str          # "ring" | "line" (torus) | "switch"
    bandwidth: float   # effective bytes/s per direction for this axis
    stride: int        # physical hops between logical neighbors (folding)
    alpha: Optional[float] = None  # per-hop latency; None: calibration's

    @property
    def diameter(self) -> int:
        if self.kind == "switch":
            return 1 if self.size > 1 else 0
        d = (ring_diameter(self.size) if self.kind == "ring"
             else line_diameter(self.size))
        return d * self.stride

    @property
    def directions(self) -> int:
        # a ring algorithm can stream both ways; a line or a switch port
        # one way per collective
        return 2 if self.kind == "ring" else 1


# placement priority: innermost (most comm-hungry) first — the mesh's
# axis order (dp, pp, ep, cp, tp) reversed
PLACEMENT_ORDER = ("tp", "cp", "ep", "pp", "dp")


def place_axes(axis_sizes: dict, gen: Generation) -> dict[str, AxisLink]:
    """The logical -> physical assignment. Torus: the first `phys_axes`
    non-trivial axes (innermost first) each own a dimension at full link
    bandwidth; later axes fold over used dimensions, paying a neighbour
    stride equal to the product of the sizes sharing their dimension.
    Switched: an axis whose ranks (innermost axes first) stay inside a
    node is one NVLink hop; one that crosses the node is on the IB tier."""
    out: dict[str, AxisLink] = {}
    nontrivial = [a for a in PLACEMENT_ORDER if axis_sizes.get(a, 1) > 1]
    if _switched(gen):
        span = 1
        for ax in nontrivial:
            n = axis_sizes[ax]
            span *= n
            if span <= gen.node_size:
                out[ax] = AxisLink(ax, n, "switch", gen.link_bandwidth, 1)
            else:
                out[ax] = AxisLink(ax, n, "switch", gen.ib_bandwidth, 1,
                                   gen.ib_alpha_s)
        return out
    dim_load = [1] * max(gen.phys_axes, 1)
    for i, ax in enumerate(nontrivial):
        n = axis_sizes[ax]
        dim = i % len(dim_load)
        stride = dim_load[dim] if i >= len(dim_load) else 1
        dim_load[dim] *= n
        kind = "ring" if n >= gen.wrap_min else "line"
        out[ax] = AxisLink(ax, n, kind,
                           gen.link_bandwidth / max(stride, 1), stride)
    return out


def split_cp_link(link: AxisLink, cp_x: int, cp_y: int,
                  gen: Generation) -> tuple[AxisLink, AxisLink]:
    """Factor one placed axis into a 2D submesh: (outer cp_x link, inner
    cp_y link). Torus: the inner sub-axis is a contiguous slice (its wrap
    by the generation's rule), the outer one hops cp_y neighbours per
    step at 1/cp_y of the bandwidth and inherits the parent's wrap.
    Switched: both sub-axes keep the parent's link (a switch gives every
    pair its own path)."""
    if link.kind == "switch":
        return (replace(link, size=cp_x), replace(link, size=cp_y))
    inner_kind = "ring" if cp_y >= gen.wrap_min else "line"
    inner = AxisLink(link.axis, cp_y, inner_kind, link.bandwidth, link.stride)
    outer_kind = link.kind if cp_x > 1 else "line"
    outer = AxisLink(link.axis, cp_x, outer_kind,
                     link.bandwidth / max(cp_y, 1), link.stride * cp_y)
    return outer, inner


def split_slice_link(link: AxisLink, n_slices: int,
                     gen: Generation) -> tuple[AxisLink, AxisLink]:
    """Factor one placed axis that crosses the slice (node) cut into
    (intra-slice sub-link of size n/slices, inter-slice link of size
    slices): the intra leg keeps the parent's bandwidth and stride, the
    cross leg runs at the tier's DCN (IB) bandwidth."""
    m = max(link.size // max(n_slices, 1), 1)
    if link.kind == "switch":
        intra = AxisLink(link.axis, m, "switch", gen.link_bandwidth, 1)
        return intra, AxisLink(f"{link.axis}@dcn", n_slices, "switch",
                               gen.dcn_bandwidth, 1, gen.dcn_alpha_s)
    intra = AxisLink(link.axis, m,
                     "ring" if m >= gen.wrap_min else "line",
                     link.bandwidth, link.stride)
    dcn = AxisLink(f"{link.axis}@dcn", n_slices, "ring",
                   gen.dcn_bandwidth, 1)
    return intra, dcn


# ---------------------------------------------------------------------------
# Calibration constants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Calibration:
    """The constants measured steps pin down. eff_max, h_half and
    eff_attn are the h100 tier's fit: `calibration.fit_calibration` of
    `calibration.FIT_KEYS` from `calibration.FIT_START` over the points of
    `analysis/h100_points.json`, measured by `chip_smoke.py` on an NVIDIA
    H100 80GB HBM3 at 700 W (a test refits them). pcie_bandwidth is
    FIT_START's, the link's measured rate (module docstring). The
    exposure fractions, latencies and remat multipliers are the JAX
    package's analytic defaults, unmeasured on cards."""

    # dense-matmul efficiency saturates with hidden size:
    #   eff_dense(h) = min(eff_max * h / (h + h_half), eff_cap)
    eff_max: float = 0.51
    h_half: float = 2048.0
    eff_cap: float = 0.92
    eff_attn: float = 0.48
    pcie_bandwidth: float = 32.8e9
    alpha_link_s: float = 1.0e-6
    # fraction of each comm class NOT hidden under compute
    expose_grad: float = 0.35
    expose_pp: float = 0.5
    # pp's mpmd executor: host cost of dispatching one per-stage program
    host_dispatch_s: float = 2.0e-4
    expose_layer: float = 1.0
    # tp_sync "deferred": the share of the hoisted gather left exposed
    expose_deferred: float = 0.55
    # step-FLOPs multiplier per remat policy, relative to "dots"
    remat_flops: tuple = (("full", 1.30), ("dots", 1.0),
                          ("dots_attn", 1.07), ("dots_lean", 1.12),
                          ("dots_norms", 0.98), ("dots_offload", 1.07))

    def remat_multiplier(self, policy: str, remat: bool) -> float:
        if not remat:
            return 1.0
        return dict(self.remat_flops).get(policy, 1.0)


DEFAULT_CALIBRATION = Calibration()

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


# ---------------------------------------------------------------------------
# Cost terms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CommTerm:
    """One class of collective traffic in a step's schedule."""

    name: str          # e.g. "grad_sync", "tp_psum", "cp_ring"
    kind: str          # all_reduce, all_gather, reduce_scatter, ...
    axes: tuple        # mesh axes the op spans
    count: int         # ops per step
    bytes_each: float  # payload bytes per op (full logical tensor)
    secs_each: float   # predicted seconds per op
    exposed_frac: float

    @property
    def secs_total(self) -> float:
        return self.secs_each * self.count

    @property
    def secs_exposed(self) -> float:
        return self.secs_total * self.exposed_frac


@dataclass(frozen=True)
class StepCost:
    """Predicted decomposition of one optimizer step."""

    config_label: str
    generation: str
    n_chips: int
    tokens_per_step: int
    compute_s: float
    bubble_s: float      # pipeline bubble (executor-dependent)
    offload_s: float     # optimizer-offload PCIe streaming
    comm: tuple          # CommTerm, ...

    @property
    def comm_s(self) -> float:
        return sum(t.secs_total for t in self.comm)

    @property
    def exposed_comm_s(self) -> float:
        return sum(t.secs_exposed for t in self.comm)

    @property
    def total_s(self) -> float:
        return (self.compute_s + self.bubble_s + self.offload_s
                + self.exposed_comm_s)

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_per_step / self.total_s

    @property
    def tokens_per_sec_per_chip(self) -> float:
        return self.tokens_per_sec / self.n_chips

    def as_dict(self) -> dict:
        return {
            "config": self.config_label,
            "generation": self.generation,
            "n_chips": self.n_chips,
            "tokens_per_step": self.tokens_per_step,
            "predicted_step_ms": round(self.total_s * 1e3, 3),
            "compute_ms": round(self.compute_s * 1e3, 3),
            "bubble_ms": round(self.bubble_s * 1e3, 3),
            "offload_ms": round(self.offload_s * 1e3, 3),
            "comm_ms": round(self.comm_s * 1e3, 3),
            "exposed_comm_ms": round(self.exposed_comm_s * 1e3, 3),
            "tokens_per_sec": round(self.tokens_per_sec, 1),
            "tokens_per_sec_per_chip": round(self.tokens_per_sec_per_chip,
                                             1),
            "comm_terms": {t.name: round(t.secs_total * 1e3, 3)
                           for t in self.comm},
        }


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class CostModel:
    """Price collectives and whole steps on one hardware tier (default
    the h100 tier)."""

    def __init__(self, generation=None,
                 calibration: Calibration = DEFAULT_CALIBRATION):
        self.gen = resolve_generation(generation)
        self.calib = calibration

    # -- per-collective ----------------------------------------------------

    def collective_secs(self, kind: str, nbytes: float,
                        link: AxisLink, alpha: float = None) -> float:
        """Seconds for one collective of `kind` moving `nbytes` (the full
        logical tensor for group collectives; the per-device payload for a
        neighbour shift) over one placed axis. `alpha` overrides the
        per-hop latency (else the link's, else the calibration's)."""
        n, bw = link.size, link.bandwidth
        if n <= 1 or nbytes <= 0:
            return 0.0
        dirs = link.directions
        if alpha is None:
            alpha = (link.alpha if link.alpha is not None
                     else self.calib.alpha_link_s)
        if kind == "all_gather" or kind == "reduce_scatter":
            return nbytes * (n - 1) / n / (dirs * bw) + alpha * (n - 1)
        if kind == "all_reduce":
            return 2 * nbytes * (n - 1) / n / (dirs * bw) + alpha * (n - 1)
        if kind == "all_to_all":
            if link.kind == "switch":
                # every peer one hop away: (n-1)/n of the payload leaves
                return nbytes * (n - 1) / n / bw + alpha * (n - 1)
            # mean pair distance n/4 on a ring (n/2 on a line) x per-pair
            # V/n payloads crossing shared links
            return nbytes * n / (4 * dirs * bw) + alpha * (n - 1)
        if kind == "collective_permute":
            # neighbour shift: every link carries one payload; on a line
            # the wraparound message re-crosses the whole slice
            hops = 1 if link.kind in ("ring", "switch") else max(n - 1, 1)
            return nbytes * hops / bw + alpha * hops
        raise ValueError(f"unknown collective kind {kind!r}")

    def axes_for(self, cfg: Config) -> dict[str, AxisLink]:
        d = cfg.distributed
        return place_axes({"dp": d.dp_size, "pp": d.pp_size,
                           "ep": d.ep_size, "cp": d.cp_size,
                           "tp": d.tp_size}, self.gen)

    # -- the dcn (ib) tier -------------------------------------------------

    def dcn_link(self, n_slices: int) -> AxisLink:
        """The inter-slice 'axis' at the tier's DCN (IB) bandwidth."""
        kind = "switch" if _switched(self.gen) else "ring"
        return AxisLink("dcn", n_slices, kind, self.gen.dcn_bandwidth, 1)

    def dcn_secs(self, kind: str, nbytes: float, n_slices: int) -> float:
        """Seconds for one collective leg crossing the slice cut — the
        same formulas at the DCN tier's bandwidth and latency."""
        return self.collective_secs(kind, nbytes, self.dcn_link(n_slices),
                                    alpha=self.gen.dcn_alpha_s)

    def slice_tiers(self, cfg: Config, n_slices: int, axis: str) -> dict:
        """The predicted step comm under a slice cut on `axis` (dp or pp):
        terms spanning the axis re-priced hierarchically (wide legs on the
        intra-slice sub-link, a shard-per-slice leg across the cut), the
        rest on their placed links."""
        cost = self.predict(cfg)
        links = self.axes_for(cfg)
        d = cfg.distributed
        axis_size = {"dp": d.dp_size, "pp": d.pp_size}.get(axis, 1)
        ici_s = dcn_s = 0.0
        dcn_bytes = 0.0
        crossing = []
        for t in cost.comm:
            if axis not in t.axes or axis not in links:
                ici_s += t.secs_total
                continue
            crossing.append(t.name)
            intra, dcn = split_slice_link(links[axis], n_slices, self.gen)
            other_s = sum(self.collective_secs(t.kind, t.bytes_each,
                                               links[a])
                          for a in t.axes if a != axis and a in links)
            if t.kind == "collective_permute":
                # the boundary pairs at the cut cross point-to-point;
                # in-slice pairs keep their price
                ici_s += t.count * (other_s + self.collective_secs(
                    t.kind, t.bytes_each, intra))
                dcn_leg = (t.bytes_each / self.gen.dcn_bandwidth
                           + self.gen.dcn_alpha_s)
                dcn_s += t.count * dcn_leg
                dcn_bytes += t.count * t.bytes_each
            else:
                m = max(axis_size // n_slices, 1)
                ici_s += t.count * (other_s + self.collective_secs(
                    t.kind, t.bytes_each, intra))
                shard = t.bytes_each / m
                dcn_s += t.count * self.dcn_secs(t.kind, shard, n_slices)
                dcn_bytes += t.count * shard * (
                    2 if t.kind == "all_reduce" else 1) * (
                    n_slices - 1) / n_slices
        return {
            "axis": axis, "slices": n_slices,
            "generation": self.gen.name,
            "crossing_terms": crossing,
            "dcn_bytes": int(dcn_bytes),
            "dcn_ms": round(dcn_s * 1e3, 4),
            "ici_ms": round(ici_s * 1e3, 4),
            "total_comm_ms": round((ici_s + dcn_s) * 1e3, 4),
        }

    # -- recorded-schedule pricing -----------------------------------------

    def price_ops(self, cfg: Config, ops) -> list[dict]:
        """Price a recorded `CollectiveOp` list (analysis/trace.py; the
        JAX model's parsed one prices alike) against the config's axis
        placement. Each op's group size is matched to a layout axis (or,
        for the data axes' grad all-reduce, to the (dp, ep, cp) product,
        priced as one pass per constituent axis). Ops whose group no axis
        explains are priced on the worst (slowest) placed axis, flagged
        `axis_guess` (port of the JAX method)."""
        links = self.axes_for(cfg)
        d = cfg.distributed
        sizes = {"dp": d.dp_size, "pp": d.pp_size, "ep": d.ep_size,
                 "cp": d.cp_size, "tp": d.tp_size}
        priced = []
        for op in ops:
            if not op.effective:
                continue
            nbytes = op.nbytes or 0
            axes = self._match_axes(op, sizes)
            if axes:
                secs = sum(
                    self.collective_secs(op.kind, nbytes, links[a])
                    for a in axes if a in links)
                guess = False
            else:
                worst = min(links.values(), key=lambda l: l.bandwidth,
                            default=None)
                secs = (self.collective_secs(op.kind, nbytes, worst)
                        if worst else 0.0)
                guess = True
            priced.append({"kind": op.kind, "line": op.line,
                           "bytes": nbytes, "axes": axes,
                           "secs": secs, "axis_guess": guess})
        return priced

    def price_reshards(self, cfg: Config, reshards) -> tuple:
        """(secs, bytes) of predicted boundary reshards, each an
        all-gather of its whole tensor on the slowest placed axis (the
        JAX method's conservative bound). Eager PyTorch predicts none
        (analysis/dataflow.py), so the port calls this with []."""
        links = [l for l in self.axes_for(cfg).values() if l.size > 1]
        worst = min(links, key=lambda l: l.bandwidth, default=None)
        if worst is None:
            return 0.0, sum(r.nbytes for r in reshards)
        secs = sum(self.collective_secs("all_gather", r.nbytes, worst)
                   for r in reshards)
        return secs, sum(r.nbytes for r in reshards)

    @staticmethod
    def _match_axes(op, sizes: dict) -> tuple:
        """Layout axes an op most plausibly spans (the JAX rule: a
        permute's pairs name no group, so cp's ring first, then pp)."""
        if op.kind == "collective_permute":
            for a in ("cp", "pp", "dp"):
                if sizes[a] > 1:
                    return (a,)
            return ()
        g = op.group_size or 0
        if g <= 1:
            return ()
        fused = sizes["dp"] * sizes["ep"] * sizes["cp"]
        if g == fused and fused > 1:
            return tuple(a for a in ("dp", "ep", "cp") if sizes[a] > 1)
        prefer = (("ep", "cp", "tp", "dp", "pp")
                  if op.kind == "all_to_all"
                  else ("tp", "cp", "ep", "dp", "pp"))
        for a in prefer:
            if sizes[a] == g:
                return (a,)
        return ()

    def priced_schedule(self, cfg: Config, recorded=None):
        """(priced ops, total comm seconds) of the config's recorded step
        (`analysis/trace.record_train_step`, made here when `recorded` is
        not given: one meta step per pipeline stage, no card)."""
        if recorded is None:
            from picotron_tpu_torch.analysis.trace import record_train_step

            recorded = record_train_step(cfg)
        priced = self.price_ops(cfg, recorded.ops)
        return priced, sum(p["secs"] for p in priced)

    def price_kv_handoff(self, model_cfg, serve_cfg=None, *,
                         n_tokens: Optional[int] = None,
                         hops: int = 1) -> tuple:
        """(secs, bytes) for ONE prefill -> decode KV handoff of the
        disaggregated engine (serve/disagg.py): the K and V blocks of one
        finished prefix cross the pool boundary point to point over `hops`
        links (the h100 tier: one NVLink hop between two GPUs of a node).
        Payload = 2 x L x blocks x block_size x Hkv x Dh at the model
        dtype, blocks rounded up from `n_tokens` (default the whole
        serve.max_model_len prefix, the conservative per-request bound)."""
        scfg = serve_cfg or ServeConfig()
        max_len = (scfg.max_model_len
                   or model_cfg.max_position_embeddings)
        if n_tokens is None:
            n_tokens = max_len
        blocks = -(-n_tokens // scfg.block_size)
        kv_bytes = _DTYPE_BYTES.get(model_cfg.dtype, 2)
        nbytes = (2 * model_cfg.num_hidden_layers * blocks
                  * scfg.block_size * model_cfg.num_key_value_heads
                  * model_cfg.head_dim * kv_bytes)
        secs = (nbytes * hops / self.gen.link_bandwidth
                + self.calib.alpha_link_s * hops)
        return secs, nbytes

    # -- analytic whole-step prediction -----------------------------------

    def predict(self, cfg: Config, label: Optional[str] = None) -> StepCost:
        """Analytic step-time decomposition for `cfg` on this tier. The
        schedule is derived from the config (one forward's promised
        collectives per axis), so this needs no devices."""
        c = self.calib
        m, d, t = cfg.model, cfg.distributed, cfg.training
        world = d.world_size
        s, h = t.seq_length, m.hidden_size
        ga, mbs = t.gradient_accumulation_steps, t.micro_batch_size
        act_bytes = _DTYPE_BYTES.get(m.dtype, 2)
        tokens = cfg.tokens_per_step

        # compute: the 6N + attention formula split into dense / attention
        f_tok = flops_per_token(m, s)
        f_attn_tok = 12.0 * m.num_hidden_layers * h * s
        f_dense_tok = f_tok - f_attn_tok
        eff_d = min(c.eff_max * h / (h + c.h_half), c.eff_cap)
        mult = c.remat_multiplier(t.remat_policy, t.remat)
        compute_s = (tokens * mult
                     * (f_dense_tok / eff_d + f_attn_tok / c.eff_attn)
                     / (world * self.gen.peak_flops))

        # non-megatron tp strategies: the 2d row-side matmuls (o/down)
        # contract a tp_y-times larger slab; their FLOPs join compute
        tp_strat = None
        tp_x = tp_y = 1
        if d.tp_size > 1:
            from picotron_tpu_torch.config import resolved_tp_strategy

            tp_strat = resolved_tp_strategy(cfg, generation=self.gen,
                                            calibration=self.calib)
            if "2d" in tp_strat.values():
                tp_x, tp_y = resolved_tp_mesh(cfg)
                extra_tok = 0.0
                if tp_strat["o"] == "2d":
                    extra_tok += 2.0 * h * h
                if tp_strat["down"] == "2d":
                    extra_tok += 2.0 * h * m.intermediate_size
                compute_s += (tokens * mult * m.num_hidden_layers
                              * extra_tok * (tp_y - 1)
                              / (eff_d * world * self.gen.peak_flops))

        # pipeline bubble: spmd's lockstep tables 2(pp-1)/ga of compute;
        # mpmd's fill/drain (pp-1)/(v ga) plus a host dispatch per program
        bubble_s = 0.0
        if d.pp_size > 1:
            pl = cfg.pipeline
            if pl.executor == "spmd":
                bubble_s = compute_s * 2 * (d.pp_size - 1) / ga
            else:
                v = pl.interleave if pl.schedule == "interleaved" else 1
                bubble_s = (compute_s * (d.pp_size - 1) / (v * ga)
                            + 2 * ga * d.pp_size * v * c.host_dispatch_s)

        # optimizer offload: master + both moments stream to the device
        # and back once per step, sharded like the params
        offload_s = 0.0
        if t.optimizer_offload:
            n_total = num_params(m)
            n_local = n_total / (d.tp_size * d.pp_size)
            if m.num_experts and d.ep_size > 1:
                bank = (m.num_hidden_layers * m.num_experts
                        * 3 * h * m.expert_ffn_size)
                n_local -= bank / d.tp_size / d.pp_size * (1 - 1 / d.ep_size)
            if d.zero1:
                n_local /= d.dp_size
            mom_b = 2 if t.adam_moments_dtype == "bfloat16" else 4
            per_param = 2 * (4 + 2 * mom_b)  # round trip: master + m + v
            offload_s = n_local * per_param / c.pcie_bandwidth

        links = self.axes_for(cfg)
        terms: list[CommTerm] = []

        def add(name, kind, axes, count, nbytes, exposed):
            axes = tuple(a for a in axes if a in links)
            if not axes or count <= 0 or nbytes <= 0:
                return
            secs = sum(self.collective_secs(kind, nbytes, links[a])
                       for a in axes)
            terms.append(CommTerm(name, kind, axes, int(count), nbytes,
                                  secs, exposed))

        layers_stage = max(m.num_hidden_layers // d.pp_size, 1)
        v_act = mbs * (s // d.cp_size) * h * act_bytes  # one microbatch

        # grad sync over the fused data axes, fp32, once per step
        n_grad_local = num_params(m) / (d.tp_size * d.pp_size)
        add("grad_sync",
            "reduce_scatter" if d.zero1 else "all_reduce",
            ("dp", "ep", "cp"), 1, 4 * n_grad_local, c.expose_grad)
        if d.zero1:
            add("zero1_gather", "all_gather", ("dp",), 1,
                act_bytes * n_grad_local, c.expose_grad)

        # tp: 2 fwd + 2 bwd boundary collectives per layer per microbatch
        # on the megatron pairing (SP: a gather/scatter pair of the same
        # volume; deferred: the gather hoisted into the next block);
        # row-first: a psum at the entry over the projection width and a
        # gathered exit; 2d: an inner tp_y gather of activations and
        # weight rows and a psum on the outer tp_x link
        if d.tp_size > 1 and tp_strat is not None:
            deferred = d.tp_sync == "deferred"
            pair_kinds = (("attn", tp_strat["qkv"]), ("mlp", tp_strat["up"]))
            n_pair = 2 * layers_stage * ga   # fwd + bwd, per pair per micro
            n_boundary = sum(n_pair for _, k in pair_kinds if k == "col")
            if n_boundary:
                if deferred:
                    add("tp_defer_gather", "all_gather", ("tp",),
                        n_boundary, v_act, c.expose_deferred)
                    add("tp_defer_scatter", "reduce_scatter", ("tp",),
                        n_boundary, v_act, c.expose_layer)
                elif d.sequence_parallel:
                    add("sp_gather", "all_gather", ("tp",), n_boundary,
                        v_act, c.expose_layer)
                    add("sp_scatter", "reduce_scatter", ("tp",), n_boundary,
                        v_act, c.expose_layer)
                else:
                    add("tp_psum", "all_reduce", ("tp",), n_boundary,
                        v_act, c.expose_layer)
            tok_mb = mbs * (s // d.cp_size)
            p_bytes = _DTYPE_BYTES.get(m.dtype, 2)
            attn_w = m.num_attention_heads * m.head_dim
            proj = {"attn": attn_w + 2 * m.num_key_value_heads * m.head_dim,
                    "mlp": 2 * m.intermediate_size}
            gath = {"attn": proj["attn"], "mlp": m.intermediate_size}
            wrows = {"attn": attn_w, "mlp": m.intermediate_size}
            for pair, kind in pair_kinds:
                if kind == "row":
                    add(f"tp_row_psum_{pair}", "all_reduce", ("tp",),
                        n_pair, tok_mb * proj[pair] * act_bytes,
                        c.expose_layer)
                    add(f"tp_row_gather_{pair}", "all_gather", ("tp",),
                        n_pair, v_act, c.expose_layer)
                elif kind == "2d" and "tp" in links:
                    outer, inner = split_cp_link(links["tp"], tp_x, tp_y,
                                                 self.gen)
                    if tp_y > 1:
                        v_g = tok_mb * gath[pair] // tp_x * act_bytes
                        terms.append(CommTerm(
                            f"tp2d_gather_{pair}", "all_gather", ("tp",),
                            n_pair, v_g,
                            self.collective_secs("all_gather", v_g, inner),
                            c.expose_layer))
                        v_w = wrows[pair] * h // tp_x * p_bytes
                        terms.append(CommTerm(
                            f"tp2d_wgather_{pair}", "all_gather", ("tp",),
                            n_pair, v_w,
                            self.collective_secs("all_gather", v_w, inner),
                            c.expose_layer))
                    if tp_x > 1:
                        terms.append(CommTerm(
                            f"tp2d_psum_{pair}", "all_reduce", ("tp",),
                            n_pair, v_act,
                            self.collective_secs("all_reduce", v_act,
                                                 outer),
                            c.expose_layer))

        # cp: the ring (K/V shifts fwd, K/V + dK/dV bwd), Ulysses' seq <->
        # head all_to_all pair each way, or mesh's 2D split (a head
        # scatter over the inner cp_y subgroup plus a K/V ring over cp_x)
        if d.cp_size > 1:
            flavor = resolved_cp_flavor(cfg)
            kv_dim = m.num_key_value_heads * m.head_dim
            v_kv = 2 * mbs * (s // d.cp_size) * kv_dim * act_bytes
            if flavor == "ulysses":
                add("ulysses_a2a", "all_to_all", ("cp",),
                    4 * layers_stage * ga, v_act, c.expose_layer)
            elif flavor == "mesh" and "cp" in links:
                cp_x, cp_y = resolved_cp_mesh(cfg)
                outer, inner = split_cp_link(links["cp"], cp_x, cp_y,
                                             self.gen)
                if cp_y > 1:
                    secs = self.collective_secs("all_to_all", v_act, inner)
                    terms.append(CommTerm(
                        "mesh_a2a", "all_to_all", ("cp",),
                        4 * layers_stage * ga, v_act, secs,
                        c.expose_layer))
                if cp_x > 1:
                    secs = self.collective_secs("collective_permute",
                                                v_kv, outer)
                    terms.append(CommTerm(
                        "mesh_ring", "collective_permute", ("cp",),
                        3 * (cp_x - 1) * layers_stage * ga, v_kv, secs,
                        c.expose_layer))
            else:
                add("cp_ring", "collective_permute", ("cp",),
                    3 * (d.cp_size - 1) * layers_stage * ga, v_kv,
                    c.expose_layer)

        # ep: dispatch + combine all_to_all, forward and backward
        if d.ep_size > 1 and m.num_experts:
            v_disp = v_act * m.num_experts_per_token * m.capacity_factor
            add("ep_dispatch", "all_to_all", ("ep",),
                4 * layers_stage * ga, v_disp, c.expose_layer)

        # pp boundary: activation fwd + grad bwd per microbatch
        if d.pp_size > 1:
            v_bound = v_act / (d.tp_size if d.sequence_parallel else 1)
            add("pp_boundary", "collective_permute", ("pp",), 2 * ga,
                v_bound, c.expose_pp)

        return StepCost(
            config_label=label or layout_label(cfg),
            generation=self.gen.name, n_chips=world,
            tokens_per_step=tokens, compute_s=compute_s,
            bubble_s=bubble_s, offload_s=offload_s, comm=tuple(terms))


def layout_label(cfg: Config) -> str:
    d, t = cfg.distributed, cfg.training
    bits = [f"dp{d.dp_size}", f"tp{d.tp_size}", f"pp{d.pp_size}",
            f"cp{d.cp_size}", f"ep{d.ep_size}"]
    flags = []
    if d.cp_size > 1 and d.cp_flavor:
        flags.append(d.cp_flavor + (f"-{d.cp_mesh}"
                                    if d.cp_flavor == "mesh" else ""))
    if d.sequence_parallel:
        flags.append("sp")
    if d.tp_size > 1 and d.tp_strategy != "megatron":
        if d.tp_strategy == "2d":
            tp_x, tp_y = resolved_tp_mesh(cfg)
            flags.append(f"tp2d-{tp_x}x{tp_y}")
        elif d.tp_strategy in ("row", "adaptive"):
            flags.append("tp" + d.tp_strategy)
        else:
            flags.append("tpmix")
    if d.tp_sync == "deferred":
        flags.append("deferred")
    if d.zero1:
        flags.append("zero1")
    if t.optimizer_offload:
        flags.append("offload")
    pl = getattr(cfg, "pipeline", None)
    if pl is not None and pl.executor == "mpmd":
        tag = "mpmd-" + pl.schedule
        if pl.schedule == "interleaved":
            tag += f"-v{pl.interleave}"
        flags.append(tag)
    return "x".join(bits) + (("+" + "+".join(flags)) if flags else "")


# ---------------------------------------------------------------------------
# CP-flavor crossover prediction
# ---------------------------------------------------------------------------


def _tp_local_heads(cfg: Config) -> tuple[int, int]:
    m, tp = cfg.model, cfg.distributed.tp_size
    return m.num_attention_heads // tp, m.num_key_value_heads // tp


def feasible_cp_meshes(cfg: Config, cp: Optional[int] = None) -> list:
    """True-2D (cp_x, cp_y) factorizations of the cp degree: both factors
    > 1 and cp_y dividing the tp-local q and kv head counts."""
    cp = cp or cfg.distributed.cp_size
    hq, hkv = _tp_local_heads(cfg)
    return [(cp // y, y) for y in range(2, cp)
            if cp % y == 0 and cp // y > 1
            and hq % y == 0 and hkv % y == 0]


def cp_flavor_costs(model: CostModel, cfg: Config) -> dict:
    """Each feasible cp flavor's price at cfg's cp degree: 'ring' always,
    'ulysses' when the tp-local heads divide by cp, 'mesh' as the best
    true-2D factorization ((StepCost, (cp_x, cp_y))); None = infeasible."""
    d = cfg.distributed
    out = {"ring": None, "ulysses": None, "mesh": None}
    ring_cfg = replace(cfg, distributed=replace(
        d, cp_flavor="ring", cp_mesh=""))
    out["ring"] = model.predict(ring_cfg)
    hq, hkv = _tp_local_heads(cfg)
    if hq % d.cp_size == 0 and hkv % d.cp_size == 0:
        out["ulysses"] = model.predict(replace(cfg, distributed=replace(
            d, cp_flavor="ulysses", cp_mesh="")))
    best = None
    for cp_x, cp_y in feasible_cp_meshes(cfg):
        cost = model.predict(replace(cfg, distributed=replace(
            d, cp_flavor="mesh", cp_mesh=f"{cp_x}x{cp_y}")))
        if best is None or cost.total_s < best[0].total_s:
            best = (cost, (cp_x, cp_y))
    out["mesh"] = best
    return out


def cp_crossover_table(model: CostModel, base: Config,
                       cp_degrees=(2, 4, 8, 16, 32)) -> list[dict]:
    """Per cp degree, each flavor's predicted step time and the winner
    (degrees the sequence cannot shard, 2 cp | seq, are skipped)."""
    rows = []
    for cp in cp_degrees:
        if base.training.seq_length % (2 * cp) or cp < 2:
            continue
        cfg = replace(base, distributed=replace(
            base.distributed, cp_size=cp, cp_flavor="", cp_mesh=""))
        costs = cp_flavor_costs(model, cfg)
        row = {"cp": cp, "generation": model.gen.name}
        times = {}
        for flavor in ("ring", "ulysses", "mesh"):
            v = costs[flavor]
            if flavor == "mesh" and v is not None:
                cost, (cp_x, cp_y) = v
                row["mesh_factorization"] = f"{cp_x}x{cp_y}"
                v = cost
            row[f"{flavor}_ms"] = (round(v.total_s * 1e3, 3)
                                   if v is not None else None)
            if v is not None:
                times[flavor] = v.total_s
        row["winner"] = min(times, key=times.get) if times else None
        rows.append(row)
    return rows


def cp_crossover(model: CostModel, base: Config,
                 cp_degrees=(2, 4, 8, 16, 32)) -> Optional[int]:
    """The smallest swept cp degree where mesh beats ring and Ulysses
    (None if it never does)."""
    for row in cp_crossover_table(model, base, cp_degrees):
        if row["winner"] == "mesh":
            return row["cp"]
    return None


# ---------------------------------------------------------------------------
# TP-strategy pricing + adaptive selection
# ---------------------------------------------------------------------------


def feasible_tp_meshes(cfg: Config, tp: Optional[int] = None) -> list:
    """True-2D (tp_x, tp_y) factorizations of the tp degree: both factors
    > 1 and tp_x dividing the q and kv head counts."""
    m = cfg.model
    tp = tp or cfg.distributed.tp_size
    return [(tp // y, y) for y in range(2, tp)
            if tp % y == 0 and tp // y > 1
            and m.num_attention_heads % (tp // y) == 0
            and m.num_key_value_heads % (tp // y) == 0]


def price_tp_strategy(model: CostModel, cfg: Config, strategy: str,
                      sync: str = "sync", tp_mesh: str = "") -> StepCost:
    """Price `cfg` with its tp strategy / sync knobs forced (a pricing
    probe: the caller owns eligibility)."""
    return model.predict(replace(cfg, distributed=replace(
        cfg.distributed, tp_strategy=strategy, tp_sync=sync,
        tp_mesh=tp_mesh)))


def _pair_spec(attn_kind: str, mlp_kind: str) -> str:
    """The per-class spec of an (attn pair, mlp pair) choice under the
    legal (entry, exit) pairings: col with row, row with col, 2d with 2d."""
    exit_of = {"col": "row", "row": "col", "2d": "2d"}
    return (f"qkv={attn_kind},o={exit_of[attn_kind]},"
            f"up={mlp_kind},down={exit_of[mlp_kind]},head=col")


def choose_tp_strategy(cfg: Config, generation=None,
                       calibration: Calibration = DEFAULT_CALIBRATION
                       ) -> dict:
    """Resolve tp_strategy='adaptive': the per-class argmin over the legal
    pair partitionings, priced on `generation`'s tier (default h100).
    Deterministic: a fixed candidate order and a strict < comparison, so
    megatron (first) wins ties."""
    model = CostModel(generation, calibration)
    d = cfg.distributed
    tp_x, tp_y = resolved_tp_mesh(cfg)
    kinds = ["col", "row"] + (["2d"] if tp_x > 1 and tp_y > 1 else [])
    best_s, best_spec = None, _pair_spec("col", "col")
    for ak in kinds:
        for mk in kinds:
            spec = _pair_spec(ak, mk)
            cost = price_tp_strategy(model, cfg, spec, sync=d.tp_sync,
                                     tp_mesh=d.tp_mesh)
            if best_s is None or cost.total_s < best_s:
                best_s, best_spec = cost.total_s, spec
    return parse_tp_strategy(best_spec)


def tp_strategy_table(model: CostModel, base: Config,
                      tp_degrees=(2, 4, 8, 16)) -> list[dict]:
    """Per tp degree, each strategy x sync mode's predicted step and
    exposed-comm time, the best 2d factorization, the adaptive resolution
    and the winner (degrees the model cannot shard are skipped)."""
    m = base.model
    rows = []
    for tp in tp_degrees:
        if (tp < 2 or m.num_attention_heads % tp
                or m.num_key_value_heads % tp or m.vocab_size % tp):
            continue
        cfg = replace(base, distributed=replace(
            base.distributed, tp_size=tp, tp_strategy="megatron",
            tp_sync="sync", tp_mesh=""))
        variants: dict[str, StepCost] = {
            "megatron": model.predict(cfg),
            "deferred": price_tp_strategy(model, cfg, "megatron",
                                          sync="deferred"),
            "row": price_tp_strategy(model, cfg, "row"),
        }
        row = {"tp": tp, "generation": model.gen.name}
        best2d = None
        for tp_mx, tp_my in feasible_tp_meshes(cfg, tp):
            cost = price_tp_strategy(model, cfg, "2d",
                                     tp_mesh=f"{tp_mx}x{tp_my}")
            if best2d is None or cost.total_s < best2d[0].total_s:
                best2d = (cost, f"{tp_mx}x{tp_my}")
        if best2d is not None:
            variants["2d"] = best2d[0]
            row["mesh_factorization"] = best2d[1]
        base_exposed = variants["megatron"].exposed_comm_s
        for name, cost in variants.items():
            row[f"{name}_ms"] = round(cost.total_s * 1e3, 3)
            row[f"{name}_exposed_ms"] = round(cost.exposed_comm_s * 1e3, 3)
            row[f"{name}_exposed_delta_ms"] = round(
                (cost.exposed_comm_s - base_exposed) * 1e3, 3)
        adaptive = choose_tp_strategy(replace(cfg, distributed=replace(
            cfg.distributed, tp_strategy="adaptive")),
            generation=model.gen, calibration=model.calib)
        row["adaptive"] = ",".join(
            f"{k}={adaptive[k]}" for k in ("qkv", "o", "up", "down"))
        row["winner"] = min(variants, key=lambda k: variants[k].total_s)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Rank statistics (calibration / validation)
# ---------------------------------------------------------------------------


def spearman(xs, ys) -> float:
    """Spearman rank correlation (mean-rank ties)."""
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError("spearman needs two equal-length series, n >= 2")

    def ranks(vs):
        order = sorted(range(len(vs)), key=lambda i: vs[i])
        r = [0.0] * len(vs)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and vs[order[j + 1]] == vs[order[i]]:
                j += 1
            mean_rank = (i + j) / 2.0
            for k in range(i, j + 1):
                r[order[k]] = mean_rank
            i = j + 1
        return r

    rx, ry = ranks(list(xs)), ranks(list(ys))
    mx = sum(rx) / len(rx)
    my = sum(ry) / len(ry)
    num = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    den = math.sqrt(sum((a - mx) ** 2 for a in rx)
                    * sum((b - my) ** 2 for b in ry))
    return num / den if den else 0.0


def with_calibration(model: CostModel, **changes) -> CostModel:
    """A CostModel with some calibration constants replaced."""
    return CostModel(model.gen, replace(model.calib, **changes))
