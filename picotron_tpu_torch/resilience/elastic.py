"""Elastic resize of the port (counterpart of picotron_tpu/resilience/
elastic.py): restore a checkpoint into a resized dp / pp layout.

The topology helpers, the constant-global-batch plan, the cursor
translation, the ZeRO-1 shard arithmetic and the restore-time check are
the JAX module's, with the same decisions and the same error facts:

- **Topology read/compare**: `saved_topology` reads the layout a step dir
  was committed under (the manifest's `topology`, else meta.json's
  config); `topology_mismatch` names the axes of `TOPOLOGY_AXES` (and
  `slices`) that differ. Only those axes are compared: the manifest's
  `process_count` and `zero1` are how the files lie, and the re-split
  below carries a checkpoint across either.
- **Resize planning at constant global batch**: `plan_resize` re-factors
  (micro_batch_size, gradient_accumulation_steps) for a new dp so that
  `mbs * ga * dp * ep` is unchanged. The port's loader assembles the
  global batch on every rank and keeps its (dp, ep) rows, its cursor
  counts samples of the global stream (`data.MicroBatchDataLoader`), so
  at a constant global batch the cursor carries verbatim
  (`translate_dataloader_state` validates and passes it through).
- **ZeRO-1 shard arithmetic**: `split_zero1` / `regather_zero1` /
  `resize_zero1` / `resize_zero1_leaves`, numpy and bitwise.
- **`check_restore_topology`**: tp/cp/ep refused even with
  `checkpoint.elastic`; elastic off refused naming both layouts and the
  `elastic_resize` invocation; a changed global batch refused with the
  overrides that restore it. `check_pp_slots` refuses what the JAX slot
  check refuses (an uneven pp split whose slots differ).

What the JAX package leaves to Orbax (its state is global arrays, which
restore onto any mesh) the port does itself: its state is per-rank files
(`checkpoint.py`): `params.rank<R>.pt` from the ranks at dp 0 and cp 0
(their tp and ep shards of their pipeline stage's layers, named by
global layer index), `opt_state.rank<R>.pt` from every rank under ZeRO-1
(its rows, `optimizer.zero1_rows`, over the data group, or for an MoE
bank over the bank group; under offload also the fp32 master), else
from the ranks at dp 0 and cp 0; a run without a process group writes
`params.pt` / `opt_state.pt`. `FileLayout` says which file holds what;
`read_whole` regathers every (ep, tp) coordinate's tensors whole (the
union of the pp stages, the ZeRO-1 rows concatenated), and
`layout_files` cuts them for another layout: the stages re-bucketed by
`stage_layers` (a tied embedding on the first and the last stage, the
interleaved chunks), the rows re-split by the target's `zero1_rows`,
the params named by the target's global ranks. Only bytes move, so a
N -> M -> N round trip writes the same files. `CheckpointManager.
load_step` reads a rank's share this way when the saved layout differs
(a restore-time resize, or a zero1 or process-group change at the same
axes); `resplit_step` rewrites a verified step's `state/` through
`state.tmp` for `tools/elastic_resize.py`.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.ckpt_integrity import MANIFEST_NAME, fsync_dir

# The axes a checkpoint's source topology is compared on (world_size is
# their product).
TOPOLOGY_AXES = ("dp", "pp", "ep", "cp", "tp")

# The axes a resize can carry a checkpoint across: dp (the constant
# global batch plan and the ZeRO-1 re-split), pp (the stages re-bucketed
# by global layer index) and slices (placement only: no file changes;
# `tools/elastic_resize.py --slices`, the slice-loss recovery).
# tp/cp/ep re-partition the weight math itself and are refused.
SUPPORTED_ELASTIC_AXES = ("dp", "pp", "slices")

RESIZE_TOOL = "python -m picotron_tpu_torch.tools.elastic_resize"


def topology_from_distributed(dist) -> dict:
    """Axis sizes of a DistributedConfig (or its JSON dict) in the
    manifest's topology schema, with the slice count."""
    get = (dist.get if isinstance(dist, dict)
           else lambda k, d=None: getattr(dist, k, d))
    topo = {ax: int(get(f"{ax}_size", 1) or 1) for ax in TOPOLOGY_AXES}
    topo["world_size"] = int(np.prod([topo[ax] for ax in TOPOLOGY_AXES]))
    topo["slices"] = int(get("slices", 1) or 1)
    return topo


def describe_topology(topo: Optional[dict]) -> str:
    """'dp2 pp1 ep1 cp1 tp2', with a 'slicesN' suffix past one slice."""
    if not topo:
        return "unknown"
    s = " ".join(f"{ax}{topo.get(ax, '?')}" for ax in TOPOLOGY_AXES)
    if int(topo.get("slices", 1) or 1) > 1:
        s += f" slices{int(topo['slices'])}"
    return s


def saved_topology(step_dir: str) -> Optional[dict]:
    """The topology a committed step dir was saved under: the manifest's
    `topology`, else meta.json's recorded config, else None."""
    try:
        with open(os.path.join(step_dir, MANIFEST_NAME)) as f:
            topo = json.load(f).get("topology") or {}
        if any(ax in topo for ax in TOPOLOGY_AXES):
            return {k: int(v) for k, v in topo.items()
                    if isinstance(v, (int, float))}
    except (FileNotFoundError, json.JSONDecodeError, ValueError):
        pass
    try:
        with open(os.path.join(step_dir, "meta.json")) as f:
            dist = (json.load(f).get("config") or {}).get("distributed")
        if dist:
            return topology_from_distributed(dist)
    except (FileNotFoundError, json.JSONDecodeError, ValueError):
        pass
    return None


def topology_mismatch(saved: Optional[dict],
                      current: Optional[dict]) -> list[str]:
    """The axes whose size differs ([] when they agree or either side
    recorded nothing); slices compares with a default of 1."""
    if not saved or not current:
        return []
    axes = [ax for ax in TOPOLOGY_AXES
            if saved.get(ax) is not None and current.get(ax) is not None
            and int(saved[ax]) != int(current[ax])]
    if int(saved.get("slices", 1) or 1) != int(current.get("slices", 1) or 1):
        axes.append("slices")
    return axes


def resize_invocation(save_dir: str, step: int, current: dict,
                      axes=("dp",)) -> str:
    """The offline re-stamp that adapts the checkpoint to this run, with
    a flag per mismatched supported axis."""
    flags = " ".join(f"--{ax} {int(current[ax])}"
                     for ax in SUPPORTED_ELASTIC_AXES if ax in axes)
    return f"{RESIZE_TOOL} {save_dir} --step {step} {flags}".rstrip()


# ---------------------------------------------------------------------------
# Resize planning at constant global batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResizePlan:
    """A dp resize that keeps global_batch_size = mbs * ga * dp * ep."""

    dp_old: int
    dp_new: int
    micro_batch_size: int
    gradient_accumulation_steps: int
    global_batch_size: int

    def overrides(self) -> dict:
        return {
            "distributed": {"dp_size": self.dp_new},
            "training": {
                "micro_batch_size": self.micro_batch_size,
                "gradient_accumulation_steps":
                    self.gradient_accumulation_steps,
            },
        }

    def overrides_line(self) -> str:
        return (f"distributed.dp_size={self.dp_new} "
                f"training.micro_batch_size={self.micro_batch_size} "
                f"training.gradient_accumulation_steps="
                f"{self.gradient_accumulation_steps}")


def plan_resize(*, micro_batch_size: int, gradient_accumulation_steps: int,
                dp_size: int, dp_new: int, ep_size: int = 1) -> ResizePlan:
    """Re-factor (mbs, ga) for a new dp at constant global batch: keep mbs
    and scale ga, else keep ga and scale mbs, else all of a replica's
    batch in mbs. ValueError when dp_new * ep cannot divide it."""
    if dp_new < 1:
        raise ValueError(f"dp_new must be >= 1, got {dp_new}")
    gbs = micro_batch_size * gradient_accumulation_steps * dp_size * ep_size
    per_replica = gbs // (dp_new * ep_size)
    if per_replica * dp_new * ep_size != gbs or per_replica < 1:
        raise ValueError(
            f"global batch {gbs} (= mbs {micro_batch_size} x ga "
            f"{gradient_accumulation_steps} x dp {dp_size} x ep {ep_size}) "
            f"cannot be kept constant at dp={dp_new} x ep={ep_size}: "
            f"{gbs} is not divisible by {dp_new * ep_size}. Elastic resize "
            f"holds global batch fixed; pick a dp that divides it")
    if per_replica % micro_batch_size == 0:
        mbs, ga = micro_batch_size, per_replica // micro_batch_size
    elif per_replica % gradient_accumulation_steps == 0:
        mbs = per_replica // gradient_accumulation_steps
        ga = gradient_accumulation_steps
    else:
        mbs, ga = per_replica, 1
    return ResizePlan(dp_old=dp_size, dp_new=dp_new, micro_batch_size=mbs,
                      gradient_accumulation_steps=ga,
                      global_batch_size=gbs)


def saved_global_batch(meta: dict) -> Optional[int]:
    """global_batch_size recorded in a meta.json's config, or None."""
    cfg = meta.get("config") or {}
    tr, dist = cfg.get("training") or {}, cfg.get("distributed") or {}
    try:
        return (int(tr["micro_batch_size"])
                * int(tr["gradient_accumulation_steps"])
                * int(dist.get("dp_size", 1))
                * int(dist.get("ep_size", 1)))
    except (KeyError, TypeError, ValueError):
        return None


def translate_dataloader_state(state: dict, *, gbs_old: int,
                               gbs_new: int) -> dict:
    """Carry a loader's (epoch, cursor) across a resize: verbatim at a
    constant global batch; a cursor that falls mid-batch of the new
    global batch is an error, never a rounding."""
    epoch, cursor = int(state["epoch"]), int(state["cursor"])
    if cursor % gbs_new != 0:
        raise ValueError(
            f"dataloader cursor {cursor} (epoch {epoch}) consumed under "
            f"global batch {gbs_old} does not land on a step boundary of "
            f"global batch {gbs_new}; elastic resize requires constant "
            f"global batch (cursor must be token-exact — no sample "
            f"replayed, none skipped)")
    return {"epoch": epoch, "cursor": cursor}


# ---------------------------------------------------------------------------
# ZeRO-1 shard arithmetic (host-side, bitwise)
# ---------------------------------------------------------------------------


def split_zero1(full: np.ndarray, dim: int, n: int) -> list[np.ndarray]:
    """n equal contiguous shards of `full` along `dim` (shard i owns rows
    [i*L/n, (i+1)*L/n))."""
    if dim >= full.ndim or full.shape[dim] % n != 0:
        raise ValueError(
            f"cannot split shape {full.shape} into {n} shards along dim "
            f"{dim}: {full.shape[dim] if dim < full.ndim else '?'} rows "
            f"not divisible")
    return [np.ascontiguousarray(s) for s in np.split(full, n, axis=dim)]


def regather_zero1(shards: list[np.ndarray], dim: int) -> np.ndarray:
    """The whole leaf from its shards (the inverse of split_zero1)."""
    return np.concatenate(shards, axis=dim)


def resize_zero1(shards: list[np.ndarray], dim: int,
                 n_new: int) -> list[np.ndarray]:
    """Regather, then split into n_new: the same bytes moved."""
    return split_zero1(regather_zero1(shards, dim), dim, n_new)


def resize_zero1_leaves(shard_lists: list, zero1_info: list,
                        n_new_of=None) -> list:
    """resize_zero1 over a leaf list; `zero1_info[i]` is None (the leaf
    carries through) or (dim, axes, sizes); `n_new_of(place)` gives the
    new shard count (default: the same count)."""
    out = []
    for shards, place in zip(shard_lists, zero1_info):
        if place is None:
            out.append(shards)
            continue
        dim, _axes, sizes = place
        n_new = (n_new_of(place) if n_new_of is not None
                 else int(np.prod(sizes)))
        out.append(resize_zero1(shards, dim, n_new))
    return out


# ---------------------------------------------------------------------------
# Restore-time compatibility check
# ---------------------------------------------------------------------------


def check_restore_topology(step_dir: str, meta: dict, cfg,
                           *, step: int, save_dir: str) -> Optional[dict]:
    """None when the saved and current topologies agree (or none was
    recorded); else the resize record {"from", "to", "axes"} when
    `checkpoint.elastic` allows it, and RuntimeError otherwise (an
    unsupported axis, elastic off, or a changed global batch), with the
    JAX package's words."""
    saved = saved_topology(step_dir)
    current = topology_from_distributed(cfg.distributed)
    axes = topology_mismatch(saved, current)
    if not axes:
        return None
    unsupported = [ax for ax in axes if ax not in SUPPORTED_ELASTIC_AXES]
    if unsupported:
        raise RuntimeError(
            f"checkpoint step {step} under {save_dir} was saved at "
            f"topology [{describe_topology(saved)}] but this run's mesh "
            f"is [{describe_topology(current)}] (mismatched axes: "
            f"{', '.join(axes)}); axis "
            f"{'/'.join(unsupported)} is not elastic-resizable "
            f"(supported: {', '.join(SUPPORTED_ELASTIC_AXES)}) — "
            f"checkpoint.elastic cannot reshard across it. Restore on "
            f"the saved {'/'.join(unsupported)} size")
    if not getattr(cfg.checkpoint, "elastic", False):
        raise RuntimeError(
            f"checkpoint step {step} under {save_dir} was saved at "
            f"topology [{describe_topology(saved)}] but this run's mesh "
            f"is [{describe_topology(current)}] (mismatched axes: "
            f"{', '.join(axes)}); refusing to resume silently across a "
            f"topology change. Either restore on the saved topology, "
            f"re-stamp the checkpoint offline with\n"
            f"  {resize_invocation(save_dir, step, current, axes)}\n"
            f"or set checkpoint.elastic=true to reshard at restore time "
            f"(global batch must stay constant)")
    gbs_saved = saved_global_batch(meta)
    gbs_now = cfg.global_batch_size
    if gbs_saved is not None and gbs_saved != gbs_now:
        plan = None
        try:
            tr = meta["config"]["training"]
            plan = plan_resize(
                micro_batch_size=int(tr["micro_batch_size"]),
                gradient_accumulation_steps=int(
                    tr["gradient_accumulation_steps"]),
                dp_size=int(saved.get("dp", 1)),
                dp_new=int(current["dp"]),
                ep_size=int(current.get("ep", 1)))
        except (KeyError, TypeError, ValueError):
            pass
        hint = (f"; to keep it constant at dp={current['dp']}: --override "
                f"{plan.overrides_line()}" if plan is not None else "")
        raise RuntimeError(
            f"elastic restore of step {step} ({describe_topology(saved)} "
            f"-> {describe_topology(current)}) changes global_batch_size "
            f"{gbs_saved} -> {gbs_now}, which breaks the token-exact "
            f"dataloader cursor and the loss-parity guarantee{hint}")
    return {"from": saved, "to": current, "axes": axes}


def pp_slots(num_layers: int, pp: int):
    """(padded size, slots): the JAX package's stacked layer axis (the
    port holds no pad layers; the slots decide what the JAX package can
    resize)."""
    from picotron_tpu_torch.models.llama import pp_layer_placement

    return pp_layer_placement(int(num_layers), int(pp))


def pp_stage_check(num_layers: int, pp: int, interleave: int = 1) -> None:
    """ValueError when `interleave` chunks per stage cannot cut the
    layers at this pp (`stage_layers`' rule)."""
    from picotron_tpu_torch.models.llama import stage_layers

    stage_layers(num_layers, pp, interleave)


def check_pp_slots(meta: dict, cfg) -> None:
    """ValueError when the checkpoint's pp split places its layers in
    other slots than this run's (an uneven split at another pp), as the
    JAX restore's slot-layout check refuses it."""
    src = meta.get("config") or {}
    src_m, src_d = src.get("model") or {}, src.get("distributed") or {}
    if not (src_m.get("num_hidden_layers") and src_d.get("pp_size")):
        return
    if int(src_d["pp_size"]) == cfg.distributed.pp_size:
        return  # the same split (another model is the shape check's)
    src_padded, src_slots = pp_slots(src_m["num_hidden_layers"],
                                     src_d["pp_size"])
    dst_padded, dst_slots = pp_slots(cfg.model.num_hidden_layers,
                                     cfg.distributed.pp_size)
    if src_padded != dst_padded or list(src_slots) != list(dst_slots):
        raise ValueError(
            f"checkpoint was saved with an uneven PP layer split "
            f"(padded stack {src_padded}, pp={src_d['pp_size']}) "
            f"whose layer slots differ from this run's (padded "
            f"stack {dst_padded}, pp={cfg.distributed.pp_size}); resume "
            f"with the same pp_size or use a layer count divisible by both")


# ---------------------------------------------------------------------------
# The port's file surgery: per-rank files regathered and re-split
# ---------------------------------------------------------------------------

PARAMS_FILE = "params.pt"
OPT_FILE = "opt_state.pt"
_TOP = ("embedding", "final_norm", "lm_head")


def rank_file(kind: str, rank: int) -> str:
    return f"{kind}.rank{rank:05d}.pt"


def _bank(name: str) -> bool:
    from picotron_tpu_torch.parallel.sharding import ep_shard_dim

    return ep_shard_dim(name) is not None


def _rows(shape, n: int, r: int) -> Optional[tuple]:
    """`optimizer.zero1_rows` for index r of a group of n."""
    from picotron_tpu_torch.optimizer import zero1_rows

    g = SimpleNamespace(data_size=n, data_rank=r, bank_size=n, bank_rank=r)
    return zero1_rows(tuple(shape), g)


@dataclass(frozen=True)
class FileLayout:
    """Which files of a step's `state/` hold what: the layout's `sizes`
    ({axis: size} over TOPOLOGY_AXES), whether ZeRO-1 splits the
    optimizer state into rows (`zero1`; only under a process group),
    whether the files are per rank (`grouped`: saved under a process
    group, world 1 included) or `params.pt` / `opt_state.pt`, and the
    pipeline's `interleave` (which layers a stage holds)."""

    sizes: tuple  # ((axis, size), ...) in TOPOLOGY_AXES order
    zero1: bool = False
    grouped: bool = False
    interleave: int = 1

    @staticmethod
    def make(sizes: dict, zero1: bool = False, grouped: bool = False,
             interleave: int = 1) -> "FileLayout":
        sz = tuple((ax, int(sizes.get(ax, 1) or 1)) for ax in TOPOLOGY_AXES)
        grouped = bool(grouped or np.prod([s for _, s in sz]) > 1)
        pp = dict(sz)["pp"]
        return FileLayout(sz, bool(zero1) and grouped, grouped,
                          int(interleave or 1) if pp > 1 else 1)

    @staticmethod
    def of_config(cfg, grouped: bool) -> "FileLayout":
        """A run's layout (`grouped`: it runs under a process group)."""
        d = cfg.distributed
        return FileLayout.make(
            {ax: getattr(d, f"{ax}_size") for ax in TOPOLOGY_AXES},
            d.zero1, grouped, cfg.pipeline.interleave)

    @property
    def size(self) -> dict:
        return dict(self.sizes)

    @property
    def world(self) -> int:
        return int(np.prod([s for _, s in self.sizes]))

    def rank(self, dp=0, pp=0, ep=0, cp=0, tp=0) -> int:
        s = self.size
        return int(np.ravel_multi_index(
            (dp, pp, ep, cp, tp), tuple(s[a] for a in TOPOLOGY_AXES)))

    def coords(self, rank: int) -> dict:
        s = self.size
        return dict(zip(TOPOLOGY_AXES, (int(c) for c in np.unravel_index(
            rank, tuple(s[a] for a in TOPOLOGY_AXES)))))

    def params_file(self, rank: int) -> Optional[str]:
        """The params file rank R writes (None: it writes none)."""
        if not self.grouped:
            return PARAMS_FILE
        c = self.coords(rank)
        return rank_file("params", rank) if c["dp"] == c["cp"] == 0 else None

    def opt_file(self, rank: int) -> Optional[str]:
        if not self.grouped:
            return OPT_FILE
        if self.zero1:
            return rank_file("opt_state", rank)
        c = self.coords(rank)
        return (rank_file("opt_state", rank) if c["dp"] == c["cp"] == 0
                else None)

    def group(self, name: str, pp: int, ep: int, tp: int) -> list:
        """The global ranks whose ZeRO-1 rows of `name` (on stage `pp`, at
        ep/tp coordinate (ep, tp)) make the whole tensor, in row order:
        the bank group (dp, cp) for an MoE bank, else the data group
        (dp, ep, cp); [rank at dp 0, cp 0] without ZeRO-1."""
        s = self.size
        if not self.zero1:
            return [self.rank(pp=pp, ep=ep, tp=tp)]
        if _bank(name):
            return [self.rank(d, pp, ep, c, tp) for d in range(s["dp"])
                    for c in range(s["cp"])]
        return [self.rank(d, pp, e, c, tp) for d in range(s["dp"])
                for e in range(s["ep"]) for c in range(s["cp"])]

    def stage_names(self, names: list, pp: int) -> list:
        """The names stage `pp` of this layout holds, of a whole model's
        `names`: its layers (`stage_layers`, by global index), the
        embedding on the first stage (and on the last when tied: no
        lm_head), the final norm and head on the last; in the model's
        order (`order_names`)."""
        from picotron_tpu_torch.models.llama import pipeline_stage

        s = self.size
        n_layers = 1 + max((int(n.split(".")[1]) for n in names
                            if n.startswith("layers.")), default=-1)
        last = pp == s["pp"] - 1
        if s["pp"] == 1:
            layers = set(range(n_layers))
        else:
            layers = set(pipeline_stage(n_layers, s["pp"], pp,
                                        self.interleave).layers)
        tied = "lm_head" not in names
        keep = []
        for n in names:
            if n == "embedding":
                ok = pp == 0 or (last and tied)
            elif n in ("final_norm", "lm_head"):
                ok = last
            else:
                ok = int(n.split(".")[1]) in layers
            if ok:
                keep.append(n)
        return keep


def order_names(names) -> list:
    """A model's parameter order: the embedding, final norm and head,
    then the layers by global index, each layer's tensors in the order
    first met in `names`."""
    leaf_pos: dict = {}
    for n in names:
        if n.startswith("layers."):
            leaf_pos.setdefault(n.split(".", 2)[2], len(leaf_pos))

    def key(n):
        if n in _TOP:
            return (0, _TOP.index(n), 0)
        _, i, leaf = n.split(".", 2)
        return (1, int(i), leaf_pos[leaf])

    return sorted(names, key=key)


def step_layout(state_dir: str, topo: Optional[dict],
                meta: dict) -> FileLayout:
    """The FileLayout a step's `state/` was written in: its sizes from the
    saved topology (else meta's config), whether its files are per rank
    from the names on disk, and zero1 from the manifest's topology (meta's
    config for a step without one); the interleave from meta's config."""
    cfg = meta.get("config") or {}
    dist = cfg.get("distributed") or {}
    topo = topo or topology_from_distributed(dist)
    grouped = any(f.startswith("params.rank") for f in os.listdir(state_dir))
    zero1 = topo.get("zero1", dist.get("zero1", False))
    interleave = (cfg.get("pipeline") or {}).get("interleave", 1)
    return FileLayout.make(topo, zero1, grouped, interleave)


class _Files:
    """mmap-loaded files of one `state/`, each read once."""

    def __init__(self, state_dir: str, load=None):
        self.dir = state_dir
        self._load = load or (lambda p: torch.load(
            p, map_location="cpu", weights_only=True, mmap=True))
        self._cache: dict = {}

    def __call__(self, name: str) -> dict:
        if name not in self._cache:
            path = os.path.join(self.dir, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path}: missing from the checkpoint's layout")
            self._cache[name] = self._load(path)
        return self._cache[name]


def read_whole(state_dir: str, layout: FileLayout, coords=None,
               load=None) -> dict:
    """Every (ep, tp) coordinate's tensors whole, or only those in
    `coords` (a list of (ep, tp)): {(ep, tp): {"params": {name: tensor},
    "opt": {kind: {name: tensor}}, "count", "step"}}, the params the
    union of the pp stages (a tied embedding's first copy), the optimizer
    state its ZeRO-1 rows concatenated in group order. The tensors are
    views of the memory-mapped files (or concatenations of them)."""
    s = layout.size
    files = _Files(state_dir, load)
    coords = coords or [(e, t) for e in range(s["ep"])
                        for t in range(s["tp"])]
    out = {}
    for ep, tp in coords:
        params, home = {}, {}
        for k in range(s["pp"]):
            for n, x in files(layout.params_file(
                    layout.rank(pp=k, ep=ep, tp=tp))).items():
                if n not in params:
                    params[n], home[n] = x, k
        first = files(layout.opt_file(layout.rank(ep=ep, tp=tp)))
        kinds = [k for k, v in first.items() if isinstance(v, dict)]
        opt = {kind: {} for kind in kinds}
        for n, x in params.items():
            group = layout.group(n, home[n], ep, tp)
            whole = _rows(x.shape, len(group), 0) is None
            for kind in kinds:
                parts = [files(layout.opt_file(r))[kind][n]
                         for r in (group[:1] if whole else group)]
                opt[kind][n] = (parts[0] if len(parts) == 1
                                else torch.cat(parts))
        out[(ep, tp)] = {"params": params, "opt": opt,
                         "count": first["count"], "step": first["step"]}
    return out


def rank_share(whole: dict, layout: FileLayout, rank: int) -> tuple:
    """(params, opt_state) that `rank` of `layout` writes (None for a
    file it does not write), cut from `read_whole`'s result: its stage's
    names in the model's order, its ZeRO-1 rows; each tensor its own
    contiguous copy."""
    c = layout.coords(rank) if layout.grouped else dict.fromkeys(
        TOPOLOGY_AXES, 0)
    shard = whole[(c["ep"], c["tp"])]
    names = layout.stage_names(order_names(shard["params"]), c["pp"])
    params = opt = None
    if layout.params_file(rank) is not None:
        params = {n: shard["params"][n].clone() for n in names}
    if layout.opt_file(rank) is not None:
        opt = {}
        for kind, tensors in shard["opt"].items():
            opt[kind] = {}
            for n in names:
                t = tensors[n]
                own = None
                if layout.zero1:
                    group = layout.group(n, c["pp"], c["ep"], c["tp"])
                    r = group.index(rank)
                    own = _rows(t.shape, len(group), r)
                opt[kind][n] = (t if own is None
                                else t[own[0]:own[1]]).clone()
        opt.update(count=shard["count"], step=shard["step"])
    return params, opt


def layout_files(whole: dict, layout: FileLayout) -> dict:
    """{file name: object} of every file `layout` writes."""
    out = {}
    for rank in range(layout.world if layout.grouped else 1):
        params, opt = rank_share(whole, layout, rank)
        if params is not None:
            out[layout.params_file(rank)] = params
        if opt is not None:
            out[layout.opt_file(rank)] = opt
    return out


def _save_file(obj, path: str) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def resplit_step(step_dir: str, src: FileLayout, dst: FileLayout) -> dict:
    """Rewrite `step_dir/state/` from layout `src` to `dst`: every file of
    `dst` written under `state.tmp.<pid>/` and fsynced, then swapped in
    (the old `state/` renamed aside, the new one renamed into place, the
    old one deleted). The caller verified the step before and re-commits
    its manifest after. A failure before the swap removes the tmp dir
    and raises, leaving `state/` as it was. Returns {"read_s", "write_s",
    "files"}."""
    import time

    state = os.path.join(step_dir, "state")
    tmp = os.path.join(step_dir, f"state.tmp.{os.getpid()}")
    old = os.path.join(step_dir, f"state.old.{os.getpid()}")
    t0 = time.perf_counter()
    try:
        files = layout_files(read_whole(state, src), dst)
        t1 = time.perf_counter()
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name, obj in files.items():
            _save_file(obj, os.path.join(tmp, name))
        fsync_dir(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    names = sorted(files)
    del files
    os.replace(state, old)
    os.replace(tmp, state)
    fsync_dir(step_dir)
    shutil.rmtree(old)
    return {"read_s": t1 - t0, "write_s": time.perf_counter() - t1,
            "files": names}
