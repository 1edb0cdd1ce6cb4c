"""One rank's train step recorded through recording groups — the port's
counterpart of picotron_tpu/analysis/trace.py `lower_train_step`.

The JAX audits lower the composed step on an abstract mesh and read its
collectives off the StableHLO text. Eager PyTorch has no such program:
what a step communicates is the sequence of calls its rank makes. Every
one of them goes through `parallel/comm.py`, which hands a call to the
group object itself when that object is not a process group
(`comm._delegate`). So the port's "lower on an abstract mesh" is: build
a rank's `ParallelEnv` from the rank grid (`mesh.layout_partitions`)
with a `RecordingGroup` in place of every process group, and run one
whole step (forward, backward, grad sync, optimizer) on
`torch.device("meta")` at the config's own widths, depth and sequence
length. No `torch.distributed` is initialised, no process is spawned and
no tensor is materialised; every collective returns a placeholder of
its result's shape and is recorded as a `CollectiveOp`:

- `kind` in the JAX package's `KINDS`: a batch of point-to-point
  transfers (`comm.send_recv`: a cp ring hop, a pipeline tick's
  exchange) is a `collective_permute`;
- `members`: every group of the op's partition that this rank's program
  spans (a tuple of rank tuples; for a permute, the (source, target)
  pairs), with `group_size` and `n_groups`, as the JAX parser recovers
  them from `replica_groups`; `group` is the issuing rank's own group;
- `nbytes`, `shape` and `dtype` of the result (an all-gather's whole
  output, a reduce-scatter's shard), the JAX parser's convention;
- `source`: the issuing `picotron_tpu_torch/<file>:<line>`, the first
  frame of the package outside `parallel/comm.py` (for a collective of
  the backward, the line that started the backward).

Ranks that run the same program issue the same schedule, so
`record_train_step` records one rank per distinct program, the rank at
coordinate 0 of every axis but pp (one per pipeline stage, which under
the mpmd executor holds every virtual stage of that rank), and unions
them (`union_schedule`): every op once, the pp-spanning ones from the
lowest stage that issues them, each transfer from its sender. A
record's `members` keep only the groups inside the issuing program
(the ranks of its stage), so the union of the stages covers every group
once. That dp, tp, cp and ep ranks really issue the same schedule is
not assumed: `program_schedule` normalises a rank's records (the
partition-wide members and pairs do not name the rank), and the tests
record every rank of the dp, tp, cp (ring zigzag and contiguous,
Ulysses, mesh), ep and pp layouts and compare them with their stage's
representative.

The step runs whole on meta, every config at its own size: the flash
attention wrapper, the AdamW update and the fused engine's weight-grad
GEMM take their plain versions for a meta tensor (they launch nothing),
`OffloadAdamW` keeps its host state on meta for a meta model, and
dots_offload's parker copies nothing off a device that is not CUDA.
Nothing on the path needs a value, so no config is recorded on the CPU
in its stead. The raw `torch.distributed` calls outside `comm.py` (the
launch's warm-up all-reduce in `mesh.init_parallel`, the checkpoint's
host agreement, the trainer's host-control flag) lie outside the step
and are not recorded.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "collective_permute",
         "all_to_all")

_DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
                torch.bfloat16: "bf16", torch.float16: "f16",
                torch.int64: "i64", torch.int32: "i32", torch.int16: "i16",
                torch.int8: "i8", torch.uint8: "ui8", torch.bool: "i1"}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NOT_SITES = (os.path.join(_PKG, "parallel", "comm.py"),
              os.path.abspath(__file__))
# a code object's file -> its path in the package ("" outside it, or
# for comm.py and this module); the package may be imported through a
# path with ".." in it (a test's sys.path entry)
_SITE_OF: dict = {}


@dataclass(frozen=True)
class CollectiveOp:
    """One recorded collective (the JAX `CollectiveOp`'s fields, plus the
    issuing rank, its own group, its source line and a permute's half)."""

    kind: str                       # one of KINDS
    group_size: Optional[int]       # participants per group (None: permute)
    n_groups: Optional[int]         # groups (a permute: its pairs)
    nbytes: Optional[int]           # result size
    shape: Optional[tuple]
    dtype: Optional[str]
    line: int                       # 1-based place in its schedule
    members: Optional[tuple] = None  # rank tuples (a permute: pairs)
    source: str = ""                # picotron_tpu_torch/<file>:<line>
    rank: int = 0                   # the issuing rank
    group: tuple = ()               # the issuing rank's own group
    role: str = ""                  # a permute's half: "send" / "recv"
    scope: str = ""                 # the issuing function
    operand: tuple = ()             # (storage, offset, numel) it reads

    @property
    def effective(self) -> bool:
        """Moves bytes between ranks (a group of one moves none)."""
        if self.kind == "collective_permute":
            return (self.n_groups or 0) > 0
        return (self.group_size or 0) > 1

    @property
    def shard_bytes(self) -> int:
        """The bytes the issuing rank hands in or takes out: an
        all-gather's input, every other kind's result."""
        n = self.nbytes or 0
        if self.kind == "all_gather" and self.group_size:
            return n // self.group_size
        return n

    def key(self) -> tuple:
        """What two ranks of one program must agree on."""
        return (self.kind, self.group_size, self.n_groups, self.nbytes,
                self.shape, self.dtype, self.members, self.source,
                self.role)


def _site_file(path: str) -> str:
    if path not in _SITE_OF:
        full = os.path.abspath(path)
        _SITE_OF[path] = (
            os.path.relpath(full, os.path.dirname(_PKG)).replace(os.sep, "/")
            if full.startswith(_PKG + os.sep) and full not in _NOT_SITES
            else "")
    return _SITE_OF[path]


def _site() -> tuple:
    """(file:line, function) of the first frame of the package outside
    comm.py and this module."""
    f = sys._getframe(2)
    while f is not None:
        rel = _site_file(f.f_code.co_filename)
        if rel:
            return f"{rel}:{f.f_lineno}", f.f_code.co_name
        f = f.f_back
    return "<outside picotron_tpu_torch>", "<unknown>"


def operand_key(t: torch.Tensor) -> tuple:
    """(storage, offset, numel): which tensor an op read or wrote, to be
    matched against the state's leaves (`analysis/dataflow.py`)."""
    return (storage_id(t), t.storage_offset(), t.numel())


class RecordingGroup:
    """Stands in for one rank's process group of one role: it knows the
    partition the group belongs to, records each call it is handed
    (`parallel/comm.py`'s hooks) into `log` and leaves the placeholders
    as they are: on meta nothing is computed."""

    def __init__(self, log: list, partition, rank: int, stage_of):
        self.log = log
        self.rank = rank
        self.members = next(tuple(g) for g in partition if rank in g)
        self.size = len(self.members)
        self.index = self.members.index(rank)
        here = stage_of(rank)
        # the groups of this rank's program: every rank of its stage
        self.groups = tuple(tuple(g) for g in partition
                            if any(stage_of(m) == here for m in g))
        # whether the group lies inside the program (not a pp group)
        self._within = all(stage_of(m) == here for m in self.members)

    def _add(self, kind: str, t: torch.Tensor, *, members=None,
             role: str = "", nbytes=None) -> None:
        members = self.groups if members is None else members
        permute = kind == "collective_permute"
        source, scope = _site()
        self.log.append(CollectiveOp(
            kind=kind, group_size=None if permute else self.size,
            n_groups=len(members),
            nbytes=(t.numel() * t.element_size() if nbytes is None
                    else nbytes),
            shape=tuple(t.shape),
            dtype=_DTYPE_NAMES.get(t.dtype, str(t.dtype)),
            line=len(self.log) + 1, members=members, source=source,
            rank=self.rank, group=self.members, role=role, scope=scope,
            operand=operand_key(t)))

    # -- the hooks of parallel/comm.py --------------------------------------

    def all_reduce_into(self, t, op=None) -> None:
        self._add("all_reduce", t)

    def all_gather_into(self, out, inp) -> None:
        self._add("all_gather", out)

    def reduce_scatter_into(self, out, inp) -> None:
        self._add("reduce_scatter", out)

    def all_to_all_into(self, out, inp) -> None:
        self._add("all_to_all", out)

    def send_recv_into(self, sends, recvs) -> None:
        """One batch of transfers: a `collective_permute` of the sends
        and one of the receives, each spelled partition-wide. Inside a
        program (a cp ring) the group's ranks issue the batch together,
        so it is the shift it applies, at every index of every group;
        across programs (a pipeline tick) it is this rank's transfers,
        at its index of every group."""
        for role, items in (("send", sends), ("recv", recvs)):
            if not items:
                continue
            pairs = set()
            for peer, _ in items:
                shift = self.members.index(peer) - self.index
                starts = (range(self.size) if self._within
                          else (self.index,))
                for g in self.groups:
                    for k in starts:
                        a, b = g[k], g[(k + shift) % self.size]
                        pairs.add((a, b) if role == "send" else (b, a))
            self._add("collective_permute", items[0][1],
                      members=tuple(sorted(pairs)), role=role,
                      nbytes=sum(t.numel() * t.element_size()
                                 for _, t in items))


@dataclass
class RecordedStep:
    """What `record_train_step` hands the analyzers."""

    cfg: object
    device: str                     # where the step ran ("meta")
    programs: dict                  # rank -> its recorded [CollectiveOp]
    states: dict                    # rank -> its TrainState after the step
    before: dict                    # rank -> `state_snapshot` before it
    batch: tuple                    # the representative rank's (ids, tgt)
    seconds: float = 0.0            # wall time of the recording
    ops: list = field(default_factory=list)  # `union_schedule(programs)`


def program_ranks(cfg) -> list:
    """One rank per distinct program: coordinate 0 on every axis but pp,
    each pipeline stage."""
    from picotron_tpu_torch.mesh import layout_sizes

    sizes = layout_sizes(cfg)
    stride = sizes["ep"] * sizes["cp"] * sizes["tp"]
    return [s * stride for s in range(sizes["pp"])]


def program_schedule(ops: list) -> list:
    """A rank's records in the form every rank of its program shares."""
    return [op.key() for op in ops]


def union_schedule(cfg, programs: dict) -> list:
    """The layout's schedule: the programs' records, each collective
    once (module docstring), renumbered."""
    from picotron_tpu_torch.mesh import layout_sizes, rank_coords

    sizes = layout_sizes(cfg)
    stage = lambda r: rank_coords(r, sizes)["pp"]  # noqa: E731
    out = []
    for rank in sorted(programs):
        for op in programs[rank]:
            if op.role == "recv":
                continue  # its sender's record carries the transfer
            if (op.kind != "collective_permute"
                    and stage(rank) != min(stage(m) for m in op.group)):
                continue  # a pp-spanning op, kept from its lowest stage
            out.append(op)
    return [CollectiveOp(**{**op.__dict__, "line": i + 1})
            for i, op in enumerate(out)]


def recording_env(cfg, rank: int, log: list, device="meta"):
    """Rank `rank`'s `mesh.ParallelEnv` with a `RecordingGroup` for every
    group the rank belongs to (groups shared between roles stay one
    object, as `mesh.init_parallel` makes them)."""
    from picotron_tpu_torch.mesh import (
        GROUP_ROLES, layout_partitions, layout_sizes, parallel_env,
        rank_coords,
    )

    sizes = layout_sizes(cfg)
    stage_of = lambda r: rank_coords(r, sizes)["pp"]  # noqa: E731
    parts = layout_partitions(cfg)
    made, groups = {}, {}
    for role in GROUP_ROLES:
        part = parts[role]
        if part is None or not any(rank in g for g in part):
            groups[role] = None
            continue
        if id(part) not in made:
            made[id(part)] = RecordingGroup(log, part, rank, stage_of)
        groups[role] = made[id(part)]
    return parallel_env(cfg, rank, torch.device(device), "record", groups)


def state_leaves(state) -> dict:
    """{name: tensor} of a TrainState: every parameter, grad buffer and
    optimizer state tensor (master weights and moments), by the
    checkpoint's names."""
    model, opt = state.model, state.optimizer
    out = {f"params/{n}": p for n, p in model.named_parameters()}
    names = {p: n for n, p in model.named_parameters()}
    for p, buf in opt.grad_of.items():
        out[f"grads/{names.get(p, '?')}"] = buf
    for kind, tensors in opt.state_tensors().items():
        for n, t in tensors.items():
            if isinstance(t, torch.Tensor):
                out[f"{kind}/{n}"] = t
    return out


def storage_id(t: torch.Tensor) -> int:
    """The identity of a tensor's storage (meta tensors have no address:
    their storage objects still differ)."""
    return t.untyped_storage()._cdata


def state_snapshot(state) -> dict:
    """{name: (tensor id, storage id, shape, dtype, device,
    requires_grad)} of every state leaf, for `hazards.py`."""
    return {n: (id(t), storage_id(t), tuple(t.shape), t.dtype,
                str(t.device), t.requires_grad)
            for n, t in state_leaves(state).items()}


def _rank_step(cfg, rank: int):
    """(ops, state, snapshot before, batch) of one rank's step on meta."""
    from picotron_tpu_torch.models.llama import LlamaModel, pipeline_stage
    from picotron_tpu_torch.parallel.cp import cp_context
    from picotron_tpu_torch.parallel.ep import ep_context
    from picotron_tpu_torch.parallel.tp import tp_context
    from picotron_tpu_torch.train_step import init_train_state, make_train_step

    log: list = []
    par = recording_env(cfg, rank, log)
    d, t = cfg.distributed, cfg.training
    stage = (pipeline_stage(cfg.model.num_hidden_layers, d.pp_size,
                            par.pp_rank, cfg.pipeline.interleave)
             if d.pp_size > 1 else None)
    model = LlamaModel(cfg.model, device=par.device,
                       tp=tp_context(par, d.sequence_parallel, cfg),
                       cp=cp_context(par, cfg), stage=stage,
                       ep=ep_context(par, cfg))
    state = init_train_state(cfg, model, par)
    before = state_snapshot(state)
    ids = torch.zeros((t.gradient_accumulation_steps, t.micro_batch_size,
                       t.seq_length // d.cp_size), dtype=torch.int64,
                      device=par.device)
    batch = (ids, ids.clone())
    make_train_step(cfg, par)(state, batch)
    return log, state, before, batch


def record_train_step(cfg, rank: Optional[int] = None) -> RecordedStep:
    """Record one step of `cfg` on meta: the ranks of `program_ranks`
    (or `rank` alone) and their union (module docstring)."""
    cfg.validate()
    t0 = time.perf_counter()
    ranks = program_ranks(cfg) if rank is None else [rank]
    programs, states, before = {}, {}, {}
    batch = None
    for r in ranks:
        programs[r], states[r], before[r], b = _rank_step(cfg, r)
        batch = b if batch is None else batch
    rec = RecordedStep(cfg, "meta", programs, states, before, batch,
                       time.perf_counter() - t0)
    rec.ops = union_schedule(cfg, programs)
    return rec
