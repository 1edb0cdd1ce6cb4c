"""AdamW over fp32 master params (port of picotron_tpu/optimizer.py).

`AdamW` applies the JAX package's optax chain step for step:

    clip_by_global_norm (when grad_clip_norm > 0)
    -> scale_by_adam with fp32 moments (optax.adamw), or
       scale_by_adam_low_moments: fp32 math, both moments stored in bf16
    -> add_decayed_weights on every param (no mask)
    -> scale by -lr, lr evaluated at the step count BEFORE the increment
       (so with warmup the first update uses lr = 0), then p += update.

Every update goes through `adamw_update`, one call per tensor (or per
slice under offload): on CUDA tensors it launches the hand-written kernel
of `csrc/adamw.cu`, one pass that reads p, g and the moments once and
writes p and the moments once (the JAX package left this fusion to XLA);
on CPU tensors it runs `adamw_update_plain`, the same function in plain
torch ops, in the kernel's order of operations. Clipping selects on a
norm the step passes in (optax's `select`), so it costs no host sync; the
divergence guard's `skip` is an `ok` flag the kernel reads on the device,
writing nothing when it is False.

`OffloadAdamW` is `training.optimizer_offload` (port of OffloadAdamState
and offload_adam_update): the fp32 master params and both moments live in
pinned host memory, the model's parameters are the bf16 compute copy, and
each step streams the state through the card slice by slice (docstring
of the class). Both take the same calls (`_AdamWState`): the grad
engines fill their fp32 grad buffers, the train step calls `step`, the
checkpoint reads `state_tensors`, so only `train_step.init_train_state`
chooses between them.

ZeRO-1 (`distributed.zero1`; port of the JAX package's `_zero1_placement`
and `offload_adam_update(..., zero1_info=)`): under a parallel layout
each rank of the data group owns a contiguous 1/dp of dim 0 of every
tensor whose dim 0 divides (`zero1_rows`; a tensor that does not stays
whole on every rank, as `_zero1_placement` leaves it replicated), keeps
the moments (and under offload the fp32 master) of that slice only, runs
`adamw_update` on it, and all-gathers the updated params (offload: the
bf16 compute copy) over the data group. The update is elementwise, so
the placement changes no number. The grads stay whole: the step
all-reduces them over the data group first, as the JAX package does.
The MoE expert banks, already sharded over ep, are not sharded over ep
again: their rows are owned over the bank group (dp, cp), as the JAX
`_zero1_placement` leaves out the axes a tensor is sharded on
(`parallel/api.py:774-795` there).
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
from torch.profiler import record_function

from picotron_tpu_torch.config import TrainingConfig
from picotron_tpu_torch.parallel import comm
from picotron_tpu_torch.parallel.sharding import ep_shard_dim, tp_shard_dim


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end
    return f


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(count, steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / steps))
        return init * ((1.0 - alpha) * decay + alpha)
    return f


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the fp32 L2 norm over every tensor, as a 0-dim
    tensor, in two fused reductions (one norm per tensor by
    `torch._foreach_norm`, then the norm of those norms) and no host
    sync. A NaN or Inf anywhere makes it non-finite."""
    # one fused launch for every tensor's norm; no public spelling
    norms = torch._foreach_norm(  # shardcheck: ok (see above)
        [t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def layout_grad_norm(names, grads, par=None, pp=None) -> torch.Tensor:
    """The global norm of the whole model's grads under a layout (each
    rank holding whole, data-reduced grads): the squares of tp-sharded
    grads summed over tp, those of the MoE banks under ep summed over ep
    (and tp), the replicated ones counted once, and under pipeline
    parallelism (`pp`, the stage's communicator) the squares summed over
    the stages, whose grads are disjoint (the caller leaves out a stage's
    copy of a tensor another stage holds). Without tp, ep and pp it is
    `global_norm`."""
    tp = par is not None and par.tp_size > 1
    ep = par is not None and par.ep_size > 1
    if not tp and not ep and pp is None:
        return global_norm(grads)
    parts = {"rep": [], "tp": [], "ep": []}
    for n, g in zip(names, grads):
        parts["ep" if ep and ep_shard_dim(n) is not None else
              "tp" if tp and tp_shard_dim(n) is not None else "rep"].append(g)

    def sq(ts):
        if not ts:
            return torch.zeros((), device=grads[0].device)
        return torch.stack(torch._foreach_norm(  # shardcheck: ok (as above)
            [t.float() for t in ts])).square().sum()

    total = sq(parts["rep"])
    sharded = sq(parts["tp"])
    if ep:
        banks = comm.all_reduce(sq(parts["ep"]), par.ep_group)
        if tp:
            sharded = sharded + banks
        else:
            total = total + banks
    if tp:
        total = total + comm.all_reduce(sharded, par.tp_group)
    if pp is not None:
        total = pp.all_reduce(total)
    return torch.sqrt(total)


def zero1_rows(shape, par=None, bank: bool = False) -> Optional[tuple]:
    """(first row, end row) of dim 0 that this rank owns under ZeRO-1, or
    None when the tensor stays whole: no layout, or dim 0 not divisible
    by the size of its group (the data group; for an MoE bank, `bank`,
    the bank group), or a slice whose elements are not a multiple of 8
    (so that every slice, fp32 or bf16, starts 16-byte aligned for the
    kernel's vector loads)."""
    if par is None or not shape:
        return None
    n, r = ((par.bank_size, par.bank_rank) if bank
            else (par.data_size, par.data_rank))
    rows = shape[0]
    per = rows // n
    if rows % n or (per * math.prod(shape[1:])) % 8:
        return None
    return r * per, (r + 1) * per


def guard_nonfinite(ok: torch.Tensor, new_tensors, old_tensors) -> None:
    """The divergence guard's 'skip' half: where `ok` (a 0-dim bool: loss
    and grad norm finite) is False, copy each old tensor back over its new
    one in place, discarding a poisoned update."""
    for n, o in zip(new_tensors, old_tensors):
        n.copy_(torch.where(ok, n, o))


def make_lr(t: TrainingConfig) -> Union[float, Callable[[int], float]]:
    """A float, or a function of the optimizer step count (optax's
    schedules: warmup via join_schedules, then cosine/linear/constant)."""
    if t.lr_schedule == "constant" and t.lr_warmup_steps == 0:
        return t.learning_rate
    peak, floor = t.learning_rate, t.learning_rate * t.lr_min_ratio
    decay_steps = max(1, t.total_train_steps - t.lr_warmup_steps)
    if t.lr_schedule == "cosine":
        decay = _cosine(peak, decay_steps, t.lr_min_ratio)
    elif t.lr_schedule == "linear":
        decay = _linear(peak, floor, decay_steps)
    else:
        decay = lambda count: peak  # noqa: E731
    if t.lr_warmup_steps == 0:
        return decay
    warm = _linear(0.0, peak, t.lr_warmup_steps)
    boundary = t.lr_warmup_steps
    return lambda count: (warm(count) if count < boundary
                          else decay(count - boundary))


@dataclass(frozen=True)
class Hyper:
    """One step's host scalars of the update (Python floats, rounded to
    fp32 where they meet a tensor, as PyTorch rounds a Python scalar):
    lr at the count before the increment, bias corrections c1 = 1 - b1^t
    and c2 = 1 - b2^t at the count after it, and the clip norm (0: off)."""
    b1: float
    b2: float
    eps: float
    wd: float
    lr: float
    c1: float
    c2: float
    clip: float


def step_hyper(t: TrainingConfig, lr, count: int) -> Hyper:
    """The Hyper of the update that takes the optimizer from `count` to
    `count + 1` steps; `lr` is `make_lr(t)`."""
    b1, b2 = t.adam_beta1, t.adam_beta2
    # bias corrections in fp32 (optax computes decay ** count there)
    cnt = torch.tensor(float(count + 1), dtype=torch.float32)
    c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** cnt)
    c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** cnt)
    return Hyper(b1=b1, b2=b2, eps=t.adam_eps, wd=t.weight_decay,
                 lr=lr(count) if callable(lr) else lr, c1=c1, c2=c2,
                 clip=t.grad_clip_norm)


# ---------------------------------------------------------------------------
# The update of one tensor: the kernel, and its plain version
# ---------------------------------------------------------------------------

# launches of the kernel since the last reset (plain runs never count),
# under a lock: the stages of a thread world update from several threads
launches = {"adamw": 0}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        launches["adamw"] = 0


_P = ctypes.c_void_p
_F = ctypes.c_float


def _lib():
    from picotron_tpu_torch.kernels.build import load

    lib = load("adamw")
    if not getattr(lib, "_pt_typed", False):
        lib.pt_adamw.argtypes = ([_P] * 5 + [ctypes.c_longlong] + [_P] * 3
                                 + [ctypes.c_int] + [_F] * 10 + [_P])
        lib.pt_adamw.restype = ctypes.c_int
        lib._pt_typed = True
    return lib


def adamw_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                       nu: torch.Tensor, h: Hyper, *,
                       grad_norm: Optional[torch.Tensor] = None,
                       grad_scale: Optional[torch.Tensor] = None,
                       ok: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None) -> None:
    """The kernel's function in plain torch ops, in place: p fp32, g
    fp32, mu/nu fp32 or bf16 (moments computed in fp32 and stored in
    their dtype), all of one shape. `grad_norm` (a 0-dim fp32 tensor)
    turns clipping on at `h.clip`: optax's select, g or (g / gn) * clip.
    `grad_scale` (0-dim fp32) scales g instead, and then the clip is a
    factor on the scale, as offload_adam_update computes it: s * where(gn
    s < clip, 1, clip / (gn s)). `ok` (0-dim bool) False leaves every
    tensor as it was. `out` (bf16, p's shape) takes p's bf16 cast.

    The divisions by c1 and c2 divide by 0-dim tensors on p's device: a
    Python-scalar divisor is a multiplication by its reciprocal on CUDA,
    which would round differently from the kernel's (and optax's)
    division; on the CPU both forms divide."""
    if grad_scale is not None:
        scale = grad_scale
        if grad_norm is not None:
            gns = grad_norm * grad_scale
            clip = torch.tensor(h.clip, dtype=torch.float32,
                                device=gns.device)
            scale = grad_scale * torch.where(gns < h.clip, 1.0,
                                             torch.div(clip, gns))
        g = g.float() * scale
    elif grad_norm is not None:
        g = torch.where(grad_norm < h.clip, g, (g / grad_norm) * h.clip)
    g = g.float()
    m = h.b1 * mu.float() + (1 - h.b1) * g
    v = h.b2 * nu.float() + (1 - h.b2) * (g * g)
    c1 = torch.tensor(h.c1, dtype=torch.float32, device=p.device)
    c2 = torch.tensor(h.c2, dtype=torch.float32, device=p.device)
    upd = (m / c1) / (torch.sqrt(v / c2) + h.eps)
    upd = upd + h.wd * p
    new = p + upd * -h.lr
    cast = None if out is None else new.to(out.dtype)
    if ok is not None:
        guard_nonfinite(ok, (new, m, v), (p, mu, nu))
        if out is not None:
            guard_nonfinite(ok, (cast,), (out,))
    p.copy_(new)
    mu.copy_(m)
    nu.copy_(v)
    if out is not None:
        out.copy_(cast)


def _check_operands(p, g, mu, nu, grad_norm, grad_scale, ok, out,
                    kernel: bool) -> None:
    """Raise on what the update cannot take: another device, dtype or
    shape; for the kernel (`kernel`) also a non-contiguous or not
    16-byte-aligned array."""
    def bad(what):
        raise ValueError(f"adamw: {what}")

    if p.dtype != torch.float32 or g.dtype != torch.float32:
        bad(f"p and g must be fp32, got {p.dtype} and {g.dtype}")
    if mu.dtype != nu.dtype or mu.dtype not in (torch.float32,
                                                torch.bfloat16):
        bad(f"mu and nu must both be fp32 or bf16, got {mu.dtype} and "
            f"{nu.dtype}")
    if out is not None and out.dtype != torch.bfloat16:
        bad(f"out must be bf16, got {out.dtype}")
    arrays = [t for t in (p, g, mu, nu, out) if t is not None]
    for t in arrays:
        if t.device != p.device or t.shape != p.shape:
            bad(f"every array must be {tuple(p.shape)} on {p.device}, got "
                f"{tuple(t.shape)} on {t.device}")
        if kernel and not t.is_contiguous():
            bad("every array must be contiguous")
        if kernel and t.data_ptr() % 16:
            bad("every array must be 16-byte aligned (the kernel's vector "
                "loads)")
    for name, t, dt in (("grad_norm", grad_norm, torch.float32),
                        ("grad_scale", grad_scale, torch.float32),
                        ("ok", ok, torch.bool)):
        if t is not None and (t.device != p.device or t.numel() != 1
                              or t.dtype != dt):
            bad(f"{name} must be one {dt} on {p.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def adamw_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, h: Hyper, *,
                 grad_norm: Optional[torch.Tensor] = None,
                 grad_scale: Optional[torch.Tensor] = None,
                 ok: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> None:
    """One AdamW update in place (arguments as `adamw_update_plain`). CPU
    tensors run the plain version (meta ones too: the shapes-only step of
    `analysis/trace.py`); CUDA tensors launch the kernel on the current
    stream, or raise (no fallback)."""
    if p.device.type in ("cpu", "meta"):
        _check_operands(p, g, mu, nu, grad_norm, grad_scale, ok, out,
                        kernel=False)
        adamw_update_plain(p, g, mu, nu, h, grad_norm=grad_norm,
                           grad_scale=grad_scale, ok=ok, out=out)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adamw: no kernel for {p.device}")
    _check_operands(p, g, mu, nu, grad_norm, grad_scale, ok, out,
                    kernel=True)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _lib().pt_adamw(
        ptr(p), ptr(g), ptr(mu), ptr(nu), ptr(out), p.numel(),
        ptr(grad_norm), ptr(grad_scale), ptr(ok),
        int(mu.dtype == torch.bfloat16), h.b1, 1 - h.b1, h.b2, 1 - h.b2,
        h.eps, h.wd, -h.lr, h.c1, h.c2, h.clip,
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adamw: CUDA launch failed with cudaError {rc}")
    with _COUNT_LOCK:
        launches["adamw"] += 1


# ---------------------------------------------------------------------------
# The optimizer state: one interface, two placements
# ---------------------------------------------------------------------------


def param_grads(params) -> dict:
    """{param: its fp32 .grad}, made as zeros where missing: the grad
    accumulators of fp32 params (autograd adds into an existing .grad in
    place)."""
    out = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        out[p] = p.grad
    return out


class _AdamWState:
    """What both placements share. `names` and `params` are the model's
    named parameters; `grads` (and `grad_of`, {param: buffer}) the fp32
    buffers the grad engines zero and fill with the microbatches' summed
    grads, NOT divided by the token count: `step` takes `grad_scale` (1 /
    count) into the update, as the JAX package's `_finish_grads` and
    offload_adam_update do; `count` the steps taken (optax's state.count;
    the host scalars lr, c1 and c2 are functions of it). `state_tensors()`
    is the checkpoint's view, {kind: {name: tensor}}; `install(params)`
    writes fp32 params ({name: tensor}, e.g. an HF import) into the state
    (the JAX package's `install_params`); `synchronize()` waits until the
    state's tensors are final; `grad_norm()` is the buffers' global norm
    over the whole model (`layout_grad_norm`). `par` is the rank's
    `mesh.ParallelEnv` (None: one device); with `zero1`, `own[i]` is
    the (first, end) rows of tensor i that this rank updates (None:
    all of it; an MoE bank's, `banks[i]`, over the bank group), and its
    state tensors hold those rows only. `pp`: a
    pipeline stage's communicator (`comm.PPComm`, or a thread world's),
    over which the grad norm sums; a stage's copy of a tensor that an
    earlier stage holds (the last stage's tied embedding) is left out
    of the norm."""

    def __init__(self, model: torch.nn.Module, t: TrainingConfig,
                 par=None, zero1: bool = False, pp=None):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.t = t
        self.par = par
        self.pp = pp
        stage = getattr(model, "stage", None)
        copy = (stage is not None and stage.last and not stage.first
                and model.cfg.tie_word_embeddings)
        self._in_norm = [i for i, n in enumerate(self.names)
                         if not (copy and n == "embedding")]
        self.banks = [ep_shard_dim(n) is not None for n in self.names]
        self.own = [zero1_rows(tuple(p.shape), par if zero1 else None, b)
                    for p, b in zip(self.params, self.banks)]
        self.lr = make_lr(t)
        self.moments_dtype = (torch.bfloat16
                              if t.adam_moments_dtype == "bfloat16"
                              else torch.float32)
        self.count = 0

    def synchronize(self) -> None:
        pass

    def grad_norm(self) -> torch.Tensor:
        return layout_grad_norm([self.names[i] for i in self._in_norm],
                                [self.grads[i] for i in self._in_norm],
                                self.par, self.pp)

    def owned_shape(self, i: int) -> tuple:
        shape = tuple(self.params[i].shape)
        own = self.own[i]
        return shape if own is None else (own[1] - own[0],) + shape[1:]

    def rows(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole tensor of param i (all of them
        unless ZeRO-1 shards it)."""
        own = self.own[i]
        return t if own is None else t[own[0]:own[1]]

    def _gather_params(self) -> None:
        """ZeRO-1: every rank's updated rows into every rank's params."""
        for i, own in enumerate(self.own):
            if own is not None:
                p = self.params[i].data
                # one gather per tensor: bucketing waits for a multi-card
                # machine to measure it on (ROADMAP, "a multi-card run")
                comm.all_gather_into(p, p[own[0]:own[1]],  # shardcheck: ok
                                     self.par.bank_group if self.banks[i]
                                     else self.par.data_group)

    @torch.no_grad()
    def step(self, grad_scale: torch.Tensor,
             grad_norm: Optional[torch.Tensor] = None,
             ok: Optional[torch.Tensor] = None) -> None:
        """One update from the grad buffers, one `adamw_update` per tensor
        or slice. `grad_scale`: a 0-dim fp32 tensor on the params' device
        (1 / token count). `grad_norm`: the buffers' global norm, unscaled,
        when the caller has it (else computed here when clipping needs
        it). `ok`: a 0-dim bool; when given and False, params, moments and
        the count keep their old values (the guard's skip policy; reading
        `ok` for the count syncs the host once)."""
        name = f"Optimizer.step#{type(self).__name__}.step"
        with record_function(name):
            clip_norm = None
            if self.t.grad_clip_norm > 0:
                clip_norm = (grad_norm if grad_norm is not None
                             else self.grad_norm())
            self._update(step_hyper(self.t, self.lr, self.count), clip_norm,
                         grad_scale, ok)
        # a recorded step on meta (analysis/trace.py) has no flag to read
        if ok is None or ok.is_meta or bool(ok):
            self.count += 1


class AdamW(_AdamWState):
    """The optax chain above over the model's fp32 params, its moments
    beside them on the params' device (this rank's rows under ZeRO-1).
    The grad buffers are the params' .grad, made here."""

    def __init__(self, model: torch.nn.Module, t: TrainingConfig,
                 par=None, zero1: bool = False, pp=None):
        super().__init__(model, t, par, zero1, pp)
        dev = self.params[0].device
        self.mu = [torch.zeros(self.owned_shape(i), dtype=self.moments_dtype,
                               device=dev) for i in range(len(self.params))]
        self.nu = [torch.zeros_like(m) for m in self.mu]
        self.grad_of = param_grads(self.params)
        self.grads = list(self.grad_of.values())
        self._index = {p: i for i, p in enumerate(self.params)}

    def moments(self, p: torch.Tensor) -> dict:
        """p's AdamW state {"mu", "nu"} in the moments dtype."""
        i = self._index[p]
        return {"mu": self.mu[i], "nu": self.nu[i]}

    def state_tensors(self) -> dict:
        return {"mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def install(self, params: dict) -> None:
        with torch.no_grad():
            for n, p in zip(self.names, self.params):
                p.copy_(params[n])

    def _update(self, h: Hyper, clip_norm, grad_scale, ok) -> None:
        for i, (p, g, mu, nu) in enumerate(zip(self.params, self.grads,
                                               self.mu, self.nu)):
            adamw_update(self.rows(i, p), self.rows(i, g), mu, nu, h,
                         grad_norm=clip_norm, grad_scale=grad_scale, ok=ok)
        self._gather_params()


# ---------------------------------------------------------------------------
# Host-offloaded AdamW
# ---------------------------------------------------------------------------

# fp32-master bytes per row group of a tensor with a big axis 0 (the
# embedding and the head), and the least a group may hold: the JAX
# package's _OFFLOAD_ROW_GROUP_BYTES and _OFFLOAD_MIN_SLICE_BYTES
ROW_GROUP_BYTES = 32 * 2 ** 20
MIN_SLICE_BYTES = 4 * 2 ** 20


def row_group(shape) -> int:
    """Rows per streamed group of an fp32 master of `shape` (0: stream it
    whole): a divisor of axis 0 whose group stays near ROW_GROUP_BYTES,
    searched below the target first, then up to 4x above it (port of
    offload_adam_update's `row_group`). Only tensors whose axis 0 is a
    vocab-sized dim (> 1024 rows) are grouped."""
    if len(shape) < 2 or shape[0] <= 1024:
        return 0
    row_bytes = 4 * math.prod(shape[1:])
    target = max(1, ROW_GROUP_BYTES // max(row_bytes, 1))
    gsz = min(target, shape[0])
    while gsz > 1 and shape[0] % gsz:
        gsz -= 1
    if gsz > 1 and gsz * row_bytes >= MIN_SLICE_BYTES and gsz < shape[0]:
        return gsz
    for cand in range(target + 1, min(4 * target, shape[0] - 1) + 1):
        if shape[0] % cand == 0:
            return cand
    return 0


def offload_host_bytes(shapes, moments_dtype: torch.dtype) -> int:
    """Bytes of the pinned host state: the fp32 master and both moments."""
    n = sum(math.prod(s) for s in shapes)
    return n * (4 + 2 * torch.empty((), dtype=moments_dtype).element_size())


def host_available_bytes() -> Optional[int]:
    """Host memory a new allocation can take: /proc/meminfo's
    MemAvailable, lowered to the cgroup's memory.max headroom where one is
    set. None when neither can be read."""
    avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read().strip())
        if limit != "max":
            room = int(limit) - used
            avail = room if avail is None else min(avail, room)
    except (OSError, ValueError):
        pass
    return avail


def check_host_room(nbytes: int) -> None:
    """Raise before pinning `nbytes` (with 10% slack) of host memory that
    the host does not have: pinned pages cannot be swapped, so a short
    host fails the run mid-allocation, or another process."""
    avail = host_available_bytes()
    need = int(nbytes * 1.1)
    if avail is not None and avail < need:
        raise RuntimeError(
            f"optimizer_offload: the pinned host state (fp32 master + "
            f"both AdamW moments) needs {nbytes / 2 ** 30:.2f} GiB "
            f"(+10% slack = {need / 2 ** 30:.2f} GiB) but the host has "
            f"{avail / 2 ** 30:.2f} GiB available; free host memory, use "
            f"adam_moments_dtype 'bfloat16', or turn "
            f"training.optimizer_offload off")


def _flat_views(shapes, dtype: torch.dtype, pin: bool, device="cpu"):
    """One zeroed host buffer (pinned when `pin`) carved into a tensor per
    shape, each starting 16-byte aligned (the kernel's vector loads).
    `device` "meta" stands it in without memory (a meta model's state)."""
    align = 16 // torch.empty((), dtype=dtype).element_size()
    sizes = [math.prod(s) for s in shapes]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // align) * align
    flat = torch.zeros(total, dtype=dtype, pin_memory=pin, device=device)
    return [flat[o:o + n].view(s) for o, n, s in zip(offsets, sizes, shapes)]


class OffloadAdamW(_AdamWState):
    """AdamW with its state in host memory (training.optimizer_offload;
    port of picotron_tpu/optimizer.py OffloadAdamState and
    offload_adam_update).

    State: `master` (fp32), `mu` and `nu` (the moments dtype), one host
    tensor per parameter, carved from three flat buffers that are pinned
    when the model is on CUDA; the grad buffers are fp32 tensors on the
    device. The model's parameters become the bf16 compute copy (torch
    refuses an fp32 .grad on them, so a post-accumulate-grad hook on each
    moves every backward's bf16 grad into its buffer and drops p.grad).

    The update streams the state through the card: each tensor whole, the
    embedding and head in row groups near 32 MB (`row_group`). Per slice,
    an H2D copy of master, mu and nu into one of two staging buffers on
    one stream, the AdamW kernel on the compute stream (writing the bf16
    compute copy straight into the parameter), and the D2H copy back on a
    third stream; CUDA events order the reuse of each staging buffer, so
    the copies of the next and the last slice overlap the kernel, and
    time the last step (`timings`). On the CPU the same slices run the
    same math in place, without placement (the JAX package's
    `transfer=False`). Under ZeRO-1 the host state holds this rank's
    rows only (`own`), and the update all-gathers the compute copy."""

    def __init__(self, model: torch.nn.Module, t: TrainingConfig,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pin: Optional[bool] = None, par=None, zero1: bool = False,
                 pp=None):
        super().__init__(model, t, par, zero1, pp)
        dev = self.params[0].device
        pin = dev.type == "cuda" if pin is None else pin
        if pin and not torch.cuda.is_available():
            raise RuntimeError("optimizer_offload: pinned host memory needs "
                               "CUDA; run on the CPU without pinning")
        shapes = [self.owned_shape(i) for i in range(len(self.params))]
        self.host_bytes = offload_host_bytes(shapes, self.moments_dtype)
        if pin:
            check_host_room(self.host_bytes)
        host = "meta" if dev.type == "meta" else "cpu"
        self.master = _flat_views(shapes, torch.float32, pin, host)
        self.mu = _flat_views(shapes, self.moments_dtype, pin, host)
        self.nu = _flat_views(shapes, self.moments_dtype, pin, host)
        with torch.no_grad():
            for i, (m, p) in enumerate(zip(self.master, self.params)):
                m.copy_(self.rows(i, p))
            for p in self.params:
                p.data = p.data.to(compute_dtype)
        self.grads = [torch.zeros_like(p, dtype=torch.float32)
                      for p in self.params]
        self.grad_of = dict(zip(self.params, self.grads))
        for p, buf in self.grad_of.items():
            p.register_post_accumulate_grad_hook(_into(buf))
        self.slices = []  # (tensor index, first row, end row) of its rows
        for i, (name, s) in enumerate(zip(self.names, shapes)):
            # one tensor of a layer at a time (a slice of the JAX layer
            # stack); the embedding and head in row groups
            grp = 0 if name.startswith("layers.") else row_group(s)
            step = grp or s[0]
            self.slices += [(i, lo, min(lo + step, s[0]))
                            for lo in range(0, s[0], step)]
        self._cuda = None  # streams, events and staging buffers
        self._events = None  # the last streamed step's timing events

    def state_tensors(self) -> dict:
        return {kind: dict(zip(self.names, ts)) for kind, ts in (
            ("master", self.master), ("mu", self.mu), ("nu", self.nu))}

    def install(self, params: dict) -> None:
        """Fill the master (fp32) and the compute copy (its cast)."""
        with torch.no_grad():
            for i, (n, m, p) in enumerate(zip(self.names, self.master,
                                              self.params)):
                m.copy_(self.rows(i, params[n]))
                p.copy_(params[n])

    def synchronize(self) -> None:
        """Wait for the last step's D2H copies: the host state is then
        final (a checkpoint snapshot reads it)."""
        if self._cuda is not None:
            self._cuda["d2h"].synchronize()

    def _update(self, h: Hyper, clip_norm, grad_scale, ok) -> None:
        if self.params[0].is_cuda:
            self._stream(h, clip_norm, grad_scale, ok)
            return
        for i, lo, hi in self.slices:
            r0 = 0 if self.own[i] is None else self.own[i][0]
            adamw_update(self.master[i][lo:hi],
                         self.grads[i][r0 + lo:r0 + hi],
                         self.mu[i][lo:hi], self.nu[i][lo:hi], h,
                         grad_norm=clip_norm, grad_scale=grad_scale, ok=ok,
                         out=self.params[i].data[r0 + lo:r0 + hi])
        self._gather_params()

    def _staging(self, dev):
        if self._cuda is None:
            most = max(self.master[i][lo:hi].numel()
                       for i, lo, hi in self.slices)
            bufs = [(torch.empty(most, dtype=torch.float32, device=dev),
                     torch.empty(most, dtype=self.moments_dtype, device=dev),
                     torch.empty(most, dtype=self.moments_dtype, device=dev))
                    for _ in range(2)]
            freed = [torch.cuda.Event() for _ in range(2)]
            for e in freed:
                e.record()
            self._cuda = {
                "h2d": torch.cuda.Stream(dev), "d2h": torch.cuda.Stream(dev),
                "bufs": bufs, "freed": freed,
                "loaded": [torch.cuda.Event() for _ in range(2)],
                "done": [torch.cuda.Event() for _ in range(2)]}
        return self._cuda

    def timings(self) -> dict:
        """Milliseconds of the last streamed step: `update_ms` on the
        compute stream (the step's share), `h2d_ms` and `d2h_ms` from the
        first copy's start to the last copy's end on each copy stream."""
        ev = self._events
        ev["end"].synchronize()
        return {"update_ms": ev["start"].elapsed_time(ev["end"]),
                "h2d_ms": ev["h2d_start"].elapsed_time(ev["h2d_end"]),
                "d2h_ms": ev["d2h_start"].elapsed_time(ev["d2h_end"])}

    def _stream(self, h: Hyper, clip_norm, grad_scale, ok) -> None:
        dev = self.params[0].device
        st = self._staging(dev)
        h2d, d2h = st["h2d"], st["d2h"]
        compute = torch.cuda.current_stream(dev)
        ev = {k: torch.cuda.Event(enable_timing=True) for k in (
            "start", "end", "h2d_start", "h2d_end", "d2h_start", "d2h_end")}
        ev["start"].record(compute)
        last = len(self.slices) - 1
        for k, (i, lo, hi) in enumerate(self.slices):
            b = k % 2
            host = [t[i][lo:hi] for t in (self.master, self.mu, self.nu)]
            n = host[0].numel()
            stage = [buf[:n].view(host[0].shape) for buf in st["bufs"][b]]
            with record_function("offload.h2d"), torch.cuda.stream(h2d):
                h2d.wait_event(st["freed"][b])
                if k == 0:
                    ev["h2d_start"].record(h2d)
                for s, t in zip(stage, host):
                    s.copy_(t, non_blocking=True)
                st["loaded"][b].record(h2d)
                if k == last:
                    ev["h2d_end"].record(h2d)
            with record_function("offload.adamw"):
                compute.wait_event(st["loaded"][b])
                r0 = 0 if self.own[i] is None else self.own[i][0]
                adamw_update(stage[0], self.grads[i][r0 + lo:r0 + hi],
                             stage[1], stage[2], h, grad_norm=clip_norm,
                             grad_scale=grad_scale, ok=ok,
                             out=self.params[i].data[r0 + lo:r0 + hi])
                st["done"][b].record(compute)
            with record_function("offload.d2h"), torch.cuda.stream(d2h):
                d2h.wait_event(st["done"][b])
                if k == 0:
                    ev["d2h_start"].record(d2h)
                for t, s in zip(host, stage):
                    t.copy_(s, non_blocking=True)
                st["freed"][b].record(d2h)
        ev["d2h_end"].record(d2h)
        self._gather_params()
        compute.wait_stream(d2h)
        ev["end"].record(compute)
        self._events = ev


def _into(buf: torch.Tensor):
    """A post-accumulate-grad hook adding the param's grad into `buf`."""
    def hook(p: torch.Tensor) -> None:
        buf.add_(p.grad)
        p.grad = None
    return hook
