"""Saved activations parked in host memory: the "dots_offload" remat
policy (port of picotron_tpu/models/llama.py:483-501).

"dots_offload" saves what "dots" saves, and every saved activation sits
in pinned host memory between a layer's forward and its backward; the
attention's lse stays on the device, as in the JAX package (tiny
[B, H, S] against the [B, S, H*D] tensors, and libtpu's host-offload
legaliser rejects it there).

The port's "dots" layer (`models/llama.remat_layer`) keeps its saved set
in two kinds of places, and both pass through autograd's saved-tensor
hooks: the flash attention node's `save_for_backward` (q, k, v, out,
lse, the positions and the RoPE tables), and the inputs of its
non-reentrant `torch.utils.checkpoint` segments (x, attn_out,
attn_proj_out, mlp_gate, mlp_up), which the checkpoint stores as saved
tensors too. So "dots_offload" is "dots" run inside
`ActivationParker.layer()`, a saved-tensor hook pair: the same graph and
the same recompute, only where the saved bytes sit between the passes
changes, and the losses and grads equal "dots"' bit for bit.

Pack (forward): each CUDA storage a layer saves is copied once (views of
one storage, such as the kernel's out and the o-projection segment's
input, share the copy) into a pinned host buffer on a side stream that
first waits for the compute stream; `record_stream` keeps the allocator
from reusing the device block before the copy lands. Inside `keep_lse()`
(the attention call) the one rank-3 fp32 tensor saved there, the lse
[B, H, S], stays on the device (q/k/v/out are rank 4, the tables rank 2,
the positions rank 1, the scale rank 0). Tensors already in host memory
(the kernel's scale) stay where they are. Parameters are never saved in
a "dots" layer: its matmuls run inside the segments.

Unpack (backward): the first unpack of a layer's tensor fetches the
whole layer (one H2D per storage on a second side stream into device
memory allocated on the compute stream, one event that stream waits on)
and issues the previous layer's fetch ahead, so its copies run under
this layer's backward. A restored tensor is a view with the saved
tensor's dtype, size, stride and offset over the fetched storage.

Pinned memory is allocated once: a buffer goes back to the pool (by
exact size) when the last saved tensor that reads it is released, and a
later copy into it waits on the event of its last read, so a run at any
gradient accumulation pins one microbatch's saves (pp: those in flight).

On the CPU the placement is a no-op, as in the JAX package: nothing is
pinned or copied and the hooks still classify and count (`counts`).
Which saves are copied is `ActivationParker._copies`; where it says yes
to a host tensor, the copy goes out and back through plain host buffers
with the same bookkeeping, views and pool as on the card (without
streams).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

# saved tensors by placement since the last reset: "parked" in host
# memory (copied, or already there), "kept" on the device (the lse);
# bytes each way and storages copied
counts = {"parked": 0, "kept": 0, "storages": 0, "d2h_bytes": 0,
          "h2d_bytes": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


class _Stored:
    """One storage a layer saved: its host copy, and after the fetch its
    device copy, until the last saved tensor over it is released."""

    __slots__ = ("group", "nbytes", "buf", "event", "dev", "users")

    def __init__(self, group: "_Group", t: torch.Tensor):
        p = group.parker
        self.group, self.dev, self.users = group, None, 0
        # the whole storage, as bytes
        src = torch.empty(0, dtype=torch.uint8, device=t.device).set_(
            t.untyped_storage())
        self.nbytes = src.numel()
        self.buf, last = p._take(self.nbytes)
        counts["storages"] += 1
        counts["d2h_bytes"] += self.nbytes
        if not p.cuda:
            self.event = None
            self.buf.copy_(src)
            return
        p.d2h.wait_stream(torch.cuda.current_stream(p.device))
        if last is not None:
            p.d2h.wait_event(last)
        with torch.cuda.stream(p.d2h):
            self.buf.copy_(src, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(p.d2h)
        src.record_stream(p.d2h)

    def release(self) -> None:
        g = self.group
        self.dev = None
        last = g.event if g.fetched else self.event
        g.parker.pool.setdefault(self.nbytes, []).append((self.buf, last))
        self.buf = None


class _Group:
    """One layer's saved storages within one forward."""

    def __init__(self, parker: "ActivationParker",
                 prev: Optional["_Group"]):
        self.parker, self.prev = parker, prev
        self.stored: dict = {}   # storage data_ptr -> _Stored
        self.alive: list = []    # the device tensors, until the layer ends
        self.fetched, self.event = False, None

    def stored_for(self, t: torch.Tensor) -> _Stored:
        key = t.untyped_storage().data_ptr()
        s = self.stored.get(key)
        if s is None:
            s = self.stored[key] = _Stored(self, t)
            # held so that no later tensor of this layer reuses the
            # address (the key) before the layer ends
            self.alive.append(t)
        s.users += 1
        return s

    def fetch(self) -> None:
        if self.fetched:
            return
        self.fetched = True
        p = self.parker
        items = [s for s in self.stored.values() if s.buf is not None]
        for s in items:
            counts["h2d_bytes"] += s.nbytes
        if not p.cuda:
            for s in items:
                s.dev = s.buf.clone()
            return
        p.h2d.wait_stream(torch.cuda.current_stream(p.device))
        for s in items:
            s.dev = torch.empty(s.nbytes, dtype=torch.uint8, device=p.device)
            p.h2d.wait_event(s.event)
        with torch.cuda.stream(p.h2d):
            for s in items:
                s.dev.copy_(s.buf, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(p.h2d)
        for s in items:
            s.dev.record_stream(p.h2d)


class _Handle:
    """What autograd holds for one parked saved tensor."""

    __slots__ = ("stored", "dtype", "size", "stride", "offset")

    def __init__(self, stored: _Stored, t: torch.Tensor):
        self.stored, self.dtype = stored, t.dtype
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()

    def restore(self) -> torch.Tensor:
        s = self.stored
        g = s.group
        g.fetch()
        if g.prev is not None:
            g.prev.fetch()   # the next layer of the backward, ahead
        if g.parker.cuda:
            torch.cuda.current_stream(g.parker.device).wait_event(g.event)
        return torch.empty(0, dtype=self.dtype, device=s.dev.device).set_(
            s.dev.untyped_storage(), self.offset, self.size, self.stride)

    def __del__(self):
        s = self.stored
        s.users -= 1
        if s.users == 0:
            s.release()


class ActivationParker:
    """Parks one model's saved activations in host memory, layer by layer
    (module docstring). `forward()` brackets one microbatch's pass over
    the layers (a pipeline chunk's), `layer()` one layer, `keep_lse()`
    the attention call."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pool: dict = {}          # nbytes -> [(buffer, last read)]
        self.pinned_bytes = 0
        self._group: Optional[_Group] = None
        self._prev: Optional[_Group] = None
        self._keep = False
        if self.cuda:
            self.d2h = torch.cuda.Stream(self.device)
            self.h2d = torch.cuda.Stream(self.device)

    @contextlib.contextmanager
    def forward(self):
        self._prev = None
        try:
            yield self
        finally:
            self._prev = None

    @contextlib.contextmanager
    def layer(self):
        group = _Group(self, self._prev)
        self._group = group
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield self
        finally:
            self._group = None
            group.alive.clear()
        self._prev = group

    @contextlib.contextmanager
    def keep_lse(self):
        self._keep = True
        try:
            yield self
        finally:
            self._keep = False

    def _pack(self, t: torch.Tensor):
        if self._keep and t.dtype == torch.float32 and t.dim() == 3:
            counts["kept"] += 1
            return t
        counts["parked"] += 1
        if not self._copies(t):
            return t
        return _Handle(self._group.stored_for(t), t)

    @staticmethod
    def _copies(t: torch.Tensor) -> bool:
        """Whether a parked save is copied out: one on the card is, one
        already in host memory (the kernel's scale; every save of a CPU
        run) stays where it is."""
        return t.device.type == "cuda"

    @staticmethod
    def _unpack(h):
        return h if isinstance(h, torch.Tensor) else h.restore()

    def _take(self, n: int):
        free = self.pool.get(n)
        if free:
            return free.pop()
        self.pinned_bytes += n
        # the host pool: in host memory by design
        return torch.empty(  # shardcheck: ok (see above)
            n, dtype=torch.uint8, pin_memory=self.cuda), None


def parker_of(model, device) -> ActivationParker:
    """The model's parker on `device` (one per model: its pinned pool
    lives as long as the model)."""
    p = getattr(model, "_parker", None)
    if p is None or p.device != torch.device(device):
        p = ActivationParker(device)
        model._parker = p
    return p
