"""Compile accounting for the port (its counterpart of
picotron_tpu/telemetry/recompile.py).

The JAX package listens to jax.monitoring for every XLA backend compile.
The port has no JIT: the only compiles it runs are the lazy nvcc builds
of its CUDA sources (`kernels/build.py`, at a kernel's first launch in a
process, when no library of the source's hash is on disk). So the port's
`CompileWatch` books exactly those: `kernels/build.py` reports each
build's seconds to its `BUILD_LISTENERS`, and one module-level listener,
registered when this module is imported, routes them to the active
watch. A build that finds its library already on disk compiles nothing
and books nothing. The Telemetry facade drains the watch at every phase boundary:
the drained seconds are booked to the `compile` goodput category and
subtracted from the enclosing phase, as in the JAX package.
"""

from __future__ import annotations

import threading

from picotron_tpu_torch.kernels import build

_active: "CompileWatch | None" = None


def _listener(name: str, secs: float) -> None:
    watch = _active
    if watch is not None:
        watch._record(secs)


build.BUILD_LISTENERS.append(_listener)


class CompileWatch:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count = 0
        self._secs = 0.0
        self.total_count = 0
        self.total_secs = 0.0

    def install(self) -> "CompileWatch":
        global _active
        _active = self
        return self

    def uninstall(self) -> None:
        global _active
        if _active is self:
            _active = None

    def _record(self, secs: float) -> None:
        with self._lock:
            self._count += 1
            self._secs += secs
            self.total_count += 1
            self.total_secs += secs

    def drain(self) -> tuple[int, float]:
        """(builds, seconds) since the previous drain — called at each
        phase boundary so build time lands in the phase it occurred in."""
        with self._lock:
            out = (self._count, self._secs)
            self._count = 0
            self._secs = 0.0
        return out
