"""The data pipeline's native token packer (port of picotron_tpu/native).

`BlockPacker` is the C++ streaming packer of `csrc/packer.cpp` (a plain C
ABI loaded with ctypes), built with g++ at first use into the build
directory that `kernels/build.py` uses for every native source (listed in
.gitignore). `PyBlockPacker` is its plain numpy version with the same
contract, which the tests hold it to. `make_packer` returns the C++ one:
a failed build raises, with the compiler's output. The JAX package falls
back to the Python packer quietly there; the port does not, so that a
run that asked for the native packer never runs another one unawares.

Both take token-id arrays of any length with `feed` and return completed
[n, block_size] int32 blocks with `take`; the partial tail carries across
feeds, so document streams pack losslessly across batch boundaries.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from picotron_tpu_torch.kernels import build

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """csrc/packer.cpp's library with its signatures (built on first
    call; raises RuntimeError if the build fails)."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = build.load("packer")
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.packer_new.restype = ctypes.c_void_p
            lib.packer_new.argtypes = [ctypes.c_int64]
            lib.packer_free.argtypes = [ctypes.c_void_p]
            lib.packer_feed.argtypes = [ctypes.c_void_p, i32p,
                                        ctypes.c_int64]
            lib.packer_num_ready.restype = ctypes.c_int64
            lib.packer_num_ready.argtypes = [ctypes.c_void_p]
            lib.packer_carry_len.restype = ctypes.c_int64
            lib.packer_carry_len.argtypes = [ctypes.c_void_p]
            lib.packer_take.restype = ctypes.c_int64
            lib.packer_take.argtypes = [ctypes.c_void_p, i32p,
                                        ctypes.c_int64]
            _lib = lib
        return _lib


class BlockPacker:
    """Streaming fixed-size token-block packer (C++ backed)."""

    def __init__(self, block_size: int):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self._lib = _load()
        self._h = self._lib.packer_new(block_size)

    def feed(self, tokens) -> None:
        arr = np.ascontiguousarray(tokens, dtype=np.int32)
        if arr.size == 0:
            return
        self._lib.packer_feed(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            arr.size)

    @property
    def num_ready(self) -> int:
        return self._lib.packer_num_ready(self._h)

    @property
    def carry_len(self) -> int:
        return self._lib.packer_carry_len(self._h)

    def take(self, max_blocks: Optional[int] = None) -> np.ndarray:
        n = self.num_ready
        if max_blocks is not None:
            n = min(n, max_blocks)
        out = np.empty((n, self.block_size), dtype=np.int32)
        if n:
            got = self._lib.packer_take(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
            if got != n:
                raise RuntimeError(f"packer_take wrote {got} blocks, "
                                   f"expected {n}")
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.packer_free(h)
            self._h = None


class PyBlockPacker:
    """The plain numpy version, with BlockPacker's exact contract."""

    def __init__(self, block_size: int):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self._carry = np.empty((0,), dtype=np.int32)
        self._blocks: list[np.ndarray] = []

    def feed(self, tokens) -> None:
        arr = np.ascontiguousarray(tokens, dtype=np.int32).ravel()
        buf = np.concatenate([self._carry, arr]) if self._carry.size else arr
        n = buf.size // self.block_size
        if n:
            self._blocks.append(
                buf[:n * self.block_size].reshape(n, self.block_size).copy())
        self._carry = buf[n * self.block_size:].copy()

    @property
    def num_ready(self) -> int:
        return sum(b.shape[0] for b in self._blocks)

    @property
    def carry_len(self) -> int:
        return int(self._carry.size)

    def take(self, max_blocks: Optional[int] = None) -> np.ndarray:
        avail = np.concatenate(self._blocks) if self._blocks else np.empty(
            (0, self.block_size), dtype=np.int32)
        n = avail.shape[0] if max_blocks is None else min(avail.shape[0],
                                                          max_blocks)
        out = avail[:n]
        rest = avail[n:]
        self._blocks = [rest] if rest.size else []
        return out


def make_packer(block_size: int) -> BlockPacker:
    """The native packer (built on first use; raises if it cannot be)."""
    return BlockPacker(block_size)
