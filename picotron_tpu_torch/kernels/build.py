"""Build the port's native sources and load them with ctypes.

Each source under `picotron_tpu_torch/csrc/` has a plain C interface and is
compiled at first use. A CUDA source (`<name>.cu`) is built for Hopper
only:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so <name>.cu

and a host source (`<name>.cpp`, the data pipeline's token packer) with
the system's C++ compiler:

    g++ -O3 -std=c++17 -shared -fPIC -o build/lib<name>-<hash>.so <name>.cpp

into `build/` at the repository root (listed in .gitignore). The library
name carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded. A failed build raises with the compiler's
output; there is no fallback. Nothing is built when this module is
imported. Each compiler run that succeeds reports (source name, seconds)
to every callable in `BUILD_LISTENERS` (telemetry/recompile.py's
CompileWatch books them as compile time); a library found on disk
reports nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# the compiler's output of each build in this process (nvcc's ptxas
# register / shared memory / spill report), by source name
BUILD_LOGS: dict[str, str] = {}
# callables (name, seconds) told of each successful build
BUILD_LISTENERS: list = []


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use and need the CUDA toolkit")


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found on PATH: the port's host-side native sources "
        "(csrc/*.cpp) are built from source at first use")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (nvcc) or csrc/<name>.cpp (g++) into a
    shared library (cached by content)."""
    src = CSRC / f"{name}.cu"
    if not src.exists() and (CSRC / f"{name}.cpp").exists():
        src = CSRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compiler = ([gxx_path(), *GXX_FLAGS] if src.suffix == ".cpp"
                else [nvcc_path(), *NVCC_FLAGS])
    cmd = [*compiler, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed building {src} (exit "
            f"{proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    for listener in list(BUILD_LISTENERS):
        listener(name, secs)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu or .cpp, built on first
    call."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
