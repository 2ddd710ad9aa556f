"""Build and load the port's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` has a plain C interface and is compiled
on first use with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the
root of the checkout, keyed by a hash of the source, the ``csrc/*.cuh``
headers and the flags, then loaded with ``ctypes``. Importing this
module builds nothing: the CPU tests import every module, and a CPU
tensor never reaches a kernel.
The port has no counterpart module in ``repro`` (Pallas compiles in
process).
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
# per kernel: seconds the build took (0.0 when the library was cached on
# disk) and what ptxas reported (registers, shared memory, spills)
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "toolkit is needed to build repro_torch's kernels")


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built if missing.
    Thread-safe (event loops may launch a kernel first at the same time;
    different kernels build in parallel, one lock per name) and safe
    across processes (the library is renamed into place)."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        # the headers a source may include are hashed with it
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"{name}-{digest[:16]}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(src)], capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
            os.replace(tmp, out)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "ptxas": log, "path": str(out)}
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib
