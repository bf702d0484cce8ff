"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), which :func:`load` opens with ``ctypes``. Builds happen at first
use, never at import, into ``kernels/build/`` (listed in ``.gitignore``);
the library's file name carries a digest of its sources and flags, so an
edited source is rebuilt and a stale library is never loaded.

:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them together. Each build's compiler output (with ``-Xptxas -v``: registers,
shared memory and spills per kernel) is kept beside its library under the
library's name with ``.log`` (:func:`log_path`), so a log always belongs to
the library it names.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS = ("bitplane_pack", "bitserial_matmul", "conv2d_fused",
           "wkv_chunked", "wkv_chunked_bwd")

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels need the CUDA "
            "toolkit with sm_90a support")
    return found


def _sources(name: str) -> list:
    return [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output of the build of :func:`library_path`."""
    return library_path(name).with_suffix(".log")


def build(names=KERNELS) -> dict:
    """Compile every named kernel that has no current library, in parallel.

    Returns ``{name: seconds}`` for the builds run. Raises with the
    compiler's output if any build fails. Every ``nvcc`` started is waited
    for, also when starting another one fails.
    """
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    try:
        for name in todo:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            with open(log_path(name), "w") as log:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(SRC_DIR / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            started[name] = (proc, tmp, time.perf_counter())
    finally:
        done = {name: (proc.wait(), tmp, time.perf_counter() - t0)
                for name, (proc, tmp, t0) in started.items()}
    failed = []
    for name, (rc, tmp, _) in done.items():
        if rc:
            failed.append(f"--- {name} (nvcc rc {rc}) ---\n"
                          + log_path(name).read_text())
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: seconds for name, (_, _, seconds) in done.items()}


def load(name: str, argtypes: dict) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed.

    ``argtypes`` maps each C entry point to its ctypes argument types; every
    entry point returns an int (a ``cudaError_t``).
    """
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if rc:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
