"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, for ``sm_90a`` (Hopper), under ``build/kernels/`` at the
root of the checkout.  The library's file name carries a digest of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built when a module is imported: the first
call that needs a kernel on a CUDA tensor builds it, and :func:`build`
builds several at once, one nvcc process each, all started together.

There is no fallback: if nvcc is missing or a build fails, the call that
asked for the kernel raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mttkrp", "syrk", "linearized")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's messages for each library built in this process (ptxas prints
# every kernel's registers, shared memory and spills)
BUILD_LOG: dict[str, str] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        if (home / "bin" / "nvcc").exists():
            nvcc = str(home / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            "src/repro_torch/kernels/csrc at first use and need the CUDA "
            "toolkit (put nvcc on PATH or set CUDA_HOME)")
    return nvcc


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> dict[str, Path]:
    """Build every library in ``names`` that is not built yet, one nvcc
    each, all in parallel; raise with nvcc's output if any fails."""
    todo = {n: lib_path(n) for n in names}
    missing = {n: p for n, p in todo.items() if not p.exists()}
    if missing:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, path in missing.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode == 0:
                os.replace(tmp, path)
            else:
                os.unlink(tmp)
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})"
                              f"\n{out}")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it if needed (each
    wrapper loads its library once and keeps it)."""
    lib = ctypes.CDLL(str(build((name,))[name]))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
