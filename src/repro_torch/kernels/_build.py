"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch/`` at the repository root, keyed on a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, and loaded
with `ctypes`. Nothing is built when a
module is imported: the first launch builds what is missing, and
`build_all` builds every kernel at once, one ``nvcc`` per source, all
started together. A library is written under a temporary name and renamed
into place, so concurrent processes never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("fused_read", "sparse_write", "usage_argmin", "scatter_rows",
           "lsh_hash", "fused_read_candidates", "flash_attention")
# The launchers' code for each row storage dtype (csrc/rows.cuh); the
# attention launcher takes the same codes for f32 and bf16.
ROW_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_sms: dict[int, int] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed on that source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=KERNELS) -> dict:
    """Build every missing library, one nvcc per source in parallel.
    Returns {name: {"path", "seconds", "cached", "ptxas"}}; ``ptxas`` is
    the compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills), kept beside the library so a cached build still has it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = lib_path(name)
        info[name] = {"path": str(path), "cached": path.exists()}
        if not path.exists():
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        path = lib_path(name)
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
    seconds = time.perf_counter() - t0
    for name in names:
        log = lib_path(name).with_suffix(".log")
        info[name]["ptxas"] = log.read_text() if log.exists() else ""
        info[name]["seconds"] = 0.0 if info[name]["cached"] else seconds
    return info


def function(lib: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``fn`` of library ``lib`` with its argument types
    declared and an int (cudaError_t) result; builds the library first if
    it is missing."""
    key = (lib, fn)
    if key not in _fns:
        if lib not in _libs:
            build_all((lib,))
            _libs[lib] = ctypes.CDLL(str(lib_path(lib)))
        f = getattr(_libs[lib], fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[key] = f
    return _fns[key]


def sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device ``dev``, which the sweeps' grid plans size
    their one wave of blocks for."""
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sms[dev.index]


def check(name: str, err: int) -> None:
    """Raise when a launcher returned a nonzero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
