"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `.cu` file with a plain C entry point (no PyTorch
headers), compiled by `nvcc` for Hopper (``sm_90a``) into a shared
library under ``build/repro_torch_ext/`` at the repository root and
loaded with ctypes.  The library name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a stale one is never loaded.

Building happens at first use (`load`), or up front for several kernels
at once (`build`, one `nvcc` process per source, all started together).
A failed build raises: nothing falls back to the plain PyTorch versions.
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

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_ext"

SOURCES = {
    "segment_pool": KERNELS_DIR / "segment_pool" / "segment_pool.cu",
    "segment_pool_runs": KERNELS_DIR / "segment_pool" / "runs.cu",
    "edge_mpnn": KERNELS_DIR / "edge_mpnn" / "edge_mpnn.cu",
    "edge_mpnn_runs": KERNELS_DIR / "edge_mpnn" / "edge_mpnn_runs.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "flash_attention.cu",
}
# every header a source may include (carry.cuh, cuda_common.cuh,
# edge_mma.cuh, flash_mma.cuh, pool.cuh)
HEADERS = tuple(sorted(KERNELS_DIR.rglob("*.cuh")))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(KERNELS_DIR))

# dtype codes of cuda_common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}

INT32_MAX = 2 ** 31 - 1  # the kernels take ids and counts as int32

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, PyTorch's notion of the
    toolkit root, or `nvcc` on PATH."""
    from torch.utils import cpp_extension
    for root in (os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA "
                           "toolkit to build the repro_torch kernels")
    return found


def library_path(name: str) -> Path:
    """Where kernel `name` is built: keyed by its source, the headers and
    the flags."""
    digest = hashlib.sha256()
    for path in (SOURCES[name], *HEADERS):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, dict]:
    """Compile every kernel in `names` that is not built yet, one `nvcc`
    per source, all in parallel.  Returns {name: {"seconds", "log"}}
    (the log holds ptxas' register and shared-memory report, kept beside
    the library as `<library>.log` for later calls); raises RuntimeError
    naming the kernel when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    report = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                log = out.with_suffix(".log")
                report[name] = {"seconds": 0.0, "log": log.read_text()
                                if log.exists() else "cached"}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(exit {proc.returncode}):\n{log}")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a reader never sees half a file
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    finally:
        for proc, tmp, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib


def dtype_code(tensor) -> int:
    """The kernels' dtype code of a float tensor; raises TypeError for a
    dtype they do not take."""
    name = str(tensor.dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take {sorted(DTYPE_CODES)}, got {name}")
    return DTYPE_CODES[name]


def check_int32(name: str, **counts: int) -> None:
    """Raise when a count a kernel takes as int32 does not fit one."""
    for what, n in counts.items():
        if n > INT32_MAX:
            raise ValueError(f"{name} kernel: {what} = {n} exceeds int32")


def check_launch(rc: int, name: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error (a
    refused launch never runs, and synchronising would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
