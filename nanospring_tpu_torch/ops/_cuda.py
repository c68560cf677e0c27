"""Build and load the package's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` (all started together), and
the objects are linked into one shared library with a plain C interface,
``_build/libnstpu_kernels.so``, loaded with ctypes. The build runs at first
use, never at import: a machine without ``nvcc`` (the CPU test hosts) can
import every module and runs the kernels' plain PyTorch versions instead.
The library is rebuilt when any source or header is newer than it.

Every exported launcher takes device pointers and the CUDA stream as
``c_void_p``, returns ``cudaGetLastError()`` right after its launch, and
allocates nothing: the Python wrappers in ``ops/`` allocate outputs and
scratch with ``torch.empty`` and raise on a nonzero return.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("sketch.cu", "banded_dp16.cu", "banded_dp32.cu", "bwt_sa.cu")
HEADERS = ("banded_dp_common.cuh",)
_SO_NAME = "libnstpu_kernels.so"
ARCH = "arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (run on a machine with a card, or pass "
                       "device='cpu')")


def _needs_build(so_path: str) -> bool:
    if not os.path.exists(so_path):
        return True
    so_mtime = os.path.getmtime(so_path)
    return any(os.path.getmtime(os.path.join(CSRC, s)) > so_mtime
               for s in SOURCES + HEADERS)


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` for sm_90a into the build dir; returns the .so
    path. Compiles run in parallel (one nvcc per source)."""
    so_path = os.path.join(BUILD_DIR, _SO_NAME)
    if not _needs_build(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    objs = []
    procs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{src}.{tag}.o")
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
               os.path.join(CSRC, src), "-o", obj]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs.append(obj)
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        text = out.decode(errors="replace")
        if verbose or p.returncode != 0:
            print(f"[nstpu] nvcc {src}:\n{text}", flush=True)
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    tmp = f"{so_path}.{tag}"
    subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", tmp] + objs,
                   check=True)
    for o in objs:
        os.unlink(o)
    os.replace(tmp, so_path)
    return so_path


def get_lib() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp = ctypes.c_void_p
            i32 = ctypes.c_int32
            i64 = ctypes.c_int64
            lib.ns_sketch_launch.restype = i32
            lib.ns_sketch_launch.argtypes = [
                vp, vp, vp, vp, i64, i32, i32, i64, vp, vp]
            dp_args = [
                vp, vp, vp, vp,          # d0, qlen, tlen, maxc
                vp, i64, vp, i64,        # tpad + row stride, q + row stride
                vp, vp, vp, vp,          # cost, ops_len, tstart, tend
                vp, i64,                 # trace + row stride
                vp, i64,                 # dirs scratch + rows per pair
                i32, vp]                 # pairs, stream
            lib.ns_banded_dp16_launch.restype = i32
            lib.ns_banded_dp16_launch.argtypes = dp_args + [
                vp, vp]                  # events around the kernel, or null
            lib.ns_banded_dp32_launch.restype = i32
            lib.ns_banded_dp32_launch.argtypes = dp_args
            lib.ns_banded_dp16_row_bytes.restype = i32
            lib.ns_banded_dp16_row_bytes.argtypes = []
            lib.ns_banded_dp32_row_bytes.restype = i32
            lib.ns_banded_dp32_row_bytes.argtypes = []
            lib.ns_bwt_sa_scratch_bytes.restype = i64
            lib.ns_bwt_sa_scratch_bytes.argtypes = [i64]
            lib.ns_bwt_sa_launch.restype = i32
            lib.ns_bwt_sa_launch.argtypes = [
                vp, i64, i32, vp, vp,    # block, n, nck, bwt out, info out
                vp, i64, vp]             # scratch and its bytes, stream
            lib.ns_copy2d.restype = i32
            lib.ns_copy2d.argtypes = [vp, i64, vp, i64, i64, i64, vp]
            lib.ns_cuda_error_string.restype = ctypes.c_char_p
            lib.ns_cuda_error_string.argtypes = [i32]
            _LIB = lib
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        msg = get_lib().ns_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
