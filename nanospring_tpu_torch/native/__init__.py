"""Native (C++) components, built on demand with g++ and loaded via ctypes.

The reference vendors minimap2/libbsc/fast-lzma2 as C/C++ (SURVEY.md §2.3);
our native layer is from-scratch C++ for the same host-side roles. Build is
a single g++ invocation (no cmake needed for one TU); the .so is cached in
the package's build directory (``nanospring_tpu_torch/_build/``, listed in
``.gitignore``) under its own name, so this library and the JAX package's
``libnstpu.so`` — each with its own device-hook state — can both be loaded
in one process. It is rebuilt when any source is newer.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_SOURCES = ["align.cpp", "codec.cpp", "fastq.cpp", "replay.cpp",
            "minimizers.cpp", "hot.cpp", "polish.cpp", "join.cpp",
            "anchors.cpp", "engine.cpp", "sketch.cpp"]
_SO_NAME = "libnstpu_torch.so"


def _needs_build(so_path: str) -> bool:
    if not os.path.exists(so_path):
        return True
    so_mtime = os.path.getmtime(so_path)
    return any(
        os.path.getmtime(os.path.join(_DIR, s)) > so_mtime for s in _SOURCES
    )


def build(verbose: bool = False) -> str:
    # NSTPU_ASAN=1 builds the native stage with AddressSanitizer (the
    # reference's Debug config, CMakeLists.txt:180-183); load with
    # LD_PRELOAD=$(g++ -print-file-name=libasan.so) python ...
    asan = os.environ.get("NSTPU_ASAN") == "1"
    so_path = os.path.join(BUILD_DIR,
                           "libnstpu_torch_asan.so" if asan else _SO_NAME)
    if not _needs_build(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # concurrent first uses (test workers, grow workers): one process
    # builds, the others wait for its lock and then find the library built
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _needs_build(so_path):
            # build under a per-process name and rename: a process that
            # loads without the lock never sees a half-written library
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = [
                "g++", "-O3", "-march=native", "-std=c++17", "-shared",
                "-fPIC", "-fopenmp", "-o", tmp,
            ] + (["-fsanitize=address", "-fno-omit-frame-pointer", "-g"]
                 if asan else []) + [os.path.join(_DIR, s) for s in _SOURCES]
            if verbose:
                print("[nstpu] building native lib:", " ".join(cmd))
            subprocess.run(cmd, check=True, capture_output=not verbose)
            os.replace(tmp, so_path)
    return so_path


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            i64 = ctypes.c_int64
            i32 = ctypes.c_int32
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.ns_banded_align.restype = i32
            lib.ns_banded_align.argtypes = [
                u8p, i64, u8p, i64, i64, i32, i32,
                u8p, i64, i64p, i64p, i64p,
            ]
            lib.ns_banded_align_batch.restype = None
            lib.ns_banded_align_batch.argtypes = [
                u8p, i64p, i64p, u8p, i64p, i64p, i64p, i32, i32, i64,
                u8p, i64p, i64, i64p, i64p, i64p, i32p,
            ]
            lib.ns_bsc_compress.restype = i64
            lib.ns_bsc_compress.argtypes = [u8p, i64, u8p]
            lib.ns_bsc_decompress.restype = i64
            lib.ns_bsc_decompress.argtypes = [u8p, i64, u8p]
            lib.ns_bsc_set_sort_hook.restype = None
            lib.ns_bsc_set_sort_hook.argtypes = [ctypes.c_void_p]
            lib.ns_bsc_take_sort_bytes.restype = None
            lib.ns_bsc_take_sort_bytes.argtypes = [i64p, i64p]
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.ns_bwt_forward_host.restype = ctypes.c_uint32
            lib.ns_bwt_forward_host.argtypes = [u8p, i64, u8p, i32, u32p]
            lib.ns_lzp_encode.restype = i64
            lib.ns_lzp_encode.argtypes = [u8p, i64, u8p]
            lib.ns_lz_compress.restype = i64
            lib.ns_lz_compress.argtypes = [u8p, i64, u8p]
            lib.ns_lz_decompress.restype = i64
            lib.ns_lz_decompress.argtypes = [u8p, i64, u8p]
            lib.ns_o1_compress.restype = i64
            lib.ns_o1_compress.argtypes = [u8p, i64, u8p]
            lib.ns_o1_decompress.restype = i64
            lib.ns_o1_decompress.argtypes = [u8p, i64, u8p]
            lib.ns_fastq_scan.restype = i32
            lib.ns_fastq_scan.argtypes = [u8p, i64, i64p, i64p, i64p]
            lib.ns_fastq_pack.restype = None
            lib.ns_fastq_pack.argtypes = [u8p, i64, u8p, i64p, i64p, i64p, u8p]
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.ns_minimizers.restype = i64
            lib.ns_minimizers.argtypes = [
                u8p, i64, i32, i32, u64p, i64p, u8p,
            ]
            lib.ns_minimizers_all.restype = None
            lib.ns_minimizers_all.argtypes = [
                u8p, i64p, i64p, i64, i32, i32, i32,
                i64p, u64p, i64p, u8p,
            ]
            lib.ns_engine_set_premz.restype = None
            lib.ns_engine_set_premz.argtypes = [i64p, u64p, i64p, u8p]
            lib.ns_gather_reads.restype = None
            lib.ns_gather_reads.argtypes = [
                u8p, u8p, i64p, u8p, i64p, i64, u8p,
            ]
            lib.ns_replay_members.restype = None
            lib.ns_replay_members.argtypes = [
                u8p, i64p, i64p, i64p, i64p, i64p, i64p,
                i64p, i64p, i64p, u8p, i64p, u8p, u8p, i64,
                i64p, i64p, u8p,
            ]
            lib.ns_unpack_batch.restype = None
            lib.ns_unpack_batch.argtypes = [
                u8p, i64p, i64p, i64p, i64, i64, ctypes.c_uint8, u8p,
            ]
            lib.ns_gather_packed.restype = None
            lib.ns_gather_packed.argtypes = [
                u8p, i64p, i64p, i64p, i64, i64, u8p,
            ]
            lib.ns_repetitive_screen.restype = None
            lib.ns_repetitive_screen.argtypes = [
                u8p, i64p, i64p, i64, i32, i32, u8p,
            ]
            lib.ns_edit_counts.restype = None
            lib.ns_edit_counts.argtypes = [
                u8p, i64p, i64p, i64, i64p, i64p, i64p, i64p,
            ]
            lib.ns_edit_fill.restype = None
            lib.ns_edit_fill.argtypes = [
                u8p, i64p, i64p, u8p, i64p, i64p, i64p, i64p, i64p, i64,
                i64p, u8p, u8p,
            ]
            lib.ns_unpack_oriented.restype = None
            lib.ns_unpack_oriented.argtypes = [
                u8p, i64p, i64p, i64p, u8p, i64, i64p, u8p,
            ]
            lib.ns_polish_batch.restype = ctypes.c_void_p
            lib.ns_polish_batch.argtypes = [
                u8p, i64p, i64p, i64,
                u8p, i64p, i64p, i64p, i64p, i64p,
                u8p, i64p, i64p, i64p,
            ]
            lib.ns_polish_fetch.restype = None
            lib.ns_polish_fetch.argtypes = [
                ctypes.c_void_p, u8p, i64p, u8p, i64p, i64p,
            ]
            lib.ns_polish_free.restype = None
            lib.ns_polish_free.argtypes = [ctypes.c_void_p]
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.ns_join_run.restype = ctypes.c_void_p
            lib.ns_join_run.argtypes = [u32p, i64, i32, i32, i32, i64p]
            lib.ns_join_fetch.restype = None
            lib.ns_join_fetch.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
            lib.ns_join_free.restype = None
            lib.ns_join_free.argtypes = [ctypes.c_void_p]
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.ns_anchor_prepare.restype = i64
            lib.ns_anchor_prepare.argtypes = [u64p, i64p, u8p, i64]
            lib.ns_anchor_join.restype = i32
            lib.ns_anchor_join.argtypes = [
                u64p, i64p, u8p, i64, u64p, i64p, u8p, i64,
                i64, i32, i32, i32p, i64p, i64p,
            ]
            lib.ns_anchor_join_chain.restype = i32
            lib.ns_anchor_join_chain.argtypes = [
                u64p, i64p, u8p, i64, u64p, i64p, u8p, i64,
                i64, i32, i32, i32p, i64p, i64p,
                i64p, i64p, i64, i64p,
            ]
            lib.ns_stitch_align.restype = i32
            lib.ns_stitch_align.argtypes = [
                u8p, i64, u8p, i64, i64p, i64p, i64,
                i64, i32, i32, i32, u8p, i64, i64p, i64p, i64p,
            ]
            lib.ns_accept_anchors.restype = i64
            lib.ns_accept_anchors.argtypes = [
                u8p, i64, i64, i64, i32, i32,
                u64p, i64p, u8p, i64, u64p, i64p, u8p,
            ]
            lib.ns_engine_run.restype = ctypes.c_void_p
            lib.ns_engine_run.argtypes = [
                u8p, i64p, i64p, i64,
                i64p, i64p, i64p,
                i64p, i64p, i64p, i64,
                u8p, i64p,
                i64p, i64p, i64p, i64p, i64p,
            ]
            lib.ns_engine_set_tpu.restype = None
            lib.ns_engine_set_tpu.argtypes = [
                ctypes.c_void_p, u8p, u8p,
                i32p, i32p, i32p, i32p,
                i32p, i32p, i32p, u8p,
                i64, i64, i32,
            ]
            lib.ns_engine_fetch.restype = None
            lib.ns_engine_fetch.argtypes = [
                ctypes.c_void_p, u8p, i64p, i64p,
                i64p, u8p, i64p, i64p, u8p,
            ]
            lib.ns_engine_contig_sizes.restype = None
            lib.ns_engine_contig_sizes.argtypes = [
                ctypes.c_void_p, i64p, i64p, i64p,
            ]
            lib.ns_engine_fetch_range.restype = None
            lib.ns_engine_fetch_range.argtypes = [
                ctypes.c_void_p, i64, i64, i32,
                u8p, i64p, i64p,
                i64p, u8p, i64p, i64p, u8p,
            ]
            lib.ns_engine_free.restype = None
            lib.ns_engine_free.argtypes = [ctypes.c_void_p]
            dp = ctypes.POINTER(ctypes.c_double)
            lib.ns_engine_probe_info.restype = None
            lib.ns_engine_probe_info.argtypes = [dp, dp, i32p]
            lib.ns_engine_timings.restype = None
            lib.ns_engine_timings.argtypes = [ctypes.c_void_p, dp]
            lib.ns_engine_spans.restype = i64
            lib.ns_engine_spans.argtypes = [ctypes.c_void_p, i64, i32p, i32p,
                                            i64p, dp, dp]
            lib.ns_join_stats.restype = None
            lib.ns_join_stats.argtypes = [ctypes.c_void_p, i64p]
            lib.ns_components.restype = i64
            lib.ns_components.argtypes = [i64p, i64p, i64, i64, i64p]
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.ns_sketch_reads.restype = None
            lib.ns_sketch_reads.argtypes = [
                u8p, i64p, i64p, i64p, i64, u32p, u32p, i64, i64, i64, u32p,
            ]
            lib.ns_emit_lone.restype = i64
            lib.ns_emit_lone.argtypes = [u8p, i64p, i64p, i64p, i64, u8p]
            lib.ns_varint_encode.restype = i64
            lib.ns_varint_encode.argtypes = [u64p, i64, u8p]
            lib.ns_varint_decode.restype = i64
            lib.ns_varint_decode.argtypes = [u8p, i64, u64p]
            _LIB = lib
    return _LIB
