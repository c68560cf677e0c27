"""Host-CPU entropy-coding backends for the archive streams.

Role of libbsc (BWT + QLFC, reference: src/bsc.cpp, 48 MB blocks, coder e2)
and fast-lzma2 (reference: src/lzma2.cpp, preset 6) — entropy coding is
byte-serial and branchy, the wrong shape for the TPU, so this stage stays on
host CPUs (SURVEY.md §2.3).

Current backends use the stdlib's native (C) codecs:
- ``bz2``  — BWT + MTF + Huffman, the same codec family as libbsc; used for
  the genome/pos/type/complement/lone/id/exc streams.
- ``lzma`` — LZMA, the same family as fast-lzma2; used for the ``base``
  stream (reference maps .base -> lzma2, src/Compressor.cpp:126-130).
Streams are chunked so multi-core compressors can parallelize by chunk.

A from-scratch C++ BWT/rank-coder stage (the package's native/) replaces
these when ratio parity requires it.
"""

from __future__ import annotations

import bz2
import concurrent.futures as cf
import contextlib
import ctypes
import lzma
import struct
import threading
import weakref
import zlib

from ..utils import observe

_CHUNK = 32 << 20  # block-chunked like the reference's 48 MB bsc blocks
                   # (bsc_helper.h:6). 32 MB: on Gbase-class inputs the
                   # genome/pos streams reach hundreds of MB, where bigger
                   # blocks buy LZP/BWT context (round-3 ask #8); medium
                   # streams still split enough for the thread pool, and
                   # SA-IS scratch stays ~5x chunk per worker

_LZMA_FILTERS = [{"id": lzma.FILTER_LZMA2, "preset": 6}]


def _bz2_c(b: bytes) -> bytes:
    return bz2.compress(b, 9)


def _bz2_d(b: bytes) -> bytes:
    return bz2.decompress(b)


def _lzma_c(b: bytes) -> bytes:
    return lzma.compress(b, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)


def _lzma_d(b: bytes) -> bytes:
    return lzma.decompress(b, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)


def _zlib_c(b: bytes) -> bytes:
    return zlib.compress(b, 6)


def _zlib_d(b: bytes) -> bytes:
    return zlib.decompress(b)


def _nsbwt_c(b: bytes) -> bytes:
    """From-scratch C++ BWT+MTF+RLE0+range-coder block codec (native/codec.cpp),
    the libbsc-role stage (reference: src/bsc.cpp, libbsc/)."""
    import ctypes

    import numpy as np

    from .. import native

    lib = native.get_lib()
    src = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(len(b) + 1024, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_bsc_compress(
        src.ctypes.data_as(u8p), ctypes.c_int64(len(b)), out.ctypes.data_as(u8p)
    )
    host, card = ctypes.c_int64(), ctypes.c_int64()
    lib.ns_bsc_take_sort_bytes(ctypes.byref(host), ctypes.byref(card))
    tr = observe.current()
    tr.add("bwt_host_bytes", host.value)
    tr.add("bwt_card_bytes", card.value)
    return out[:n].tobytes()


def _nsbwt_d(b: bytes) -> bytes:
    import ctypes
    import struct as _st

    import numpy as np

    from .. import native

    lib = native.get_lib()
    (raw_n,) = _st.unpack_from("<I", b, 0)
    src = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(max(raw_n, 1), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_bsc_decompress(
        src.ctypes.data_as(u8p), ctypes.c_int64(len(b)), out.ctypes.data_as(u8p)
    )
    return out[:n].tobytes()


def _nslz_c(b: bytes) -> bytes:
    """From-scratch C++ LZ77 + range coder (native/codec.cpp ns_lz_*),
    the fast-lzma2-role stage (reference: src/lzma2.cpp, fast-lzma2/)."""
    import ctypes

    import numpy as np

    from .. import native

    lib = native.get_lib()
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(len(b) + len(b) // 8 + 1024, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_lz_compress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


def _nslz_d(b: bytes) -> bytes:
    import ctypes
    import struct as _st

    import numpy as np

    from .. import native

    lib = native.get_lib()
    (raw_n,) = _st.unpack_from("<I", b, 0)
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(max(raw_n, 1), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_lz_decompress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


def _nso1_c(b: bytes) -> bytes:
    """Order-1 adaptive range coder, no transform (native/codec.cpp
    ns_o1_*): owner of the exc stream, whose position varints a BWT
    scrambles (docs/CODECS.md)."""
    import ctypes

    import numpy as np

    from .. import native

    lib = native.get_lib()
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(len(b) + 1024, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_o1_compress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


def _nso1_d(b: bytes) -> bytes:
    import ctypes
    import struct as _st

    import numpy as np

    from .. import native

    lib = native.get_lib()
    (raw_n,) = _st.unpack_from("<I", b, 0)
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(max(raw_n, 1), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_o1_decompress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


# The C signature of the suffix-sort hook (native/codec.cpp, SaHook):
# (data, n, out, nck, info) -> 0, or nonzero to sort the block on the host.
SORT_HOOK = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p)


def set_sort_hook(fn) -> None:
    """Sets the codec library's suffix-sort hook to ``fn`` (a ``SORT_HOOK``
    callback), or clears it with None. The hook is one for the process."""
    from .. import native

    native.get_lib().ns_bsc_set_sort_hook(
        None if fn is None else ctypes.cast(fn, ctypes.c_void_p))


class CardSuffixSort:
    """The codec library's suffix-sort hook (``native/codec.cpp``,
    ``ns_bsc_set_sort_hook``) on a card: ``bwt_forward`` hands it every
    nsbwt block of at least ``kCardSortMinBytes`` (plain and LZP variants
    alike), and ``ops.bwt_sa.bwt_sa`` builds the block's suffix array there
    and returns the BWT bytes, the primary index and the checkpoints. The
    LZP pass and the coders stay on the host; the coded bytes are the same.

    The codec pool's threads call the callback concurrently; each block
    runs under one lock on one stream: copied into one pinned staging
    buffer (grown to the largest block, kept for the next job), sorted,
    and its BWT copied back through the same buffer. Each use is a
    ``codec.sa_card`` span (``bytes_in``) under the thread's
    ``codec.<stream>`` span.

    A failure must not pass for success: the block is then sorted on the
    host (same bytes), the callback keeps the exception in ``error`` and
    returns 1 for this and every later block, and ``card_suffix_sort``
    raises it when the archive's jobs are done."""

    def __init__(self, device):
        import torch

        from ..ops import bwt_sa

        self.device = device
        self._torch = torch
        self._bwt_sa = bwt_sa.bwt_sa
        self.stream = torch.cuda.Stream(device)
        self._lock = threading.Lock()
        self._buf = torch.empty(0, dtype=torch.uint8, pin_memory=True)
        self._info = torch.empty(bwt_sa.MAX_NCK, dtype=torch.int32,
                                 pin_memory=True)
        self.error: BaseException | None = None
        me = weakref.ref(self)             # no cycle through the callback

        @SORT_HOOK
        def _cb(data, n, out, nck, info):
            hook = me()
            if hook is None or hook.error is not None:
                return 1
            try:
                hook._run(data, int(n), out, int(nck), info)
                return 0
            except BaseException as e:  # noqa: BLE001 - re-raised by caller
                hook.error = e
                return 1

        self._cb = _cb

    def _run(self, data, n: int, out, nck: int, info) -> None:
        torch = self._torch
        tr = observe.current()
        with tr.stage("codec.sa_card"), self._lock, \
                torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            tr.note(bytes_in=n)
            if self._buf.numel() < n:
                self._buf = torch.empty(-(-n // (1 << 20)) << 20,   # whole MB
                                        dtype=torch.uint8, pin_memory=True)
            buf = self._buf[:n]
            ctypes.memmove(buf.data_ptr(), data, n)
            bwt, inf = self._bwt_sa(buf.to(self.device, non_blocking=True),
                                    nck)
            buf.copy_(bwt, non_blocking=True)
            self._info[:nck].copy_(inf, non_blocking=True)
            self.stream.synchronize()
            ctypes.memmove(out, buf.data_ptr(), n)
            ctypes.memmove(info, self._info.data_ptr(), 4 * nck)


_CARD_SORTS: dict[str, CardSuffixSort] = {}


@contextlib.contextmanager
def card_suffix_sort(device):
    """Within the block, nsbwt blocks of at least ``kCardSortMinBytes``
    are suffix-sorted on ``device`` when it is a card; elsewhere this does
    nothing. One hook per card lives for the process, so its staging is
    reused from job to job. The library's hook is one for the process:
    while the block runs, every nsbwt block that any thread of the process
    codes goes to this card, so the port runs one card compress at a time
    in a process (the bytes would be the same, the counters not)."""
    if device is None or device.type != "cuda":
        yield
        return
    key = str(device)
    hook = _CARD_SORTS.get(key)
    if hook is None:
        hook = _CARD_SORTS[key] = CardSuffixSort(device)
    hook.error = None
    set_sort_hook(hook._cb)
    try:
        yield
    finally:
        set_sort_hook(None)
    if hook.error is not None:
        raise RuntimeError("the card's suffix sort failed") from hook.error


_BACKENDS: dict[str, tuple] = {
    "nslz": (_nslz_c, _nslz_d),
    "bz2": (_bz2_c, _bz2_d),
    "lzma": (_lzma_c, _lzma_d),
    "zlib": (_zlib_c, _zlib_d),
    "nsbwt": (_nsbwt_c, _nsbwt_d),
    "nso1": (_nso1_c, _nso1_d),
    "raw": (lambda b: b, lambda b: b),
}


def register(name: str, compress_fn, decompress_fn) -> None:
    _BACKENDS[name] = (compress_fn, decompress_fn)


def split_chunks(data: bytes) -> list[bytes]:
    """The chunking used by compress(), exposed so callers can flatten
    (stream, chunk) jobs across one pool (io/archive.py)."""
    return [data[i: i + _CHUNK] for i in range(0, len(data), _CHUNK)] or [b""]


def compress_chunk(name: str, chunk: bytes) -> bytes:
    return _BACKENDS[name][0](chunk)


def assemble_chunks(payloads: list[bytes]) -> bytes:
    header = struct.pack("<I", len(payloads)) + b"".join(
        struct.pack("<Q", len(p)) for p in payloads
    )
    return header + b"".join(payloads)


def compress(name: str, data: bytes, pool: cf.Executor | None = None) -> bytes:
    """Chunked compression: [u32 nchunks][u64 raw_len per chunk][payloads...].

    Chunking bounds memory like the reference's 48 MB bsc blocks and lets a
    thread pool run chunks in parallel (the stdlib codecs release the GIL).
    """
    c, _ = _BACKENDS[name]
    chunks = [data[i : i + _CHUNK] for i in range(0, len(data), _CHUNK)] or [b""]
    if pool is not None and len(chunks) > 1:
        payloads = list(pool.map(c, chunks))
    else:
        payloads = [c(ch) for ch in chunks]
    header = struct.pack("<I", len(chunks)) + b"".join(
        struct.pack("<Q", len(p)) for p in payloads
    )
    return header + b"".join(payloads)


def split_payloads(data: bytes) -> list[bytes]:
    """Inverse of assemble_chunks: the coded chunk payloads."""
    (nchunks,) = struct.unpack_from("<I", data, 0)
    off = 4
    sizes = []
    for _ in range(nchunks):
        (sz,) = struct.unpack_from("<Q", data, off)
        sizes.append(sz)
        off += 8
    payloads = []
    for sz in sizes:
        payloads.append(data[off: off + sz])
        off += sz
    return payloads


def decompress_chunk(name: str, payload: bytes) -> bytes:
    return _BACKENDS[name][1](payload)


def decompress(name: str, data: bytes, pool: cf.Executor | None = None) -> bytes:
    _, d = _BACKENDS[name]
    (nchunks,) = struct.unpack_from("<I", data, 0)
    off = 4
    sizes = []
    for _ in range(nchunks):
        (sz,) = struct.unpack_from("<Q", data, off)
        sizes.append(sz)
        off += 8
    payloads = []
    for sz in sizes:
        payloads.append(data[off : off + sz])
        off += sz
    if pool is not None and nchunks > 1:
        return b"".join(pool.map(d, payloads))
    return b"".join(d(p) for p in payloads)
