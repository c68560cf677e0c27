"""MinHash sketch of every read: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``nanospring_tpu/ops/sketch.py`` (``sketch_batch_packed`` /
``sketch_batch``, :110-153), computing the same bits as
``native/sketch.cpp::ns_sketch_reads``: canonical k-mers split as
(hi = first k-16 bases, lo = last 16), y = fmix32(lo), z = fmix32(hi ^ y),
h_j = y*(a_j|1) + z*(b_j|1) mod 2^32, and the per-seed minimum over every
k-mer of the read. Reads shorter than max(k, min_len) stay ``EMPTY_SLOT``.

Both versions read the whole 2-bit packed store (4 bases per byte, LSB
first) through its per-read byte offsets, as ``ns_sketch_reads`` does, so
no padding buckets exist. ``sketch_reads`` launches ``csrc/sketch.cu`` for
CUDA tensors and takes the plain version only for CPU tensors.

Sketches are returned as int32 tensors holding the uint32 bits
(``as_uint32`` views them as numpy uint32): PyTorch on the CPU lacks
shifts, adds and compares for uint32.
"""

from __future__ import annotations

import numpy as np
import torch

EMPTY_SLOT = np.uint32(0xFFFFFFFF)  # sketch value for invalid/short reads
MAX_SEEDS = 256                     # csrc/sketch.cu: 32 lanes x 8 seeds each
_M32 = 0xFFFFFFFF


def make_seeds(num_hashes: int, seed: int) -> np.ndarray:
    """(n, 2) uint32 deterministic hash seeds."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**32, size=(num_hashes, 2), dtype=np.uint32)


def as_uint32(sk: torch.Tensor) -> np.ndarray:
    """(N, n) int32 sketch tensor -> numpy uint32 (same bits)."""
    return sk.cpu().numpy().view(np.uint32)


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x, c < 2^32 held in int64, with c split in
    16-bit halves so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 lanes holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _check(packed, offsets, lengths, seeds, k) -> None:
    dev = packed.device
    for name, t, dt in (("packed", packed, torch.uint8),
                        ("offsets", offsets, torch.int64),
                        ("lengths", lengths, torch.int64),
                        ("seeds", seeds, torch.int64)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, packed on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if seeds.dim() != 2 or seeds.shape[1] != 2:
        raise ValueError("seeds must have shape (n, 2)")
    if not 16 < k <= 32:
        raise ValueError("sketch k must be in (16, 32]")
    if offsets.shape != lengths.shape:
        raise ValueError("offsets and lengths differ in shape")


def sketch_reads_plain(packed: torch.Tensor, offsets: torch.Tensor,
                       lengths: torch.Tensor, seeds: torch.Tensor, k: int,
                       min_len: int, chunk: int = 1 << 16) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/sketch.cu`` (int64 arithmetic masked
    to 32 bits), on any device. Works through ``chunk`` k-mer positions at a
    time; returns (N, n) int32 holding the uint32 sketch bits."""
    _check(packed, offsets, lengths, seeds, k)
    dev = packed.device
    N = lengths.shape[0]
    n = seeds.shape[0]
    best = torch.full((N, n), _M32, dtype=torch.int64, device=dev)
    a = (seeds[:, 0] | 1)[None, :]
    b = (seeds[:, 1] | 1)[None, :]
    npos = torch.where(lengths >= max(k, min_len), lengths - k + 1,
                       torch.zeros_like(lengths))
    ends = torch.cumsum(npos, 0)
    total = int(ends[-1]) if N else 0
    h = k - 16
    for c0 in range(0, total, chunk):
        c1 = min(total, c0 + chunk)
        flat = torch.arange(c0, c1, device=dev)
        rid = torch.searchsorted(ends, flat, right=True)
        p = flat - (ends[rid] - npos[rid])          # k-mer start in read
        base0 = offsets[rid] * 4 + p                # first base, in bases
        fhi = torch.zeros_like(p)
        flo = torch.zeros_like(p)
        rhi = torch.zeros_like(p)
        rlo = torch.zeros_like(p)
        for j in range(k):
            x = base0 + j
            c = (packed[x >> 2].long() >> (2 * (x & 3))) & 3
            if j < h:
                fhi = (fhi << 2) | c
            else:
                flo = (flo << 2) | c
            if j < 16:
                rlo = rlo | ((3 - c) << (2 * j))
            else:
                rhi = rhi | ((3 - c) << (2 * (j - 16)))
        take_fwd = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
        lo = torch.where(take_fwd, flo, rlo)
        hi = torch.where(take_fwd, fhi, rhi)
        y = _fmix32(lo)
        z = _fmix32(hi ^ y)
        hv = (_mul32(y[:, None], a) + _mul32(z[:, None], b)) & _M32
        best.scatter_reduce_(0, rid[:, None].expand(-1, n), hv, reduce="amin")
    return torch.where(best >= 1 << 31, best - (1 << 32), best).to(torch.int32)


def sketch_reads(packed: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor, seeds: torch.Tensor, k: int,
                 min_len: int) -> torch.Tensor:
    """Sketch every read of a packed store: (N, n) int32 uint32 bits.

    CUDA tensors launch ``csrc/sketch.cu``; CPU tensors take the plain
    version. ``sketch_reads.launches`` counts kernel launches."""
    _check(packed, offsets, lengths, seeds, k)
    dev = packed.device
    if dev.type == "cpu":
        return sketch_reads_plain(packed, offsets, lengths, seeds, k, min_len)
    if dev.type != "cuda":
        raise ValueError(f"sketch_reads runs on cuda or cpu, not {dev}")
    n = seeds.shape[0]
    if n > MAX_SEEDS:
        raise ValueError(f"the sketch kernel takes at most {MAX_SEEDS} "
                         f"seeds, got {n}")
    from . import _cuda

    lib = _cuda.get_lib()
    N = lengths.shape[0]
    out = torch.empty((N, n), dtype=torch.int32, device=dev)
    if N == 0:
        return out
    rc = lib.ns_sketch_launch(
        packed.data_ptr(), offsets.data_ptr(), lengths.data_ptr(),
        seeds.data_ptr(), N, n, k, int(min_len), out.data_ptr(),
        _cuda.stream_handle(dev))
    _cuda.check(rc, "sketch kernel launch")
    sketch_reads.launches += 1
    return out


sketch_reads.launches = 0
