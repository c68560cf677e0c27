"""Port parity: the PyTorch sketch (``nanospring_tpu_torch.ops.sketch``)
against the JAX package's ``sketch_batch_packed`` / ``sketch_batch`` /
``sketch_batch_np`` and its host ``ns_sketch_reads``. Sketches are hashes:
bit-equality, no tolerance."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nanospring_tpu import native as jax_native
from nanospring_tpu.io import packed as jpk
from nanospring_tpu.ops import sketch as jsk
from nanospring_tpu_torch.ops import sketch as tsk


def _store(lens, rng):
    """A packed store (flat bytes, byte offsets, lengths) of random reads,
    plus the same reads as a zero-padded (B, L) code matrix."""
    codes = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in lens]
    parts, offs, o = [], [], 0
    for c in codes:
        p = jpk.pack_codes(c)
        offs.append(o)
        o += len(p)
        parts.append(p)
    packed = (np.concatenate(parts) if parts else np.zeros(0)).astype(np.uint8)
    L = max(int(max(lens)), 1)
    L = -(-L // 4) * 4
    mat = np.zeros((len(lens), L), np.uint8)
    for i, c in enumerate(codes):
        mat[i, : len(c)] = c
    return packed, np.array(offs, np.int64), np.array(lens, np.int64), mat


def _port(packed, offs, lens, seeds, k, min_len):
    out = tsk.sketch_reads(torch.from_numpy(packed), torch.from_numpy(offs),
                           torch.from_numpy(lens),
                           torch.from_numpy(seeds.astype(np.int64)), k,
                           min_len)
    return tsk.as_uint32(out)


def _native(packed, offs, lens, seeds, k, min_len):
    lib = jax_native.get_lib()
    n = len(seeds)
    out = np.empty((len(lens), n), np.uint32)
    rids = np.arange(len(lens), dtype=np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    s_lo = np.ascontiguousarray(seeds[:, 0])
    s_hi = np.ascontiguousarray(seeds[:, 1])
    lib.ns_sketch_reads(
        packed.ctypes.data_as(u8p), offs.ctypes.data_as(i64p),
        lens.ctypes.data_as(i64p), rids.ctypes.data_as(i64p), len(rids),
        s_lo.ctypes.data_as(u32p), s_hi.ctypes.data_as(u32p), n, k,
        min_len, out.ctypes.data_as(u32p))
    return out


def test_make_seeds_equal():
    for n, s in ((60, 0x5EEDF00D), (8, 123), (1, 7)):
        np.testing.assert_array_equal(tsk.make_seeds(n, s),
                                      jsk.make_seeds(n, s))
    assert tsk.EMPTY_SLOT == jsk.EMPTY_SLOT


# lengths: multiples of 4 and not, below k, between k and 32, long
LENS = [5, 16, 17, 22, 23, 24, 31, 32, 33, 57, 101, 250, 1001, 2003, 0, 64]


@pytest.mark.parametrize("k", [23, 17])
def test_sketch_matches_jax_packed_and_native(k):
    rng = np.random.default_rng(k)
    packed, offs, lens, mat = _store(LENS, rng)
    seeds = jsk.make_seeds(60, 0x5EEDF00D)
    got = _port(packed, offs, lens, seeds, k, k)
    # the JAX kernel on the packed batch (min_len = k: its only cut)
    pk_rows = np.stack([
        np.concatenate([jpk.pack_codes(mat[i, : lens[i]]),
                        np.zeros(mat.shape[1] // 4, np.uint8)])
        [: mat.shape[1] // 4] for i in range(len(lens))])
    ref = np.asarray(jsk.sketch_batch_packed(pk_rows, lens.astype(np.int32),
                                             seeds, k=k))
    np.testing.assert_array_equal(got, ref)
    ref2 = np.asarray(jsk.sketch_batch(mat, lens.astype(np.int32), seeds,
                                       k=k))
    np.testing.assert_array_equal(got, ref2)
    # the host sketch with the pipeline's min_len (= max(k, 32))
    got32 = _port(packed, offs, lens, seeds, k, max(k, 32))
    np.testing.assert_array_equal(
        got32, _native(packed, offs, lens, seeds, k, max(k, 32)))
    short = lens < max(k, 32)
    assert (got32[short] == jsk.EMPTY_SLOT).all()
    assert not (got32[~short] == jsk.EMPTY_SLOT).all(axis=1).any()


def test_sketch_matches_numpy_reference():
    rng = np.random.default_rng(3)
    lens = [40, 64, 100, 23, 22, 5, 37]
    packed, offs, lens_a, mat = _store(lens, rng)
    seeds = jsk.make_seeds(8, 123)
    got = _port(packed, offs, lens_a, seeds, 23, 23)
    ref = jsk.sketch_batch_np(mat, lens_a, seeds, k=23)
    np.testing.assert_array_equal(got, ref)


def test_sketch_chunking_and_k32():
    """Chunk boundaries inside reads and k = 32 (a 64-bit k-mer) change
    nothing."""
    rng = np.random.default_rng(11)
    packed, offs, lens, _ = _store([300, 47, 129, 1000], rng)
    seeds = jsk.make_seeds(5, 1)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    for k in (32, 19):
        whole = tsk.sketch_reads_plain(t(packed), t(offs), t(lens),
                                       t(seeds.astype(np.int64)), k, k)
        small = tsk.sketch_reads_plain(t(packed), t(offs), t(lens),
                                       t(seeds.astype(np.int64)), k, k,
                                       chunk=97)
        assert torch.equal(whole, small)
        np.testing.assert_array_equal(
            tsk.as_uint32(whole), _native(packed, offs, lens, seeds, k, k))


def test_sketch_rejects_bad_k():
    z = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        tsk.sketch_reads(torch.zeros(1, dtype=torch.uint8), z, z,
                         torch.ones((2, 2), dtype=torch.int64), 16, 16)


@pytest.mark.parametrize("k", cs.SKETCH_EDGE_KS)
@pytest.mark.parametrize("n", [1, 33, 64, 65, 256])
def test_sketch_edge_store_matches_jax_and_native(k, n):
    """The card's edge store (read lengths around k, the minimum length and
    the kernel's tiles, an empty read in the middle and one last in the
    store) at seed counts around the kernel's 32-lane layout: the port on
    the CPU against the JAX package's packed sketch and its host sketch."""
    packed, offs, lens = cs.sketch_edge_store(
        np.random.default_rng(2027 + k), k, empty_last=True)
    assert lens[-1] == 0 and offs[-1] == len(packed) and len(packed) % 8
    for tile in cs.SKETCH_EDGE_TILES:
        assert {tile + k - 2, tile + k - 1, tile + k} <= set(lens.tolist())
    seeds = jsk.make_seeds(n, 77 + n)
    min_len = max(k, 32)
    got = _port(packed, offs, lens, seeds, k, min_len)
    np.testing.assert_array_equal(
        got, _native(packed, offs, lens, seeds, k, min_len))
    assert (got[lens < min_len] == jsk.EMPTY_SLOT).all()
    # the JAX kernel takes padded rows and cuts at k alone
    width = -(-int(lens.max()) // 4)
    rows = np.zeros((len(lens), width), np.uint8)
    for i, (o, m) in enumerate(zip(offs, lens)):
        nb = -(-int(m) // 4)
        rows[i, :nb] = packed[o: o + nb]
    ref = np.asarray(jsk.sketch_batch_packed(rows, lens.astype(np.int32),
                                             seeds, k=k))
    np.testing.assert_array_equal(_port(packed, offs, lens, seeds, k, k), ref)


class _OnCard:
    """Stands in for a CUDA tensor where there is no card: a CPU tensor
    that reports ``cuda`` as its device, so ``sketch_reads`` takes the
    kernel's route up to the point where it needs the library."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def _on_card_args(n):
    z = torch.zeros(2, dtype=torch.int64)
    return (_OnCard(torch.zeros(16, dtype=torch.uint8)), _OnCard(z),
            _OnCard(z), _OnCard(torch.ones((n, 2), dtype=torch.int64)),
            23, 32)


def test_sketch_kernel_route_rejects_257_seeds(monkeypatch):
    from nanospring_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "get_lib", lambda: pytest.fail(
        "the library was asked for before the seed count was checked"))
    assert tsk.MAX_SEEDS == 256
    with pytest.raises(ValueError, match="at most 256 seeds"):
        tsk.sketch_reads(*_on_card_args(257))


def test_broken_sketch_kernel_raises(monkeypatch):
    """No fallback: when the kernels' library cannot be had, a sketch of
    tensors on the card raises and the plain version is not taken."""
    from nanospring_tpu_torch.ops import _cuda

    def broken():
        raise RuntimeError("sketch kernel build failed")

    monkeypatch.setattr(_cuda, "get_lib", broken)
    monkeypatch.setattr(tsk, "sketch_reads_plain", lambda *a, **kw: pytest.fail(
        "the plain version ran for tensors on the card"))
    n0 = tsk.sketch_reads.launches
    with pytest.raises(RuntimeError, match="sketch kernel build failed"):
        tsk.sketch_reads(*_on_card_args(256))
    assert tsk.sketch_reads.launches == n0
