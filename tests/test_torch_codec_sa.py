"""The card's suffix sort (``ops/bwt_sa.py``), held on the CPU: its plain
PyTorch version (the kernel's rounds and tie rules, with ``torch.sort``)
against SA-IS's ``bwt_forward`` byte for byte (BWT, primary, every
checkpoint), on the blocks that stress prefix doubling; the codec with no
hook against the JAX package's own library; and the hook's plumbing
through ``ns_bsc_compress`` (the callback and the counters) with the
plain version behind it."""

import ctypes

import numpy as np
import pytest
import torch

from nanospring_tpu import native as jax_native
from nanospring_tpu_torch import native
from nanospring_tpu_torch.codec import backends
from nanospring_tpu_torch.ops import bwt_sa
from nanospring_tpu_torch.utils import observe

U8P = ctypes.POINTER(ctypes.c_uint8)
U32P = ctypes.POINTER(ctypes.c_uint32)


def _nck(n: int) -> int:
    """``code_block``'s chain count (native/codec.cpp)."""
    return int(min(16, max(1, n >> 16)))


def _sais(block: np.ndarray, nck: int):
    out = np.empty(len(block), np.uint8)
    ck = np.zeros(32, np.uint32)
    primary = native.get_lib().ns_bwt_forward_host(
        block.ctypes.data_as(U8P), len(block), out.ctypes.data_as(U8P), nck,
        ck.ctypes.data_as(U32P))
    return out, [int(primary)] + [int(c) for c in ck[1:nck]]


def _bsc(lib, block: np.ndarray) -> bytes:
    out = np.empty(len(block) + 1024, np.uint8)
    n = lib.ns_bsc_compress(block.ctypes.data_as(U8P), len(block),
                            out.ctypes.data_as(U8P))
    return out[:n].tobytes()


def _type_like(rng, n: int) -> np.ndarray:
    """The type stream's shape: per read a few hundred edit tokens
    ('i', 'd', 's') and a newline."""
    toks = np.frombuffer(b"ids", np.uint8)[rng.integers(0, 3, n)]
    toks[np.cumsum(rng.integers(200, 800, n // 200))[:-1] % n] = ord("\n")
    return toks[:n]


def _genome_like(rng, n: int, rep: int = 20_000) -> np.ndarray:
    """Consensus-like codes 0-3 in which 20 kb stretches recur, exact and
    at 99% identity."""
    g = rng.integers(0, 4, n).astype(np.uint8)
    for dst in range(rep + 1000, n - rep, rep + 7_000):
        src = int(rng.integers(0, dst - rep))
        g[dst:dst + rep] = g[src:src + rep]
        mut = rng.random(rep) < (0.01 if dst % 2 else 0.0)
        g[dst:dst + rep][mut] ^= 1
    return g


def _block(case: str) -> np.ndarray:
    rng = np.random.default_rng(13)
    return {
        "n1": lambda: np.array([0x41], np.uint8),
        "n2": lambda: np.array([0, 0], np.uint8),
        "n65537": lambda: rng.integers(0, 256, 65_537).astype(np.uint8),
        "n131072": lambda: rng.integers(0, 4, 131_072).astype(np.uint8),
        "all_equal": lambda: np.full(70_000, 7, np.uint8),
        "period2": lambda: (np.arange(50_001) % 2).astype(np.uint8),
        "period7": lambda: np.tile(np.frombuffer(b"ACGTTGA", np.uint8),
                                   10_000),
        "lzp_esc": lambda: np.full(40_000, 0xFB, np.uint8),
        "type_like": lambda: _type_like(rng, 262_144),
        "genome_like": lambda: _genome_like(rng, 300_000),
    }[case]()


@pytest.mark.parametrize("case", ["n1", "n2", "n65537", "n131072",
                                  "all_equal", "period2", "period7",
                                  "lzp_esc", "type_like", "genome_like"])
def test_plain_suffix_sort_equals_sais(case):
    block = _block(case)
    nck = _nck(len(block))
    bwt, info = bwt_sa.bwt_sa(torch.from_numpy(block), nck)
    ref, ref_info = _sais(block, nck)
    assert np.array_equal(bwt.numpy(), ref)
    assert info.tolist() == ref_info
    # the codec with no hook set: the JAX package's library, byte for byte
    assert _bsc(native.get_lib(), block) == _bsc(jax_native.get_lib(), block)


def test_hook_through_the_codec_on_cpu():
    """A block over the size bound coded with a hook set (here a callback
    that runs the plain version, both LZP variants) is the same bytes as
    without; both variants go to the hook and count as card bytes; with
    no hook they count as host bytes."""
    rng = np.random.default_rng(5)
    part = _type_like(rng, 1_330_000)
    block = np.concatenate([part, part[:70_000]])   # LZP shrinks it ~5%
    raw = block.tobytes()
    seen = []

    @backends.SORT_HOOK
    def plain_hook(data, n, out, nck, info):
        src = np.ctypeslib.as_array(ctypes.cast(data, U8P), (n,))
        bwt, inf = bwt_sa.bwt_sa_plain(torch.from_numpy(src.copy()), nck)
        np.ctypeslib.as_array(ctypes.cast(out, U8P), (n,))[:] = bwt.numpy()
        np.ctypeslib.as_array(ctypes.cast(info, U32P), (nck,))[:] = \
            inf.numpy().view(np.uint32)
        seen.append(n)
        return 0

    tr = observe.StageTimer(report=False)
    # direct ns_bsc_compress calls above left counts on this thread
    native.get_lib().ns_bsc_take_sort_bytes(
        ctypes.byref(ctypes.c_int64()), ctypes.byref(ctypes.c_int64()))
    with tr.active():
        ref = backends.compress_chunk("nsbwt", raw)
        host = tr.stage_s["bwt_host_bytes"]
        assert host > 2 << 20 and tr.stage_s["bwt_card_bytes"] == 0
        backends.set_sort_hook(plain_hook)
        try:
            got = backends.compress_chunk("nsbwt", raw)
        finally:
            backends.set_sort_hook(None)
    assert got == ref
    assert tr.stage_s["bwt_card_bytes"] == host
    assert tr.stage_s["bwt_host_bytes"] == host
    assert len(seen) == 2 and seen[0] == len(raw) and sum(seen) == host
