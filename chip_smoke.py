#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``nanospring_tpu_torch``) on one NVIDIA
GPU. Run from the root of the repository:

    python3 chip_smoke.py            # the full check, about 10 minutes
    python3 chip_smoke.py --small    # the same phases on a small dataset
    python3 chip_smoke.py --nccl-ranks 4   # phase 6 (b), (c) alone, as 4
                                           # NCCL ranks on 4 cards
    python3 chip_smoke.py --big      # after the build, one set over 2 GiB
                                     # (the low-memory store), ~20 minutes
    python3 chip_smoke.py --hs1      # after the build, phase 8 alone

Phases, in order; any failure exits nonzero and nothing is carried on:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: the port's C++ library (g++) and the CUDA kernels
   (``csrc/*.cu``, one nvcc per source, all started together).
3. parity: each kernel against its plain PyTorch version on the card:
   the sketch on every read of the headline set at k=23 and k=17
   (bit-equal) and on an edge store (``sketch_edge_store``: read lengths
   around k, the minimum length and the kernel's tiles, empty reads, the
   last read flush with the store) at k = 17, 23 and 32 and 1 to 256
   seeds, and the banded DP on three hook-shaped batches whose
   longest queries need <= 8,192, ~32,768 and > 65,536 rows (byte-equal
   cost / ops_len / tstart / tend / trace rows); plus the DP's costs
   against the exact C++ DP (W=63) on the first batch. The v1 DP
   (``banded_dp32``) likewise on two batches whose longest queries need
   <= 8,192 rows (the TPU kernel's own shape) and ~32,768 rows (the
   headline's longest read), with its costs against the exact C++ DP at
   band 128 on the first. Then both DP kernels on an edge batch
   (``edge_pairs``: 1 to 131,072 rows, padding, a rejected pair, invalid
   slots, a deletion run that escapes), held against the plain version
   run on the CPU, in two worker processes started at the beginning of
   this phase (their host time overlaps the batches above). Last, the
   card's suffix sort (``bwt_sa``) on blocks of an ``sa`` job's sizes: a
   type-like block of 14.9 MB and a genome-like one of 8.2 MB with 20 kb
   repeats, each plain and as its LZP variant, and a genome-like block of
   32 MB (the codec's largest), byte-equal (BWT, primary, checkpoints) to
   its plain version on the card and to SA-IS on the host.
4. main paths, each on the 60 Mb headline set (bench.py's dataset: 2 Mb
   genome, 12,000 reads, mean length 5,000, seed 1234) on cuda with one
   pipeline worker, decompressed and byte-compared, with the kernel launch
   counts set to 0 just before the run and read just after:
   ``compress_file`` with the engine and its device DP hook (the default;
   every kernel, ``bwt_sa`` included, must launch, and nsbwt bytes must be
   sorted on the card),
   the same data with the engine's own DP (``aligner="native"``, the ratio
   anchor), and the Python wavefront (``aligner="python"``), which sends
   batches up to 8,192 rows to the v1 DP and longer ones to the host DP,
   as the reference does; its kernel batches are then replayed on the
   exact C++ DP (band 128) to compare each pair's verdict and cost.
   (d) ``aligner="auto"``, the first probe-mode run in this process, so
   the engine really probes: a warm-up and a probe batch through the hook
   on the card, timed against its own DP, and the faster keeps the run.
   It must run at least those 2 batches on the card and decode to the
   input; with a ``native`` verdict it must write phase 4's native
   archive byte for byte. (``--small``'s set is under the probe's
   2e7-base gate, so there it only checks the archive.)
5. times: each kernel at the main paths' shapes with CUDA events (warm-up,
   then many launches), its plain version's time and its bound; for the DP
   kernels also the profiler's time per main-path launch and the cycles
   per row of a launch's longest query, at the maximum SM clock; for the
   sketch also the split of one pass as the pipeline makes it (copies to
   the card, kernel, copy back) beside the ``sketch_join`` stage; for
   ``bwt_sa`` each block of phase 3 against SA-IS's host time, and the
   profiler's device time of its kernels in the main path.
6. scale-out (``nanospring_tpu_torch/parallel``):
   (a) the sharded join on one NCCL rank in this process, its tensors on
   the card, whose gathered pairs and counts must equal the single-host
   ``SketchIndex`` join on the same sketches; and the sketch kernel at the
   inputs the scale-out path gives it (each half of the rows through
   ``offsets[lo:hi]``, each FASTQ shard's spill store), bit-equal to its
   plain version on the same tensors. (b) ``python -m
   nanospring_tpu_torch.parallel.distributed`` as two ranks on the one card
   (``backend="gloo"``: NCCL refuses two ranks on one card), each with its
   own FASTQ shard, the device DP and one pipeline worker; (c)
   ``compress_mesh`` as two ranks the same way. (b) and (c) run on the
   headline set, which is one overlap component that one rank grows, and
   on a set of its shape from two genomes of half the length, where each
   rank grows one. Both must decode to the input and keep as many pairs as
   the single-host join finds; (b) prints each rank's phase times,
   collective bytes, memory evidence and kernel launches. Every rank must
   have launched the sketch, every rank that grew a component
   ``banded_dp16``, and on the two-genome set both ranks must grow.
   With ``--nccl-ranks N``, only (b) and (c) run, as N NCCL ranks on N
   cards, after the build.
7. workers on one card: the two-genome set with the device DP at
   ``pipeline_workers`` 1, 2 and 0 (the default, min(threads, cores) // 2
   processes), each with its own CUDA context and hook. Each run must
   decode to the input, and with 2 and 0 workers every grow process must
   have launched ``banded_dp16``. Prints each run's wall, the largest
   ``max_memory_allocated`` of a grow process and the card's used memory
   (nvidia-smi, sampled during the run).
8. hs1 (not with ``--small``): one job of the benchmark's ``hs1``
   configuration (``benchmark/configs/hs1.json``: 15,667 reads of mean
   8,484 at ~9.6% error, made by ``benchmark/gen.py``) through
   ``compress_file`` with its settings. The k=23 join is sparse, so the
   candidate graph sketches again at k=17: the job must run that pass,
   retry band rejects on the host and decode to its input. The k=17 rows
   of 256 reads drawn from a seed and of the longest read must equal
   ``benchmark/reference.py``'s, and the pairs the graph was built from
   the plain join's with the recovery rule
   (``benchmark/reference_join.py``) on the job's rows of both passes.

With ``--big``, after the build: one synthetic set over 2 GiB
(``bench_scale.py``'s recipe: mean length 5,000, genome = bases / 24,
seed 99, n-frac 0.0005; 1.2 Gbase), so that ``compress_file`` switches
the low-memory store on by itself. First the spill map's copy to the card
(32 MB chunks) and its sketch, every row, are held against a whole copy
and the plain version. Then it compresses with ``aligner="device"`` and
``"auto"`` and decompresses each archive in memory and with ``-m 1``,
each in a process of its own (peak RSS from ``ru_maxrss``), and compares
by streamed digest. The device run keeps each grow process's first and
largest hook batch (``NSTPU_DP_RECORD``, at the hook's ``M_CAP``), and
32 pairs of each, the longest among them, are replayed on the plain
``banded_dp16`` on the host.

It prints one JSON line listing every kernel, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

# the port's bench anchors (device-independent; BENCH_r05.json)
HEADLINE = dict(genome_len=2_000_000, num_reads=12_000, mean_len=5_000,
                seed=1234, p_n_base=0.0005, realistic=True)
SMALL = dict(genome_len=200_000, num_reads=400, mean_len=4_000,
             seed=1234, p_n_base=0.0005, realistic=True)
ANCHOR_RATIO = 17.3          # native-DP ratio of the headline set
ANCHOR_BASES = 60_023_697
# H100 SXM published HBM rate. Both kernels do 32-bit integer work (add,
# min, compare, multiply), which an SM issues at 64 lanes per clock on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput); the peak is counted from the card's SM count
# and maximum SM clock (int32_ops_s).
HBM_BYTES_S = 3.35e12
INT32_LANES_PER_SM = 64
SKETCH_MULS_PER_HASH = 2     # y * a + z * b: a multiply and a multiply-add
DP_OPS_PER_CELL = 8          # 2 adds, 3 mins, 2 +/-k, 1 code compare
DP16_CELLS = 128             # band cells per query row, banded_dp16
DP32_CELLS = 256             # and banded_dp32


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_mhz() -> float:
    """The maximum SM clock of card 0 that nvidia-smi reports, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def int32_ops_s(mhz: float) -> float:
    """Peak 32-bit integer operations per second of card 0: SMs x 64
    lanes x the maximum SM clock ``mhz``."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def cycles_per_row(ms: float, rows: float, mhz: float) -> float:
    """Cycles at ``mhz`` per row of a launch's longest query."""
    return ms * 1e-3 * mhz * 1e6 / max(rows, 1)


def timed(fn, reps: int, warm: int = 1) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# DP batches shaped like the engine hook's: random targets, mutated queries
# ---------------------------------------------------------------------------

def make_pairs(rng, q_lens):
    """Pairs as ``banded_align_batch`` takes them: for each length L, a
    random target and a query copied from t[s:s+L] with ~9% error (7%
    substitutions, 1% deletions, 1% insertions: indels balanced so the
    diagonal drifts slowly enough for long queries to stay in the band)."""
    tf, qf = [], []
    t_off, t_len, q_off, q_len, d0 = [], [], [], [], []
    to = qo = 0
    for L in q_lens:
        s = int(rng.integers(0, 200))
        n = s + int(L) + int(rng.integers(0, 200))
        t = rng.integers(0, 4, n).astype(np.uint8)
        src = t[s: s + int(L)]
        r = rng.random(len(src))
        reps = np.where(r < 0.08, np.where(r < 0.07, 1, 0),
                        np.where(r < 0.09, 2, 1))
        q = np.repeat(src, reps)
        sub = np.repeat(r < 0.07, reps)
        q[sub] = rng.integers(0, 4, int(sub.sum()))
        ins = np.zeros(len(q), bool)
        ins[np.cumsum(reps)[reps == 2] - 1] = True
        q[ins] = rng.integers(0, 4, int(ins.sum()))
        tf.append(t)
        qf.append(q)
        t_off.append(to)
        t_len.append(n)
        to += n
        q_off.append(qo)
        q_len.append(len(q))
        qo += len(q)
        d0.append(s)
    return (np.concatenate(tf), np.array(t_off), np.array(t_len),
            np.concatenate(qf), np.array(q_off), np.array(q_len),
            np.array(d0))


def dp_batches(rng, small: bool):
    """(label, pairs, m_pad) for the three hook shapes."""
    P = 64 if small else 512

    def lognormal(n, cap):
        L = rng.lognormal(np.log(5_000), 0.6, n).astype(np.int64)
        return np.clip(L, 500, cap)

    a = lognormal(P, 8_000)
    a[0] = 8_000
    b = lognormal(P, 32_000)
    b[0] = 32_000
    c = rng.integers(66_000, 70_000, 4 if small else 8)
    return [("v2 (<= 8,192 rows)", make_pairs(rng, a), 8192),
            ("t2 (~32,768 rows)", make_pairs(rng, b), 32768),
            ("t (> 65,536 rows)", make_pairs(rng, c), 131072)]


def dp32_batches(rng, small: bool):
    """(label, pairs) for the v1 DP: a wavefront-sized batch at the TPU
    kernel's own shape and the headline's largest batch at its longest
    read."""
    def lognormal(n, cap):
        L = rng.lognormal(np.log(5_000), 0.6, n).astype(np.int64)
        return np.clip(L, 500, cap)

    a = lognormal(16 if small else 96, 8_000)
    a[0] = 8_000
    b = lognormal(16 if small else 300, 32_000)
    b[0] = 32_000
    return [("v1 (<= 8,192 rows)", make_pairs(rng, a)),
            ("v1 (~32,768 rows)", make_pairs(rng, b))]


EDGE_LONG = 131_072          # the kernels' row capacity (M_ROWS_MAX)


def edge_pairs(rng):
    """Pairs at the edges of the DP kernels' design, for both kernels:
    queries of 1, 31, 32 and 33 rows (the forward pass's 32-row register
    chunks) and 63, 65, 127, 129 and 257 rows (the traceback's 64-row
    staged chunks), one of 131,072 rows, two padding pairs (q_len 0), an
    unrelated query (every base mismatches: rejected), d0 at 0 and 3 and
    at the target's end (invalid slots, code 3), and a 70-base deletion
    (a left run of 70 slots: ``banded_dp16``'s 255 escape)."""
    items = []                          # (target, query, d0)

    def copy(t, s, L):
        q = t[s: s + L].copy()
        sub = rng.random(L) < 0.05      # substitutions only: stays in band
        q[sub] = rng.integers(0, 4, int(sub.sum()))
        return q

    for L in (1, 31, 32, 33, 63, 65, 127, 129, 257, EDGE_LONG):
        t = rng.integers(0, 4, L + 300).astype(np.uint8)
        items.append((t, copy(t, 100, L), 100))
    for _ in range(2):
        items.append((rng.integers(0, 4, 300).astype(np.uint8),
                      np.zeros(0, np.uint8), 0))
    items.append((rng.integers(2, 4, 3000).astype(np.uint8),
                  rng.integers(0, 2, 2000).astype(np.uint8), 100))
    t = rng.integers(0, 4, 2000).astype(np.uint8)
    items += [(t, copy(t, 0, 1500), 0), (t, copy(t, 3, 1500), 3),
              (t, copy(t, 1000, 1000), 1000),
              (t, copy(t, 1000, 1000), 1030)]
    # the deleted bases match no query base, so the 70 deletions stay one
    # run in one row (slot 24 before it, 94 after)
    t = rng.integers(0, 3, 1500).astype(np.uint8)
    t[600:670] = 3
    items.append((t, np.concatenate([t[100:600], t[670:1170]]), 140))
    t_len = np.array([len(a) for a, _, _ in items])
    q_len = np.array([len(b) for _, b, _ in items])
    return (np.concatenate([a for a, _, _ in items]),
            np.concatenate([[0], np.cumsum(t_len)[:-1]]), t_len,
            np.concatenate([b for _, b, _ in items]),
            np.concatenate([[0], np.cumsum(q_len)[:-1]]), q_len,
            np.array([d for _, _, d in items]))


def edge_plain(pairs, v1: bool) -> tuple:
    """The plain version of ``banded_dp32`` (``v1``) or ``banded_dp16`` on
    the edge batch, on the CPU (its row loop is faster there than on the
    card at this pair count). Run in a worker process, beside the card's
    parity batches, so its ~70-120 s of host time overlap them. Returns
    (outputs, seconds)."""
    import torch

    from nanospring_tpu_torch.ops import align_tpu as at

    torch.set_num_threads(1)
    t = dp_tensors(pairs, None, torch.device("cpu"), v1=v1)
    plain = at.banded_dp32_plain if v1 else at.banded_dp16_plain
    t0 = time.time()
    out = tuple(x.clone() for x in plain(*dp_args(t)))
    return out, time.time() - t0


def edge_parity(kernel, ref, pairs, dev, v1: bool) -> tuple:
    """The kernel on the card against its plain version's outputs ``ref``
    (``edge_plain``) on the edge batch; returns (outputs on the CPU, max
    abs error)."""
    t = dp_tensors(pairs, None, dev, v1=v1)
    got = tuple(x.cpu() for x in kernel(*dp_args(t)))
    t_cpu = {k: v.cpu() for k, v in t.items()}
    return got, compare_dp(t_cpu, got, ref)


# ---------------------------------------------------------------------------
# the sketch kernel's edge store
# ---------------------------------------------------------------------------

SKETCH_EDGE_KS = (17, 23, 32)
SKETCH_EDGE_SEEDS = (1, 31, 32, 33, 60, 64, 65, 255, 256)
# position counts at which the kernel's work changes hands: a quarter of a
# tile, a tile (4,096 positions), and the 4 tiles that the blocks of one
# read take in one round (csrc/sketch.cu: TILE, SPLIT)
SKETCH_EDGE_TILES = (1024, 4096, 16384)


def sketch_edge_store(rng, k: int, empty_last: bool = False):
    """A packed store (bytes, byte offsets, lengths) of random reads at
    the edges of the sketch kernel's design: lengths 0, 1, k-1, k, k+1 and
    31, 32, 33 (below, at and above the pipeline's minimum length), one
    position short of, exactly at and one past each count of
    ``SKETCH_EDGE_TILES``, reads over two and five tiles, an empty read in
    the middle, and a last read that fills its last byte, sized so that
    the store's bytes are not a multiple of 8: the last k-mer's 64-bit
    window ends flush with the store. ``empty_last`` appends a read of
    length 0 at the store's end."""
    from nanospring_tpu_torch.io import packed as pk

    lens = [0, 1, k - 1, k, k + 1, 31, 32, 33, 57, 250]
    for tile in SKETCH_EDGE_TILES:
        lens += [tile + k - 2, tile + k - 1, tile + k]
    tile = SKETCH_EDGE_TILES[1]
    lens += [2 * tile + k + 1, 0, 5 * tile + k + 5, 2051]
    last = 4 * 75
    while (sum(-(-n // 4) for n in lens) + last // 4) % 8 == 0:
        last += 4
    lens.append(last)
    if empty_last:
        lens.append(0)
    parts = [pk.pack_codes(rng.integers(0, 4, n).astype(np.uint8))
             for n in lens]
    nbytes = np.array([len(p) for p in parts], np.int64)
    return (np.concatenate(parts).astype(np.uint8),
            np.concatenate([[0], np.cumsum(nbytes)[:-1]]).astype(np.int64),
            np.array(lens, np.int64))


def sketch_edge_parity(dev) -> int:
    """The sketch kernel against its plain version, bit for bit, on the
    edge store at every k of ``SKETCH_EDGE_KS`` and every seed count of
    ``SKETCH_EDGE_SEEDS`` with the pipeline's minimum length, and at 60
    seeds with the minimum length k; returns the number of cases, or
    fails."""
    import torch

    from nanospring_tpu_torch.ops import sketch as sk

    cases = 0
    for k in SKETCH_EDGE_KS:
        store = [torch.from_numpy(a).to(dev) for a in
                 sketch_edge_store(np.random.default_rng(2027 + k), k)]
        for n, min_len in [(n, max(k, 32)) for n in SKETCH_EDGE_SEEDS] \
                + [(60, k)]:
            seeds = torch.from_numpy(
                sk.make_seeds(n, 77 + n).astype(np.int64)).to(dev)
            got = sk.sketch_reads(*store, seeds, k, min_len)
            ref = sk.sketch_reads_plain(*store, seeds, k, min_len)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                bad = (got != ref).any(dim=1).nonzero()[:5, 0].tolist()
                fail(f"sketch edge store k={k}, {n} seeds, min_len "
                     f"{min_len}: differs from the plain version at reads "
                     f"{bad} (lengths {store[2][bad].tolist()})")
            short = store[2] < min_len
            if not bool((got[short] == -1).all()) or \
                    bool((got[~short] == -1).all(dim=1).any()):
                fail(f"sketch edge store k={k}, {n} seeds: EMPTY rows are "
                     f"not exactly the reads under {min_len} bases")
            cases += 1
    return cases


# ---------------------------------------------------------------------------
# the card's suffix sort (csrc/bwt_sa.cu) at the main path's block sizes
# ---------------------------------------------------------------------------

# the nsbwt blocks of one sa.device job as the device route writes them:
# the type stream (14,943,215 bytes) and the genome stream (8,213,874),
# each coded plain and as its LZP variant, and the codec's largest block
# (codec/backends.py: _CHUNK, 32 MB)
BWT_TYPE_BYTES = 14_943_215
BWT_GENOME_BYTES = 8_213_874
BWT_MAX_BYTES = 32 << 20
BWT_MIN_BYTES = 1 << 18          # native/codec.cpp: kCardSortMinBytes


def bwt_nck(n: int) -> int:
    """``code_block``'s inverse-BWT chain count (native/codec.cpp)."""
    return int(min(16, max(1, n >> 16)))


def type_like(rng, n: int) -> np.ndarray:
    """The type stream's shape (as an sa job's): edit tokens 'i', 'd', 's'
    at that stream's shares, a newline every ~1,350 bytes (one per read),
    and a 1.5 kb stretch from earlier every 50 kb, which LZP shortens, as
    it does that stream, by a few percent."""
    toks = np.frombuffer(b"ids", np.uint8)[
        rng.choice(3, n, p=[0.237, 0.215, 0.548])]
    toks[np.cumsum(rng.integers(700, 2000, n // 700))[:-1] % n] = ord("\n")
    for dst in range(100_000, n - 1_500, 50_000):
        src = int(rng.integers(0, dst - 1_500))
        toks[dst:dst + 1_500] = toks[src:src + 1_500]
    return toks


def genome_like(rng, n: int, rep: int = 20_000) -> np.ndarray:
    """Consensus-like codes 0-3 in which 20 kb stretches recur, exact and
    at 99% identity: the rounds that long repeats cost."""
    g = rng.integers(0, 4, n).astype(np.uint8)
    for dst in range(rep + 1000, n - rep, rep + 7_000):
        src = int(rng.integers(0, dst - rep))
        g[dst:dst + rep] = g[src:src + rep]
        mut = rng.random(rep) < (0.01 if dst % 2 else 0.0)
        g[dst:dst + rep][mut] ^= 1
    return g


def lzp_variant(block: np.ndarray) -> np.ndarray:
    """The block that ``ns_bsc_compress`` codes when LZP engages."""
    import ctypes

    from nanospring_tpu_torch import native

    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = np.empty(2 * len(block) + 16, np.uint8)
    m = native.get_lib().ns_lzp_encode(block.ctypes.data_as(u8p), len(block),
                                       out.ctypes.data_as(u8p))
    return out[:m].copy()


def sais_bwt(block: np.ndarray, nck: int) -> tuple:
    """SA-IS's BWT on the host (``ns_bwt_forward_host``): (BWT bytes,
    [primary] + checkpoints, ms)."""
    import ctypes

    from nanospring_tpu_torch import native

    u8p, u32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
    out = np.empty(len(block), np.uint8)
    ck = np.zeros(32, np.uint32)
    t0 = time.perf_counter()
    primary = native.get_lib().ns_bwt_forward_host(
        block.ctypes.data_as(u8p), len(block), out.ctypes.data_as(u8p), nck,
        ck.ctypes.data_as(u32p))
    ms = (time.perf_counter() - t0) * 1e3
    return out, [int(primary)] + [int(c) for c in ck[1:nck]], ms


def bwt_sa_blocks(rng) -> list:
    """(label, block) at the main path's sizes, plain and LZP variants."""
    t = type_like(rng, BWT_TYPE_BYTES)
    g = genome_like(rng, BWT_GENOME_BYTES)
    return [("type-like", t), ("type-like, LZP", lzp_variant(t)),
            ("genome-like", g), ("genome-like, LZP", lzp_variant(g)),
            ("genome-like, largest block", genome_like(rng, BWT_MAX_BYTES))]


def bwt_sa_parity(dev, blocks) -> list:
    """The card's suffix sort (``ops.bwt_sa.bwt_sa``) against its plain
    version on the card and SA-IS on the host, byte for byte (BWT,
    primary, every checkpoint), on each (label, block); returns per block
    the card's copy, its nck and the plain version's and SA-IS's ms."""
    import torch

    from nanospring_tpu_torch.ops import bwt_sa

    rows = []
    for label, b in blocks:
        nck = bwt_nck(len(b))
        x = torch.from_numpy(b).to(dev)
        bwt, info = bwt_sa.bwt_sa(x, nck)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        p_bwt, p_info = bwt_sa.bwt_sa_plain(x, nck)
        e.record()
        torch.cuda.synchronize()
        ref, ref_info, sais_ms = sais_bwt(b, nck)
        got = bwt.cpu().numpy()
        for side, (rb, ri) in (("its plain version", (p_bwt.cpu().numpy(),
                                                      p_info.cpu().tolist())),
                               ("SA-IS", (ref, ref_info))):
            if not np.array_equal(got, rb) or info.cpu().tolist() != ri:
                diff = np.flatnonzero(got != rb)[:5].tolist()
                fail(f"bwt_sa {label} ({len(b)} bytes) differs from {side}: "
                     f"BWT at {diff}, info {info.cpu().tolist()} against {ri}")
        rows.append({"label": label, "n": len(b), "x": x, "nck": nck,
                     "plain_ms": a.elapsed_time(e), "sais_ms": sais_ms})
        log(f"[parity] bwt_sa {label}: {len(b)} bytes, nck {nck}: BWT, "
            f"primary and checkpoints equal the plain version and SA-IS")
    return rows


def sketch_pass_split(store, cfg, dev) -> dict:
    """One sketch pass made as ``compute_all_sketches`` makes it (host
    arrays in pageable memory to the card, one kernel launch, the sketches
    back to the host), with a CUDA event between the parts: milliseconds
    of each."""
    import torch

    from nanospring_tpu_torch.ops import sketch as sk

    host = [np.ascontiguousarray(store.packed), store.offsets, store.lengths,
            sk.make_seeds(cfg.num_hashes, cfg.sketch_seed).astype(np.int64)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    on_card = [torch.from_numpy(a).to(dev) for a in host]
    ev[1].record()
    out = sk.sketch_reads(*on_card, cfg.kmer_size,
                          max(cfg.kmer_size, cfg.min_read_len_for_sketch))
    ev[2].record()
    res = sk.as_uint32(out)
    ev[3].record()
    torch.cuda.synchronize()
    return {"h2d_ms": ev[0].elapsed_time(ev[1]),
            "launch_ms": ev[1].elapsed_time(ev[2]),
            "d2h_ms": ev[2].elapsed_time(ev[3]),
            "host_wall_ms": (time.perf_counter() - t0) * 1e3,
            "h2d_bytes": int(sum(a.nbytes for a in host)),
            "d2h_bytes": int(res.nbytes)}


def dp_tensors(pairs, m_pad, dev, v1: bool = False):
    import torch

    from nanospring_tpu_torch.ops import align_tpu as at

    _order, bufs = at.build_buffers(*pairs, m_pad=m_pad,
                                    slots=at.W32 if v1 else at.W16)
    return {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}


def dp_args(t):
    return (t["d0"], t["q_len"], t["t_len"], t["max_cost"], t["tpad"],
            t["queries"])


def dp_bound_ms(rows: int, P: int, ops_s: float,
                cells: int = DP16_CELLS) -> tuple[float, str]:
    """Least time for a batch of P pairs and ``rows`` query rows: bytes
    (used target window, query, trace or records, 16 B of scalars in and
    out per pair) over HBM rate vs cells x ops over the int32 rate
    ``ops_s``. ``banded_dp16`` writes a 1-byte trace per row over 128
    cells, ``banded_dp32`` a 4-byte record per row over 256 cells."""
    rec = 1 if cells == DP16_CELLS else 4
    nbytes = (rows + cells * P) + rows + rec * rows + 32 * P
    ops = rows * cells * DP_OPS_PER_CELL
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / ops_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare_dp(t, got, ref) -> int:
    """Byte-compare kernel and plain outputs; returns max abs difference
    (0) or fails."""
    names = ("cost", "ops_len", "tstart", "tend")
    err = 0
    for name, g, r in zip(names, got[:4], ref[:4]):
        d = (g.long() - r.long()).abs().max().item() if g.numel() else 0
        err = max(err, d)
        if d:
            bad = (g != r).nonzero()[:5, 0].tolist()
            fail(f"DP {name} differs at pairs {bad}")
    m = t["q_len"].long()
    rows = (np.arange(got[4].shape[1])[None, :]
            < m.cpu().numpy()[:, None])
    g4 = got[4].cpu().numpy()
    r4 = ref[4].cpu().numpy()
    diff = (g4 != r4) & rows
    if diff.any():
        p = int(np.flatnonzero(diff.any(axis=1))[0])
        fail(f"DP trace differs: pair {p}, first row "
             f"{int(np.flatnonzero(diff[p])[0])}")
    return int(err)


def host_dp_verdicts(batches, al) -> dict:
    """The wavefront's kernel batches replayed on the exact C++ DP at band 128
    (``ns_banded_align``, the JAX package's ``aligner="python"`` DP), each
    pair's verdict against the v1 kernel's: accepts on each side, pairs
    only one side accepts, and cost disagreements where both accept. The
    host DP also rejects a pair whose row minimum passes 0.35 per row +
    240 (its divergence-slope abort, native/align.cpp); ``over_slope``
    counts the kernel-only accepts whose final cost alone passes that
    line."""
    out = dict(pairs=0, rows=0, kernel_accepts=0, host_accepts=0,
               kernel_only=0, host_only=0, cost_differs=0, over_slope=0,
               kernel_only_rows=0, kernel_only_cost=0, host_s=0.0)
    for a, kcost in batches:
        t0 = time.perf_counter()
        h = al.banded_align_batch(*a, band=128, use_native=True)
        out["host_s"] += time.perf_counter() - t0
        m = np.asarray(a[5], np.int64)
        k_ok, h_ok = kcost >= 0, h.cost >= 0
        only = k_ok & ~h_ok
        out["pairs"] += len(m)
        out["rows"] += int(m.sum())
        out["kernel_accepts"] += int(k_ok.sum())
        out["host_accepts"] += int(h_ok.sum())
        out["kernel_only"] += int(only.sum())
        out["host_only"] += int((h_ok & ~k_ok).sum())
        out["cost_differs"] += int((k_ok & h_ok & (kcost != h.cost)).sum())
        out["over_slope"] += int((only & (kcost > m * 7 // 20 + 240)).sum())
        out["kernel_only_rows"] += int(m[only].sum())
        out["kernel_only_cost"] += int(kcost[only].sum())
    return out


def bwt_sa_kernel_names() -> set:
    """The ``__global__`` functions of ``csrc/bwt_sa.cu``."""
    import re

    from nanospring_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda.CSRC, "bwt_sa.cu")) as f:
        return set(re.findall(r"__global__ void (\w+)\(", f.read()))


def device_times(prof) -> dict:
    """{kernel: (count, device ms)} from a torch.profiler run: the
    kernels of the port by name (``bwt_sa``: all of its kernels, one count
    per kernel launch), everything else on the card as 'other'."""
    import re

    from torch.autograd import DeviceType

    bwt = re.compile(r"\(anonymous namespace\)::(%s)\(" % "|".join(
        sorted(bwt_sa_kernel_names())))
    out: dict = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue                # host ops: their kernels count below
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us:
            continue
        key = ("banded_dp16" if "banded_dp16_kernel" in e.key
               else "banded_dp32" if "banded_dp32_kernel" in e.key
               else "sketch" if "sketch_kernel" in e.key
               else "bwt_sa" if bwt.match(e.key) else "other")
        c, t = out.get(key, (0, 0.0))
        out[key] = (c + (e.count if key != "other" else 0), t + us / 1e3)
    return out


# ---------------------------------------------------------------------------
# scale-out: ranks as subprocesses
# ---------------------------------------------------------------------------

# one rank of compress_mesh: the whole store in every rank
MESH_RANK = r"""
import json
import sys
import time

from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.io import read_store
from nanospring_tpu_torch.ops import align_tpu as at
from nanospring_tpu_torch.ops import bwt_sa
from nanospring_tpu_torch.ops import sketch as sk
from nanospring_tpu_torch.parallel import mesh
from nanospring_tpu_torch.parallel.pipeline import compress_mesh

fq, arc, world, rank, port, backend = sys.argv[1:7]
group = mesh.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                        device="cuda", backend=backend)
try:
    store = read_store.load_fastq(fq)
    t0 = time.perf_counter()
    res = compress_mesh(store, arc, CompressConfig(pipeline_workers=1), group)
    wall = time.perf_counter() - t0
finally:
    mesh.shutdown()
print("RANK " + json.dumps({
    "rank": int(rank), "wall_s": wall,
    "launches": {"sketch": sk.sketch_reads.launches,
                 "banded_dp16": at.banded_dp16.launches,
                 "bwt_sa": bwt_sa.bwt_sa.launches},
    "ratio": res["ratio"] if res else None,
    "pairs": res["pairs"] if res else None,
    "gathered_meta": res["gathered_meta"] if res else None}))
"""


def run_ranks(argvs, timeout: float) -> list[str]:
    """Run one rank per argv (``parallel.mesh.run_ranks``) from this
    checkout; fails unless every rank exited 0."""
    from nanospring_tpu_torch.parallel import mesh

    here = os.path.dirname(os.path.abspath(__file__))
    ranks = mesh.run_ranks(argvs, env={"PYTHONPATH": here}, timeout=timeout)
    for i, (rc, o) in enumerate(ranks):
        if rc != 0:
            fail(f"rank {i} exited {rc}:\n{o[-4000:]}")
    return [o for _, o in ranks]


def decodes_to(arc: str, reads, work: str) -> bool:
    from nanospring_tpu_torch import decompressor

    out = os.path.join(work, "scale.reads")
    decompressor.decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        return f.read().split(b"\n")[:-1] == reads


def single_host_pairs(host: np.ndarray, thr: int) -> np.ndarray:
    """The single-host join of (N, S) uint32 sketches: every ordered pair
    (q, r, shared slots), q != r, sorted by (q, r)."""
    from nanospring_tpu_torch.pipeline import candidates

    index = candidates.SketchIndex(host)
    parts = []
    for i in range(0, len(host), 4096):
        wq, wr, wc = index.query(host[i: i + 4096], thr)
        keep = wq + i != wr
        parts.append(np.stack([wq[keep] + i, wr[keep], wc[keep]], axis=1))
    return np.concatenate(parts)


def sketch_input_parity(store, fq: str, cfg, work: str, dev,
                        full) -> list[str]:
    """The sketch kernel at the inputs the scale-out path gives it, bit for
    bit against its plain version on the same tensors: each half of the
    rows through ``offsets[lo:hi]`` of the whole buffer (``compress_mesh``,
    two ranks) and each FASTQ shard's own spill store
    (``compress_distributed``, two ranks). The shards' sketches, in rank
    order, must also equal ``full``, the whole store's."""
    import torch

    from nanospring_tpu_torch.io import read_store
    from nanospring_tpu_torch.ops import sketch as sk
    from nanospring_tpu_torch.pipeline import contigs

    seeds = sk.make_seeds(cfg.num_hashes, cfg.sketch_seed).astype(np.int64)

    def check(st, lo, hi, label):
        got = contigs.sketch_rows(st, cfg, lo, hi)

        def t(a):
            return torch.from_numpy(np.array(a)).to(dev)

        ref = sk.sketch_reads_plain(
            t(st.packed), t(st.offsets[lo:hi]), t(st.lengths[lo:hi]),
            t(seeds), cfg.kmer_size,
            max(cfg.kmer_size, cfg.min_read_len_for_sketch), chunk=1 << 22)
        if got.shape != (hi - lo, cfg.num_hashes) or not torch.equal(got, ref):
            fail(f"(a) sketch of {label} differs from the plain version")
        return got

    N = store.num_reads
    half = -(-N // 2)
    done = []
    for lo, hi in ((0, half), (half, N)):
        check(store, lo, hi, f"rows [{lo}, {hi})")
        done.append(f"rows [{lo}, {hi})")
    shards = []
    for pid in range(2):
        wdir = os.path.join(work, f"shard_parity_{pid}")
        os.makedirs(wdir)
        st, n = read_store.load_fastq_shard(fq, pid, 2, wdir)
        shards.append(check(st, 0, n, f"FASTQ shard {pid}"))
        done.append(f"shard {pid} ({n} reads)")
    if not torch.equal(torch.cat(shards), full):
        fail("(a) the FASTQ shards' sketches differ from the whole store's")
    return done


def scale_out(store, reads, fq: str, work: str, dev, spec: dict,
              world: int = 2, backend: str = "gloo"):
    """Phase 6: (a) the sharded join on one NCCL rank against the
    single-host join, and the sketch kernel at the scale-out inputs; (b)
    the multi-process compress and (c) the mesh compress as ``world``
    ranks of ``backend``, on the headline set and on a set of two genomes.
    With ``world`` NCCL ranks (one card each), (a) is left out. Returns
    the two-genome set (its FASTQ path and reads)."""
    import torch

    from nanospring_tpu_torch.config import CompressConfig
    from nanospring_tpu_torch.ops import sketch as sk
    from nanospring_tpu_torch.parallel import mesh
    from nanospring_tpu_torch.parallel import sharded_join as sj
    from nanospring_tpu_torch.pipeline import contigs

    cfg = CompressConfig()
    thr = cfg.overlap_sketch_threshold
    if backend == "gloo":
        # (a) --------------------------------------------------------------
        t0 = time.time()
        group = mesh.initialize(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                                device="cuda")
        try:
            if group.backend != "nccl":
                fail(f"one-rank group on {group.backend}, not nccl")
            sk.sketch_reads.launches = 0
            sketches = contigs.sketch_rows(store, cfg)
            comm: dict = {}
            t1 = time.time()
            q, r, c = sj.gather_pairs(group, *sj.sharded_candidate_pairs(
                group, sketches, torch.arange(store.num_reads, device=dev),
                thr, comm=comm))
            join_s = time.time() - t1
            launches_a = sk.sketch_reads.launches
        finally:
            mesh.shutdown()
        want = single_host_pairs(sk.as_uint32(sketches), thr)
        same = (len(q) == len(want) and np.array_equal(q, want[:, 0])
                and np.array_equal(r, want[:, 1])
                and np.array_equal(c, want[:, 2]))
        log(f"[scale] (a) NCCL, one rank: {len(q)} pairs ({len(want)} single "
            f"host), equal {same}; sketch launches {launches_a}; join "
            f"{join_s:.2f} s, bytes {json.dumps(comm)}")
        if not same or len(q) == 0 or launches_a != 1:
            fail("(a) the one-rank NCCL join differs from the single-host join")
        done = sketch_input_parity(store, fq, cfg, work, dev, sketches)
        log(f"[scale] (a) sketch kernel bit-equal to its plain version at "
            f"the scale-out inputs: {', '.join(done)}; the shards' sketches "
            f"equal the whole store's; {time.time() - t0:.1f} s")
        del sketches
        torch.cuda.empty_cache()

    # (b), (c) on the headline set and on a set of two genomes ----------------
    from nanospring_tpu_torch.io import read_store

    fq2, reads2 = two_genome_set(work, spec)
    for label, fq_, reads_, growers in (("headline", fq, reads, 1),
                                        ("two genomes", fq2, reads2, 2)):
        bases = sum(len(x) for x in reads_)
        # each unordered pair that the single-host join finds, once
        st = store if fq_ == fq else read_store.load_fastq(fq_)
        host = sk.as_uint32(contigs.sketch_rows(st, cfg))
        w = single_host_pairs(host, thr)
        pairs = int((w[:, 0] < w[:, 1]).sum())
        run = (label, fq_, reads_, bases, work, world, backend, pairs,
               growers)
        dist_ranks(*run)
        mesh_ranks(*run)
    return fq2, reads2


def two_genome_set(work: str, spec: dict):
    """The headline set's shape from two genomes of half its length, half
    its reads each (seeds ``seed`` and ``seed + 1``): two overlap
    components, so two ranks each own one. The headline set is one
    component, which one rank grows alone."""
    from nanospring_tpu_torch.utils import synth

    half = dict(spec, genome_len=spec["genome_len"] // 2,
                num_reads=spec["num_reads"] // 2)
    reads = []
    for i in range(2):
        part = os.path.join(work, f"genome{i}.fastq")
        reads += synth.make_dataset(part, **dict(half, seed=spec["seed"] + i))
        os.unlink(part)
    fq = os.path.join(work, "two_genomes.fastq")
    synth.write_fastq(fq, reads, gz=False)
    return fq, reads


def check_ranks(step: str, label: str, launches: list, grew: list,
                pairs: int, want_pairs: int, growers: int) -> None:
    """Every rank launched the sketch, every rank that grew a component
    launched ``banded_dp16``, at least ``growers`` ranks grew, and the
    ranks kept as many pairs as the single-host join finds."""
    for rank, (kl, g) in enumerate(zip(launches, grew)):
        if kl["sketch"] <= 0 or (g and kl["banded_dp16"] <= 0):
            fail(f"({step}) {label}: rank {rank} never launched a kernel of "
                 f"its path: {kl} (grew: {g})")
    if sum(map(bool, grew)) < growers:
        fail(f"({step}) {label}: {sum(map(bool, grew))} rank(s) grew, "
             f"expected at least {growers}")
    if pairs != want_pairs:
        fail(f"({step}) {label}: {pairs} pairs, the single-host join has "
             f"{want_pairs}")


def dist_ranks(label, fq, reads, bases, work, world, backend, want_pairs,
               growers) -> None:
    """(b): ``python -m nanospring_tpu_torch.parallel.distributed`` as
    ``world`` ranks, with the device DP and one pipeline worker."""
    import pickle

    from nanospring_tpu_torch.parallel import mesh

    tag = f"{label.replace(' ', '_')}_{backend}{world}"
    arc = os.path.join(work, f"dist_{tag}.nstpu")
    wdir = os.path.join(work, f"dist_{tag}")
    os.makedirs(wdir)
    port = mesh.free_port()
    t0 = time.time()
    outs = run_ranks(
        [[sys.executable, "-m", "nanospring_tpu_torch.parallel.distributed",
          fq, arc, wdir, str(world), str(pid), str(port), "--device", "cuda",
          "--backend", backend, "--aligner", "device", "--workers", "1"]
         for pid in range(world)], timeout=600)
    wall = time.time() - t0
    if "distributed compress ok" not in outs[0]:
        fail(f"(b) {label}: rank 0 wrote no archive:\n{outs[0][-2000:]}")
    lossless = decodes_to(arc, reads, work)
    evs = []
    for pid in range(world):
        with open(os.path.join(wdir, f"mem_{pid}.pkl"), "rb") as f:
            evs.append(pickle.load(f))
    pairs = sum(ev["local_pairs"] for ev in evs)
    log(f"[scale] (b) distributed, {label}, {world} {backend} ranks: ratio "
        f"{bases / os.path.getsize(arc):.4f}, wall {wall:.2f} s (all ranks, "
        f"start to exit), lossless {lossless}, {pairs} pairs (single host "
        f"{want_pairs})")
    for pid, ev in enumerate(evs):
        mem = {k: ev[k] for k in (
            "local_shard_bytes", "gathered_bytes", "full_packed_bytes",
            "local_pairs", "owned_edges", "label_allgather_rounds")}
        log(f"[scale] (b) {label}, rank {pid}: phase_times "
            f"{json.dumps(ev['phase_times'])} | comm_bytes "
            f"{json.dumps(ev['comm_bytes'])} | memory {json.dumps(mem)} | "
            f"launches {json.dumps(ev['kernel_launches'])}")
    check_ranks("b", label, [ev["kernel_launches"] for ev in evs],
                [ev["owned_edges"] > 0 for ev in evs], pairs, want_pairs,
                growers)
    if not lossless:
        fail(f"(b) {label}: the archive does not decode to the input")


def mesh_ranks(label, fq, reads, bases, work, world, backend, want_pairs,
               growers) -> None:
    """(c): ``compress_mesh`` as ``world`` ranks; the same checks as
    (b)."""
    from nanospring_tpu_torch.parallel import mesh

    tag = f"{label.replace(' ', '_')}_{backend}{world}"
    arc = os.path.join(work, f"mesh_{tag}.nstpu")
    port = mesh.free_port()
    t0 = time.time()
    outs = run_ranks(
        [[sys.executable, "-c", MESH_RANK, fq, arc, str(world), str(pid),
          str(port), backend] for pid in range(world)], timeout=600)
    wall = time.time() - t0
    ranks = sorted((json.loads(ln[len("RANK "):]) for o in outs
                    for ln in o.splitlines() if ln.startswith("RANK ")),
                   key=lambda x: x["rank"])
    if [x["rank"] for x in ranks] != list(range(world)):
        fail(f"(c) {label}: {len(ranks)} of {world} ranks reported")
    lossless = decodes_to(arc, reads, work)
    log(f"[scale] (c) compress_mesh, {label}, {world} {backend} ranks: "
        f"ratio {bases / os.path.getsize(arc):.4f}, wall {wall:.2f} s (all "
        f"ranks, start to exit), lossless {lossless}; per rank "
        f"{json.dumps(ranks)}")
    meta = ranks[0]["gathered_meta"]        # (contigs, reads, bases) per rank
    check_ranks("c", label, [x["launches"] for x in ranks],
                [meta[x["rank"]][1] > 0 for x in ranks], ranks[0]["pairs"],
                want_pairs, growers)
    if not lossless:
        fail(f"(c) {label}: the archive does not decode to the input")


# ---------------------------------------------------------------------------
# phase 4 (d), phase 7 and --big: the default aligner's probe, grow workers
# on one card, the low-memory store
# ---------------------------------------------------------------------------

class CardMemory:
    """The card's used memory (MiB, ``nvidia-smi``) before a block and its
    largest sample while the block runs (every 0.2 s, from a thread)."""

    def __init__(self):
        self.before = self.peak = 0
        self._stop = threading.Event()

    @staticmethod
    def used_mib() -> int:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
        return int(out.split()[0])

    def _poll(self):
        while not self._stop.wait(0.2):
            self.peak = max(self.peak, self.used_mib())

    def __enter__(self):
        self.before = self.peak = self.used_mib()
        self._th = threading.Thread(target=self._poll, daemon=True)
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()


def auto_phase(fq: str, reads, arc_native: str, work: str,
               small: bool) -> None:
    """Phase 4 (d): ``aligner="auto"`` on the headline set, the first
    probe-mode run in this process (the engine caches its verdict per
    process and kernel shape)."""
    from nanospring_tpu_torch import compressor
    from nanospring_tpu_torch.config import CompressConfig
    from nanospring_tpu_torch.ops import align_tpu as at
    from nanospring_tpu_torch.ops import bwt_sa

    arc = os.path.join(work, "headline_auto.nstpu")
    at.banded_dp16.launches = 0
    bwt_sa.bwt_sa.launches = 0
    res = compressor.compress_file(
        fq, arc, CompressConfig(aligner="auto", pipeline_workers=1),
        report=False)
    launches = at.banded_dp16.launches
    dpi = res["dp_info"]
    lossless = decodes_to(arc, reads, work)
    with open(arc, "rb") as f, open(arc_native, "rb") as g:
        same = f.read() == g.read()
    log(f"[main] auto: verdict {dpi['dp_backend']}, probe batch on the card "
        f"{dpi['dp_probe_device_s']:.4f} s, on the host "
        f"{dpi['dp_probe_native_s']:.4f} s; {dpi['dp_hook_batches']} hook "
        f"batches, {launches} banded_dp16 launches, "
        f"{bwt_sa.bwt_sa.launches} bwt_sa launches; ratio "
        f"{res['ratio']:.4f}, compress {res['wall_s']:.2f} s, lossless "
        f"{lossless}, byte-equal to the native archive {same}")
    log(f"[main] auto stages {json.dumps(res['stage_s'])} | pipe split "
        f"{json.dumps(res['pipe_split'])}")
    # the small set is under the probe's 2e7-base gate
    if not small and (dpi["dp_hook_batches"] < 2 or launches < 2):
        fail(f"auto: {dpi['dp_hook_batches']} hook batches and {launches} "
             "launches, not the warm-up and the probe on the card")
    if not lossless:
        fail("auto archive does not decode to the input")
    if dpi["dp_backend"] == "native" and not same:
        fail("auto chose the native DP but its archive differs from the "
             "native archive")


def workers_phase(fq: str, reads, work: str) -> None:
    """Phase 7: the two-genome set with the device DP at 1, 2 and the
    default number of grow workers, every one of them on the one card."""
    import torch

    from nanospring_tpu_torch import compressor
    from nanospring_tpu_torch.config import CompressConfig
    from nanospring_tpu_torch.ops import bwt_sa

    for w in (1, 2, 0):
        cfg = CompressConfig(aligner="device", pipeline_workers=w)
        arc = os.path.join(work, f"workers_{w}.nstpu")
        torch.cuda.reset_peak_memory_stats()
        bwt_sa.bwt_sa.launches = 0      # the codec runs in this process
        with CardMemory() as mem:
            res = compressor.compress_file(fq, arc, cfg, report=False)
        dpi = res["dp_info"]
        lossless = decodes_to(arc, reads, work)
        procs = dpi["grow_workers"]
        where = "this process" if procs == 1 else "processes"
        log(f"[workers] pipeline_workers={w} (resolves to "
            f"{cfg.resolved_workers()}): {procs} grow {where}, "
            f"{dpi['dp_workers_launched']} launched banded_dp16 "
            f"({dpi['dp_kernel_launches']} launches), bwt_sa launches "
            f"{bwt_sa.bwt_sa.launches}; compress "
            f"{res['wall_s']:.2f} s, ratio {res['ratio']:.4f}, lossless "
            f"{lossless}; largest max_memory_allocated of a grow process "
            f"{dpi['dp_worker_peak_bytes']} B; card memory used "
            f"{mem.before} MiB before, {mem.peak} MiB at most during")
        log(f"[workers] pipeline_workers={w} pipe split "
            f"{json.dumps(res['pipe_split'])}")
        if not lossless:
            fail(f"pipeline_workers={w}: the archive does not decode to the "
                 "input")
        if dpi["dp_workers_launched"] != procs or procs < (1 if w == 1
                                                             else 2):
            fail(f"pipeline_workers={w}: {dpi['dp_workers_launched']} of "
                 f"{procs} grow processes launched banded_dp16")


BIG_BASES = 1.2e9
BIG_MEAN_LEN = 5_000

# one compress of --big's set in a process of its own: the result, the
# process's peak RSS and its grow workers' (ru_maxrss, KiB on Linux); its
# report prints each stage's wall and the RSS at its end to stderr
BIG_COMPRESS = r"""
import json, resource, sys, time
import torch
from nanospring_tpu_torch import compressor
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.ops import bwt_sa
from nanospring_tpu_torch.utils.observe import rss_gb

fq, arc, aligner, work = sys.argv[1:5]
rss_imports = rss_gb()      # torch's libraries, before any work
t0 = time.perf_counter()
res = compressor.compress_file(fq, arc, CompressConfig(aligner=aligner,
                                                       work_dir=work))
wall = time.perf_counter() - t0
print("BIG " + json.dumps({
    "wall_s": wall, "ratio": res["ratio"], "low_mem": res["low_mem"],
    "num_reads": res["num_reads"], "total_bases": res["total_bases"],
    "stage_s": res["stage_s"], "dp_info": res["dp_info"],
    "pipe_split": res["pipe_split"], "rss_imports_gb": rss_imports,
    "bwt_sa_launches": bwt_sa.bwt_sa.launches,
    "rss_kib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
    "workers_rss_kib":
        resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss}))
"""

BIG_DECOMPRESS = r"""
import json, resource, sys, time
from nanospring_tpu_torch.config import DecompressConfig
from nanospring_tpu_torch.decompressor import decompress_file

arc, out, gb, work = sys.argv[1:5]
t0 = time.perf_counter()
res = decompress_file(arc, out, DecompressConfig(memory_gb=float(gb),
                                                 work_dir=work),
                      report=False)
print("BIG " + json.dumps({
    "wall_s": time.perf_counter() - t0, "stage_s": res["stage_s"],
    "rss_kib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}))
"""


def run_big_child(argv: list, label: str, env: dict | None = None) -> dict:
    """Run one of --big's child scripts (``env`` added to this process's
    environment); its ``BIG`` line, with the ``[nstpu]`` stage lines of
    its stderr under ``stage_lines``."""
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c"] + argv, capture_output=True,
                       text=True,
                       env=dict(os.environ, PYTHONPATH=here, **(env or {})))
    if r.returncode != 0:
        fail(f"{label} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
             f"{r.stderr[-4000:]}")
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("BIG ")]
    out = json.loads(line[-1][4:])
    out["stage_lines"] = [ln for ln in r.stderr.splitlines()
                          if ln.startswith("[nstpu]") and "rss" in ln]
    return out


def seq_digest(path: str, fastq: bool) -> tuple:
    """(sha256, lines, longest line) of a FASTQ's sequence lines or of a
    reads file, streamed."""
    import hashlib

    h = hashlib.sha256()
    n = longest = 0
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            if not fastq or i % 4 == 1:
                h.update(line)
                n += 1
                longest = max(longest, len(line.rstrip(b"\n")))
    return h.hexdigest(), n, longest


def big_sketch_parity(fq: str, work: str, dev) -> str:
    """--big's sketch input: the set's spill-backed store goes to the card
    in ``contigs.STAGE_BYTES`` chunks through the pinned staging buffer
    (``packed_on_device``). That buffer must equal a whole copy of the
    spill map, and ``sketch_rows`` on it, every row, must equal the plain
    version on the whole copy bit for bit."""
    import torch

    from nanospring_tpu_torch.config import CompressConfig
    from nanospring_tpu_torch.io import read_store
    from nanospring_tpu_torch.ops import sketch as sk
    from nanospring_tpu_torch.pipeline import contigs

    cfg = CompressConfig(device=dev.type)
    store = read_store.load_fastq(fq, low_mem=True, work_dir=work)
    try:
        packed = np.asarray(store.packed)
        if packed.flags["WRITEABLE"]:
            fail("--big's store is not a read-only spill map")
        chunks = -(-len(packed) // contigs.STAGE_BYTES)
        whole = torch.from_numpy(np.array(packed)).to(dev)
        if not torch.equal(contigs.packed_on_device(packed, dev), whole):
            fail(f"the spill map's {chunks} chunks on the card differ from "
                 "a whole copy")
        t0 = time.time()
        got = contigs.sketch_rows(store, cfg)
        torch.cuda.synchronize()
        t1 = time.time()

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        seeds = sk.make_seeds(cfg.num_hashes, cfg.sketch_seed)
        ref = sk.sketch_reads_plain(
            whole, t(store.offsets), t(store.lengths),
            t(seeds.astype(np.int64)), cfg.kmer_size,
            max(cfg.kmer_size, cfg.min_read_len_for_sketch), chunk=1 << 22)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            bad = (got != ref).any(dim=1).nonzero()[:5, 0].tolist()
            fail(f"--big's sketch differs from the plain version at reads "
                 f"{bad}")
        return (f"{store.num_reads} reads, {len(packed)} packed bytes in "
                f"{chunks} chunks of {contigs.STAGE_BYTES}: bit-equal "
                f"(sketch_rows {t1 - t0:.2f} s, plain "
                f"{time.time() - t1:.2f} s)")
    finally:
        store.cleanup()


DP_REPLAY_PAIRS = 32


def replay_dp_batch(path: str) -> dict:
    """One hook batch kept by ``NSTPU_DP_RECORD`` (inputs, and outputs as
    the hook copied them back from the card) replayed on
    ``banded_dp16_plain`` on the CPU. Pairs are independent, so up to
    ``DP_REPLAY_PAIRS`` of them, the longest query among them, are
    replayed; their cost, tstart, tend and trace rows must equal the
    batch's. Runs in a worker process; returns what it compared and the
    first difference, if any."""
    import torch

    from nanospring_tpu_torch.ops import align_tpu as at

    torch.set_num_threads(1)
    b = np.load(path)
    q_len = b["q_len"]
    P = len(q_len)
    pick = np.unique(np.concatenate([
        np.linspace(0, P - 1, min(P, DP_REPLAY_PAIRS - 1)).astype(np.int64),
        [int(np.argmax(q_len))]]))
    m = int(q_len[pick].max())
    t0 = time.time()

    def t(k, cols=None):
        a = b[k][pick] if cols is None else b[k][pick, :cols]
        return torch.from_numpy(np.ascontiguousarray(a))

    got = at.banded_dp16_plain(
        t("d0"), t("q_len"), t("t_len"), t("max_cost"), t("tpad", m + 128),
        t("queries", m))
    bad = None
    for name, i in (("cost", 0), ("tstart", 2), ("tend", 3)):
        want = b[{"cost": "cost", "tstart": "ts", "tend": "te"}[name]][pick]
        diff = np.flatnonzero(got[i].numpy() != want)
        if len(diff) and bad is None:
            bad = f"{name} at pair {int(pick[diff[0]])}"
    rows = np.arange(m)[None, :] < q_len[pick][:, None]
    diff = (got[4].numpy() != b["trace"][pick, :m]) & rows
    if diff.any() and bad is None:
        p = int(np.flatnonzero(diff.any(axis=1))[0])
        bad = (f"trace at pair {int(pick[p])}, row "
               f"{int(np.flatnonzero(diff[p])[0])}")
    return {"batch": os.path.basename(path), "m_cap": int(b["m_cap"]),
            "pairs": P, "rows": int(b["tpad"].shape[1]) - 128,
            "replayed": len(pick), "longest": m,
            "accepted": int((b["cost"][pick] >= 0).sum()),
            "plain_s": round(time.time() - t0, 1), "differs": bad}


def big_run(work: str, dev, pool) -> None:
    """``--big``: one set over 2 GiB through the low-memory store."""
    num_reads = int(BIG_BASES / BIG_MEAN_LEN)
    genome_len = int(BIG_BASES / 24)
    fq = os.path.join(work, "big.fastq")
    t0 = time.time()
    here = os.path.dirname(os.path.abspath(__file__))
    # made in a process of its own, which alone holds the whole read list
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from nanospring_tpu_torch.utils import synth; "
         "synth.make_dataset(sys.argv[1], genome_len=int(sys.argv[2]), "
         "num_reads=int(sys.argv[3]), mean_len=int(sys.argv[4]), seed=99, "
         "p_n_base=0.0005, realistic=True)",
         fq, str(genome_len), str(num_reads), str(BIG_MEAN_LEN)],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=here))
    if r.returncode != 0:
        fail(f"synth exited {r.returncode}: {r.stderr[-2000:]}")
    in_bytes = os.path.getsize(fq)
    want = seq_digest(fq, fastq=True)
    log(f"[big] {num_reads} reads (genome {genome_len}), longest read "
        f"{want[2]}, {in_bytes} input bytes, made and digested in "
        f"{time.time() - t0:.1f} s")
    if in_bytes <= 2 << 30:
        fail(f"the --big input has {in_bytes} bytes, not over 2 GiB")
    t0 = time.time()
    log(f"[big] sketch of the spill map vs the plain version: "
        f"{big_sketch_parity(fq, work, dev)} ({time.time() - t0:.1f} s)")
    record = os.path.join(work, "dp_record")
    os.makedirs(record)
    replays = []
    for aligner in ("device", "auto"):
        arc = os.path.join(work, f"big_{aligner}.nstpu")
        # the device run keeps its grow processes' first hook batches
        c = run_big_child([BIG_COMPRESS, fq, arc, aligner, work],
                          f"compress ({aligner})",
                          env={"NSTPU_DP_RECORD": record}
                          if aligner == "device" else None)
        dpi = c["dp_info"]
        rss = c["rss_kib"] * 1024
        log(f"[big] {aligner}: ratio {c['ratio']:.4f}, compress "
            f"{c['wall_s']:.2f} s, low_mem {c['low_mem']}, "
            f"{c['total_bases']} bases; peak RSS {rss} B "
            f"({rss / in_bytes:.4f} of the input), its child processes' "
            f"largest {c['workers_rss_kib'] * 1024} B; sketch launches "
            f"{dpi['sketch_kernel_launches']}, bwt_sa launches "
            f"{c['bwt_sa_launches']} (card bytes "
            f"{c['stage_s'].get('bwt_card_bytes', 0)}), banded_dp16 launches "
            f"{dpi['dp_kernel_launches']} in {dpi['grow_workers']} grow "
            f"processes ({dpi['dp_workers_launched']} launched), hook "
            f"M_CAP {dpi['dp_hook_m_cap']}, card memory of a grow process "
            f"{dpi['dp_worker_peak_bytes']} B")
        if aligner == "auto":
            log(f"[big] auto: verdict {dpi['dp_backend']}, probe batch on "
                f"the card {dpi['dp_probe_device_s']:.4f} s, on the host "
                f"{dpi['dp_probe_native_s']:.4f} s (summed over "
                f"{dpi['dp_probe_device_workers']} device and "
                f"{dpi['dp_probe_native_workers']} native verdicts)")
        log(f"[big] {aligner} stages {json.dumps(c['stage_s'])} | pipe split "
            f"{json.dumps(c['pipe_split'])}")
        log(f"[big] {aligner}, RSS after the imports "
            f"{c['rss_imports_gb']:.3f} GB; at each stage's end: "
            f"{' | '.join(c['stage_lines'])}")
        if not c["low_mem"]:
            fail("the low-memory store did not switch on by itself")
        if dpi["sketch_kernel_launches"] != 1:
            fail(f"{dpi['sketch_kernel_launches']} sketch launches, not 1")
        if c["bwt_sa_launches"] <= 0:
            fail("no bwt_sa launch: the low-memory store's archive was "
                 "sorted on the host")
        if aligner == "device":
            if dpi["dp_kernel_launches"] <= 0:
                fail("no banded_dp16 launch on the device route")
            # each grow process's first and largest hook batches,
            # replayed on the plain version beside the next runs, the
            # largest first
            kept = sorted(os.listdir(record), key=lambda f: "first" in f)
            pids = {f.split("_")[1] for f in kept}
            if len(pids) != dpi["dp_workers_launched"]:
                fail(f"hook batches kept by {len(pids)} grow processes, "
                     f"{dpi['dp_workers_launched']} launched banded_dp16")
            m_cap = dpi["dp_hook_m_cap"]
            replays = [pool.submit(replay_dp_batch, os.path.join(record, f))
                       for f in kept]
        for gb in (5.0, 1.0):
            out = os.path.join(work, "big.reads")
            d = run_big_child([BIG_DECOMPRESS, arc, out, str(gb), work],
                              f"decompress ({aligner}, -m {gb:g})")
            got = seq_digest(out, fastq=False)
            os.unlink(out)
            lossless = got == want
            drss = d["rss_kib"] * 1024
            log(f"[big] {aligner}, decompress -m {gb:g}: {d['wall_s']:.2f} "
                f"s, peak RSS {drss} B ({drss / in_bytes:.4f} of the "
                f"input), lossless {lossless}; stages "
                f"{json.dumps(d['stage_s'])}")
            if not lossless:
                fail(f"{aligner}: -m {gb:g} does not decode to the input")
        os.unlink(arc)
    for fut in replays:
        r = fut.result()
        log(f"[big] device run's hook batch on banded_dp16_plain: "
            f"{json.dumps(r)}")
        if r["differs"] or r["m_cap"] != m_cap:
            fail(f"hook batch {r['batch']}: {r['differs']} (M_CAP "
                 f"{r['m_cap']})")


# ---------------------------------------------------------------------------

def hs1_phase(work: str) -> None:
    """One job of the benchmark's ``hs1`` configuration (~9.6% error) on
    the card through ``compress_file``, as its cell runs it: the recovery
    pass must run, the job must decode to its input and retry band rejects
    on the host; the k=17 sketch rows of 256 reads drawn from a seed and
    of the longest read must equal ``benchmark/reference.py``'s, and the
    pairs the candidate graph was built from must equal
    ``benchmark/reference_join.py``'s, worked out from the job's own rows
    of both passes."""
    from nanospring_tpu_torch import compressor
    from nanospring_tpu_torch.config import CompressConfig
    from nanospring_tpu_torch.pipeline import contigs

    bench = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "benchmark")
    sys.path.insert(0, bench)
    import gen
    import reference
    import reference_join

    with open(os.path.join(bench, "configs", "hs1.json")) as f:
        config = json.load(f)
    t0 = time.time()
    d = os.path.join(work, "hs1")
    os.makedirs(d, exist_ok=True)
    info = gen.write_run(config, 2_718_281_829, d, 64, workers=4)
    fq = os.path.join(d, "reads.fastq")
    reads = reference.fastq_reads(fq)
    N = len(reads)
    log(f"[hs1] data: {N} reads, {info['bases']} bases, longest "
        f"{info['longest']} in {time.time() - t0:.1f} s")

    rows: dict = {}
    graphs: list = []
    orig_sketch, orig_graph = (contigs.compute_all_sketches,
                               contigs._build_candidate_graph)

    def compute_all_sketches(store, cfg, report=False):
        out = orig_sketch(store, cfg, report)
        rows[cfg.kmer_size] = np.array(out)
        return out

    def build_graph(*a, **kw):
        graphs.append(orig_graph(*a, **kw))
        return graphs[-1]

    cfg = CompressConfig(**config["compress"])
    arc = os.path.join(d, "hs1.nstpu")
    contigs.compute_all_sketches = compute_all_sketches
    contigs._build_candidate_graph = build_graph
    try:
        t0 = time.time()
        res = compressor.compress_file(fq, arc, cfg, report=False)
        wall = time.time() - t0
    finally:
        contigs.compute_all_sketches = orig_sketch
        contigs._build_candidate_graph = orig_graph
    ps, ss, dpi = res["pipe_split"], res["stage_s"], res["dp_info"]
    log(f"[hs1] job {wall:.2f} s, ratio {res['ratio']:.4f}; join pairs "
        f"first {ps['join_pairs_first']:.0f}, kept {ps['join_pairs_kept']:.0f}"
        f", buckets over the cap {ps['capped_buckets']:.0f} (reads "
        f"{ps['capped_reads']:.0f}), resketch_fired "
        f"{ps['resketch_fired']:.0f}, graph.resketch "
        f"{ss.get('graph.resketch', 0):.3f} s of sketch_join "
        f"{ps['sketch_join']:.3f} s; DP pairs {ps['dp_pairs']:.0f}, rejects "
        f"{ps['dp_rejects']:.0f}, escaped {dpi['dp_escaped_pairs']}, "
        f"host-routed long {dpi['host_routed_long_pairs']}; retries "
        f"{ps['retry_pairs']:.0f}, accepted "
        f"{ps['retry_accepted']:.0f}, {ps['retry_dp_s']:.3f} s; no chain "
        f"{ps['nochain_pairs']:.0f}, stitch failures "
        f"{ps['stitchfail_pairs']:.0f}; lone "
        f"{100 * ss['lone_bases'] / info['bases']:.2f}% of the bases; "
        f"stages " + " ".join(f"{k} {v:.2f}" for k, v in ss.items()
                              if k in ("load_reads", "pipeline", "serialize",
                                       "codec+archive")))
    if not decodes_to(arc, reads, work):
        fail("[hs1] the archive does not decode to the input")
    if ps["resketch_fired"] != 1 or not ps["join_pairs_first"] < 1.5 * N:
        fail("[hs1] the recovery pass did not run")
    if sorted(rows) != [17, 23]:
        fail(f"[hs1] sketch passes at k = {sorted(rows)}, expected 17 and 23")
    if ps["retry_pairs"] <= 0:
        fail("[hs1] no band reject was retried on the host")

    t0 = time.time()
    rng = np.random.default_rng(2_718_281_829)
    ids = np.unique(np.r_[rng.choice(N, 256, replace=False),
                          int(np.argmax([len(r) for r in reads]))])
    seeds = reference.sketch_seeds(cfg.num_hashes, cfg.sketch_seed)
    min_len = max(17, cfg.min_read_len_for_sketch)
    wrong_rows = sum(
        not np.array_equal(reference.sketch_read(reads[i], 17, seeds,
                                                 min_len), rows[17][i])
        for i in ids.tolist())
    ref = reference_join.graph_pairs(lambda k: rows[k], N, cfg.kmer_size,
                                     cfg.overlap_sketch_threshold,
                                     cfg.max_bucket)
    g = graphs[-1]
    got = np.stack([np.repeat(np.arange(N), np.diff(g["adj_off"])),
                    g["dst"]])
    want = np.concatenate([np.stack([ref["q"], ref["r"]]),
                           np.stack([ref["r"], ref["q"]])], axis=1)
    got = got[:, np.lexsort(got[::-1])]
    want = want[:, np.lexsort(want[::-1])]
    same = got.shape == want.shape and bool(np.array_equal(got, want))
    log(f"[hs1] k=17 rows: {wrong_rows} of {len(ids)} differ from the "
        f"reference; graph pairs: {got.shape[1]} ({len(ref['q'])} ordered "
        f"of k={ref['k']}), reference fired {ref['fired']}, first "
        f"{ref['first']}; equal {same}; check {time.time() - t0:.1f} s")
    if wrong_rows or not same or not ref["fired"] \
            or ref["first"] != ps["join_pairs_first"]:
        fail("[hs1] the k=17 rows or the graph's pairs differ from the "
             "plain reference")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="small dataset and batches (quick first check)")
    ap.add_argument("--nccl-ranks", type=int, default=0, metavar="N",
                    help="run only phase 6's (b) and (c), as N NCCL ranks "
                    "on N cards")
    ap.add_argument("--big", action="store_true",
                    help="after the build, only a set over 2 GiB (the "
                    "low-memory store), device and auto")
    ap.add_argument("--hs1", action="store_true",
                    help="after the build, only phase 8: one job of the "
                    "benchmark's hs1 configuration")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False: this smoke test "
            "needs an NVIDIA GPU")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import nanospring_tpu_torch  # noqa: F401 - fails outside the repo

    dev = torch.device("cuda")
    t_start = time.time()
    # the pool's workers are stopped when this block ends, however it ends
    with tempfile.TemporaryDirectory(prefix="nstpu_smoke_") as work, \
            ProcessPoolExecutor(2, mp_context=get_context("spawn")) as pool:
        return _run(args, dev, work, t_start, pool)


def _run(args, dev, work: str, t_start: float, pool) -> int:
    import torch

    from nanospring_tpu_torch import compressor, decompressor, native
    from nanospring_tpu_torch.config import CompressConfig
    from nanospring_tpu_torch.io import read_store
    from nanospring_tpu_torch.ops import _cuda
    from nanospring_tpu_torch.ops import align as al
    from nanospring_tpu_torch.ops import align_tpu as at
    from nanospring_tpu_torch.ops import bwt_sa
    from nanospring_tpu_torch.ops import sketch as sk
    from nanospring_tpu_torch.utils import synth

    # 1. device ------------------------------------------------------------
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    mhz = max_sm_mhz()
    ops_s = int32_ops_s(mhz)
    log(f"[device] {smi} | torch: {name} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | max SM clock {mhz:.0f} MHz | int32 "
        f"peak {ops_s / 1e12:.2f} T op/s")

    # 2. build -------------------------------------------------------------
    t0 = time.time()
    errs: list = []

    def _bg(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    th = threading.Thread(target=_bg, args=(native.get_lib,))
    th.start()
    _bg(lambda: _cuda.build(verbose=True))
    th.join()
    if errs:
        fail(f"build: {errs[0]!r}")
    _cuda.get_lib()
    log(f"[build] native + CUDA kernels in {time.time() - t0:.1f} s")

    if args.big or args.hs1:
        t0 = time.time()
        if args.big:
            big_run(work, dev, pool)
        else:
            hs1_phase(work)
        log(f"[{'big' if args.big else 'hs1'}] {time.time() - t0:.1f} s")
        log(f"[done] {time.time() - t_start:.1f} s")
        print(nvidia_smi(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # dataset --------------------------------------------------------------
    fq = os.path.join(work, "headline.fastq")
    t0 = time.time()
    spec = SMALL if args.small else HEADLINE
    reads = synth.make_dataset(fq, **spec)
    total = sum(len(r) for r in reads)
    log(f"[data] {len(reads)} reads, {total} bases in "
        f"{time.time() - t0:.1f} s")
    if not args.small and total != ANCHOR_BASES:
        fail(f"headline set has {total} bases, expected {ANCHOR_BASES}")

    if args.nccl_ranks:
        # the scale-out path alone, one NCCL rank per card
        if torch.cuda.device_count() < args.nccl_ranks:
            fail(f"--nccl-ranks {args.nccl_ranks} needs as many cards, "
                 f"found {torch.cuda.device_count()}")
        t0 = time.time()
        scale_out(read_store.load_fastq(fq), reads, fq, work, dev, spec,
                  world=args.nccl_ranks, backend="nccl")
        log(f"[scale] phase {time.time() - t0:.1f} s")
        log(f"[done] {time.time() - t_start:.1f} s")
        print(nvidia_smi(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. parity ------------------------------------------------------------
    # the DP edge batch's plain versions start now on the host, one worker
    # process each, and are collected after the batches below
    edge = edge_pairs(np.random.default_rng(2026))
    edge_refs = {v1: pool.submit(edge_plain, edge, v1) for v1 in (False, True)}
    store = read_store.load_fastq(fq)
    cfg0 = CompressConfig()
    seeds = torch.from_numpy(
        sk.make_seeds(cfg0.num_hashes, cfg0.sketch_seed).astype(np.int64)
    ).to(dev)
    packed = torch.from_numpy(np.ascontiguousarray(store.packed)).to(dev)
    offsets = torch.from_numpy(store.offsets).to(dev)
    lengths = torch.from_numpy(store.lengths).to(dev)
    min_len = cfg0.min_read_len_for_sketch
    sk_plain_ms = None
    sk_err = 0
    for k in (23, 17):
        sargs = (packed, offsets, lengths, seeds, k, max(k, min_len))
        got = sk.sketch_reads(*sargs)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = sk.sketch_reads_plain(*sargs, chunk=1 << 22)
        b.record()
        torch.cuda.synchronize()
        if k == 23:
            sk_plain_ms = a.elapsed_time(b)
        sk_err = max(sk_err, int((got.long() - ref.long()).abs().max()))
        if not torch.equal(got, ref):
            bad = (got != ref).any(dim=1).nonzero()[:5, 0].tolist()
            fail(f"sketch k={k} differs from the plain version at reads "
                 f"{bad}")
        empty = int((got == -1).all(dim=1).sum())
        log(f"[parity] sketch k={k}: {store.num_reads} reads bit-equal "
            f"({empty} empty)")

    t0 = time.time()
    n_edge = sketch_edge_parity(dev)
    log(f"[parity] sketch edge store: {n_edge} cases (k in "
        f"{list(SKETCH_EDGE_KS)}, seeds in {list(SKETCH_EDGE_SEEDS)}, "
        f"minimum length k and max(k, 32)) bit-equal "
        f"({time.time() - t0:.1f} s)")

    rng = np.random.default_rng(2024)
    dp_rows = {}
    dp_err = 0
    for label, pairs, m_pad in dp_batches(rng, args.small):
        t = dp_tensors(pairs, m_pad, dev)
        got = at.banded_dp16(*dp_args(t))
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = at.banded_dp16_plain(*dp_args(t))
        b.record()
        torch.cuda.synchronize()
        dp_err = max(dp_err, compare_dp(t, got, ref))
        cost = got[0]
        rows = (torch.arange(got[4].shape[1], device=dev)[None, :]
                < t["q_len"][:, None])
        esc = int((((got[4] == 255) & rows).any(dim=1) & (cost >= 0)).sum())
        log(f"[parity] DP {label}: {t['d0'].numel()} pairs, longest "
            f"{int(t['q_len'].max())} rows, {int((cost >= 0).sum())} "
            f"accepted, {esc} escaped: byte-equal")
        dp_rows[label] = (t, a.elapsed_time(b))
        if label.startswith("v2"):
            res = at.banded_align_batch_16(*pairs, device="cuda")
            nat = al.banded_align_batch(*pairs, band=63, use_native=True)
            if not np.array_equal(res.cost, nat.cost):
                fail("DP costs differ from ns_banded_align(W=63)")
            log("[parity] DP v2 batch: costs equal ns_banded_align(W=63)")

    rng32 = np.random.default_rng(2025)
    dp32_rows = {}
    dp32_err = 0
    for label, pairs in dp32_batches(rng32, args.small):
        t = dp_tensors(pairs, None, dev, v1=True)
        got = at.banded_dp32(*dp_args(t))
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = at.banded_dp32_plain(*dp_args(t))
        b.record()
        torch.cuda.synchronize()
        dp32_err = max(dp32_err, compare_dp(t, got, ref))
        log(f"[parity] DP {label}: {t['d0'].numel()} pairs, longest "
            f"{int(t['q_len'].max())} rows, {int((got[0] >= 0).sum())} "
            f"accepted: byte-equal")
        dp32_rows[label] = (t, a.elapsed_time(b))
        if label.startswith("v1 (<="):
            res = at.banded_align_batch_32(*pairs, device="cuda")
            nat = al.banded_align_batch(*pairs, band=128, use_native=True)
            if not np.array_equal(res.cost, nat.cost):
                fail("v1 DP costs differ from ns_banded_align(band 128)")
            log("[parity] DP v1 batch: costs equal ns_banded_align(band 128)")

    for kname, kern, v1 in (("banded_dp16", at.banded_dp16, False),
                            ("banded_dp32", at.banded_dp32, True)):
        t0 = time.time()
        ref, plain_s = edge_refs[v1].result()
        got, err = edge_parity(kern, ref, edge, dev, v1)
        cost, tr = got[0], got[4]
        rows = (torch.arange(tr.shape[1])[None, :]
                < torch.from_numpy(np.sort(edge[5])[::-1].copy())[:, None])
        esc = int((((tr == 255) & rows).any(dim=1) & (cost >= 0)).sum())
        log(f"[parity] DP edge batch, {kname}: {cost.numel()} pairs, longest "
            f"{int(edge[5].max())} rows, {int((cost >= 0).sum())} accepted, "
            f"{int((cost < 0).sum())} rejected, {esc} escaped: byte-equal "
            f"(plain version {plain_s:.1f} s in its worker; here "
            f"{time.time() - t0:.1f} s)")
        if int((cost < 0).sum()) != 1 or (not v1 and esc < 1):
            fail(f"{kname} edge batch: not one rejected pair, or no escape")
        if v1:
            dp32_err = max(dp32_err, err)
        else:
            dp_err = max(dp_err, err)

    t0 = time.time()
    bwt_rows = bwt_sa_parity(dev, bwt_sa_blocks(np.random.default_rng(2028)))
    log(f"[parity] bwt_sa: {len(bwt_rows)} blocks ({time.time() - t0:.1f} s)")

    # 4. main path ---------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    arc = os.path.join(work, "headline.nstpu")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sk.sketch_reads.launches = 0
        at.banded_dp16.launches = 0
        bwt_sa.bwt_sa.launches = 0
        res = compressor.compress_file(
            fq, arc, CompressConfig(aligner="device", pipeline_workers=1),
            report=False)
        launches = {"sketch": sk.sketch_reads.launches,
                    "banded_dp16": at.banded_dp16.launches,
                    "bwt_sa": bwt_sa.bwt_sa.launches}
    prof_ms = device_times(prof)
    busy_ms = sum(v[1] for v in prof_ms.values())
    log(f"[main] profiler, device time by kernel (count, ms): "
        f"{json.dumps(prof_ms)}; device busy {busy_ms:.1f} ms of {res['wall_s'] * 1e3:.0f} ms "
        f"compress wall ({busy_ms / (res['wall_s'] * 1e3):.4f})")
    dpi = res["dp_info"]
    out = os.path.join(work, "headline.reads")
    dres_t0 = time.time()
    decompressor.decompress_file(arc, out, report=False)
    dec_s = time.time() - dres_t0
    with open(out, "rb") as f:
        lossless = f.read().split(b"\n")[:-1] == reads
    esc_share = dpi["dp_escaped_pairs"] / max(dpi["dp_kernel_pairs"], 1)
    log(f"[main] device DP: ratio {res['ratio']:.4f}, compress "
        f"{res['wall_s']:.2f} s, decompress {dec_s:.2f} s, lossless "
        f"{lossless}")
    log(f"[main] stages {json.dumps(res['stage_s'])}")
    log(f"[main] pipe split {json.dumps(res['pipe_split'])}")
    log(f"[main] dp_info {json.dumps(dpi)} | launches {json.dumps(launches)}"
        f" | escape share {esc_share:.4f}")
    if not lossless:
        fail("device-DP archive does not decode to the input")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if res["stage_s"].get("bwt_card_bytes", 0) <= 0:
        fail("the main path sorted no nsbwt block on the card")
    if dpi["dp_kernel_pairs"] <= 0:
        fail("no pair went to the DP kernel")
    if dpi["host_routed_long_pairs"] != 0:
        fail(f"{dpi['host_routed_long_pairs']} pairs were host-routed")

    arc_n = os.path.join(work, "headline_native.nstpu")
    bwt_sa.bwt_sa.launches = 0
    res_n = compressor.compress_file(
        fq, arc_n, CompressConfig(aligner="native", pipeline_workers=1),
        report=False)
    decompressor.decompress_file(arc_n, out, report=False)
    with open(out, "rb") as f:
        lossless_n = f.read().split(b"\n")[:-1] == reads
    log(f"[main] native DP: ratio {res_n['ratio']:.4f} (anchor "
        f"{ANCHOR_RATIO}), compress {res_n['wall_s']:.2f} s, lossless "
        f"{lossless_n}, bwt_sa launches {bwt_sa.bwt_sa.launches}")
    log(f"[main] native stages {json.dumps(res_n['stage_s'])} | pipe split "
        f"{json.dumps(res_n['pipe_split'])}")
    if not lossless_n:
        fail("native-DP archive does not decode to the input")
    if not args.small and round(res_n["ratio"], 2) != ANCHOR_RATIO:
        fail(f"native-DP ratio {res_n['ratio']:.4f} is not the anchor "
             f"{ANCHOR_RATIO}")
    auto_phase(fq, reads, arc_n, work, args.small)

    arc_w = os.path.join(work, "headline_wavefront.nstpu")
    # keep each wavefront batch and its costs, to replay them on the host
    # DP after the run
    batches_w = []
    batch32 = at.banded_align_batch_32

    def recording(*a, **kw):
        r = batch32(*a, **kw)
        batches_w.append((a, r.cost))
        return r

    at.banded_align_batch_32 = recording
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_w:
            sk.sketch_reads.launches = 0
            at.banded_dp16.launches = 0
            at.banded_dp32.launches = 0
            bwt_sa.bwt_sa.launches = 0
            res_w = compressor.compress_file(
                fq, arc_w,
                CompressConfig(aligner="python", pipeline_workers=1),
                report=False)
            launches_w = {"sketch": sk.sketch_reads.launches,
                          "banded_dp16": at.banded_dp16.launches,
                          "banded_dp32": at.banded_dp32.launches,
                          "bwt_sa": bwt_sa.bwt_sa.launches}
    finally:
        at.banded_align_batch_32 = batch32
    prof_w_ms = device_times(prof_w)
    busy_w = sum(v[1] for v in prof_w_ms.values())
    wall_w = res_w["wall_s"] * 1e3
    log(f"[main] wavefront profiler, device time by kernel (count, ms): "
        f"{json.dumps(prof_w_ms)}; device busy {busy_w:.1f} ms of "
        f"{wall_w:.0f} ms compress wall ({busy_w / wall_w:.4f})")
    dpi_w = res_w["dp_info"]
    decompressor.decompress_file(arc_w, out, report=False)
    with open(out, "rb") as f:
        lossless_w = f.read().split(b"\n")[:-1] == reads
    log(f"[main] wavefront + v1 DP: ratio {res_w['ratio']:.4f}, compress "
        f"{res_w['wall_s']:.2f} s, lossless {lossless_w}")
    log(f"[main] wavefront stages {json.dumps(res_w['stage_s'])} | pipe "
        f"split {json.dumps(res_w['pipe_split'])}")
    log(f"[main] wavefront dp_info {json.dumps(dpi_w)} | launches "
        f"{json.dumps(launches_w)}")
    if not lossless_w:
        fail("wavefront archive does not decode to the input")
    if min(launches_w["sketch"], launches_w["banded_dp32"],
           launches_w["bwt_sa"]) <= 0:
        fail(f"a kernel of the wavefront path never launched: {launches_w}")
    if dpi_w["dp_kernel_launches"] != launches_w["banded_dp32"]:
        fail("the wavefront's launch count disagrees with banded_dp32's")
    # the reference's route rule: batches up to M_PAD_MAX rows take the
    # kernel, one launch each; longer ones the host DP
    longest_w = [int(np.max(a[5])) for a, _ in batches_w]
    if len(longest_w) != launches_w["banded_dp32"] or \
            max(longest_w, default=0) > at.M_PAD_MAX:
        fail(f"{launches_w['banded_dp32']} banded_dp32 launches for "
             f"{len(longest_w)} batches up to {at.M_PAD_MAX} rows")
    if not args.small and dpi_w["host_routed_long_pairs"] <= 0:
        fail("no wavefront batch went to the host DP")
    log(f"[main] wavefront route: {len(longest_w)} batches up to "
        f"{at.M_PAD_MAX} rows on banded_dp32, "
        f"{dpi_w['host_routed_long_pairs']} pairs "
        f"({dpi_w['host_routed_long_rows']} rows) on the host DP")
    log(f"[main] wavefront batches vs the host DP: "
        f"{json.dumps(host_dp_verdicts(batches_w, al))}")
    del batches_w

    # 5. times -------------------------------------------------------------
    k = cfg0.kmer_size
    sargs = (packed, offsets, lengths, seeds, k, max(k, min_len))
    sk_ms = timed(lambda: sk.sketch_reads(*sargs), reps=20, warm=2)
    n_pos = int(torch.clamp(lengths - k + 1, min=0)[
        lengths >= max(k, min_len)].sum())
    sk_bytes = packed.numel() + 16 * lengths.numel() + \
        4 * lengths.numel() * seeds.shape[0]
    # per (k-mer, seed): a multiply, a multiply-add and one minimum.
    # The multiplies alone fill the SM's 64 multiply lanes; the minima go
    # to another pipe beside them, so the multiplies are the least time
    # (all 4 operations counted through those 64 lanes give twice that, a
    # time the kernel runs under: no bound).
    sk_ops = n_pos * seeds.shape[0] * SKETCH_MULS_PER_HASH
    tb, to = sk_bytes / HBM_BYTES_S * 1e3, sk_ops / ops_s * 1e3
    kernels = [{
        "name": "sketch", "route": "cuda",
        "source": "nanospring_tpu_torch/csrc/sketch.cu",
        "replaces": "nanospring_tpu/ops/sketch.py:138",
        "launches": launches["sketch"], "max_abs_err": sk_err,
        "ms": sk_ms, "plain_ms": sk_plain_ms,
        "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to
        else "operations", "library_ms": None,
    }]
    log(f"[time] sketch: {sk_ms:.4f} ms per launch ({store.num_reads} "
        f"reads, {n_pos} k-mers), plain {sk_plain_ms:.1f} ms, bound "
        f"{max(tb, to):.4f} ms (the multiplies; {2 * to:.4f} ms if all 4 "
        f"operations per k-mer and seed went through the same 64 lanes)")
    split = sketch_pass_split(store, cfg0, dev)
    log(f"[time] sketch pass as the pipeline makes it: "
        f"{json.dumps(split)}; sketch_join stage of the device-DP run "
        f"{res['pipe_split'].get('sketch_join', float('nan')):.4f} s")
    for label, (t, plain_ms) in dp_rows.items():
        ms = timed(lambda: at.banded_dp16(*dp_args(t)), reps=5, warm=1)
        bms, bby = dp_bound_ms(int(t["q_len"].sum()), t["d0"].numel(),
                               ops_s)
        log(f"[time] banded_dp16 {label}: {ms:.3f} ms per batch of "
            f"{t['d0'].numel()} pairs ({int(t['q_len'].sum())} rows, "
            f"{cycles_per_row(ms, int(t['q_len'].max()), mhz):.0f} cycles "
            f"per longest-query row), plain {plain_ms:.1f} ms, bound "
            f"{bms:.4f} ms ({bby})")
    # the main path's mean batch: its pair count, with query lengths drawn
    # from the dataset's reads (the hook's M_CAP row capacity)
    n_b = max(1, round(dpi["dp_kernel_pairs"] / max(dpi["dp_hook_batches"],
                                                    1)))
    lens = rng.choice(store.lengths[store.lengths >= 32], n_b)
    m_cap = 1 << (int(store.lengths.max()) - 1).bit_length()
    t = dp_tensors(make_pairs(rng, lens), m_cap, dev)
    ms = timed(lambda: at.banded_dp16(*dp_args(t)), reps=10, warm=2)
    got = at.banded_dp16(*dp_args(t))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = at.banded_dp16_plain(*dp_args(t))
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    dp_err = max(dp_err, compare_dp(t, got, ref))
    bms, bby = dp_bound_ms(int(t["q_len"].sum()), n_b, ops_s)
    log(f"[time] banded_dp16 main-path batch: {ms:.3f} ms per batch of "
        f"{n_b} pairs ({int(t['q_len'].sum())} rows, longest "
        f"{int(t['q_len'].max())}, "
        f"{cycles_per_row(ms, int(t['q_len'].max()), mhz):.0f} cycles per "
        f"longest-query row), plain {plain_ms:.1f} ms, bound {bms:.4f} ms "
        f"({bby})")
    launches16 = max(launches["banded_dp16"], 1)
    rows_per_launch = dpi["dp_kernel_rows"] / launches16
    longest_per_launch = dpi["dp_kernel_longest_rows"] / launches16
    pbms, pbby = dp_bound_ms(int(rows_per_launch), n_b, ops_s)
    if "banded_dp16" in prof_ms:
        cnt, tot = prof_ms["banded_dp16"]
        per = tot / max(cnt, 1)
        log(f"[time] banded_dp16 in the main path (profiler): {cnt} "
            f"launches, {tot:.1f} ms in all, {per:.3f} ms per launch, "
            f"{rows_per_launch:.0f} rows and {longest_per_launch:.0f} "
            f"longest-query rows per launch, "
            f"{cycles_per_row(per, longest_per_launch, mhz):.0f} cycles per "
            f"longest-query row at {mhz:.0f} MHz, bound {pbms:.4f} ms "
            f"({pbby})")
    kernels.append({
        "name": "banded_dp16", "route": "cuda",
        "source": "nanospring_tpu_torch/csrc/banded_dp16.cu",
        "replaces": "nanospring_tpu/ops/align_tpu.py:1202",
        "launches": launches["banded_dp16"], "max_abs_err": dp_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
        "bound_by": bby, "library_ms": None,
    })
    for label, (t, p_ms) in dp32_rows.items():
        ms32 = timed(lambda: at.banded_dp32(*dp_args(t)), reps=3, warm=1)
        bms32, bby32 = dp_bound_ms(int(t["q_len"].sum()), t["d0"].numel(),
                                   ops_s, DP32_CELLS)
        log(f"[time] banded_dp32 {label}: {ms32:.3f} ms per batch of "
            f"{t['d0'].numel()} pairs ({int(t['q_len'].sum())} rows, "
            f"{cycles_per_row(ms32, int(t['q_len'].max()), mhz):.0f} cycles "
            f"per longest-query row), plain {p_ms:.1f} ms, bound "
            f"{bms32:.4f} ms ({bby32})")
    # the wavefront's mean kernel batch: its pair count, with query lengths
    # drawn from the dataset's reads up to the route's M_PAD_MAX rows
    n_w = max(1, round(dpi_w["dp_kernel_pairs"]
                       / max(dpi_w["dp_kernel_launches"], 1)))
    lens = rng32.choice(store.lengths[(store.lengths >= 32)
                                      & (store.lengths <= at.M_PAD_MAX)], n_w)
    t = dp_tensors(make_pairs(rng32, lens), None, dev, v1=True)
    ms32 = timed(lambda: at.banded_dp32(*dp_args(t)), reps=10, warm=2)
    got = at.banded_dp32(*dp_args(t))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    ref = at.banded_dp32_plain(*dp_args(t))
    b.record()
    torch.cuda.synchronize()
    plain32_ms = a.elapsed_time(b)
    dp32_err = max(dp32_err, compare_dp(t, got, ref))
    bms32, bby32 = dp_bound_ms(int(t["q_len"].sum()), n_w, ops_s, DP32_CELLS)
    log(f"[time] banded_dp32 wavefront mean batch: {ms32:.3f} ms per batch "
        f"of {n_w} pairs ({int(t['q_len'].sum())} rows, longest "
        f"{int(t['q_len'].max())}, "
        f"{cycles_per_row(ms32, int(t['q_len'].max()), mhz):.0f} cycles per "
        f"longest-query row), plain {plain32_ms:.1f} ms, bound "
        f"{bms32:.4f} ms ({bby32})")
    launches32 = max(launches_w["banded_dp32"], 1)
    rows_w = dpi_w["dp_kernel_rows"] / launches32
    pbms, pbby = dp_bound_ms(int(rows_w), n_w, ops_s, DP32_CELLS)
    if "banded_dp32" in prof_w_ms:
        cnt, tot = prof_w_ms["banded_dp32"]
        per = tot / max(cnt, 1)
        longest32 = dpi_w["dp_kernel_longest_rows"] / launches32
        log(f"[time] banded_dp32 in the wavefront run (profiler): {cnt} "
            f"launches, {tot:.1f} ms in all, {per:.3f} ms per launch, "
            f"{rows_w:.0f} rows and {longest32:.0f} longest-query rows per "
            f"launch, {cycles_per_row(per, longest32, mhz):.0f} cycles per "
            f"longest-query row at {mhz:.0f} MHz, bound {pbms:.4f} ms "
            f"({pbby})")
    kernels.append({
        "name": "banded_dp32", "route": "cuda",
        "source": "nanospring_tpu_torch/csrc/banded_dp32.cu",
        "replaces": "nanospring_tpu/ops/align_tpu.py:60",
        "launches": launches_w["banded_dp32"], "max_abs_err": dp32_err,
        "ms": ms32, "plain_ms": plain32_ms, "bound_ms": bms32,
        "bound_by": bby32, "library_ms": None,
    })

    for r in bwt_rows:
        ms_b = timed(lambda: bwt_sa.bwt_sa(r["x"], r["nck"]), reps=3, warm=1)
        r["ms"] = ms_b
        r["bound_ms"] = 2 * r["n"] / HBM_BYTES_S * 1e3   # n in, n out
        log(f"[time] bwt_sa {r['label']}: {r['n']} bytes, {ms_b:.3f} ms per "
            f"launcher call (its rounds and their syncs), plain "
            f"{r['plain_ms']:.1f} ms, SA-IS on the host {r['sais_ms']:.1f} "
            f"ms, bound {r['bound_ms']:.4f} ms (bytes)")
    if "bwt_sa" in prof_ms:
        cnt, tot = prof_ms["bwt_sa"]
        log(f"[time] bwt_sa in the main path (profiler): "
            f"{launches['bwt_sa']} launcher calls, {cnt} kernel launches, "
            f"{tot:.1f} ms of device time in all, "
            f"{res['stage_s']['bwt_card_bytes']} bytes sorted on the card, "
            f"{res['stage_s'].get('bwt_host_bytes', 0)} on the host")
    main_b = bwt_rows[0]                 # the type stream's size
    kernels.append({
        "name": "bwt_sa", "route": "cuda",
        "source": "nanospring_tpu_torch/csrc/bwt_sa.cu",
        "replaces": "nanospring_tpu_torch/native/codec.cpp:bwt_forward_host "
                    "(SA-IS on the host; no TPU kernel)",
        "launches": launches["bwt_sa"], "max_abs_err": 0,
        "ms": main_b["ms"], "plain_ms": main_b["plain_ms"],
        "host_ms": main_b["sais_ms"], "bound_ms": main_b["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
    })

    # 6. scale-out ---------------------------------------------------------
    t0 = time.time()
    fq2, reads2 = scale_out(store, reads, fq, work, dev, spec)
    log(f"[scale] phase {time.time() - t0:.1f} s")

    # 7. workers on one card -------------------------------------------------
    torch.cuda.empty_cache()
    t0 = time.time()
    workers_phase(fq2, reads2, work)
    log(f"[workers] phase {time.time() - t0:.1f} s")

    # 8. the hs1 configuration ---------------------------------------------
    if not args.small:
        t0 = time.time()
        hs1_phase(work)
        log(f"[hs1] phase {time.time() - t0:.1f} s")
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
