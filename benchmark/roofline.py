"""The card's peaks and the work that a kernel's roofline share counts.

Peaks of one NVIDIA H100 SXM (80 GB HBM3): HBM at 3.35 TB/s (NVIDIA's
data sheet) and 32-bit integer work at 16.73 T op/s (132 SMs x 64 INT32
lanes x 1,980 MHz, the card's highest SM clock). Work is counted from what
the inputs need: each input byte read once, each output byte written once,
and the operations the function needs, whatever the kernel does again.
"""

from __future__ import annotations

import numpy as np

PEAKS = {"NVIDIA H100 80GB HBM3": {"int32_ops_per_s": 132 * 64 * 1.980e9,
                                   "hbm_bytes_per_s": 3.35e12}}

DP16_BAND = 128          # band cells per query row of banded_dp16
DP16_OPS_PER_CELL = 8    # integer operations per band cell
DP16_PAIR_IN = 4 * 4     # d0, q_len, t_len, max_cost (int32)
DP16_PAIR_OUT = 3 * 4    # cost, tstart, tend (int32)


def kmers(lengths: np.ndarray, k: int, min_len: int) -> int:
    """k-mers of the reads that the sketch covers (those of at least
    ``max(k, min_len)`` bases)."""
    lengths = np.asarray(lengths, np.int64)
    return int(np.where(lengths >= max(k, min_len), lengths - k + 1, 0).sum())


def sketch_bound_s(n_kmers: int, n_reads: int, n_bases: int, n_seeds: int,
                   peaks: dict) -> float:
    """The least time of one sketch of a store: 2 multiplies per (k-mer,
    seed) against the packed bases read once (2 bits a base) and the
    (reads, seeds) uint32 rows written once."""
    ops = 2.0 * n_kmers * n_seeds
    bytes_ = n_bases / 4.0 + 4.0 * n_reads * n_seeds
    return max(ops / peaks["int32_ops_per_s"],
               bytes_ / peaks["hbm_bytes_per_s"])


def dp16_bound_s(rows: int, pairs: int, peaks: dict) -> float:
    """The least time of the banded DP over ``pairs`` pairs of ``rows``
    query rows in all: 8 operations per band cell against the target and
    query bytes read once (a pair's target window is its rows plus the
    band), the trace byte per row and three int32 per pair written once."""
    ops = float(rows) * DP16_BAND * DP16_OPS_PER_CELL
    bytes_ = (2.0 * rows + pairs * (DP16_BAND + DP16_PAIR_IN) + rows
              + pairs * DP16_PAIR_OUT)
    return max(ops / peaks["int32_ops_per_s"],
               bytes_ / peaks["hbm_bytes_per_s"])
