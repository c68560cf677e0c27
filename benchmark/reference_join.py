"""The plain reference of the candidate graph's pairs and its recovery rule.

Plain NumPy, like ``reference.py``: it imports nothing of the program and
is written from the rule the compressor states, not from its code.

- ``join_pairs``: from MinHash rows (one row of ``num_hashes`` slots per
  read), the ordered pairs (q, r), q != r, of reads that share a value in
  at least ``threshold`` slots. Per slot the reads are grouped by value; a
  group whose value is ``EMPTY`` (a read too short to sketch) or that
  holds more than ``max_bucket`` reads (a repetitive k-mer) counts for no
  pair. Sorted by (q, r).
- ``graph_pairs``: the join with the recovery rule for sparse graphs.
  Where the first join gives fewer than 1.5 pairs per read (pairs x 2 <
  3N, the pairs counted ordered, both ways) and k > 17, the reads are
  sketched again at k = 17 and joined at the threshold
  max(3, threshold // 2); the second pairs are kept only where there are
  more of them. The caller gives the rows at each k, so that the same
  function judges rows that the program made (on the card) and rows that
  ``reference.sketch_read`` works out from the bases (``sketch_all``).

Departures from the program: none in the pairs. The program's join keeps
a count of shared slots per pair and its drop counters; this reference
returns neither.
"""

from __future__ import annotations

import numpy as np

import reference

EMPTY = reference.EMPTY
RECOVERY_K = 17
MIN_THRESHOLD = 3


def join_pairs(rows: np.ndarray, threshold: int,
               max_bucket: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Ordered candidate pairs (q, r) of ``rows`` ((N, n) uint32), sorted
    by (q, r)."""
    rows = np.asarray(rows, np.uint32)
    N, n = rows.shape
    keys = []
    for j in range(n):
        vals = rows[:, j]
        order = np.argsort(vals, kind="stable")
        sv = vals[order]
        starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
        sizes = np.diff(np.r_[starts, N])
        ok = (sv[starts] != EMPTY) & (sizes >= 2) & (sizes <= max_bucket)
        for s, b in zip(starts[ok].tolist(), sizes[ok].tolist()):
            ids = order[s:s + b].astype(np.int64)
            q = np.repeat(ids, b)
            r = np.tile(ids, b)
            keep = q != r
            keys.append(q[keep] * N + r[keep])
    if not keys:
        z = np.zeros(0, np.int64)
        return z, z
    uk, counts = np.unique(np.concatenate(keys), return_counts=True)
    uk = uk[counts >= threshold]
    return uk // N, uk % N


def graph_pairs(rows_at, num_reads: int, k: int, threshold: int,
                max_bucket: int = 256) -> dict:
    """The pairs the candidate graph is built from. ``rows_at(k)`` gives
    the (N, n) uint32 rows of every read at k-mer length k. Returns
    ``q``, ``r``, ``first`` (pairs of the first pass), ``fired`` (the
    second pass ran) and ``k`` (the k of the pairs kept)."""
    q, r = join_pairs(rows_at(k), threshold, max_bucket)
    first = len(q)
    fired = bool(num_reads and first * 2 < 3 * num_reads and k > RECOVERY_K)
    kept_k = k
    if fired:
        q2, r2 = join_pairs(rows_at(RECOVERY_K),
                            max(MIN_THRESHOLD, threshold // 2), max_bucket)
        if len(q2) > len(q):
            q, r, kept_k = q2, r2, RECOVERY_K
    return {"q": q, "r": r, "first": first, "fired": fired, "k": kept_k}


def sketch_all(reads: list, k: int, num_hashes: int, seed: int,
               min_len: int) -> np.ndarray:
    """``reference.sketch_read`` of every read: (N, n) uint32."""
    seeds = reference.sketch_seeds(num_hashes, seed)
    out = np.empty((len(reads), num_hashes), np.uint32)
    for i, read in enumerate(reads):
        out[i] = reference.sketch_read(read, k, seeds, max(k, min_len))
    return out
