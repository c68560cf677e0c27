"""The plain reference that decides a run's ``correct``.

Plain NumPy, written from the functions that the port's kernels state in
their headers, and from the benchmark's own inputs: it imports nothing of
the program and takes nothing that the program made. The judges:

- ``restored_mismatches``: the restored reads against the generated FASTQ,
  read by read and in order (the compressor's lossless guarantee);
- ``sketch_rows``: the MinHash sketch of a read from its bases (the sketch
  layer's function: canonical k-mers split as hi = first k - 16 bases,
  lo = last 16, y = fmix32(lo), z = fmix32(hi ^ y),
  h_j = y * (a_j | 1) + z * (b_j | 1) mod 2^32, the minimum per seed);
- ``banded_dp16``: the banded edit DP with a byte trace, W = 63, of the
  engine's device batches (the function stated in ``csrc/banded_dp16.cu``),
  and ``dp_input_faults``: those batches' inputs against the generated
  reads.
"""

from __future__ import annotations

import numpy as np

EMPTY = np.uint32(0xFFFFFFFF)
BASE_CODE = np.zeros(256, np.uint8)
BASE_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
ASCII_OF = np.frombuffer(b"ACGT", np.uint8)


def fastq_reads(path: str) -> list[bytes]:
    """A FASTQ file's sequence lines, in order."""
    with open(path, "rb") as f:
        return f.read().split(b"\n")[1::4]


def restored_mismatches(restored_path: str, reads: list[bytes]) -> int:
    """Reads that the restored file (one read per line, in input order)
    does not give back byte for byte; a missing or extra line counts as a
    wrong read."""
    with open(restored_path, "rb") as f:
        got = f.read().split(b"\n")
    if got and got[-1] == b"":
        got.pop()
    wrong = sum(1 for a, b in zip(got, reads) if a != b)
    return wrong + abs(len(got) - len(reads))


# --- the sketch ----------------------------------------------------------

def sketch_seeds(num_hashes: int, seed: int) -> np.ndarray:
    """(n, 2) uint32 hash seeds, drawn as the compressor's configuration
    defines them (``default_rng(sketch_seed)``, integers in [1, 2^32))."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**32, size=(num_hashes, 2), dtype=np.uint32)


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def sketch_read(read: bytes | np.ndarray, k: int, seeds: np.ndarray,
                min_len: int, bits: int = 32) -> np.ndarray:
    """The sketch of one read (ASCII ACGT): (n,) uint32, all ``EMPTY``
    for a read shorter than ``max(k, min_len)``. ``bits=16`` is the
    control's arithmetic."""
    c = BASE_CODE[np.frombuffer(bytes(read), np.uint8)].astype(np.uint32)
    n_seeds = len(seeds)
    L = len(c)
    if L < max(k, min_len):
        return np.full(n_seeds, EMPTY, np.uint32)
    npos = L - k + 1
    h = k - 16
    four = np.uint32(4)
    fhi = np.zeros(npos, np.uint32)
    flo = np.zeros(npos, np.uint32)
    rhi = np.zeros(npos, np.uint32)
    rlo = np.zeros(npos, np.uint32)
    for j in range(k):
        cj = c[j:j + npos]
        if j < h:
            fhi = fhi * four + cj
        else:
            flo = flo * four + cj
        if j < 16:
            rlo |= (np.uint32(3) - cj) << np.uint32(2 * j)
        else:
            rhi |= (np.uint32(3) - cj) << np.uint32(2 * (j - 16))
    fwd = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    lo = np.where(fwd, flo, rlo)
    hi = np.where(fwd, fhi, rhi)
    y = _fmix32(lo)
    z = _fmix32(hi ^ y)
    a = seeds[:, 0] | np.uint32(1)
    b = seeds[:, 1] | np.uint32(1)
    if bits == 16:
        y, z, a, b = (x.astype(np.uint16) for x in (y, z, a, b))
    step = max(1, (1 << 22) // n_seeds)
    best = np.full(n_seeds, EMPTY, np.uint32)
    for p in range(0, npos, step):
        hv = y[p:p + step, None] * a[None, :] + z[p:p + step, None] * b[None, :]
        np.minimum(best, hv.min(axis=0), out=best)
    return best


# --- the banded DP ------------------------------------------------------

W = 128           # band slots
KOFF = 64         # slot k <-> target column j = d0 + i + k - 64
INF = 0x3FFF      # escape sentinel of the 16-bit DP
BIG = 1 << 20     # an invalid final slot
ESC = 255


def banded_dp16(d0, q_len, t_len, max_cost, tpad: list, queries: list,
                inf: int = INF):
    """The DP of a group of pairs, each given by its scalars and its
    ``tpad`` (at least q_len + 128 bytes, ``tpad[x] = t[x + d0 - 65]``) and
    query bytes. Returns cost, tstart, tend (int64 (P,); cost -1 for a
    rejected pair, whose tstart and tend are 0) and each pair's trace as
    uint8 rows [0, q_len).

    Row 0: every valid slot 0. Row i: diag = prev[k] + mismatch, up =
    prev[k + 1] + 1 (k < 127), base = their minimum, then the left chain
    cur = min(base, k + prefixmin(base - k)), INF on invalid slots (slot 0,
    columns outside [0, n]); the direction code is 0/4 (diag,
    mismatch/match), 1 (up), 2 (left), 3 (INF). The best is the lowest
    valid final slot; the traceback walks back from it, each row's byte
    op2 << 6 | dels, or 255 where dels > 62 or no slot qualifies.

    Values at or above INF all mean INF: each row is capped once, and a
    slot of column -1 holds INF in the row before, so the diagonal into
    column 0 needs no test of its own. The forward pass keeps every row;
    the traceback works each code out again from two of them. ``inf``
    other than INF is the control's narrower cell (``CONTROL_INF``)."""
    i16 = np.int16
    d0 = np.asarray(d0, np.int64)
    M = np.asarray(q_len, np.int64)
    N = np.asarray(t_len, np.int64)
    P = len(d0)
    m_max = int(M.max()) if P else 0
    T = np.zeros((P, m_max + W), np.uint8)
    Q = np.zeros((max(m_max, 1), P), np.uint8)
    for p in range(P):
        t = np.frombuffer(bytes(tpad[p]), np.uint8)[:m_max + W]
        T[p, :len(t)] = t
        q = np.frombuffer(bytes(queries[p]), np.uint8)[:int(M[p])]
        Q[:len(q), p] = q
    k = np.arange(W, dtype=np.int64)[None, :]
    # slot k of row i is column j = d0 + i + k - 64: valid for
    # lo <= i <= hi, never for slot 0; only rows near either end of a
    # pair's target have an invalid slot besides slot 0
    lo = KOFF - d0[:, None] - k
    hi = N[:, None] + KOFF - d0[:, None] - k
    lo[:, 0] = m_max + 1
    lo = np.clip(lo, -1, m_max + 1)
    hi = np.clip(hi, -1, m_max + 1)
    edge = np.zeros(m_max + 1, bool)
    for p in range(P):
        edge[:max(0, min(m_max + 1, int(KOFF - 1 - d0[p])))] = True
        edge[max(0, int(N[p] + KOFF - W + 1 - d0[p])):] = True
    k16 = k.astype(i16)
    C = np.empty((m_max + 1, P, W), i16)
    C[0] = np.where((lo <= 0) & (0 <= hi), 0, inf)
    up = np.empty((P, W), i16)
    up[:, W - 1] = inf
    Tw = np.lib.stride_tricks.sliding_window_view(T, W, axis=1)
    for i in range(1, m_max + 1):
        prev = C[i - 1]
        diag = prev + (Tw[:, i, :] != Q[i - 1][:, None])
        np.add(prev[:, 1:], 1, out=up[:, :W - 1])
        np.minimum(diag, up, out=diag)
        cur = C[i]
        np.minimum.accumulate(diag - k16, axis=1, out=cur)
        cur += k16
        if edge[i]:
            cur[~((lo <= i) & (i <= hi))] = inf
        else:
            cur[:, 0] = inf
        np.minimum(cur, inf, out=cur)
    fin = C[M, np.arange(P)].astype(np.int64)
    fin[~((lo <= M[:, None]) & (M[:, None] <= hi))] = BIG
    best = fin.min(axis=1)
    best_k = np.where(fin == best[:, None], k, W).min(axis=1)
    ok = (best <= np.asarray(max_cost, np.int64)) & (M > 0)
    ts = np.zeros(P, np.int64)
    traces = []
    for p in range(P):
        tr = np.zeros(int(M[p]), np.uint8)
        if ok[p]:
            ts[p] = d0[p] + _traceback(C[:, p, :], T[p], Q[:, p], int(M[p]),
                                       int(best_k[p]), tr, inf) - KOFF
        traces.append(tr)
    cost = np.where(ok, best, np.where(M > 0, -1, 0))
    te = np.where(ok, d0 + M + best_k - KOFF, 0)
    return cost, ts, te, traces


def _traceback(C: np.ndarray, t: np.ndarray, q: np.ndarray, m: int,
               kk: int, out: np.ndarray, inf: int = INF) -> int:
    """One pair's walk back from slot ``kk`` of row ``m`` over its rows of
    the forward pass ``C``; writes the trace into ``out`` and returns the
    slot it ends in. Each row: the highest slot at or below kk whose code
    is not left; its code decides the byte and the next kk."""
    c_ = memoryview(np.ascontiguousarray(C[:m + 1])).cast("B").cast("h")
    t_ = t.tobytes()
    q_ = q[:m].tobytes()
    for i in range(m, 0, -1):
        row, prow = i * W, (i - 1) * W
        qi = q_[i - 1]
        kp = kk
        code = 3
        while kp >= 0:
            c = c_[row + kp]
            if c >= inf:
                break
            mis = t_[i + kp] != qi
            if c == c_[prow + kp] + mis:
                code = 0 if mis else 4
                break
            if kp < W - 1 and c == c_[prow + kp + 1] + 1:
                code = 1
                break
            kp -= 1
        dels = kk - kp
        if kp < 0 or dels > 62 or code == 3:
            out[i - 1] = ESC
        else:
            op2 = 2 if code == 1 else (0 if code == 4 else 1)
            out[i - 1] = (op2 << 6) | dels
        kk = kp + (code == 1)
    return kk


def dp_mismatches(pairs: list[dict], group: int = 8,
                  control: bool = False) -> int:
    """Pairs whose recorded outputs differ from the reference's: cost,
    tstart and tend for every pair, and the trace rows [0, q_len) of an
    accepted one. ``pairs`` hold the scalars (``d0``, ``q_len``,
    ``t_len``, ``max_cost``), the input bytes (``tpad``, ``query``) and the
    program's outputs (``cost``, ``ts``, ``te``, ``trace``). Pairs run in
    groups of like length, so a group's rows are those of its longest.
    ``control`` judges the control's outputs in the program's place."""
    order = sorted(range(len(pairs)), key=lambda i: pairs[i]["q_len"])
    bad = 0
    for g in range(0, len(order), group):
        grp = [pairs[i] for i in order[g:g + group]]
        args = ([p["d0"] for p in grp], [p["q_len"] for p in grp],
                [p["t_len"] for p in grp], [p["max_cost"] for p in grp],
                [p["tpad"] for p in grp], [p["query"] for p in grp])
        cost, ts, te, trace = banded_dp16(*args)
        if control:
            c_cost, c_ts, c_te, c_trace = banded_dp16(*args, inf=CONTROL_INF)
            grp = [{"q_len": p["q_len"], "cost": c_cost[x], "ts": c_ts[x],
                    "te": c_te[x], "trace": c_trace[x]}
                   for x, p in enumerate(grp)]
        for x, p in enumerate(grp):
            same = (int(cost[x]) == int(p["cost"]) and int(ts[x]) == int(p["ts"])
                    and int(te[x]) == int(p["te"]))
            if same and cost[x] >= 0:
                same = bytes(trace[x]) == bytes(p["trace"][:p["q_len"]])
            bad += not same
    return bad


_RC = bytes.maketrans(b"ACGT", b"TGCA")
PAD = 0xFF        # a target window's byte outside the target
PREFIX = 24       # bases that key a read's ends in ``dp_input_faults``


def dp_input_faults(pairs: list[dict], reads: list[bytes]) -> int:
    """Pairs whose inputs are not what the generated reads allow: the query
    (codes 0-3 of ``q_len`` bases) is no stretch of a read or of its
    reverse complement, or the target window ``tpad`` (``tpad[x] =
    t[x + d0 - 65]``) holds anything but codes 0-3 at the target's columns
    ``[0, t_len)`` and ``PAD`` outside them. The target itself is the
    program's consensus, which only the round trip judges. A query is
    looked up first among the reads' ends, where the engine's windows
    mostly start or stop, then in all the reads."""
    ends: dict[bytes, list[int]] = {}
    for i, r in enumerate(reads):
        rc = r.translate(_RC)[::-1]
        for key in (r[:PREFIX], r[-PREFIX:], rc[:PREFIX], rc[-PREFIX:]):
            ends.setdefault(key, []).append(i)
    hay = None
    bad = 0
    for p in pairs:
        q = np.frombuffer(p["query"], np.uint8)
        t = np.frombuffer(p["tpad"], np.uint8)
        col = np.arange(len(t)) + int(p["d0"]) - (KOFF + 1)
        inside = (col >= 0) & (col < int(p["t_len"]))
        ok = (len(q) == int(p["q_len"]) and bool((q < 4).all())
              and bool((t[inside] < 4).all())
              and bool((t[~inside] == PAD).all()))
        if ok:
            fwd = bytes(ASCII_OF[q])
            rev = fwd.translate(_RC)[::-1]
            near = set(ends.get(fwd[:PREFIX], [])) | set(
                ends.get(fwd[-PREFIX:], []))
            ok = any(fwd in reads[i] or rev in reads[i] for i in near)
            if not ok:
                if hay is None:
                    hay = b"\n".join(reads)
                ok = fwd in hay or rev in hay
        bad += not ok
    return bad


# --- the control: the reference one precision down -------------------------
#
# The configuration states exact 32-bit sketch hashes and 16-bit DP cells
# (INF 0x3FFF). The control is the reference computed one step narrower,
# the step that would tempt a faster kernel: 16-bit hashes (every factor
# and product taken mod 2^16) and 8-bit cells (INF 0x7F, so a cost of 127
# or more escapes).

CONTROL_INF = 0x7F


def control_sketch_read(read, k: int, seeds: np.ndarray,
                        min_len: int) -> np.ndarray:
    """``sketch_read`` in 16-bit hash arithmetic."""
    return sketch_read(read, k, seeds, min_len, bits=16)
