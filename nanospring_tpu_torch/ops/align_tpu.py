"""Batch banded DP (W = 63) with a byte trace: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of the W=63 byte-trace kernels of
``nanospring_tpu/ops/align_tpu.py``: ``_kernel16`` (``_align_padded16``),
``_kernel16t2``, ``_kernel16t`` and ``_kernel16q``, which compute one
function and differ only in how they fit the TPU's VMEM. ``banded_dp16``
takes the engine hook's buffer ABI (engine.cpp ``dp_run_tpu``): per pair
int32 ``d0, q_len, t_len, max_cost``, 0xFF-padded target windows
``tpad[x] = t[x + d0 - 65]`` and queries, one row per pair; it returns
int32 cost / ops_len / tstart / tend and one trace byte per query row
(``op2 << 6 | dels``, 255 = escape). ``csrc/banded_dp16.cu`` states the
recurrence in full.

``banded_align_batch_16`` is the counterpart of
``banded_align_batch_tpu16`` for tests and callers outside the engine: it
builds the same buffers, runs ``banded_dp16``, expands the traces into op
tapes and reruns escaped pairs on the exact C++ DP.

``banded_dp32`` is the counterpart of the v1 kernel ``_kernel``
(``_align_padded``): 256 band slots, int32 costs and one int32 record per
query row (``dels + (optype << 16) + (match << 18)``), no escape.
``csrc/banded_dp32.cu`` states its recurrence. ``banded_align_batch_32``
is the counterpart of ``banded_align_batch_tpu``, the Python wavefront's
batch DP.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .align import AlignResult

W16 = 128               # band slots
KOFF16 = 64
INF16 = 0x3FFF          # the TPU kernels' int16 sentinel, kept on purpose
TRACE_ESC = 255         # escape byte: the caller reruns the pair exactly
M_ROWS_MAX = 131072     # longest query the device DP takes (engine hook)
_BIG = 1 << 20          # invalid final slot
W32 = 256               # v1 band slots: k <-> diagonal offset k - 128
KOFF32 = 128
INF32 = 1 << 30
# The reference's route rule for the Python wavefront: a batch whose longest
# query is at most this many rows goes to the v1 DP, a longer one to the
# exact host DP. It is the JAX route's rule (there it is the TPU's VMEM cap),
# not a limit of banded_dp32, which takes up to M_ROWS_MAX rows.
M_PAD_MAX = 8192
# buffer layout by band slots: (koff, extra target width, extra query width)
_LAYOUT = {W16: (KOFF16, 3 * W16, 2 * W16),     # the engine hook's ABI
           W32: (KOFF32, W32, 0)}


def _check(d0, q_len, t_len, max_cost, tpad, queries) -> int:
    dev = tpad.device
    P = d0.shape[0]
    for name, t in (("d0", d0), ("q_len", q_len), ("t_len", t_len),
                    ("max_cost", max_cost)):
        if t.device != dev or t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on {dev}")
        if t.shape != (P,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({P},) tensor")
    for name, t in (("tpad", tpad), ("queries", queries)):
        if t.device != dev or t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8 on {dev}")
        if t.dim() != 2 or t.shape[0] != P or t.stride(1) != 1:
            raise ValueError(f"{name} must be ({P}, width) with unit "
                             f"column stride")
    return P


def banded_dp16_plain(d0, q_len, t_len, max_cost, tpad, queries,
                      m_rows: int | None = None):
    """Plain PyTorch version of ``csrc/banded_dp16.cu`` on any device: a
    loop over rows on (P, 128) int64 tensors with ``torch.cummin`` for the
    left chain, then a loop back over the stored direction codes."""
    P = _check(d0, q_len, t_len, max_cost, tpad, queries)
    dev = tpad.device
    m_max = int(q_len.max()) if P else 0
    if m_rows is None:
        m_rows = m_max
    if tpad.shape[1] < m_max + W16 or queries.shape[1] < m_max:
        raise ValueError("tpad/queries narrower than the longest query")
    i64 = torch.int64
    k = torch.arange(W16, device=dev, dtype=i64)[None, :]
    D0 = d0.to(i64)[:, None]
    M = q_len.to(i64)[:, None]
    N = t_len.to(i64)[:, None]
    INF = torch.tensor(INF16, dtype=i64, device=dev)
    kvalid = k >= 1
    j0 = D0 + k - KOFF16
    prev = torch.where(kvalid & (j0 >= 0) & (j0 <= N), 0, INF)
    codes = torch.empty((m_max, P, W16), dtype=torch.uint8, device=dev)
    inf_col = torch.full((P, 1), INF16, dtype=i64, device=dev)
    for i in range(1, m_max + 1):
        j = D0 + i + k - KOFF16
        jvalid = kvalid & (j >= 0) & (j <= N)
        dvalid = (j >= 1) & (j <= N)
        match = tpad[:, i: i + W16] == queries[:, i - 1: i]
        diag = torch.where(dvalid & (prev < INF), prev + (~match).to(i64),
                           INF)
        up = torch.cat([prev[:, 1:], inf_col], dim=1)
        up = torch.where((k < W16 - 1) & (up < INF), up + 1, INF)
        base = torch.where(jvalid, torch.minimum(diag, up), INF)
        left = torch.cummin(base - k, dim=1).values + k
        cur = torch.where(jvalid, torch.minimum(base, left), INF)
        d = torch.where(cur == diag, torch.where(match, 4, 0),
                        torch.where(cur == up, 1, 2))
        d = torch.where(cur >= INF, 3, d)
        codes[i - 1] = d.to(torch.uint8)
        prev = torch.where(i <= M, cur, prev)

    jm = D0 + M + k - KOFF16
    final = torch.where(kvalid & (jm >= 0) & (jm <= N), prev, _BIG)
    best = final.min(dim=1).values
    best_k = torch.where(final == best[:, None], k, W16).min(dim=1).values
    m1 = M[:, 0]
    ok = (best <= max_cost.to(i64)) & (m1 > 0)

    kk = best_k.clone()
    ndel = torch.zeros(P, dtype=i64, device=dev)
    trace = torch.zeros((P, m_rows), dtype=torch.uint8, device=dev)
    for i in range(m_max, 0, -1):
        active = (i <= m1) & ok
        row = codes[i - 1].to(i64)
        nd = ((row & 3) != 2) & (k <= kk[:, None])
        kp = torch.where(nd, k, -1).max(dim=1).values
        dv = torch.where(kp >= 0,
                         row.gather(1, kp.clamp(min=0)[:, None])[:, 0], -1)
        optype = torch.where(dv < 0, 3, dv & 3)
        mbit = torch.where(dv < 0, -1, dv >> 2)
        dels = kk - kp
        op2 = torch.where(optype == 1, 2, torch.where(mbit == 1, 0, 1))
        esc = (dels > 62) | (optype >= 3) | (dv < 0)
        rec = torch.where(esc, TRACE_ESC, (op2 << 6) | dels.clamp(0, 63))
        trace[:, i - 1] = torch.where(active, rec, 0).to(torch.uint8)
        kk = torch.where(active, kp + (optype == 1).to(i64), kk)
        ndel = ndel + torch.where(active & ~esc, dels, 0)

    zero = torch.zeros_like(best)
    cost = torch.where(ok, best, torch.where(m1 > 0, -1, 0))
    ops_len = torch.where(ok, m1 + ndel, zero)
    ts = torch.where(ok, D0[:, 0] + kk - KOFF16, zero)
    te = torch.where(ok, D0[:, 0] + m1 + best_k - KOFF16, zero)
    i32 = torch.int32
    return (cost.to(i32), ops_len.to(i32), ts.to(i32), te.to(i32), trace)


def banded_dp16(d0, q_len, t_len, max_cost, tpad, queries,
                m_rows: int | None = None, events=None):
    """Banded DP of a batch at the hook's buffer ABI.

    Returns (cost, ops_len, tstart, tend) int32 (P,) and the trace, uint8
    (P, m_rows), of which rows [0, q_len) of each pair are written
    (``m_rows`` defaults to the longest query; passing it saves a device
    sync). CUDA tensors launch ``csrc/banded_dp16.cu``; CPU tensors take the
    plain version. ``banded_dp16.launches`` counts kernel launches.
    ``events``, two CUDA events that exist (recorded once), are recorded
    by the launcher on the stream right before and right after the
    kernel, so that they time it alone."""
    P = _check(d0, q_len, t_len, max_cost, tpad, queries)
    dev = tpad.device
    if dev.type == "cpu":
        return banded_dp16_plain(d0, q_len, t_len, max_cost, tpad, queries,
                                 m_rows)
    if dev.type != "cuda":
        raise ValueError(f"banded_dp16 runs on cuda or cpu, not {dev}")
    if m_rows is None:
        m_rows = int(q_len.max()) if P else 0
    if m_rows > M_ROWS_MAX:
        raise ValueError(f"query of {m_rows} rows exceeds {M_ROWS_MAX}")
    if tpad.shape[1] < m_rows + W16 or queries.shape[1] < m_rows:
        raise ValueError("tpad/queries narrower than the longest query")
    from . import _cuda

    lib = _cuda.get_lib()
    out = [torch.empty(P, dtype=torch.int32, device=dev) for _ in range(4)]
    trace = torch.empty((P, max(m_rows, 1)), dtype=torch.uint8, device=dev)
    # direction records, one per row, of the size the kernel states: one
    # uint16 (4 slots x 3 bits) per lane, then 4 not-left and 4 up masks
    dirs = torch.empty((P, max(m_rows, 1), lib.ns_banded_dp16_row_bytes()),
                       dtype=torch.uint8, device=dev)
    if P == 0:
        return (*out, trace[:, :m_rows])
    rc = lib.ns_banded_dp16_launch(
        d0.data_ptr(), q_len.data_ptr(), t_len.data_ptr(),
        max_cost.data_ptr(), tpad.data_ptr(), tpad.stride(0),
        queries.data_ptr(), queries.stride(0),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), trace.data_ptr(), trace.stride(0),
        dirs.data_ptr(), dirs.shape[1], P, _cuda.stream_handle(dev),
        *((None, None) if events is None
          else (events[0].cuda_event, events[1].cuda_event)))
    _cuda.check(rc, "banded DP kernel launch")
    banded_dp16.launches += 1
    return (*out, trace[:, :m_rows])


banded_dp16.launches = 0


def _expand(offs: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Concatenated aranges [offs[i], offs[i] + sizes[i])."""
    sizes = np.asarray(sizes, np.int64)
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    excl = np.zeros(len(sizes), np.int64)
    np.cumsum(sizes[:-1], out=excl[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(excl, sizes)
    return np.repeat(np.asarray(offs, np.int64), sizes) + within


def build_buffers(targets_flat, t_off, t_len, queries_flat, q_off, q_len,
                  d0, max_cost_per_kb: int = 500, m_pad: int | None = None,
                  slots: int = W16):
    """A DP's buffers for a list of pairs, longest query first.

    Returns (order, dict of numpy arrays d0/q_len/t_len/max_cost int32 and
    tpad / queries uint8). ``slots=W16`` gives ``banded_dp16``'s layout,
    the engine hook's (engine.cpp ``dp_run_tpu``): tpad (P, m_pad + 384)
    with ``tpad[x] = t[x + d0 - 65]``, queries (P, m_pad + 256).
    ``slots=W32`` gives ``banded_dp32``'s: tpad (P, m_pad + 256) with
    ``tpad[x] = t[x + d0 - 129]``, queries (P, m_pad)."""
    koff, t_extra, q_extra = _LAYOUT[slots]
    P = len(q_len)
    order = np.argsort(-np.asarray(q_len), kind="stable")
    q_len_s = np.asarray(q_len)[order].astype(np.int64)
    t_len_s = np.asarray(t_len)[order].astype(np.int64)
    q_off_s = np.asarray(q_off)[order].astype(np.int64)
    t_off_s = np.asarray(t_off)[order].astype(np.int64)
    d0_s = np.asarray(d0)[order].astype(np.int64)
    if m_pad is None:
        m_pad = 1 << max(9, int(q_len_s.max() - 1).bit_length()) if P else 512
    tw = m_pad + t_extra
    qw = m_pad + q_extra
    tpad = np.full((P, tw), 0xFF, dtype=np.uint8)
    qbuf = np.zeros((P, qw), dtype=np.uint8)
    pidx = np.arange(P, dtype=np.int64)
    qbuf.reshape(-1)[_expand(pidx * qw, q_len_s)] = \
        np.asarray(queries_flat)[_expand(q_off_s, q_len_s)]
    lo = d0_s - (koff + 1)
    st = np.maximum(0, -lo)
    en = np.minimum(tw, t_len_s - lo)
    ln = np.maximum(0, en - st)
    tpad.reshape(-1)[_expand(pidx * tw + st, ln)] = \
        np.asarray(targets_flat)[_expand(t_off_s + lo + st, ln)]
    bufs = {
        "d0": d0_s.astype(np.int32), "q_len": q_len_s.astype(np.int32),
        "t_len": t_len_s.astype(np.int32),
        "max_cost": (q_len_s * max_cost_per_kb // 1000 + 8).astype(np.int32),
        "tpad": tpad, "queries": qbuf,
    }
    return order, bufs


def banded_align_batch_16(targets_flat, t_off, t_len, queries_flat, q_off,
                          q_len, d0, max_cost_per_kb: int = 500,
                          device: str = "cuda") -> AlignResult:
    """Counterpart of ``banded_align_batch_tpu16``: W=63 banded alignment of
    a list of pairs on ``device``, with escaped pairs rerun on the exact
    C++ DP (``ns_banded_align``)."""
    P = len(q_len)
    if P == 0:
        z = np.zeros(0, np.int64)
        return AlignResult(np.zeros(0, np.int32), z, z,
                           np.zeros(0, np.uint8), z.copy(), z.copy())
    order, b = build_buffers(targets_flat, t_off, t_len, queries_flat,
                             q_off, q_len, d0, max_cost_per_kb)
    dev = torch.device(device)
    ts_ = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    cost, ops_len, ts, te, trace = banded_dp16(
        ts_["d0"], ts_["q_len"], ts_["t_len"], ts_["max_cost"],
        ts_["tpad"], ts_["queries"])
    cost = cost.cpu().numpy().astype(np.int32)
    ops_len = ops_len.cpu().numpy().astype(np.int64)
    ts = ts.cpu().numpy().astype(np.int64)
    te = te.cpu().numpy().astype(np.int64)
    tr_bytes = trace.cpu().numpy()
    q_len_s = b["q_len"].astype(np.int64)
    t_off_s = np.asarray(t_off)[order].astype(np.int64)
    t_len_s = np.asarray(t_len)[order].astype(np.int64)
    q_off_s = np.asarray(q_off)[order].astype(np.int64)

    from .. import native

    lib = native.get_lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    parts = []
    ops_off = np.zeros(P, np.int64)
    acc = 0
    for p in range(P):
        ops_off[p] = acc
        if cost[p] < 0:
            ops_len[p] = ts[p] = te[p] = 0
            continue
        m_ = int(q_len_s[p])
        rows = tr_bytes[p, :m_]
        if (rows == TRACE_ESC).any():
            cap = 2 * m_ + 2 * 63 + 2
            buf = np.empty(cap, np.uint8)
            ol, t1, t2 = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
            tseg = np.ascontiguousarray(
                targets_flat[t_off_s[p]: t_off_s[p] + t_len_s[p]])
            qseg = np.ascontiguousarray(
                queries_flat[q_off_s[p]: q_off_s[p] + m_])
            c = lib.ns_banded_align(
                tseg.ctypes.data_as(u8p), ctypes.c_int64(len(tseg)),
                qseg.ctypes.data_as(u8p), ctypes.c_int64(m_),
                ctypes.c_int64(int(b["d0"][p])), ctypes.c_int32(63),
                ctypes.c_int32(int(b["max_cost"][p])),
                buf.ctypes.data_as(u8p), ctypes.c_int64(cap),
                ctypes.byref(ol), ctypes.byref(t1), ctypes.byref(t2))
            cost[p] = c
            if c < 0:
                ops_len[p] = ts[p] = te[p] = 0
                continue
            ops_len[p], ts[p], te[p] = ol.value, t1.value, t2.value
            parts.append(buf[: ol.value].copy())
            acc += ol.value
            continue
        # record layout: the op byte first, then its dels 'd's
        dels = (rows & 63).astype(np.int64)
        op2 = rows >> 6
        opchar = np.where(op2 == 2, np.uint8(ord("i")),
                          np.where(op2 == 0, np.uint8(ord("=")),
                                   np.uint8(ord("s"))))
        total = int(m_ + dels.sum())
        seg = np.full(total, ord("d"), np.uint8)
        seg[np.concatenate([[0], np.cumsum(1 + dels)[:-1]])] = opchar
        parts.append(seg)
        ops_len[p] = total
        acc += total
    ops_flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    inv = np.empty(P, np.int64)
    inv[order] = np.arange(P)
    return AlignResult(cost[inv], ts[inv], te[inv], ops_flat,
                       ops_off[inv], ops_len[inv])


# ---------------------------------------------------------------------------
# v1: 256 slots, int32 costs and per-row records (the Python wavefront's DP)
# ---------------------------------------------------------------------------

def banded_dp32_plain(d0, q_len, t_len, max_cost, tpad, queries,
                      m_rows: int | None = None):
    """Plain PyTorch version of ``csrc/banded_dp32.cu`` on any device, the
    function of the v1 Pallas kernel ``_kernel``: a loop over rows on
    (P, 256) int64 tensors with ``torch.cummin`` for the left chain, then a
    loop back over the stored direction codes. Rows [q_len, m_rows) of the
    records are 0."""
    P = _check(d0, q_len, t_len, max_cost, tpad, queries)
    dev = tpad.device
    m_max = int(q_len.max()) if P else 0
    if m_rows is None:
        m_rows = m_max
    if tpad.shape[1] < m_max + W32 or queries.shape[1] < m_max:
        raise ValueError("tpad/queries narrower than the longest query")
    i64 = torch.int64
    k = torch.arange(W32, device=dev, dtype=i64)[None, :]
    D0 = d0.to(i64)[:, None]
    M = q_len.to(i64)[:, None]
    N = t_len.to(i64)[:, None]
    INF = torch.tensor(INF32, dtype=i64, device=dev)
    j0 = D0 + k - KOFF32
    prev = torch.where((j0 >= 0) & (j0 <= N), 0, INF)
    codes = torch.empty((m_max, P, W32), dtype=torch.uint8, device=dev)
    inf_col = torch.full((P, 1), INF32, dtype=i64, device=dev)
    for i in range(1, m_max + 1):
        j = D0 + i + k - KOFF32
        jvalid = (j >= 0) & (j <= N)
        dvalid = (j >= 1) & (j <= N)
        match = tpad[:, i: i + W32] == queries[:, i - 1: i]
        diag = torch.where(dvalid & (prev < INF), prev + (~match).to(i64),
                           INF)
        up = torch.cat([prev[:, 1:], inf_col], dim=1)
        up = torch.where((k < W32 - 1) & (up < INF), up + 1, INF)
        base = torch.where(jvalid, torch.minimum(diag, up), INF)
        left = torch.cummin(base - k, dim=1).values + k
        cur = torch.where(jvalid, torch.minimum(base, left), INF)
        d = torch.where(cur == diag, torch.where(match, 4, 0),
                        torch.where(cur == up, 1, 2))
        d = torch.where(cur >= INF, 3, d)
        codes[i - 1] = d.to(torch.uint8)
        prev = torch.where(i <= M, cur, prev)

    jm = D0 + M + k - KOFF32
    final = torch.where((jm >= 0) & (jm <= N), prev, INF)
    best = final.min(dim=1).values
    best_k = torch.where(final == best[:, None], k, W32).min(dim=1).values
    m1 = M[:, 0]
    ok = (best <= max_cost.to(i64)) & (m1 > 0)

    kk = best_k.clone()
    ndel = torch.zeros(P, dtype=i64, device=dev)
    trace = torch.zeros((P, m_rows), dtype=torch.int32, device=dev)
    for i in range(m_max, 0, -1):
        active = (i <= m1) & ok
        row = codes[i - 1].to(i64)
        nd = ((row & 3) != 2) & (k <= kk[:, None])
        kp = torch.where(nd, k, -1).max(dim=1).values
        dv = torch.where(kp >= 0,
                         row.gather(1, kp.clamp(min=0)[:, None])[:, 0], -1)
        # the kernel's int32 arithmetic, also where no slot qualifies
        # (kp = -1: optype 3, match bit -1)
        optype = torch.where(dv < 0, 3, dv & 3)
        mbit = torch.where(dv < 0, -1, dv >> 2)
        dels = kk - kp
        rec = dels + optype * (1 << 16) + mbit * (1 << 18)
        trace[:, i - 1] = torch.where(active, rec, 0).to(torch.int32)
        kk = torch.where(active, kp + (optype == 1).to(i64), kk)
        ndel = ndel + torch.where(active, dels, 0)

    zero = torch.zeros_like(best)
    cost = torch.where(ok, best, torch.where(m1 > 0, -1, 0))
    ops_len = torch.where(ok, m1 + ndel, zero)
    ts = torch.where(ok, D0[:, 0] + kk - KOFF32, zero)
    te = torch.where(ok, D0[:, 0] + m1 + best_k - KOFF32, zero)
    i32 = torch.int32
    return (cost.to(i32), ops_len.to(i32), ts.to(i32), te.to(i32), trace)


def banded_dp32(d0, q_len, t_len, max_cost, tpad, queries,
                m_rows: int | None = None):
    """v1 banded DP of a batch: per pair int32 ``d0, q_len, t_len,
    max_cost``, targets ``tpad[x] = t[x + d0 - 129]`` (0xFF outside the
    target, width >= longest query + 256) and queries, uint8, one row per
    pair.

    Returns (cost, ops_len, tstart, tend) int32 (P,) and the records, int32
    (P, m_rows), of which rows [0, q_len) of each pair are written
    (``m_rows`` defaults to the longest query and must not be less;
    passing it saves a device sync). CUDA tensors launch
    ``csrc/banded_dp32.cu``; CPU tensors take the plain version.
    ``banded_dp32.launches`` counts kernel launches."""
    P = _check(d0, q_len, t_len, max_cost, tpad, queries)
    dev = tpad.device
    if dev.type == "cpu":
        return banded_dp32_plain(d0, q_len, t_len, max_cost, tpad, queries,
                                 m_rows)
    if dev.type != "cuda":
        raise ValueError(f"banded_dp32 runs on cuda or cpu, not {dev}")
    if m_rows is None:
        m_rows = int(q_len.max()) if P else 0
    if m_rows > M_ROWS_MAX:
        raise ValueError(f"query of {m_rows} rows exceeds {M_ROWS_MAX}")
    if tpad.shape[1] < m_rows + W32 or queries.shape[1] < m_rows:
        raise ValueError("tpad/queries narrower than the longest query")
    from . import _cuda

    lib = _cuda.get_lib()
    out = [torch.empty(P, dtype=torch.int32, device=dev) for _ in range(4)]
    trace = torch.empty((P, max(m_rows, 1)), dtype=torch.int32, device=dev)
    # direction records, one per row, of the size the kernel states: one
    # 32-bit word (8 slots x 4 bits) per lane, then 8 not-left and 8 up masks
    dirs = torch.empty((P, max(m_rows, 1), lib.ns_banded_dp32_row_bytes()),
                       dtype=torch.uint8, device=dev)
    if P == 0:
        return (*out, trace[:, :m_rows])
    rc = lib.ns_banded_dp32_launch(
        d0.data_ptr(), q_len.data_ptr(), t_len.data_ptr(),
        max_cost.data_ptr(), tpad.data_ptr(), tpad.stride(0),
        queries.data_ptr(), queries.stride(0),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), trace.data_ptr(), trace.stride(0),
        dirs.data_ptr(), dirs.shape[1], P, _cuda.stream_handle(dev))
    _cuda.check(rc, "banded DP (v1) kernel launch")
    banded_dp32.launches += 1
    return (*out, trace[:, :m_rows])


banded_dp32.launches = 0


def banded_align_batch_32(targets_flat, t_off, t_len, queries_flat, q_off,
                          q_len, d0, max_cost_per_kb: int = 500,
                          device="cuda") -> AlignResult:
    """Counterpart of ``banded_align_batch_tpu``: banded alignment of a
    list of pairs in the band [-128, 127] around ``d0`` on ``device``.

    Same host work as the JAX wrapper: pairs sorted by query length
    (longest first), ``max_cost = q_len * max_cost_per_kb // 1000 + 8``,
    the per-row records expanded into op bytes with numpy, the sort undone.
    Unlike it, queries are not capped at 8,192 rows (the TPU's VMEM limit):
    ``banded_dp32`` takes up to ``M_ROWS_MAX``. The wavefront sends it only
    batches up to ``M_PAD_MAX`` rows, as the reference does."""
    P = len(q_len)
    if P == 0:
        z = np.zeros(0, np.int64)
        return AlignResult(np.zeros(0, np.int32), z, z,
                           np.zeros(0, np.uint8), z.copy(), z.copy())
    order, b = build_buffers(targets_flat, t_off, t_len, queries_flat,
                             q_off, q_len, d0, max_cost_per_kb, slots=W32)
    dev = torch.device(device)
    ts_ = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    q_len_s = b["q_len"].astype(np.int64)
    cost, ops_len, ts, te, trace = banded_dp32(
        ts_["d0"], ts_["q_len"], ts_["t_len"], ts_["max_cost"],
        ts_["tpad"], ts_["queries"], m_rows=int(q_len_s[0]))
    cost = cost.cpu().numpy().astype(np.int32)
    ops_len = ops_len.cpu().numpy().astype(np.int64)
    ts = ts.cpu().numpy().astype(np.int64)
    te = te.cpu().numpy().astype(np.int64)
    trace = trace.cpu().numpy()

    # ops-byte expansion, vectorized across the batch: each per-row record
    # becomes one '='/'s'/'i' byte followed by its dels 'd' bytes
    mm_ok = np.where(cost >= 0, q_len_s, 0)      # sorted order
    rec = trace.reshape(-1)[_expand(np.arange(P, dtype=np.int64)
                                    * trace.shape[1], mm_ok)].astype(np.int64)
    dels = rec & 0xFFFF
    optype = (rec >> 16) & 3
    mbit = (rec >> 18) & 1
    opchar = np.where(
        optype == 1, np.uint8(ord("i")),
        np.where(mbit == 1, np.uint8(ord("=")), np.uint8(ord("s"))),
    ).astype(np.uint8)
    ops_off_s = np.zeros(P, np.int64)
    np.cumsum(ops_len[:-1], out=ops_off_s[1:])
    total = int(ops_len.sum())
    if int(mm_ok.sum() + dels.sum()) != total:
        raise AssertionError("v1 DP records disagree with ops_len")
    out_flat = np.full(total, ord("d"), dtype=np.uint8)
    step = 1 + dels
    excl = np.cumsum(step) - step
    if len(rec):
        rec_pair = np.repeat(np.arange(P, dtype=np.int64), mm_ok)
        first_rec = np.zeros(P + 1, np.int64)
        np.cumsum(mm_ok, out=first_rec[1:])
        seg_base = np.repeat(excl[first_rec[:-1][mm_ok > 0]],
                             mm_ok[mm_ok > 0])
        out_flat[ops_off_s[rec_pair] + excl - seg_base] = opchar

    inv = np.empty(P, np.int64)
    inv[order] = np.arange(P)
    return AlignResult(cost[inv], ts[inv], te[inv], out_flat,
                       ops_off_s[inv], ops_len[inv])
