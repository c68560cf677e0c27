"""Contig building: sketch-join clustering + wavefront growth (the C++
engine or the Python wavefront), with the sketch and the batch DP on the
device.

Port of ``nanospring_tpu/pipeline/contigs.py``:

1. **Sketch** every read once: ``csrc/sketch.cu`` on ``cuda``, its plain
   PyTorch version on ``cpu`` (``ops/sketch.py``).
2. **Join**: one batched index query finds all overlap-candidate pairs
   (reads sharing >= threshold sketch slots), then components and the
   repetitive-read screen (C++).
3. **Grow**: the C++ engine (``native/engine.cpp``) places candidates,
   verifies them by banded DP and splices accepted reads into contigs.
   With ``aligner="device"`` it hands each batch of DP to
   ``_DeviceDpHook``, which runs ``csrc/banded_dp16.cu`` (or its plain
   version on ``cpu``); ``aligner="native"`` keeps the engine's own DP;
   ``aligner="auto"`` installs the hook in the engine's probe mode, which
   times one batch on both and keeps the faster for the rest.
   ``aligner="python"`` grows in the Python wavefront (``_Wavefront``),
   whose frontier batches run ``csrc/banded_dp32.cu`` (the v1 kernel's
   counterpart) on ``cfg.device``, then polishes in one native call.
4. **Emit**: polished contigs become flat edit-script arrays.

Components are disjoint, so subsets of them grow in separate worker
processes (``pipeline/grow_worker.py``) with no coordination.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import threading
import time
import weakref

import numpy as np

from ..config import CompressConfig
from ..io import packed as pk
from ..io.serialize import ContigBatch
from ..ops import align as al
from ..ops import align_tpu as at
from ..ops import minimizers as mz
from ..ops import sketch as sk
from ..utils import observe
from ..utils.observe import FunnelStats
from . import candidates


# last run's DP backend and kernel counters (bench/CLI reporting); set by
# build_contigs from the counters summed over worker processes
DP_INFO: dict = {"dp_backend": "native"}

# last run's pipeline sub-stage walls (seconds) + DP counters — the
# machine-readable analog of the reference's per-stage stdout report
# (src/Compressor.cpp:59-82). Populated by build_contigs / the engine's
# ns_engine_timings; summed across worker processes.
PIPE_STAGES: dict = {}


# counters that take the largest value over worker processes, not the sum
_MAX_TIMINGS = ("dp_worker_peak_bytes", "dp_hook_m_cap")


def _merge_timings(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if k in _MAX_TIMINGS:
            dst[k] = max(dst.get(k, 0.0), float(v))
        else:
            dst[k] = dst.get(k, 0.0) + float(v)


@dataclasses.dataclass
class _Member:
    rid: int
    strand: int            # 0 forward, 1 reverse-complement
    tstart: int            # consensus coords (origin = seed start, may go <0)
    ops: np.ndarray        # uint8 op bytes
    cost: int


# the staging buffer through which a spill-backed store's packed bytes go
# to the device, chunk by chunk
STAGE_BYTES = 32 << 20


def packed_on_device(packed: np.ndarray, dev):
    """A store's packed buffer as one uint8 tensor on ``dev``. An
    in-memory buffer goes whole. A read-only spill map (the low-memory
    store) is never copied whole into host memory: it goes in
    ``STAGE_BYTES`` chunks through one staging buffer (pinned on ``cuda``)
    into the device buffer."""
    import torch

    if packed.flags["C_CONTIGUOUS"] and packed.flags["WRITEABLE"]:
        return torch.from_numpy(packed).to(dev)
    n = len(packed)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    pin = dev.type == "cuda"
    stage = torch.empty(max(1, min(STAGE_BYTES, n)), dtype=torch.uint8,
                        pin_memory=pin)
    view = stage.numpy()
    for a in range(0, n, len(view)):
        b = min(a + len(view), n)
        if pin:     # the last chunk's copy has left the staging buffer
            torch.cuda.current_stream(dev).synchronize()
        view[: b - a] = packed[a:b]
        out[a:b].copy_(stage[: b - a], non_blocking=pin)
    if pin:
        torch.cuda.current_stream(dev).synchronize()
    return out


def sketch_rows(store, cfg: CompressConfig, lo: int = 0,
                hi: int | None = None):
    """Sketch reads [lo, hi) of ``store`` on ``cfg.device``: (hi - lo, n)
    int32 sketch bits on the device.

    One call: the packed buffer goes to the device whole
    (``packed_on_device``) and the kernel (or, on ``cpu``, its plain
    version) reads each read through ``offsets[lo:hi]``, so there are no
    padding buckets and nothing is copied per read."""
    import torch

    dev = cfg.torch_device()
    hi = store.num_reads if hi is None else hi
    seeds = sk.make_seeds(cfg.num_hashes, cfg.sketch_seed).astype(np.int64)
    min_len = max(cfg.kmer_size, cfg.min_read_len_for_sketch)

    def to_dev(a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return sk.sketch_reads(packed_on_device(np.asarray(store.packed), dev),
                           to_dev(store.offsets[lo:hi]),
                           to_dev(store.lengths[lo:hi]), to_dev(seeds),
                           cfg.kmer_size, min_len)


def compute_all_sketches(store, cfg: CompressConfig,
                         report: bool = False) -> np.ndarray:
    """Sketch every read on ``cfg.device``: (N, n) uint32. Bit-identical
    to the JAX package's ``sketch_batch_packed`` and to
    ``native/sketch.cpp``."""
    launches0 = sk.sketch_reads.launches
    res = sk.as_uint32(sketch_rows(store, cfg))
    _merge_timings(PIPE_STAGES, {
        "sketch_kernel_launches": sk.sketch_reads.launches - launches0})
    if report:
        print(f"[nstpu] sketched {store.num_reads} reads on "
              f"{cfg.torch_device()} (k={cfg.kmer_size})")
    return res


def repetitive_screen(store, cfg: CompressConfig) -> np.ndarray:
    """Self-similar (repetitive) read mask, vectorized over padded batches.

    The reference computes per-read Hamming self-similarity at offsets 1..6
    and flags reads above 0.7 (checkRepetitive, src/Consensus.cpp:405-424);
    repetitive reads are never seeded or claimed (:203-208) because their
    sketches recruit spurious overlaps. Same screen here as shifted-equality
    means over (B, Lpad) code matrices (numpy fallback); the native path
    runs the per-read scan directly on the packed store (hot.cpp).
    """
    N = store.num_reads
    try:
        from .. import native as _nat

        lib = _nat.get_lib()
    except Exception:
        lib = None
    if lib is not None and hasattr(store, "packed"):
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        packed = store.packed
        if not packed.flags["C_CONTIGUOUS"]:
            packed = np.ascontiguousarray(packed)
        mask = np.zeros(N, dtype=np.uint8)
        lib.ns_repetitive_screen(
            packed.ctypes.data_as(u8p),
            store.offsets.ctypes.data_as(i64p),
            store.lengths.ctypes.data_as(i64p),
            ctypes.c_int64(N), ctypes.c_int32(cfg.repetitive_offsets),
            ctypes.c_int32(int(round(cfg.repetitive_threshold * 1e6))),
            mask.ctypes.data_as(u8p),
        )
        return mask.astype(bool)
    rep = np.zeros(N, dtype=bool)
    order = np.argsort(store.lengths, kind="stable")
    maxoff = cfg.repetitive_offsets
    thr = cfg.repetitive_threshold
    i = 0
    while i < N:
        L0 = int(store.lengths[order[i]])
        if L0 <= maxoff:
            i += 1
            continue
        pad = 1 << max(8, (L0 - 1).bit_length())
        j = i
        while j < N and store.lengths[order[j]] <= pad and j - i < 4096:
            j += 1
        rids = order[i:j]
        codes, lens = store.get_batch_padded(rids, pad_to=pad, fill=255)
        best = np.zeros(len(rids))
        pos = np.arange(pad, dtype=np.int64)
        for off in range(1, maxoff + 1):
            eq = codes[:, off:] == codes[:, :-off]
            real = pos[None, : pad - off] < (lens - off)[:, None]
            valid = np.maximum(lens - off, 1)
            frac = (eq & real).sum(axis=1) / valid
            best = np.maximum(best, frac)
        rep[rids] = best > thr
        i = j
    return rep


def _orient_codes(codes: np.ndarray, strand: int) -> np.ndarray:
    return pk.revcomp_codes(codes) if strand else codes


class _ContigState:
    """Mutable consensus + placed-member anchor tables for one contig."""

    def __init__(self, cid: int, seed_rid: int, seed_codes: np.ndarray,
                 cfg: CompressConfig):
        self.cid = cid
        self.cfg = cfg
        # consensus lives in a slack buffer so head/tail growth is amortized
        # O(growth) instead of O(len) per accept (contigs reach megabases)
        n = len(seed_codes)
        self._buf = np.empty(2 * n + 512, dtype=np.uint8)
        self._start = n // 2 + 128
        self._len = n
        self._buf[self._start: self._start + n] = seed_codes
        self.lo = 0  # consensus coords of cons[0]
        self.members: list[_Member] = []
        self.total_aligned = 0
        self.pending = 0       # frontier items referencing this contig
        self.closed = False    # edge_threshold reached: stop growing
        # parent anchor tables: rid -> (hash, tpos, fwdflag)
        self.anchors: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    @property
    def cons(self) -> np.ndarray:
        return self._buf[self._start: self._start + self._len]

    @cons.setter
    def cons(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr, dtype=np.uint8)
        self._buf = arr.copy() if arr.base is self._buf else arr
        self._start = 0
        self._len = len(arr)

    def _prepend(self, codes: np.ndarray) -> None:
        n = len(codes)
        if n > self._start:
            grow = max(n, self._len) + 512
            nb = np.empty(grow + self._start + len(self._buf), dtype=np.uint8)
            nb[grow + self._start: grow + self._start + self._len] = self.cons
            self._buf = nb
            self._start += grow
        self._start -= n
        self._len += n
        self._buf[self._start: self._start + n] = codes

    def _append(self, codes: np.ndarray) -> None:
        n = len(codes)
        end = self._start + self._len
        if end + n > len(self._buf):
            grow = max(n, self._len) + 512
            nb = np.empty(len(self._buf) + grow, dtype=np.uint8)
            nb[self._start: end] = self.cons
            self._buf = nb
        self._buf[end: end + n] = codes
        self._len += n

    @property
    def hi(self) -> int:
        return self.lo + self._len

    def add_seed_member(self, rid: int, codes: np.ndarray) -> None:
        ops = np.full(len(codes), ord("="), dtype=np.uint8)
        self.members.append(_Member(rid, 0, 0, ops, 0))
        h, p, f = mz.minimizers(codes, self.cfg.seed_kmer_size, self.cfg.seed_window)
        self.anchors[rid] = mz.prepare_anchors(h, p.astype(np.int64), f)
        self.total_aligned += len(codes)

    def accept(self, rid: int, is_rc: int, tstart_abs: int, tend_abs: int,
               ops: np.ndarray, cost: int, codes: np.ndarray,
               fwd_anchors) -> None:
        """Record an accepted alignment; splice overhangs into the consensus.

        ``ops`` may begin/end with 'i' runs (clipped overhangs). If an 'i'
        run touches the consensus end it becomes consensus growth (the run
        flips to '='); otherwise it stays an insertion run — lossless either
        way, growth is just better for ratio.
        """
        cfg = self.cfg
        mlen = len(codes)
        head = 0
        while head < len(ops) and ops[head] == ord("i"):
            head += 1
        tail = 0
        while tail < len(ops) and ops[len(ops) - 1 - tail] == ord("i"):
            tail += 1
        if head and tstart_abs == self.lo:
            self._prepend(codes[:head])
            self.lo -= head
            ops[:head] = ord("=")
            tstart_abs -= head
        if tail and tend_abs == self.hi and head + tail <= len(ops):
            self._append(codes[mlen - tail:])
            ops[len(ops) - tail:] = ord("=")

        self.members.append(_Member(rid, is_rc, tstart_abs, ops, cost))
        self.total_aligned += mlen

        # anchor table for this member: minimizer positions mapped through
        # the alignment into consensus coords (oriented coords -> tpos).
        # Positions inside 'i' runs are DROPPED: an inserted query base has
        # no target position (q2t collapses whole runs onto one cursor
        # value), and anchors built there would hand children wildly wrong
        # diagonals — a self-reinforcing misplacement cascade.
        # fwd_anchors is already prepared (sorted-unique), so the output
        # table is too (native one-pass in ops/minimizers.accept_anchors).
        h, p, f = fwd_anchors
        self.anchors[rid] = mz.accept_anchors(
            ops, tstart_abs, mlen, is_rc, cfg.seed_kmer_size, h, p, f)


def _check_member(st, m: _Member, codes: np.ndarray | None = None,
                  store=None) -> None:
    """Edit-script replay equality: walking the member's op tape over the
    live consensus must reproduce the oriented read exactly ('=' ops match,
    cursors end exactly at read/consensus bounds). The reference runs the
    same invariant after every alignment and graph update under -DCHECKS
    (src/Consensus.cpp:280-337, src/ConsensusGraph.cpp:1187-1239)."""
    if codes is None:
        codes = _orient_codes(store.get_codes(m.rid), m.strand)
    ops = m.ops
    consumes_t = ops != ord("i")
    consumes_q = ops != ord("d")
    if int(consumes_q.sum()) != len(codes):
        raise AssertionError(
            f"rid {m.rid}: ops consume {int(consumes_q.sum())} query bases, "
            f"read has {len(codes)}")
    tcol = (m.tstart - st.lo) + np.cumsum(consumes_t) - consumes_t
    qpos = np.cumsum(consumes_q) - consumes_q
    eq = ops == ord("=")
    cols = tcol[eq]
    if len(cols) and (cols.min() < 0 or cols.max() >= len(st.cons)):
        raise AssertionError(f"rid {m.rid}: '=' column out of consensus bounds")
    if not np.array_equal(st.cons[cols], codes[qpos[eq]]):
        raise AssertionError(f"rid {m.rid}: '=' ops disagree with consensus")
    sub = ops == ord("s")
    if sub.any() and (st.cons[tcol[sub]] == codes[qpos[sub]]).any():
        raise AssertionError(f"rid {m.rid}: 's' op where bases match")


def check_contigs(states: list, store) -> None:
    """Run the -DCHECKS invariants over every member of every contig."""
    for st in states:
        for m in st.members:
            _check_member(st, m, store=store)


def _polish_contig(state: _ContigState, store) -> None:
    """Majority-vote substitution polish of the consensus (one pass).

    The mosaic consensus keeps the seed read's bases in the interior, so
    every member pays an 's' edit wherever the seed erred (~error-rate of
    the seed, at full coverage). The reference fixes this with weighted
    heaviest-path recompute (src/ConsensusGraph.cpp:559-615
    calculateMainPathGreedy); here the same effect is a vectorized pileup
    vote. Substitution-only polish is purely mechanical on the op tapes:
    'd' consumes no base and literals are re-extracted from the query codes
    downstream (ops_to_edit_scripts), so changing consensus column c from X
    to Y just flips members' ops at c between '=' and 's' — no re-alignment.
    """
    members = state.members
    if len(members) < 3:
        return
    L = len(state.cons)
    vote_keys = []
    per_member = []  # (ops_idx_of_base_ops, tcols, bases)
    for m in members:
        ops = m.ops
        consumes_t = ops != ord("i")
        tcol = (m.tstart - state.lo) + np.cumsum(consumes_t) - consumes_t
        consumes_q = ops != ord("d")
        qpos = np.cumsum(consumes_q) - consumes_q
        codes = _orient_codes(store.get_codes(m.rid), m.strand)
        has_base = consumes_t & consumes_q          # '=' or 's'
        cols = tcol[has_base]
        bases = codes[qpos[has_base]]
        vote_keys.append(cols * 4 + bases)
        per_member.append((has_base, cols, bases))
    votes = np.bincount(
        np.concatenate(vote_keys), minlength=L * 4
    ).reshape(L, 4)

    best = np.argmax(votes, axis=1).astype(np.uint8)
    old = state.cons
    maxv = votes[np.arange(L), best]
    oldv = votes[np.arange(L), old]
    new = np.where((maxv > oldv), best, old)        # ties keep the old base
    if not (new != old).any():
        return
    state.cons = new.astype(np.uint8)
    for m, (has_base, cols, bases) in zip(members, per_member):
        newop = np.where(bases == new[cols], np.uint8(ord("=")), np.uint8(ord("s")))
        m.ops[has_base] = newop


def _excl_cumsum64(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), dtype=np.int64)
    if len(x) > 1:
        np.cumsum(x[:-1], out=out[1:])
    return out


def _member_codes_flat(states: list, store):
    """Oriented query codes of every member of every contig, flat (native)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    rids = np.array([m.rid for st in states for m in st.members], np.int64)
    strand = np.array([m.strand for st in states for m in st.members], np.uint8)
    codes_len = store.lengths[rids].astype(np.int64)
    codes_off = _excl_cumsum64(codes_len)
    codes_flat = np.empty(int(codes_len.sum()), np.uint8)
    packed = store.packed
    if not packed.flags["C_CONTIGUOUS"]:
        packed = np.ascontiguousarray(packed)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ns_unpack_oriented(
        packed.ctypes.data_as(u8p),
        store.offsets.ctypes.data_as(i64p),
        store.lengths.ctypes.data_as(i64p),
        rids.ctypes.data_as(i64p), strand.ctypes.data_as(u8p),
        ctypes.c_int64(len(rids)), codes_off.ctypes.data_as(i64p),
        codes_flat.ctypes.data_as(u8p),
    )
    return codes_flat, codes_off, codes_len


def _polish_batch_native(states: list, store) -> bool:
    """Batched C++ polish of all contigs (native/polish.cpp); mutates the
    states in place. Returns False when the native lib is unavailable so
    the caller can fall back to the numpy oracle path."""
    try:
        import ctypes

        from .. import native

        lib = native.get_lib()
    except Exception:
        return False
    C = len(states)
    if C == 0:
        return True
    cons_len = np.array([len(st.cons) for st in states], np.int64)
    cons_off = _excl_cumsum64(cons_len)
    cons_flat = (np.concatenate([st.cons for st in states])
                 if C else np.zeros(0, np.uint8)).astype(np.uint8, copy=False)
    m_cnt = np.array([len(st.members) for st in states], np.int64)
    m_off = _excl_cumsum64(m_cnt)
    members = [m for st in states for m in st.members]
    M = len(members)
    ops_len = np.array([len(m.ops) for m in members], np.int64)
    ops_off = _excl_cumsum64(ops_len)
    ops_flat = (np.concatenate([m.ops for m in members])
                if M else np.zeros(0, np.uint8)).astype(np.uint8, copy=False)
    tstart_rel = np.empty(M, np.int64)
    k = 0
    for st in states:
        for m in st.members:
            tstart_rel[k] = m.tstart - st.lo
            k += 1
    codes_flat, codes_off, _ = _member_codes_flat(states, store)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    out_cons_total = ctypes.c_int64()
    out_ops_total = ctypes.c_int64()
    h = lib.ns_polish_batch(
        cons_flat.ctypes.data_as(u8p), cons_off.ctypes.data_as(i64p),
        cons_len.ctypes.data_as(i64p), ctypes.c_int64(C),
        ops_flat.ctypes.data_as(u8p), ops_off.ctypes.data_as(i64p),
        ops_len.ctypes.data_as(i64p), tstart_rel.ctypes.data_as(i64p),
        m_off.ctypes.data_as(i64p), m_cnt.ctypes.data_as(i64p),
        codes_flat.ctypes.data_as(u8p), codes_off.ctypes.data_as(i64p),
        ctypes.byref(out_cons_total), ctypes.byref(out_ops_total),
    )
    try:
        new_cons_flat = np.empty(out_cons_total.value, np.uint8)
        new_cons_len = np.empty(C, np.int64)
        new_ops_flat = np.empty(out_ops_total.value, np.uint8)
        new_ops_len = np.empty(M, np.int64)
        new_tstart = np.empty(M, np.int64)
        lib.ns_polish_fetch(
            ctypes.c_void_p(h),
            new_cons_flat.ctypes.data_as(u8p), new_cons_len.ctypes.data_as(i64p),
            new_ops_flat.ctypes.data_as(u8p), new_ops_len.ctypes.data_as(i64p),
            new_tstart.ctypes.data_as(i64p),
        )
    finally:
        lib.ns_polish_free(ctypes.c_void_p(h))
    # unflatten
    oo = 0
    mi = 0
    cpos = 0
    ci = 0
    for st in states:
        L = int(new_cons_len[ci])
        st.cons = new_cons_flat[cpos: cpos + L].copy()
        cpos += L
        ci += 1
        for m in st.members:
            ln = int(new_ops_len[mi])
            m.ops = new_ops_flat[oo: oo + ln].copy()
            m.tstart = st.lo + int(new_tstart[mi])
            oo += ln
            mi += 1
    return True


def _member_tape(state: _ContigState, store, m: _Member):
    """Per-op (target column, query pos, codes) arrays for one member."""
    ops = m.ops
    consumes_t = ops != ord("i")
    tcol = (m.tstart - state.lo) + np.cumsum(consumes_t) - consumes_t
    consumes_q = ops != ord("d")
    qpos = np.cumsum(consumes_q) - consumes_q
    codes = _orient_codes(store.get_codes(m.rid), m.strand)
    return ops, consumes_t, tcol, consumes_q, qpos, codes


def _polish_indels(state: _ContigState, store) -> None:
    """Column-voting indel polish (one pass each of deletions, insertions).

    Seed-read indel errors survive in the consensus: every member pays a
    'd' at a spurious column and an 'i' at a missing one (the reference
    heals these through its weighted DAG re-extension,
    src/ConsensusGraph.cpp:559-615). Both fixes are mechanical op rewrites:

    - delete column c (majority 'd' there): members' 'd' ops at c vanish;
      members with a base there keep it as an 'i' (literals re-extracted
      from query codes downstream).
    - insert base b at gap g (majority of spanning members carry a first
      'i' of base b there): those 'i' ops flip to '='; other spanning
      members gain a 'd'.
    """
    members = state.members
    if len(members) < 3:
        return

    # --- deletions ---------------------------------------------------------
    L = len(state.cons)
    dv_keys, bv_keys = [], []
    for m in members:
        ops, consumes_t, tcol, consumes_q, qpos, codes = _member_tape(state, store, m)
        dv_keys.append(tcol[ops == ord("d")])
        bv_keys.append(tcol[consumes_t & consumes_q])
    del_votes = np.bincount(np.concatenate(dv_keys), minlength=L + 1)
    base_votes = np.bincount(np.concatenate(bv_keys), minlength=L + 1)
    delmask = del_votes[:L] > base_votes[:L]
    if delmask.any():
        ndel_before = np.cumsum(delmask) - delmask
        for m in members:
            ops = m.ops
            consumes_t = ops != ord("i")
            tcol = (m.tstart - state.lo) + np.cumsum(consumes_t) - consumes_t
            at_del = consumes_t & delmask[np.minimum(tcol, L - 1)] & (tcol < L)
            if not at_del.any():
                ts_rel = m.tstart - state.lo
                m.tstart = state.lo + ts_rel - int(ndel_before[min(ts_rel, L - 1)])
                continue
            drop = at_del & (ops == ord("d"))
            to_i = at_del & (ops != ord("d"))
            ops2 = ops.copy()
            ops2[to_i] = ord("i")
            m.ops = ops2[~drop]
            ts_rel = m.tstart - state.lo
            m.tstart = state.lo + ts_rel - int(ndel_before[min(ts_rel, L - 1)])
        state.cons = state.cons[~delmask]

    # --- insertions --------------------------------------------------------
    L = len(state.cons)
    iv = np.zeros((L + 1, 4), np.int64)
    cov = np.zeros(L + 3, np.int64)
    tapes = []
    for m in members:
        tape = _member_tape(state, store, m)
        tapes.append(tape)
        ops, consumes_t, tcol, consumes_q, qpos, codes = tape
        n = len(ops)
        if n == 0 or not consumes_t.any():
            continue
        isi = ~consumes_t
        idx = np.arange(n)
        first_c = int(np.argmax(consumes_t))
        last_c = n - 1 - int(np.argmax(consumes_t[::-1]))
        interior = isi & (idx > first_c) & (idx < last_c)
        ii = np.flatnonzero(interior)
        ts_rel = int(tcol[first_c])
        te_rel = int(tcol[last_c]) + 1
        cov[ts_rel + 1] += 1
        cov[max(te_rel, ts_rel + 1)] -= 1
        if len(ii):
            gaps = tcol[ii]
            bases = codes[qpos[ii]]
            firstmask = np.ones(len(ii), bool)
            firstmask[1:] = gaps[1:] != gaps[:-1]
            np.add.at(iv, (gaps[firstmask], bases[firstmask]), 1)
    cov = np.cumsum(cov)[: L + 1]
    best_b = np.argmax(iv, axis=1)
    best_v = iv[np.arange(L + 1), best_b]
    insmask = best_v * 2 > np.maximum(cov, 1)
    ins_gaps = np.flatnonzero(insmask)
    if len(ins_gaps) == 0:
        return
    ins_base = best_b[ins_gaps].astype(np.uint8)
    gap_newbase = np.full(L + 1, 255, np.uint8)
    gap_newbase[ins_gaps] = ins_base
    nins_leq = np.cumsum(insmask)          # inserted gaps with index <= c
    for m, tape in zip(members, tapes):
        ops, consumes_t, tcol, consumes_q, qpos, codes = tape
        n = len(ops)
        if n == 0 or not consumes_t.any():
            continue
        idx = np.arange(n)
        first_c = int(np.argmax(consumes_t))
        last_c = n - 1 - int(np.argmax(consumes_t[::-1]))
        ts_rel = int(tcol[first_c])
        te_rel = int(tcol[last_c]) + 1
        isi = ~consumes_t
        interior = isi & (idx > first_c) & (idx < last_c)
        ii = np.flatnonzero(interior)
        flip = np.zeros(n, bool)
        matched_gap = np.zeros(L + 1, bool)
        if len(ii):
            gaps = tcol[ii]
            firstmask = np.ones(len(ii), bool)
            firstmask[1:] = gaps[1:] != gaps[:-1]
            fi = ii[firstmask]
            fgaps = tcol[fi]
            fbase = codes[qpos[fi]]
            hit = insmask[fgaps] & (fbase == gap_newbase[fgaps])
            flip[fi[hit]] = True
            matched_gap[fgaps[hit]] = True
        ops2 = ops.copy()
        ops2[flip] = ord("=")
        # spanning gaps without a matching first-'i' gain a 'd' before the
        # op that consumes column g
        need_d = insmask.copy()
        need_d[: ts_rel + 1] = False
        need_d[te_rel:] = False
        need_d &= ~matched_gap
        dg = np.flatnonzero(need_d)
        if len(dg):
            # position: first op with consumes_t and tcol == g
            pos = np.searchsorted(tcol[consumes_t], dg)
            cons_idx = np.flatnonzero(consumes_t)
            at = cons_idx[pos]
            ops2 = np.insert(ops2, at, ord("d"))
        m.ops = ops2
        m.tstart = state.lo + ts_rel + int(nins_leq[ts_rel])
    state.cons = np.insert(state.cons, ins_gaps, ins_base)


def _emit_group(states: list, store) -> dict:
    """Pack a group of finished contigs into flat member-order arrays.

    One edit-script extraction call over every member of every contig —
    the batch axis replaces the reference's per-read writeRead loop
    (src/ConsensusGraph.cpp:984-1178).
    """
    members = [m for st in states for m in st.members]
    M = len(members)
    ops_len = np.array([len(m.ops) for m in members], dtype=np.int64)
    ops_off = _excl_cumsum64(ops_len)
    ops_flat = np.concatenate([m.ops for m in members]) if M else np.zeros(0, np.uint8)
    rids = np.array([m.rid for m in members], dtype=np.int64)
    strands = np.array([m.strand for m in members], dtype=np.uint8)
    tstarts = np.empty(M, dtype=np.int64)
    k = 0
    for st in states:
        for m in st.members:
            tstarts[k] = m.tstart - st.lo
            k += 1

    # oriented query codes for literal extraction
    try:
        queries_flat, q_off, q_len = _member_codes_flat(states, store)
    except Exception:
        q_len = store.lengths[rids].astype(np.int64) if M else np.zeros(0, np.int64)
        q_off = _excl_cumsum64(q_len)
        qparts = [_orient_codes(store.get_codes(m.rid), m.strand) for m in members]
        queries_flat = np.concatenate(qparts) if M else np.zeros(0, np.uint8)

    res = al.AlignResult(
        cost=np.zeros(M, np.int32), tstart=tstarts,
        tend=np.zeros(M, np.int64),
        ops_flat=ops_flat, ops_off=ops_off, ops_len=ops_len,
    )
    es = al.ops_to_edit_scripts(res, np.arange(M), queries_flat, q_off, q_len)
    return {
        "consensus_list": [st.cons for st in states],
        "reads_per_contig": np.array([len(st.members) for st in states], np.int64),
        "ids": rids,
        "strand": strands,
        "es": es,
    }


@dataclasses.dataclass
class _Item:
    """One frontier entry: candidate rid to be placed on contig cid."""
    cid: int
    rid: int
    parent: int
    attempts: int = 0


@dataclasses.dataclass
class _Placed:
    """A frontier item that anchored successfully, ready for banded DP."""
    item: _Item
    is_rc: int
    codes: np.ndarray       # oriented query codes
    qlo: int
    qhi: int
    wlo: int                # consensus-coord window passed as DP target
    whi: int
    snap_lo: int            # contig extent at placement time
    snap_hi: int
    d0_win: int             # expected diagonal in window/clipped coords
    fwd_anchors: tuple      # candidate's forward-orientation minimizers


class _Wavefront:
    """Cross-contig frontier scheduler around the batched aligner."""

    def __init__(self, store, cfg: CompressConfig, stats: FunnelStats,
                 adj_off: np.ndarray, adj: np.ndarray, claimed: np.ndarray,
                 comp_of: np.ndarray):
        self.store = store
        self.cfg = cfg
        self.stats = stats
        self.adj_off = adj_off
        self.adj = adj
        self.claimed = claimed
        self.states: dict[int, _ContigState] = {}
        self.queue: list[_Item] = []
        self.done: list[_ContigState] = []
        self.visited: dict[int, set] = {}  # cid -> rids ever enqueued
        self._mz_cache: dict[int, tuple] = {}
        self._next_cid = 0
        # Contigs per component: unconstrained concurrent seeds inside one
        # component fragment it into competing contigs, but one contig at a
        # time starves the alignment batch (frontier width ~ coverage). So
        # extra seeds are allowed only where no frontier has reached yet
        # (``touched`` = enqueued by any contig): contigs stay >=2 hops
        # apart and meet at claim boundaries — the same partitioning the
        # reference gets from its per-thread contigs
        # (reference: src/Consensus.cpp:41,444-468, thread-count-dependent).
        self.comp_of = comp_of
        self.touched = np.zeros(len(claimed), dtype=bool)
        self._comp_cursor: dict[int, int] = {}  # comp -> next seed scan pos
        self._comp_phase: dict[int, int] = {}   # 0 = fresh pass, 1 = residual
        self._comp_members: dict[int, np.ndarray] = {}
        self.comp_active: dict[int, int] = {}   # comp -> live contig count
        # batch DP: banded_dp32 on cfg.device (raises now if it has no card)
        self.device = cfg.torch_device()
        self.dp_s = 0.0             # wall inside _align (its own thread)
        self.dp_launches = 0        # CUDA kernel launches (0 on cpu)
        self.dp_pairs = 0           # pairs sent to banded_dp32
        self.dp_rows = 0            # query rows of those pairs
        self.dp_longest_rows = 0    # longest query of each such batch, summed
        self.host_pairs = 0         # pairs of batches over M_PAD_MAX rows,
        self.host_rows = 0          # sent to the host DP, and their rows

    # -- contig lifecycle ---------------------------------------------------

    def register_component(self, comp: int, members: np.ndarray) -> None:
        self._comp_members[comp] = members
        self._comp_cursor[comp] = 0
        self._comp_phase[comp] = 0
        self.comp_active[comp] = 0

    def expandable_comps(self) -> list[int]:
        return [c for c, ph in self._comp_phase.items()
                if ph == 0 and c in self._comp_members]

    def activate_next_in_comp(self, comp: int, fresh_only: bool = False) -> bool:
        """Claim the next eligible seed of a component; False if none.

        The fresh pass only seeds untouched reads (keeps concurrent contigs
        separated); the residual pass reclaims unclaimed leftovers and only
        runs once the component has no live contigs. Iterates until an
        activated seed actually has work (a seed whose neighbors were all
        claimed by earlier contigs finalizes instantly).
        """
        min_len = max(self.cfg.kmer_size, self.cfg.min_read_len_for_sketch)
        while True:
            members = self._comp_members.get(comp)
            if members is None:
                return False
            fresh = self._comp_phase[comp] == 0
            if not fresh and (fresh_only or self.comp_active.get(comp, 0) > 0):
                return False
            cur = self._comp_cursor[comp]
            seed = -1
            while cur < len(members):
                s = int(members[cur])
                cur += 1
                if self.claimed[s] or self.store.lengths[s] < min_len:
                    continue
                if fresh and self.touched[s]:
                    continue
                seed = s
                break
            self._comp_cursor[comp] = cur
            if seed < 0:
                if fresh:
                    self._comp_phase[comp] = 1
                    self._comp_cursor[comp] = 0
                    continue
                del self._comp_members[comp]
                return False
            if self._activate_seed(seed):
                return True

    def _activate_seed(self, seed: int) -> bool:
        """Start a contig at ``seed``; False if it had no live frontier."""
        self.claimed[seed] = True
        self.touched[seed] = True
        cid = self._next_cid
        self._next_cid += 1
        st = _ContigState(cid, seed, self.store.get_codes(seed), self.cfg)
        st.add_seed_member(seed, st.cons)
        self.states[cid] = st
        self.visited[cid] = {seed}
        self.comp_active[int(self.comp_of[seed])] += 1
        self._enqueue_children(st, seed)
        if st.pending == 0:
            self._finalize(st, reseed=False)
            return False
        return True

    def _enqueue_children(self, st: _ContigState, rid: int) -> None:
        vis = self.visited[st.cid]
        for r2 in self.adj[self.adj_off[rid]: self.adj_off[rid + 1]]:
            r2 = int(r2)
            if not self.claimed[r2] and r2 not in vis:
                vis.add(r2)
                self.touched[r2] = True
                self.queue.append(_Item(st.cid, r2, rid))
                st.pending += 1

    def _finalize(self, st: _ContigState, reseed: bool = True) -> None:
        if st.cid not in self.states:
            return
        del self.states[st.cid]
        del self.visited[st.cid]
        if len(st.members) > 1:
            self.done.append(st)
        else:
            self.claimed[st.members[0].rid] = False  # lone after all
        comp = int(self.comp_of[st.members[0].rid])
        self.comp_active[comp] -= 1
        if reseed:
            # hand the component to its next unclaimed seed (residual reads
            # the finished contig failed to absorb get their own chance)
            self.activate_next_in_comp(comp)

    # -- frontier batch -----------------------------------------------------

    def _align(self, tf, t_off, t_len, qf, q_off, q_len, d0) -> al.AlignResult:
        """Run one frontier batch by the reference's route rule: a batch
        whose longest query is at most ``at.M_PAD_MAX`` rows goes to
        ``banded_dp32`` on ``cfg.device`` (the kernel on cuda, its plain
        version on cpu; band fixed at [-128, 127], ``CompressConfig``
        refuses a wider one), a longer one to the exact host DP at
        ``cfg.band_width``. The split depends on the query length alone."""
        t0 = time.perf_counter()
        cfg = self.cfg
        longest = int(np.max(q_len))
        if longest > at.M_PAD_MAX:
            res = al.banded_align_batch(
                tf, t_off, t_len, qf, q_off, q_len, d0,
                band=cfg.band_width,
                max_cost_per_kb=int(cfg.max_edit_frac * 1000),
            )
            self.host_pairs += len(q_len)
            self.host_rows += int(np.sum(q_len))
        else:
            n0 = at.banded_dp32.launches
            res = at.banded_align_batch_32(
                tf, t_off, t_len, qf, q_off, q_len, d0,
                max_cost_per_kb=int(cfg.max_edit_frac * 1000),
                device=self.device,
            )
            self.dp_launches += at.banded_dp32.launches - n0
            self.dp_pairs += len(q_len)
            self.dp_rows += int(np.sum(q_len))
            self.dp_longest_rows += longest
        self.dp_s += time.perf_counter() - t0
        return res

    def counters(self) -> dict:
        return {"dp": self.dp_s, "dp_kernel_launches": self.dp_launches,
                "dp_kernel_pairs": self.dp_pairs,
                "dp_kernel_rows": self.dp_rows,
                "dp_kernel_longest_rows": self.dp_longest_rows,
                "host_routed_long_pairs": self.host_pairs,
                "host_routed_long_rows": self.host_rows}

    def _forward_minimizers(self, rid: int, codes: np.ndarray):
        a = self._mz_cache.get(rid)
        if a is None:
            h, p, f = mz.minimizers(codes, self.cfg.seed_kmer_size,
                                    self.cfg.seed_window)
            a = mz.prepare_anchors(h, p.astype(np.int64), f)
            self._mz_cache[rid] = a
        return a

    def _place(self, it: _Item) -> _Placed | None:
        """Host anchoring: candidate -> (orientation, clipped window, d0)."""
        cfg = self.cfg
        st = self.states.get(it.cid)
        if st is None or st.closed:
            return None
        pa = st.anchors.get(it.parent)
        if pa is None:
            return None
        codes_fwd = self.store.get_codes(it.rid)
        r_h, r_p, r_f = self._forward_minimizers(it.rid, codes_fwd)
        if len(r_h) == 0:
            return None
        m = mz.match_anchors_prepared(
            pa[0], pa[1], pa[2], r_h, r_p, r_f, len(codes_fwd),
            cfg.seed_kmer_size, max_anchors=cfg.max_chain_iter,
        )
        if m is None:
            return None
        is_rc, d0_abs, _votes = m
        codes = _orient_codes(codes_fwd, int(is_rc))
        mlen = len(codes)
        band = cfg.band_width
        # clip the query to the predicted overlap window: overhangs past the
        # consensus ends would walk out of the band as insertion runs, so
        # align only [qlo, qhi) and re-attach the clipped ends as head/tail
        # insertions (which accept() converts to consensus growth).
        qlo = max(0, (st.lo - d0_abs) - band // 2)
        qhi = min(mlen, (st.hi - d0_abs) + band // 2)
        if qhi - qlo < cfg.min_overlap:
            return None
        # clip the DP target to the band-reachable consensus window
        wlo = max(st.lo, d0_abs + qlo - band)
        whi = min(st.hi, d0_abs + qhi + band)
        return _Placed(
            item=it, is_rc=int(is_rc), codes=codes, qlo=qlo, qhi=qhi,
            wlo=wlo, whi=whi, snap_lo=st.lo, snap_hi=st.hi,
            d0_win=(d0_abs + qlo) - wlo,
            fwd_anchors=(r_h, r_p, r_f),
        )

    def collect_batch(self) -> tuple[list[_Placed], list[_Item]]:
        """Pop + place up to align_batch frontier items (host-side work)."""
        batch: list[_Placed] = []
        consumed: list[_Item] = []
        while self.queue and len(batch) < self.cfg.align_batch:
            it = self.queue.pop()
            consumed.append(it)
            if self.claimed[it.rid]:
                continue
            self.stats.not_claimed += 1
            p = self._place(it)
            if p is not None:
                batch.append(p)
        return batch, consumed

    def build_arrays(self, batch: list[_Placed]):
        """Snapshot the batch's DP inputs (targets copied out of the live
        consensus buffers, so later splices can't corrupt an in-flight DP)."""
        if not batch:
            return None
        t_parts = [self.states[p.item.cid].cons[p.wlo - self.states[p.item.cid].lo:
                                                p.whi - self.states[p.item.cid].lo]
                   for p in batch]
        q_parts = [p.codes[p.qlo:p.qhi] for p in batch]
        t_len = np.array([len(t) for t in t_parts], dtype=np.int64)
        q_len = np.array([len(q) for q in q_parts], dtype=np.int64)
        t_off = np.zeros(len(batch), np.int64)
        np.cumsum(t_len[:-1], out=t_off[1:])
        q_off = np.zeros(len(batch), np.int64)
        np.cumsum(q_len[:-1], out=q_off[1:])
        return (np.concatenate(t_parts), t_off, t_len,
                np.concatenate(q_parts), q_off, q_len,
                np.array([p.d0_win for p in batch], np.int64))

    def apply_batch(self, batch: list[_Placed], consumed: list[_Item],
                    res: al.AlignResult | None) -> None:
        if res is not None:
            for bi, p in enumerate(batch):
                self._apply(p, res, bi)
        # decrement pending and finalize drained contigs
        for it in consumed:
            st = self.states.get(it.cid)
            if st is None:
                continue
            st.pending -= 1
            if st.pending == 0:
                self._finalize(st)

    def run_batch(self) -> None:
        batch, consumed = self.collect_batch()
        arrays = self.build_arrays(batch)
        res = self._align(*arrays) if arrays else None
        self.apply_batch(batch, consumed, res)

    def _apply(self, p: _Placed, res: al.AlignResult, bi: int) -> None:
        it = p.item
        st = self.states.get(it.cid)
        if st is None or st.closed or self.claimed[it.rid]:
            return
        if res.cost[bi] < 0:
            return
        mlen = len(p.codes)
        core_ops = res.ops_flat[res.ops_off[bi]: res.ops_off[bi] + res.ops_len[bi]]
        ops = np.concatenate([
            np.full(p.qlo, ord("i"), dtype=np.uint8),
            core_ops,
            np.full(mlen - p.qhi, ord("i"), dtype=np.uint8),
        ])
        tstart_abs = p.wlo + int(res.tstart[bi])
        tend_abs = p.wlo + int(res.tend[bi])
        # The result wanted to splice its overhang onto a consensus end that
        # another batch member already extended (only the first splicer of
        # an end wins; coords are absolute so interior results stay valid).
        # Accepting now would store the whole overhang as insertion runs —
        # retry instead: once the end stabilizes the overhang aligns
        # against the newly grown consensus. Bounded by coverage, so the
        # attempt cap is just a livelock guard.
        head_run = int(np.argmax(ops != ord("i"))) if (ops != ord("i")).any() else len(ops)
        tail_run = (int(np.argmax(ops[::-1] != ord("i")))
                    if (ops != ord("i")).any() else 0)
        head_lost = head_run > 0 and tstart_abs == p.snap_lo and st.lo != p.snap_lo
        tail_lost = tail_run > 0 and tend_abs == p.snap_hi and st.hi != p.snap_hi
        # Stale-placement variant (the DP pipeline places against a snapshot
        # one batch older): the query was clipped to the snapshot extents and
        # the contig has since grown past them — a fresh placement would
        # align the clipped overhang instead of storing it as insertions.
        head_lost |= head_run > 0 and p.qlo > 0 and st.lo < p.snap_lo
        tail_lost |= tail_run > 0 and p.qhi < mlen and st.hi > p.snap_hi
        if (head_lost or tail_lost) and it.attempts < 8:
            it.attempts += 1
            self.queue.append(it)
            st.pending += 1
            return
        self.stats.aligned_ok += 1
        self.claimed[it.rid] = True
        self._mz_cache.pop(it.rid, None)
        st.accept(it.rid, p.is_rc, tstart_abs, tend_abs, ops,
                  int(res.cost[bi]), p.codes, p.fwd_anchors)
        if self.cfg.checks:
            _check_member(st, st.members[-1], p.codes)
        self._enqueue_children(st, it.rid)
        if st.total_aligned > self.cfg.edge_threshold:
            st.closed = True


def _precompute_minimizers(store, cfg: CompressConfig):
    """Whole-dataset per-read minimizer tables (prepared/deduped), computed
    on host threads. Launched in the background so it overlaps the TPU
    sketch wait; the engine then memcpys slices instead of re-extracting
    per candidate (~1s of the 60 Mb bench). Returns (off, h, p, f)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    N = store.num_reads
    packed = store.packed
    if not packed.flags["C_CONTIGUOUS"]:
        packed = np.ascontiguousarray(packed)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    counts = np.zeros(N, np.int64)
    args0 = (packed.ctypes.data_as(u8p), store.offsets.ctypes.data_as(i64p),
             store.lengths.ctypes.data_as(i64p), ctypes.c_int64(N),
             ctypes.c_int32(cfg.seed_kmer_size),
             ctypes.c_int32(cfg.seed_window))
    nullh = ctypes.cast(None, u64p)
    null64 = ctypes.cast(None, i64p)
    null8 = ctypes.cast(None, u8p)
    lib.ns_minimizers_all(*args0, ctypes.c_int32(0),
                          counts.ctypes.data_as(i64p), nullh, null64, null8)
    off = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    total = int(off[-1])
    h = np.empty(total, np.uint64)
    p = np.empty(total, np.int64)
    f = np.empty(total, np.uint8)
    lib.ns_minimizers_all(*args0, ctypes.c_int32(1),
                          off.ctypes.data_as(i64p), h.ctypes.data_as(u64p),
                          p.ctypes.data_as(i64p), f.ctypes.data_as(u8p))
    return off, h, p, f


# minimizer tables cost ~0.7 B/base; precompute only when that fits
# comfortably (the engine falls back to on-demand builds above this)
PREMZ_MAX_BASES = int(float(os.environ.get("NSTPU_PREMZ_MAX_BASES", 8e9)))


def _build_candidate_graph(store, cfg: CompressConfig, stats: FunnelStats,
                           report: bool) -> dict:
    """Sketch + hash-join + components + repetitive screen (the shared,
    device-side half of the pipeline)."""
    N = store.num_reads
    premz_fut = None
    # The precomputed minimizer tables STAY ON in low-mem runs: measured
    # at 1 Gbase (round 5), disabling them pushed the engine onto its
    # on-demand mz_cache, whose per-read vector/map overhead grew peak
    # RSS 1.73 -> 3.18 GB — the packed tables (~0.7 B/base) are the
    # cheaper memory by >2x AND avoid recomputing minimizers per
    # placement. (An earlier advisor note flagged the low-mem gate here
    # as a silent no-op; making it effective was measured worse on both
    # axes, so the gate is deliberately absent — this comment is the
    # record.)
    if (not getattr(cfg, "disable_assembly", False)
            and cfg.aligner != "python"
            and 0 < store.total_bases <= PREMZ_MAX_BASES):
        import concurrent.futures as _cf

        _premz_pool = _cf.ThreadPoolExecutor(1)
        try:
            from .. import native as _nat

            _nat.get_lib()
            premz_fut = _premz_pool.submit(_precompute_minimizers, store, cfg)
        except Exception:
            premz_fut = None
        finally:
            _premz_pool.shutdown(wait=False)

    def _sketch_and_join(c: CompressConfig):
        sketches = compute_all_sketches(store, c, report)
        nat = candidates.all_pairs_native(sketches, c.overlap_sketch_threshold,
                                          getattr(c, "max_bucket", 256))
        if nat is not None:
            q_, r_, _cnt = nat
            return q_, r_
        index = candidates.SketchIndex(sketches,
                                       getattr(c, "max_bucket", 256))
        pairs_q: list[np.ndarray] = []
        pairs_r: list[np.ndarray] = []
        B = c.sketch_batch_reads
        for i in range(0, N, B):
            q, r, _hits = index.query(sketches[i: i + B],
                                      c.overlap_sketch_threshold)
            keep = (q + i) != r
            pairs_q.append(q[keep] + i)
            pairs_r.append(r[keep])
        q_ = np.concatenate(pairs_q) if pairs_q else np.zeros(0, np.int64)
        r_ = np.concatenate(pairs_r) if pairs_r else np.zeros(0, np.int64)
        return q_, r_

    _t0 = time.perf_counter()
    candidates.reset_join_stats()
    pq, pr = _sketch_and_join(cfg)
    first = len(pq)
    # Adaptive recovery for high-error data (hs1-like old basecaller):
    # k=23 minhash sketches barely collide at ~10% error, so a sparse
    # candidate graph (< ~1.5 neighbors/read; healthy data sits at 30+)
    # triggers one re-sketch with a shorter k-mer and a lower slot
    # threshold. The reference has no such fallback — its hs1 ratio decays
    # with the same fixed parameters (logs/2022/hs1.log).
    fired = bool(N and len(pq) * 2 < 3 * N and cfg.kmer_size > 17)
    if fired:
        cfg2 = dataclasses.replace(
            cfg, kmer_size=17,
            overlap_sketch_threshold=max(3, cfg.overlap_sketch_threshold // 2))
        with observe.current().stage("graph.resketch"):
            pq2, pr2 = _sketch_and_join(cfg2)
        if len(pq2) > len(pq):
            if report:
                print(f"[nstpu] sparse candidate graph "
                      f"({len(pq)} pairs / {N} reads): re-sketched with "
                      f"k=17 thr={cfg2.overlap_sketch_threshold} -> "
                      f"{len(pq2)} pairs")
            pq, pr = pq2, pr2
    stats.minhash_hits += len(pq)
    stats.capped_buckets += candidates.JOIN_STATS["dropped_buckets"]
    stats.capped_reads += candidates.JOIN_STATS["capped_reads"]
    _merge_timings(PIPE_STAGES, {"sketch_join": time.perf_counter() - _t0,
                                 "capped_buckets":
                                     candidates.JOIN_STATS["dropped_buckets"],
                                 "capped_reads":
                                     candidates.JOIN_STATS["capped_reads"],
                                 "join_pairs_first": first,
                                 "join_pairs_kept": len(pq),
                                 "resketch_fired": int(fired)})
    _t0 = time.perf_counter()

    # adjacency CSR over both directions
    src = np.concatenate([pq, pr])
    dst = np.concatenate([pr, pq])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=N)
    adj_off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(deg, out=adj_off[1:])

    # overlap components of the pair graph: disjoint work units — the
    # owner-computes partition that shards contig building across workers
    # here and across hosts at scale (replaces the reference's shared
    # inGraph[] + striped locks, src/Consensus.cpp:256-277,444-468)
    try:
        import ctypes

        from .. import native as _nat

        _lib = _nat.get_lib()
        comp_of = np.empty(N, dtype=np.int64)
        _pq = np.ascontiguousarray(pq, dtype=np.int64)
        _pr = np.ascontiguousarray(pr, dtype=np.int64)
        _i64p = ctypes.POINTER(ctypes.c_int64)
        n_comp = int(_lib.ns_components(
            _pq.ctypes.data_as(_i64p), _pr.ctypes.data_as(_i64p),
            ctypes.c_int64(len(_pq)), ctypes.c_int64(N),
            comp_of.ctypes.data_as(_i64p)))
    except Exception:
        import scipy.sparse as sp
        from scipy.sparse import csgraph

        g = sp.csr_matrix(
            (np.ones(len(src), dtype=np.int8), (src, dst)), shape=(N, N)
        )
        n_comp, comp_of = csgraph.connected_components(g, directed=False)
    comp_sizes = np.bincount(comp_of, minlength=n_comp)
    comp_order = np.argsort(comp_of, kind="stable")
    boundaries = np.zeros(n_comp + 1, dtype=np.int64)
    np.cumsum(comp_sizes, out=boundaries[1:])

    _merge_timings(PIPE_STAGES, {"components": time.perf_counter() - _t0})
    _t0 = time.perf_counter()
    rep = repetitive_screen(store, cfg)
    stats.repetitive = int(rep.sum())
    _merge_timings(PIPE_STAGES, {"screen": time.perf_counter() - _t0})
    premz = None
    if premz_fut is not None:
        try:
            with observe.current().stage("graph.premz_wait"):
                premz = premz_fut.result()
        except Exception:
            premz = None
    return {
        "adj_off": adj_off, "dst": dst, "comp_of": comp_of,
        "n_comp": n_comp, "comp_order": comp_order, "boundaries": boundaries,
        "rep": rep, "premz": premz,
    }


class _ShimState:
    """Minimal contig-state shim around the native engine's output, duck-
    typed for _emit_group / check_contigs."""

    __slots__ = ("cons", "lo", "members")

    def __init__(self, cons, members):
        self.cons = cons
        self.lo = 0
        self.members = members


class _DeviceDpHook:
    """Registers the banded-DP kernel as the engine's batch DP backend.

    Same buffer ABI as the JAX package's ``_TpuDpHook`` (engine.cpp
    ``dp_run_tpu``): ``P_CAP`` pairs, target windows ``tw = M_CAP + 384``,
    queries ``qw = M_CAP + 256``, one trace byte per query row, padding
    pairs with ``q_len`` 0 after the used ones. The engine fills the host
    buffers (pinned on ``cuda``) and calls the callback from its C++ DP
    thread; the callback copies only the used pairs and query rows to the
    card, runs ``ops.align_tpu.banded_dp16`` there and copies the outputs
    back before it returns.

    A failure must not pass for success: the engine reruns a batch on the
    host when the callback returns nonzero, so the callback keeps the
    exception in ``error``, returns 1 for this and every later batch, and
    ``_grow_components_engine`` raises it once the engine returns."""

    P_CAP = 512

    def __init__(self, lib, device, max_read_len: int):
        import torch

        from ..ops import align_tpu as at

        self.M_CAP = min(at.M_ROWS_MAX,
                         max(512, 1 << (int(max_read_len) - 1).bit_length()))
        self.lib = lib
        self.device = device
        self._at = at
        self._torch = torch
        P, tw, qw = self.P_CAP, self.M_CAP + 3 * 128, self.M_CAP + 2 * 128
        pin = device.type == "cuda"
        u8, i32 = torch.uint8, torch.int32

        def host(shape, dt):
            return torch.zeros(shape, dtype=dt, pin_memory=pin)

        self.host = {"tpad": host((P, tw), u8), "queries": host((P, qw), u8),
                     "trace": host((P, self.M_CAP), u8)}
        for name in ("d0", "q_len", "t_len", "max_cost", "cost", "ts", "te"):
            self.host[name] = host(P, i32)
        self.np = {k: v.numpy() for k, v in self.host.items()}
        self.dev = None
        self._mem0 = 0
        if pin:
            # the peak the hook reports is counted from here: what the
            # process held before (the caller's tensors) is left out
            torch.cuda.reset_peak_memory_stats(device)
            self._mem0 = torch.cuda.memory_allocated(device)
            self.dev = {k: torch.empty(self.host[k].shape, dtype=t.dtype,
                                       device=device)
                        for k, t in self.host.items()
                        if k in ("tpad", "queries", "d0", "q_len", "t_len",
                                 "max_cost")}
        self.batches = 0            # batches the hook ran
        self.pairs = 0              # pairs sent to the DP
        self.rows = 0               # query rows of those pairs
        self.longest_rows = 0       # longest query of each batch, summed
        self.escaped = 0            # accepted pairs with a 255 trace byte
        self.kernel_launches = 0    # CUDA kernel launches (0 on cpu)
        # on cuda, per batch: events around the kernel, their seconds
        # summed (0 on cpu); a first record makes the events the launcher
        # records
        self.events = ([torch.cuda.Event(enable_timing=True)
                        for _ in range(2)] if pin else None)
        for ev in self.events or ():
            ev.record(torch.cuda.current_stream(device))
        self.kernel_event_s = 0.0
        self.batch = -1             # the engine's number of the batch in hand
        self.owner = None           # native id of the thread running the engine
        self.error: BaseException | None = None
        # with NSTPU_DP_RECORD=DIR set, the process's first batch and its
        # largest (pairs x longest query) are kept in DIR, inputs and
        # outputs, as dp_<pid>_first.npz and dp_<pid>_largest.npz, to be
        # replayed on the kernel's plain version (chip_smoke.py --big)
        self.record_dir = os.environ.get("NSTPU_DP_RECORD")
        self.record_size = -1

        # the callback holds the hook weakly: a reference cycle would keep
        # the hook's pinned buffers resident until the garbage collector
        # ran, beside the next job's
        me = weakref.ref(self)

        @ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_int64, ctypes.c_int64)
        def _cb(n_pairs, batch):
            hook = me()
            if hook.error is not None:
                return 1
            if threading.get_native_id() != hook.owner:
                # the engine's DP thread, which Python names anew each call
                threading.current_thread().name = "engine.dp"
            hook.batch = int(batch)
            try:
                hook._run(int(n_pairs))
                return 0
            except BaseException as e:  # noqa: BLE001 - re-raised by caller
                hook.error = e
                return 1

        self._cb = _cb  # keep the callback object alive

    def _run(self, n_pairs: int) -> None:
        torch = self._torch
        h = self.np
        q_len = h["q_len"][:n_pairs]
        P = int(np.count_nonzero(q_len))     # used pairs come first
        if P == 0:
            return
        m_rows = int(q_len[:P].max())
        self.batches += 1
        self.pairs += P
        self.rows += int(q_len[:P].sum())
        self.longest_rows += m_rows
        tr = observe.current()

        @contextlib.contextmanager
        def span(name):
            with tr.stage(name):
                tr.note(batch=self.batch)
                yield

        scal = ("d0", "q_len", "t_len", "max_cost")
        if self.dev is None:
            with span("dp.hook.copy_in"):
                args = [torch.from_numpy(h[k][:P]) for k in scal]
                tpad = torch.from_numpy(h["tpad"][:P, :m_rows + 128])
                queries = torch.from_numpy(h["queries"][:P, :m_rows])
            with span("dp.hook.launch"):
                cost, _ln, ts, te, trace = self._at.banded_dp16(
                    *args, tpad, queries, m_rows=m_rows)
            with span("dp.hook.copy_out"):
                h["cost"][:P] = cost.numpy()
                h["ts"][:P] = ts.numpy()
                h["te"][:P] = te.numpy()
                h["trace"][:P, :m_rows] = trace.numpy()
            with span("dp.hook.escape"):
                rows = np.arange(m_rows)[None, :] < h["q_len"][:P, None]
                esc = ((h["trace"][:P, :m_rows] == 255) & rows).any(axis=1)
                self.escaped += int((esc & (h["cost"][:P] >= 0)).sum())
            self._record(P, m_rows)
            return
        from ..ops import _cuda

        dev, d, hs, ev = self.device, self.dev, self.host, self.events
        lib = _cuda.get_lib()
        with torch.cuda.device(dev):
            stream = _cuda.stream_handle(dev)
            with span("dp.hook.copy_in"):
                for k in scal:
                    d[k][:P].copy_(hs[k][:P], non_blocking=True)
                for k, width in (("tpad", m_rows + 128), ("queries", m_rows)):
                    _cuda.check(lib.ns_copy2d(
                        d[k].data_ptr(), d[k].stride(0), hs[k].data_ptr(),
                        hs[k].stride(0), width, P, stream), f"copy {k}")
            with span("dp.hook.launch"):
                launches0 = self._at.banded_dp16.launches
                cost, _ln, ts, te, trace = self._at.banded_dp16(
                    *(d[k][:P] for k in scal), d["tpad"][:P, :m_rows + 128],
                    d["queries"][:P, :m_rows], m_rows=m_rows,
                    events=ev)
                self.kernel_launches += (self._at.banded_dp16.launches
                                         - launches0)
            with span("dp.hook.copy_out"):
                for k, v in (("cost", cost), ("ts", ts), ("te", te)):
                    hs[k][:P].copy_(v, non_blocking=True)
                _cuda.check(lib.ns_copy2d(
                    hs["trace"].data_ptr(), hs["trace"].stride(0),
                    trace.data_ptr(), trace.stride(0), m_rows, P, stream),
                    "copy trace")
            with span("dp.hook.escape"):
                rows = (torch.arange(m_rows, device=dev)[None, :]
                        < d["q_len"][:P, None])
                esc = ((trace == 255) & rows).any(dim=1) & (cost >= 0)
                n_esc = esc.sum()
            with span("dp.hook.sync"):
                torch.cuda.current_stream(dev).synchronize()
            self.escaped += int(n_esc)
            # the events were recorded on the stream that was just
            # synchronised, so reading them waits for nothing
            self.kernel_event_s += ev[0].elapsed_time(ev[1]) / 1e3
        self._record(P, m_rows)

    def _record(self, P: int, m_rows: int) -> None:
        if not self.record_dir or P * m_rows <= self.record_size:
            return
        slot = "first" if self.record_size < 0 else "largest"
        self.record_size = P * m_rows
        h = self.np
        np.savez(os.path.join(self.record_dir,
                              f"dp_{os.getpid()}_{slot}.npz"),
                 m_cap=self.M_CAP, tpad=h["tpad"][:P, :m_rows + 128],
                 queries=h["queries"][:P, :m_rows],
                 trace=h["trace"][:P, :m_rows],
                 **{k: h[k][:P] for k in ("d0", "q_len", "t_len", "max_cost",
                                          "cost", "ts", "te")})

    def counters(self) -> dict:
        """The hook's DP counters; a process whose hook launched the
        kernel counts once in ``dp_workers_launched``; on ``cuda``
        ``dp_worker_peak_bytes`` is the device memory that the hook's
        buffers and launches held at their peak (the process's
        ``torch.cuda.max_memory_allocated`` since the hook was made, less
        what it held then); ``dp_hook_m_cap`` is the hook's row capacity
        (both take the largest over workers); ``dp_kernel_event_s`` is the
        kernel's device seconds by CUDA events (0 on cpu)."""
        peak = (self._torch.cuda.max_memory_allocated(self.device)
                - self._mem0 if self.dev is not None else 0)
        return {"dp_hook_batches": self.batches,
                "dp_kernel_launches": self.kernel_launches,
                "dp_kernel_pairs": self.pairs,
                "dp_kernel_rows": self.rows,
                "dp_kernel_longest_rows": self.longest_rows,
                "dp_escaped_pairs": self.escaped,
                "dp_workers_launched": int(self.kernel_launches > 0),
                "dp_worker_peak_bytes": peak,
                "dp_hook_m_cap": self.M_CAP,
                "dp_kernel_event_s": self.kernel_event_s}

    def install(self, mode: int) -> None:
        self.owner = threading.get_native_id()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        h = self.np
        self.lib.ns_engine_set_tpu(
            ctypes.cast(self._cb, ctypes.c_void_p),
            h["tpad"].ctypes.data_as(u8p), h["queries"].ctypes.data_as(u8p),
            h["d0"].ctypes.data_as(i32p), h["q_len"].ctypes.data_as(i32p),
            h["t_len"].ctypes.data_as(i32p),
            h["max_cost"].ctypes.data_as(i32p),
            h["cost"].ctypes.data_as(i32p), h["ts"].ctypes.data_as(i32p),
            h["te"].ctypes.data_as(i32p), h["trace"].ctypes.data_as(u8p),
            ctypes.c_int64(self.P_CAP), ctypes.c_int64(self.M_CAP),
            ctypes.c_int32(mode))

    def clear(self) -> None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        null8 = ctypes.cast(None, u8p)
        null32 = ctypes.cast(None, i32p)
        self.lib.ns_engine_set_tpu(
            None, null8, null8, null32, null32, null32, null32,
            null32, null32, null32, null8,
            ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int32(0))


def _probe_wanted(store, cfg: CompressConfig) -> bool:
    """Whether ``aligner="auto"`` probes the device DP: the JAX package's
    gate, under its environment names, with "a chip is attached" read as
    ``device="cuda"`` (which raises where there is no card). It probes
    when the store holds at least ``NSTPU_PROBE_MIN_BASES`` bases (2e7 by
    default; the warm-up and probe batches only pay off on real inputs)
    or ``NSTPU_TPU_PROBE=1``, and never with ``NSTPU_TPU_PROBE=0``."""
    env = os.environ.get("NSTPU_TPU_PROBE")
    if cfg.device != "cuda" or env == "0":
        return False
    return env == "1" or store.total_bases >= int(float(
        os.environ.get("NSTPU_PROBE_MIN_BASES", 2e7)))


def _probe_verdict(lib) -> dict:
    """The engine's last probe (``ns_engine_probe_info``) as counters
    that sum over worker processes: both timed sides of the probe batch,
    and one count for the side that won. A process whose run reached no
    probe batch (none of 64 pairs or more) counts for neither. The
    verdict is cached per process and kernel shape, so a later run of the
    same shape in one process reports, and follows, the first one's."""
    dev_s, nat_s = ctypes.c_double(), ctypes.c_double()
    dec = ctypes.c_int32()
    lib.ns_engine_probe_info(ctypes.byref(dev_s), ctypes.byref(nat_s),
                             ctypes.byref(dec))
    probed = dec.value >= 0
    return {"dp_probe_device_s": dev_s.value if probed else 0.0,
            "dp_probe_native_s": nat_s.value if probed else 0.0,
            "dp_probe_device_workers": int(dec.value == 1),
            "dp_probe_native_workers": int(dec.value == 0)}


# ns_engine_spans' kinds and threads, by their numbers in native/engine.cpp
ENGINE_SPANS = ("engine.collect", "engine.settle", "engine.wait_dp",
                "engine.dp_starved", "dp.pack", "dp.hook", "dp.expand",
                "dp.host_routed")
ENGINE_THREADS = ("engine.main", "engine.dp")


def _engine_spans(lib, h, tr) -> None:
    """The engine run ``h``'s per-batch records, added to ``tr`` as spans
    with their batch numbers. Nothing happens where ``tr`` records
    nothing."""
    if tr is observe.NO_TRACER:
        return
    n = lib.ns_engine_spans(ctypes.c_void_p(h), 0, None, None, None, None,
                            None)
    kind = np.empty(n, np.int32)
    thread = np.empty(n, np.int32)
    batch = np.empty(n, np.int64)
    t0 = np.empty(n, np.float64)
    t1 = np.empty(n, np.float64)
    lib.ns_engine_spans(ctypes.c_void_p(h), n,
                        kind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        thread.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        t0.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        t1.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    for k, th, b, a, z in sorted(zip(kind.tolist(), thread.tolist(),
                                     batch.tolist(), t0.tolist(),
                                     t1.tolist()), key=lambda r: r[3]):
        tr.record(ENGINE_SPANS[k], a, z, ENGINE_THREADS[th], batch=b)


def _grow_components_engine(store, cfg: CompressConfig, stats: FunnelStats,
                            graph: dict, comp_subset) -> dict:
    """Whole grow loop in C++ (native/engine.cpp). With
    ``aligner="device"`` the engine's batch DP runs through
    ``_DeviceDpHook`` in mode 1 (every batch it can take); with
    ``aligner="auto"``, where ``_probe_wanted``, in mode 2 (a warm-up
    batch and a probe batch run on both sides, the host's results kept,
    then the faster side runs the rest). A hook that fails raises in
    either mode."""
    from .. import native

    lib = native.get_lib()
    hook = None
    mode = 1 if cfg.aligner == "device" else 2
    if cfg.aligner == "device" or (cfg.aligner == "auto"
                                   and _probe_wanted(store, cfg)):
        max_len = int(store.lengths.max()) if store.num_reads else 8192
        hook = _DeviceDpHook(lib, cfg.torch_device(), max_len)
    comp_order = graph["comp_order"]
    boundaries = graph["boundaries"]
    comps = []
    memb_parts = []
    for comp in comp_subset:
        members = comp_order[boundaries[comp]: boundaries[comp + 1]]
        if len(members) < 2:
            continue
        comps.append(comp)
        memb_parts.append(np.ascontiguousarray(members, dtype=np.int64))
    comps_a = np.asarray(comps, dtype=np.int64)
    memb_off = np.zeros(len(comps) + 1, np.int64)
    np.cumsum([len(m) for m in memb_parts], out=memb_off[1:])
    memb_flat = (np.concatenate(memb_parts) if memb_parts
                 else np.zeros(0, np.int64))
    claimed = np.ascontiguousarray(graph["rep"], dtype=np.uint8).copy()
    packed = store.packed
    if not packed.flags["C_CONTIGUOUS"]:
        packed = np.ascontiguousarray(packed)
    params = np.array([
        cfg.seed_kmer_size, cfg.seed_window, cfg.max_chain_iter,
        cfg.band_width, int(cfg.max_edit_frac * 1000), cfg.min_overlap,
        cfg.align_batch, cfg.frontier_target, cfg.edge_threshold,
        max(cfg.kmer_size, cfg.min_read_len_for_sketch),
        cfg.max_place_attempts,
        min(cfg.band_width_min, cfg.band_width),
        1 if cfg.polish_rounds > 0 else 0,   # in-engine polish
    ], dtype=np.int64)
    adj_off = np.ascontiguousarray(graph["adj_off"], np.int64)
    adj = np.ascontiguousarray(graph["dst"], np.int64)
    comp_of = np.ascontiguousarray(graph["comp_of"], np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    premz = graph.get("premz")
    if premz is not None:
        pz_off, pz_h, pz_p, pz_f = premz
        lib.ns_engine_set_premz(
            pz_off.ctypes.data_as(i64p), pz_h.ctypes.data_as(u64p),
            pz_p.ctypes.data_as(i64p), pz_f.ctypes.data_as(u8p))
    c64 = lambda a: a.ctypes.data_as(i64p)
    nc = ctypes.c_int64()
    nm = ctypes.c_int64()
    ctot = ctypes.c_int64()
    otot = ctypes.c_int64()
    st2 = np.zeros(2, np.int64)
    if hook is not None:
        hook.install(mode)
    tr = observe.current()
    _t_eng = time.perf_counter()
    h = lib.ns_engine_run(
        packed.ctypes.data_as(u8p), c64(store.offsets), c64(store.lengths),
        ctypes.c_int64(store.num_reads),
        c64(adj_off), c64(adj), c64(comp_of),
        c64(comps_a), c64(memb_off), c64(memb_flat),
        ctypes.c_int64(len(comps)),
        claimed.ctypes.data_as(u8p), c64(params),
        ctypes.byref(nc), ctypes.byref(nm), ctypes.byref(ctot),
        ctypes.byref(otot), c64(st2),
    )
    try:
        if hook is not None and hook.error is not None:
            raise RuntimeError("device DP hook failed") from hook.error
        _eng_wall = time.perf_counter() - _t_eng
        _engine_spans(lib, h, tr)
        _tim = np.zeros(31, np.float64)
        lib.ns_engine_timings(ctypes.c_void_p(h),
                              _tim.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_double)))
        timings = {
            "place": _tim[0], "dp": _tim[1], "apply": _tim[2],
            "polish": _tim[3], "dp_stitch": _tim[6], "dp_full": _tim[7],
            "dp_tpu": _tim[8], "engine_wall": _eng_wall,
            "dp_pairs": _tim[10], "dp_bases": _tim[11],
            "stitch_bases": _tim[12], "full_dp_bases": _tim[13],
            "dp_rejects": _tim[14], "dp_retries": _tim[15],
            "host_routed_long_pairs": _tim[18],
            "host_routed_long_bases": _tim[19],
            "engine_wait_dp": _tim[20], "dp_starved": _tim[21],
        }
        # the host's full-band DPs by class: the escalated retries of band
        # rejects (retry_*), pairs with no anchor chain, stitch failures
        for c, name in enumerate(("nochain", "stitchfail", "retry")):
            timings[name + "_pairs"] = _tim[22 + c]
            timings[name + "_accepted"] = _tim[25 + c]
            timings[name + "_dp_s"] = _tim[28 + c]
        C, M = nc.value, nm.value
        flat_fast = not cfg.checks
        if flat_fast:
            # flat fast path, fetched in BOUNDED SLICES: the old monolithic
            # fetch materialized ops_flat + codes_flat (~2 B per aligned
            # base) in one transient — the top RSS term on Gbase-class
            # inputs. Each slice is fetched with release=1 so the engine's
            # own copy drains as the caller converts; peak extra memory is
            # one slice (~2 * EMIT_SLICE_OPS) plus the compact edit
            # streams (~0.2 B/base).
            t_emit = time.perf_counter()
            per_cons = np.empty(C, np.int64)
            per_m = np.empty(C, np.int64)
            per_ops = np.empty(C, np.int64)
            lib.ns_engine_contig_sizes(
                ctypes.c_void_p(h), c64(per_cons), c64(per_m), c64(per_ops))
            slice_cap = int(float(os.environ.get(
                "NSTPU_EMIT_SLICE_OPS", 96e6)))
            consensus_list = []
            pieces = []        # per-slice (rid, strand, es)
            u8pp = ctypes.POINTER(ctypes.c_uint8)
            i64pp = ctypes.POINTER(ctypes.c_int64)
            c0 = 0
            while c0 < C:
                c1 = c0 + 1
                acc = int(per_ops[c0])
                while c1 < C and acc + int(per_ops[c1]) <= slice_cap:
                    acc += int(per_ops[c1])
                    c1 += 1
                Ms = int(per_m[c0:c1].sum())
                with tr.stage("emit.fetch"):
                    tr.note(contigs=c1 - c0, members=Ms, ops=acc)
                    cons_flat = np.empty(int(per_cons[c0:c1].sum()),
                                         np.uint8)
                    cons_len = np.empty(c1 - c0, np.int64)
                    m_cnt_s = np.empty(c1 - c0, np.int64)
                    rid_s = np.empty(Ms, np.int64)
                    strand_s = np.empty(Ms, np.uint8)
                    tstart_s = np.empty(Ms, np.int64)
                    ops_len_s = np.empty(Ms, np.int64)
                    ops_flat = np.empty(acc, np.uint8)
                    lib.ns_engine_fetch_range(
                        ctypes.c_void_p(h), ctypes.c_int64(c0),
                        ctypes.c_int64(c1), ctypes.c_int32(1),
                        cons_flat.ctypes.data_as(u8p), c64(cons_len),
                        c64(m_cnt_s), c64(rid_s),
                        strand_s.ctypes.data_as(u8p),
                        c64(tstart_s), c64(ops_len_s),
                        ops_flat.ctypes.data_as(u8p),
                    )
                with tr.stage("emit.unpack"):
                    ops_off = np.zeros(Ms + 1, np.int64)
                    np.cumsum(ops_len_s, out=ops_off[1:])
                    codes_len = (store.lengths[rid_s].astype(np.int64) if Ms
                                 else np.zeros(0, np.int64))
                    codes_off = np.zeros(Ms + 1, np.int64)
                    np.cumsum(codes_len, out=codes_off[1:])
                    codes_flat = np.empty(int(codes_len.sum()), np.uint8)
                    lib.ns_unpack_oriented(
                        packed.ctypes.data_as(u8pp),
                        store.offsets.ctypes.data_as(i64pp),
                        store.lengths.ctypes.data_as(i64pp),
                        rid_s.ctypes.data_as(i64pp),
                        strand_s.ctypes.data_as(u8pp),
                        ctypes.c_int64(Ms), codes_off.ctypes.data_as(i64pp),
                        codes_flat.ctypes.data_as(u8pp),
                    )
                with tr.stage("emit.scripts"):
                    res = al.AlignResult(
                        cost=np.zeros(Ms, np.int32), tstart=tstart_s,
                        tend=np.zeros(Ms, np.int64),
                        ops_flat=ops_flat, ops_off=ops_off[:-1],
                        ops_len=ops_len_s,
                    )
                    es_s = al.ops_to_edit_scripts(res, np.arange(Ms),
                                                  codes_flat, codes_off[:-1],
                                                  codes_len)
                cpos = 0
                for ln in cons_len:
                    consensus_list.append(
                        cons_flat[cpos: cpos + int(ln)])
                    cpos += int(ln)
                pieces.append((rid_s, strand_s, m_cnt_s, es_s))
                c0 = c1
            m_cnt = (np.concatenate([p[2] for p in pieces]) if pieces
                     else np.zeros(0, np.int64))
            rid = (np.concatenate([p[0] for p in pieces]) if pieces
                   else np.zeros(0, np.int64))
            strand = (np.concatenate([p[1] for p in pieces]) if pieces
                      else np.zeros(0, np.uint8))
            if pieces:
                ess = [p[3] for p in pieces]
                es = al.EditScripts(*[
                    np.concatenate([getattr(e, f) for e in ess])
                    for f in ("start_pos", "head_ins", "tail_ins",
                              "n_edits", "runs_flat", "types_flat",
                              "bases_flat")])
            else:
                z = lambda dt: np.zeros(0, dtype=dt)
                es = al.EditScripts(z(np.int64), z(np.int64), z(np.int64),
                                    z(np.int64), z(np.int64), z(np.uint8),
                                    z(np.uint8))
            timings["emit"] = time.perf_counter() - t_emit
        else:
            cons_flat = np.empty(ctot.value, np.uint8)
            cons_len = np.empty(C, np.int64)
            m_cnt = np.empty(C, np.int64)
            rid = np.empty(M, np.int64)
            strand = np.empty(M, np.uint8)
            tstart_rel = np.empty(M, np.int64)
            ops_len = np.empty(M, np.int64)
            ops_flat = np.empty(otot.value, np.uint8)
            lib.ns_engine_fetch(
                ctypes.c_void_p(h), cons_flat.ctypes.data_as(u8p),
                c64(cons_len), c64(m_cnt), c64(rid),
                strand.ctypes.data_as(u8p),
                c64(tstart_rel), c64(ops_len),
                ops_flat.ctypes.data_as(u8p),
            )
    finally:
        lib.ns_engine_free(ctypes.c_void_p(h))
        if premz is not None:
            null64 = ctypes.cast(None, i64p)
            lib.ns_engine_set_premz(null64, ctypes.cast(None, u64p),
                                    null64, ctypes.cast(None, u8p))
        if hook is not None:
            hook.clear()
    stats.not_claimed += int(st2[0])
    stats.aligned_ok += int(st2[1])
    if hook is not None:
        timings.update(hook.counters())
        if mode == 2:
            timings.update(_probe_verdict(lib))

    if flat_fast:
        return {
            "consensus_list": consensus_list,
            "reads_per_contig": m_cnt,
            "ids": rid,
            "strand": strand,
            "es": es,
            "timings": timings,
        }

    states = []
    cpos = 0
    mi = 0
    oo = 0
    for c in range(C):
        cons = cons_flat[cpos: cpos + int(cons_len[c])].copy()
        cpos += int(cons_len[c])
        members = []
        for _ in range(int(m_cnt[c])):
            ln = int(ops_len[mi])
            members.append(_Member(int(rid[mi]), int(strand[mi]),
                                   int(tstart_rel[mi]),
                                   ops_flat[oo: oo + ln].copy(), 0))
            oo += ln
            mi += 1
        states.append(_ShimState(cons, members))

    # polish already ran inside the engine (P_POLISH), on its own contig
    # structures — no flatten/fetch round trip here
    if cfg.checks:
        check_contigs(states, store)
    _t_emit = time.perf_counter()
    g = _emit_group(states, store)
    timings["emit"] = time.perf_counter() - _t_emit
    g["timings"] = timings
    return g


def _grow_components_wavefront(store, cfg: CompressConfig,
                               stats: FunnelStats, graph: dict,
                               comp_subset) -> dict:
    """The Python wavefront grow loop (``aligner="python"``): placement,
    bookkeeping and polish on the host, each frontier batch's DP in
    ``banded_dp32`` on ``cfg.device``. A DP error propagates: the pool's
    ``fut.result()`` re-raises it here."""
    import collections

    _t0 = time.perf_counter()
    # repetitive reads are never seeded or claimed (they go lone), matching
    # the reference's screen (src/Consensus.cpp:203-208,405-424)
    claimed_for_wf = graph["rep"].copy()
    wf = _Wavefront(store, cfg, stats, graph["adj_off"], graph["dst"],
                    claimed_for_wf, graph["comp_of"])

    comp_order = graph["comp_order"]
    boundaries = graph["boundaries"]
    expand = collections.deque()
    for comp in comp_subset:
        members = comp_order[boundaries[comp]: boundaries[comp + 1]]
        if len(members) < 2:
            continue
        wf.register_component(comp, members)
        expand.append(comp)

    # main loop: top the frontier up with fresh well-separated seeds
    # (round-robin over components) so every alignment batch is full.
    # Two-stage software pipeline: while the banded DP for batch k runs in
    # a worker thread (torch releases the GIL while it computes or waits),
    # the main thread places batch k+1 — anchoring/bookkeeping and the DP
    # overlap instead of alternating (the reference interleaves them inside
    # each OpenMP thread, src/Consensus.cpp:168-340).
    import concurrent.futures as _cf

    def _top_up():
        while len(wf.queue) < cfg.frontier_target and expand:
            if wf.activate_next_in_comp(expand[0], fresh_only=True):
                expand.rotate(-1)
            else:
                expand.popleft()

    with _cf.ThreadPoolExecutor(1) as _pool:
        fut = None
        inflight = None
        while True:
            _top_up()
            batch, consumed = wf.collect_batch()
            arrays = wf.build_arrays(batch)
            nfut = _pool.submit(wf._align, *arrays) if arrays else None
            if inflight is not None:
                wf.apply_batch(inflight[0], inflight[1],
                               fut.result() if fut is not None else None)
            fut = nfut
            inflight = (batch, consumed) if (batch or consumed) else None
            # applying a batch can finalize+reseed (new queue items), so
            # only stop when nothing is in flight and nothing is queued
            if fut is None and inflight is None and not wf.queue and not expand:
                break
    # residual drain: components whose leftovers weren't reseeded yet
    for comp in list(wf._comp_members.keys()):
        while wf.activate_next_in_comp(comp):
            while wf.queue:
                wf.run_batch()
    for st in list(wf.states.values()):
        wf._finalize(st)
    timings = {"grow": time.perf_counter() - _t0}

    _t0 = time.perf_counter()
    if cfg.polish_rounds > 0:
        # substitutions -> indels -> substitutions: the second sub pass
        # settles columns whose votes shifted when indel columns moved.
        # One batched native call when available; numpy oracle otherwise.
        if not _polish_batch_native(wf.done, store):
            for st in wf.done:
                _polish_contig(st, store)
                _polish_indels(st, store)
                _polish_contig(st, store)
    timings["polish"] = time.perf_counter() - _t0
    if cfg.checks:
        check_contigs(wf.done, store)
    _t0 = time.perf_counter()
    g = _emit_group(wf.done, store)
    timings["emit"] = time.perf_counter() - _t0
    g["timings"] = {**timings, **wf.counters()}
    return g


def _grow_components(store, cfg: CompressConfig, stats: FunnelStats,
                     graph: dict, comp_subset) -> dict:
    """Grow + polish + emit one contig group for a subset of components.

    Components are disjoint in reads, so subsets run with zero coordination
    (no locks, no shared claim table) — one subset per worker process.
    ``aligner="python"`` takes the Python wavefront, the others the C++
    engine."""
    if cfg.aligner == "python":
        return _grow_components_wavefront(store, cfg, stats, graph,
                                          comp_subset)
    return _grow_components_engine(store, cfg, stats, graph, comp_subset)


def _dp_backend(cfg: CompressConfig) -> str:
    """The DP that grew the contigs: ``cfg.aligner``, except that
    ``auto`` reports its probe's verdict over the worker processes:
    ``device``, ``native`` (also where no process probed) or ``mixed``."""
    if cfg.aligner != "auto":
        return cfg.aligner
    dev = PIPE_STAGES.get("dp_probe_device_workers", 0)
    nat = PIPE_STAGES.get("dp_probe_native_workers", 0)
    return "mixed" if dev and nat else "device" if dev else "native"


def build_contigs(
    store, cfg: CompressConfig, stats: FunnelStats, report: bool = True
) -> tuple[list[ContigBatch], np.ndarray]:
    N = store.num_reads
    PIPE_STAGES.clear()
    # dataset-scaled knobs: short-read datasets need a denser anchor set
    # and a reachable overlap floor (config.py effective_*)
    cfg = dataclasses.replace(
        cfg,
        seed_window=cfg.effective_seed_window(store.avg_len),
        min_overlap=cfg.effective_min_overlap(store.avg_len),
    )
    graph = _build_candidate_graph(store, cfg, stats, report)
    boundaries = graph["boundaries"]
    comp_sizes = np.diff(boundaries)
    eligible = np.flatnonzero(comp_sizes >= 2)

    W = cfg.resolved_workers()
    if W > 1 and len(eligible) >= 2:
        # greedy size-balanced bins, largest components first
        order = eligible[np.argsort(-comp_sizes[eligible])]
        bins = [[] for _ in range(W)]
        loads = np.zeros(W, dtype=np.int64)
        for c in order:
            b = int(np.argmin(loads))
            bins[b].append(int(c))
            loads[b] += comp_sizes[c]
        bins = [b for b in bins if b]
        import os
        import pickle
        import subprocess
        import sys as _sys
        import tempfile as _tf

        # low-mem stores ship the spill-file path, not the packed buffer:
        # pickling the memmap would materialize the whole dataset per
        # worker (the reference's disk-backed mode exists for exactly the
        # inputs where that matters, src/ReadData.cpp:156-235)
        if store.temp_path:
            store_parts = ("lowmem", store.temp_path, store.offsets,
                           store.lengths, store.exc_read, store.exc_pos,
                           store.exc_byte)
        else:
            store_parts = ("mem", store.packed, store.offsets, store.lengths,
                           store.exc_read, store.exc_pos, store.exc_byte)
        omp = max(1, (cfg.resolved_threads() or 2) // len(bins))
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=repo_root)
        # premz tables stay local: pickling ~0.7 B/base per worker defeats
        # the point (workers rebuild minimizers on demand)
        graph_wire = {k: v for k, v in graph.items() if k != "premz"}
        procs, files = [], []
        for b in bins:
            fi = _tf.NamedTemporaryFile(suffix=".in.pkl", delete=False)
            fo = _tf.NamedTemporaryFile(suffix=".out.pkl", delete=False)
            fo.close()
            pickle.dump((store_parts, cfg, graph_wire, b, omp), fi,
                        protocol=pickle.HIGHEST_PROTOCOL)
            fi.close()
            p = subprocess.Popen(
                [_sys.executable, "-m",
                 "nanospring_tpu_torch.pipeline.grow_worker",
                 fi.name, fo.name],
                env=env,
            )
            procs.append(p)
            files.append((fi.name, fo.name))
        groups = []
        for p, (fin, fout) in zip(procs, files):
            rc = p.wait()
            if rc != 0:
                raise RuntimeError(f"grow worker failed with exit code {rc}")
            with open(fout, "rb") as f:
                g, wstats = pickle.load(f)
            groups.append(g)
            stats.not_claimed += wstats.not_claimed
            stats.aligned_ok += wstats.aligned_ok
            os.unlink(fin)
            os.unlink(fout)
    else:
        groups = [_grow_components(store, cfg, stats, graph, eligible.tolist())]
    PIPE_STAGES["grow_workers"] = len(groups)

    member_mask = np.zeros(N, dtype=bool)
    for g in groups:
        member_mask[g["ids"]] = True
        _merge_timings(PIPE_STAGES, g.pop("timings", {}))
    lone = np.flatnonzero(~member_mask)
    DP_INFO.clear()
    DP_INFO.update(
        dp_backend=_dp_backend(cfg), device=cfg.device,
        sketch_kernel_launches=int(PIPE_STAGES.get(
            "sketch_kernel_launches", 0)),
        **{k: int(PIPE_STAGES.get(k, 0)) for k in (
            "dp_hook_batches", "dp_kernel_launches", "dp_kernel_pairs",
            "dp_kernel_rows", "dp_kernel_longest_rows", "dp_escaped_pairs",
            "host_routed_long_pairs", "host_routed_long_rows",
            "grow_workers", "dp_workers_launched", "dp_worker_peak_bytes",
            "dp_hook_m_cap")})
    DP_INFO["dp_kernel_event_s"] = float(
        PIPE_STAGES.get("dp_kernel_event_s", 0.0))
    if cfg.aligner == "auto":
        DP_INFO.update({k: PIPE_STAGES.get(k, 0) for k in (
            "dp_probe_device_s", "dp_probe_native_s")})
        DP_INFO.update({k: int(PIPE_STAGES.get(k, 0)) for k in (
            "dp_probe_device_workers", "dp_probe_native_workers")})

    # combine all groups into one ContigBatch
    groups = [g for g in groups if len(g["consensus_list"])]
    if groups:
        cb = ContigBatch(
            consensus_list=[c for g in groups for c in g["consensus_list"]],
            reads_per_contig=np.concatenate([g["reads_per_contig"] for g in groups]),
            ids=np.concatenate([g["ids"] for g in groups]),
            strand=np.concatenate([g["strand"] for g in groups]),
            start_pos=np.concatenate([g["es"].start_pos for g in groups]),
            head_ins=np.concatenate([g["es"].head_ins for g in groups]),
            tail_ins=np.concatenate([g["es"].tail_ins for g in groups]),
            n_edits=np.concatenate([g["es"].n_edits for g in groups]),
            runs_flat=np.concatenate([g["es"].runs_flat for g in groups]),
            types_flat=np.concatenate([g["es"].types_flat for g in groups]),
            bases_flat=np.concatenate([g["es"].bases_flat for g in groups]),
        )
        batches = [cb]
    else:
        batches = []
    return batches, lone
