"""Decompression: archive -> byte-identical read sequences, original order.

The reference replays edit scripts read-at-a-time in C++
(reference: src/Decompressor.cpp:105-172 regeneration, :252-314 generateRead,
:186-235 memory-bounded reorder). Here the replay is one numpy "op tape"
over *all* contig reads at once: tokens (unchanged-runs and edits) are
expanded with repeat/cumsum into flat gather indices against the concatenated
consensus buffer and the literal-base stream — no per-read Python.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np

from .config import DecompressConfig
from .io import archive
from .io import streams as st
from .utils.observe import StageTimer

# ASCII complement LUT (A<->T, C<->G); non-ACGT maps to itself (exceptions
# are re-applied after strand resolution anyway).
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in ((ord("A"), ord("T")), (ord("C"), ord("G"))):
    _COMP[_a], _COMP[_b] = _b, _a


def _excl_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), dtype=np.int64)
    if len(x) > 1:
        np.cumsum(x[:-1], out=out[1:])
    return out


def _segmented_before(values: np.ndarray, group_starts_idx: np.ndarray,
                      group_sizes: np.ndarray) -> np.ndarray:
    """Within-group exclusive prefix sums for concatenated groups."""
    cc = _excl_cumsum(values)
    base = cc[group_starts_idx] if len(group_starts_idx) else np.zeros(0, np.int64)
    return cc - np.repeat(base, group_sizes)


def _expand_gather(offs: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Flat indices [offs[i] .. offs[i]+sizes[i]) concatenated."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    within = np.arange(total, dtype=np.int64) - np.repeat(_excl_cumsum(sizes), sizes)
    return np.repeat(offs, sizes) + within


def replay_members(*args) -> tuple[np.ndarray, np.ndarray]:
    """Native replay with numpy fallback (both tested equal)."""
    try:
        from . import native

        native.get_lib()
    except Exception:
        return replay_contig_reads(*args)
    return replay_contig_reads_native(*args)


def replay_contig_reads_native(
    genome_flat, genome_offsets, contig_of_member, start, head, tail,
    n_edits, runs_flat, types_flat, bases_flat, strand,
) -> tuple[np.ndarray, np.ndarray]:
    """C++ edit-script replay (native/replay.cpp), OMP over members.

    Same contract as replay_contig_reads; ~20x faster (the numpy op-tape
    expansion is memory-bandwidth bound on its index arrays).
    """
    import ctypes

    from . import native

    M = len(start)
    if M == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    E = n_edits.astype(np.int64)
    run_off = _excl_cumsum(E + 1)
    type_off = _excl_cumsum(E)
    is_si = (types_flat == ord("s")) | (types_flat == ord("i"))
    si_per = np.zeros(M, dtype=np.int64)
    np.add.at(si_per, np.repeat(np.arange(M), E), is_si.astype(np.int64))
    lit_off = _excl_cumsum(head + si_per + tail)
    seg_runs = (np.add.reduceat(runs_flat, run_off)
                if len(runs_flat) else np.zeros(M, np.int64))
    # 'd' edits emit nothing; 's'/'i' emit one => body = runs + si
    out_len = head + tail + si_per + seg_runs
    out_off = _excl_cumsum(out_len)
    out = np.empty(int(out_len.sum()), dtype=np.uint8)

    lib = native.get_lib()
    c64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    cu8 = lambda a: np.ascontiguousarray(a, dtype=np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    args = [
        cu8(genome_flat), c64(genome_offsets), c64(contig_of_member),
        c64(start), c64(head), c64(tail), c64(E),
        c64(run_off), c64(runs_flat), c64(type_off), cu8(types_flat),
        c64(lit_off), cu8(bases_flat), cu8(strand),
    ]
    cargs = [a.ctypes.data_as(u8p if a.dtype == np.uint8 else i64p)
             for a in args]
    lib.ns_replay_members(
        *cargs, ctypes.c_int64(M),
        c64(out_off).ctypes.data_as(i64p),
        c64(out_len).ctypes.data_as(i64p),
        out.ctypes.data_as(u8p),
    )
    return out, out_len


def replay_contig_reads(
    genome_flat: np.ndarray,       # ASCII consensus bytes, concatenated
    genome_offsets: np.ndarray,    # int64 (C,) start of each contig's consensus
    contig_of_member: np.ndarray,  # int64 (M,)
    start: np.ndarray,             # int64 (M,)
    head: np.ndarray,
    tail: np.ndarray,
    n_edits: np.ndarray,
    runs_flat: np.ndarray,         # int64, E_r+1 per read
    types_flat: np.ndarray,        # uint8 'i'/'d'/'s', E_r per read
    bases_flat: np.ndarray,        # uint8 ASCII literals per read
    strand: np.ndarray,            # uint8, 1 = reverse-complemented
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (flat ASCII member sequences, member lengths)."""
    M = len(start)
    if M == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)

    E = n_edits.astype(np.int64)
    ntok = 2 * E + 1
    tok_offs = np.zeros(M + 1, dtype=np.int64)
    np.cumsum(ntok, out=tok_offs[1:])
    T = int(tok_offs[-1])

    # token kinds: 0=copy-run, 1='s', 2='i', 3='d'
    kind = np.zeros(T, dtype=np.uint8)
    # scatter runs into even local slots, edits into odd local slots
    nruns = E + 1
    run_tgt = np.repeat(tok_offs[:-1], nruns) + 2 * (
        np.arange(int(nruns.sum()), dtype=np.int64)
        - np.repeat(_excl_cumsum(nruns), nruns)
    )
    edit_tgt = np.repeat(tok_offs[:-1], E) + 1 + 2 * (
        np.arange(int(E.sum()), dtype=np.int64) - np.repeat(_excl_cumsum(E), E)
    )
    emit_n = np.zeros(T, dtype=np.int64)
    consume_n = np.zeros(T, dtype=np.int64)
    lit_n = np.zeros(T, dtype=np.int64)
    emit_n[run_tgt] = runs_flat
    consume_n[run_tgt] = runs_flat
    is_s = types_flat == ord("s")
    is_i = types_flat == ord("i")
    kind[edit_tgt] = np.where(is_s, 1, np.where(is_i, 2, 3)).astype(np.uint8)
    emit_n[edit_tgt] = (is_s | is_i).astype(np.int64)
    consume_n[edit_tgt] = (~is_i).astype(np.int64)
    lit_n[edit_tgt] = (is_s | is_i).astype(np.int64)

    # per-read literal layout in bases_flat: head | script literals | tail
    n_script_lit = np.zeros(M, dtype=np.int64)
    np.add.at(n_script_lit, np.repeat(np.arange(M), E), lit_n[edit_tgt])
    lit_total = head + n_script_lit + tail
    lit_offs = _excl_cumsum(lit_total)

    # within-read prefix sums over tokens
    consume_before = _segmented_before(consume_n, tok_offs[:-1], ntok)
    lit_before = _segmented_before(lit_n, tok_offs[:-1], ntok)
    emit_before = _segmented_before(emit_n, tok_offs[:-1], ntok)

    body_len = np.zeros(M, dtype=np.int64)
    np.add.at(body_len, np.repeat(np.arange(M), ntok), emit_n)
    out_len = head + body_len + tail
    out_offs = _excl_cumsum(out_len)
    out = np.empty(int(out_len.sum()), dtype=np.uint8)

    # heads and tails: straight literal copies
    out[_expand_gather(out_offs, head)] = bases_flat[_expand_gather(lit_offs, head)]
    out[_expand_gather(out_offs + head + body_len, tail)] = bases_flat[
        _expand_gather(lit_offs + head + n_script_lit, tail)
    ]

    # body: expand tokens by emit count
    tok_read = np.repeat(np.arange(M), ntok)
    nb = int(emit_n.sum())
    base_tok = np.repeat(np.arange(T), emit_n)           # token id per body base
    within = np.arange(nb, dtype=np.int64) - np.repeat(_excl_cumsum(emit_n), emit_n)
    b_read = tok_read[base_tok]
    b_kind = kind[base_tok]
    tgt = out_offs[b_read] + head[b_read] + emit_before[base_tok] + within
    is_copy = b_kind == 0
    # consensus-sourced bases (copy runs)
    cons_src = (
        genome_offsets[contig_of_member[b_read]]
        + start[b_read]
        + consume_before[base_tok]
        + within
    )
    # literal-sourced bases ('s' and 'i')
    lit_src = lit_offs[b_read] + head[b_read] + lit_before[base_tok]
    src = np.where(is_copy, cons_src, 0)
    vals = np.empty(nb, dtype=np.uint8)
    vals[is_copy] = genome_flat[src[is_copy]]
    lit_mask = ~is_copy
    vals[lit_mask] = bases_flat[lit_src[lit_mask]]
    out[tgt] = vals

    # reverse-complement the 'c' strand reads in place
    c_mask = strand == 1
    if c_mask.any():
        c_offs = out_offs[c_mask]
        c_lens = out_len[c_mask]
        fwd = _expand_gather(c_offs, c_lens)
        rev = _expand_gather(c_offs + c_lens - 1, c_lens) - 2 * (
            np.arange(int(c_lens.sum()), dtype=np.int64)
            - np.repeat(_excl_cumsum(c_lens), c_lens)
        )
        out[fwd] = _COMP[out[rev]]

    return out, out_len


def _decompress_bounded(
    out_path, cfg, timer, budget_bases, num_reads,
    genome_flat, genome_offsets, contig_of_member, reads_per_contig,
    member_ids, lone_ids, start, head, tail, n_edits, runs_flat,
    types_all, bases_stream, strand, lone_flat, lone_lens,
    exc_read, exc_pos, exc_byte,
) -> int:
    """Memory-bounded replay + multi-pass external reorder.

    The reference regenerates reads into temp bitset files and then restores
    original order in passes sized by --decompression-memory
    (reference: src/Decompressor.cpp:105-172,186-235). Same structure here:
    contig-chunked replay spills sequences to one temp file; ordered output
    is produced in read-id passes whose total bases fit the budget.
    """
    import os
    import tempfile

    E = n_edits.astype(np.int64)
    run_offs = _excl_cumsum(E + 1)
    type_offs = _excl_cumsum(E)
    # literal bytes per member: head + tail + one per 's'/'i' edit
    is_si = (types_all == ord("s")) | (types_all == ord("i"))
    si_per = np.zeros(len(E), dtype=np.int64)
    np.add.at(si_per, np.repeat(np.arange(len(E)), E), is_si.astype(np.int64))
    lit_per = head + tail + si_per
    lit_offs = _excl_cumsum(lit_per)

    spill = tempfile.NamedTemporaryFile(
        dir=cfg.resolved_work_root(), prefix="nstpu_reorder_", delete=False
    )
    spill_off = np.zeros(num_reads, dtype=np.int64)
    final_lens = np.zeros(num_reads, dtype=np.int64)
    M = len(member_ids)
    contig_end_member = np.cumsum(reads_per_contig)

    # per-member output-size estimate: copy runs + one base per edit + ins
    seg_runs = np.add.reduceat(runs_flat, run_offs) if M else np.zeros(0, np.int64)
    est = head + tail + E + seg_runs
    cum_est = np.concatenate([[0], np.cumsum(est)])

    with timer.stage("replay_spill"):
        pos = 0
        mlo = 0
        while mlo < M:
            # take whole contigs until the chunk replay budget is reached
            ci = int(np.searchsorted(contig_end_member, mlo, side="right"))
            mhi = mlo
            while mhi < M:
                nxt = int(contig_end_member[ci])
                if mhi > mlo and cum_est[nxt] - cum_est[mlo] > budget_bases // 2:
                    break
                mhi = nxt
                ci += 1
            sl = slice(mlo, mhi)
            seq, lens = replay_members(
                genome_flat, genome_offsets, contig_of_member[sl],
                start[sl], head[sl], tail[sl], n_edits[sl],
                runs_flat[run_offs[mlo]: run_offs[mhi]] if mhi < M
                else runs_flat[run_offs[mlo]:],
                types_all[type_offs[mlo]: type_offs[mhi]] if mhi < M
                else types_all[type_offs[mlo]:],
                bases_stream[lit_offs[mlo]: lit_offs[mhi]] if mhi < M
                else bases_stream[lit_offs[mlo]:],
                strand[sl],
            )
            spill.write(seq.tobytes())
            offs = pos + _excl_cumsum(lens)
            spill_off[member_ids[sl]] = offs
            final_lens[member_ids[sl]] = lens
            pos += int(lens.sum())
            mlo = mhi
        # lone reads appended to the same spill
        spill.write(lone_flat.tobytes())
        spill_off[lone_ids] = pos + _excl_cumsum(lone_lens)
        final_lens[lone_ids] = lone_lens
        spill.flush()

    total = int(final_lens.sum())
    with timer.stage("reorder_passes"):
        mm = np.memmap(spill.name, dtype=np.uint8, mode="r") if total else \
            np.zeros(0, np.uint8)
        final_offs = _excl_cumsum(final_lens)
        # one global cumsum; each pass binary-searches a view (the per-pass
        # recompute was O(N * passes) on exactly the multi-pass inputs)
        cum_all = np.cumsum(final_lens)
        with open(out_path, "wb") as f:
            lo = 0
            while lo < num_reads:
                # widen the pass until its bases exceed the budget
                base = int(cum_all[lo - 1]) if lo else 0
                hi = lo + int(np.searchsorted(cum_all[lo:],
                                              base + budget_bases)) + 1
                hi = min(hi, num_reads)
                lens = final_lens[lo:hi]
                blk = np.full(int(lens.sum()) + len(lens), ord("\n"), np.uint8)
                boffs = _excl_cumsum(lens + 1)
                lib = None
                try:
                    from . import native

                    lib = native.get_lib()
                except Exception:
                    pass
                if lib is not None and total:
                    # ordered gather straight off the spill memmap (the
                    # numpy index-expansion here was the bounded path's
                    # dominant cost)
                    import ctypes

                    u8p = ctypes.POINTER(ctypes.c_uint8)
                    i64p = ctypes.POINTER(ctypes.c_int64)
                    offs = np.ascontiguousarray(spill_off[lo:hi])
                    lens_c = np.ascontiguousarray(lens)
                    not_lone = np.zeros(hi - lo, dtype=np.uint8)
                    lib.ns_gather_reads(
                        mm.ctypes.data_as(u8p), mm.ctypes.data_as(u8p),
                        offs.ctypes.data_as(i64p),
                        not_lone.ctypes.data_as(u8p),
                        lens_c.ctypes.data_as(i64p),
                        ctypes.c_int64(hi - lo), blk.ctypes.data_as(u8p),
                    )
                else:
                    src = _expand_gather(spill_off[lo:hi], lens)
                    blk[_expand_gather(boffs, lens)] = mm[src]
                # restore non-ACGT bytes for reads in this pass
                esel = (exc_read >= lo) & (exc_read < hi)
                if esel.any():
                    er = exc_read[esel] - lo
                    blk[boffs[er] + exc_pos[esel]] = exc_byte[esel]
                f.write(memoryview(blk))
                lo = hi
        del mm
    os.unlink(spill.name)
    return total


def _split_lines(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Newline-separated buffer -> (flat content, line lengths)."""
    if len(buf) == 0:
        return buf, np.zeros(0, dtype=np.int64)
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], nl[:-1] + 1])
    lens = nl - starts
    keep = np.ones(len(buf), dtype=bool)
    keep[nl] = False
    return buf[keep], lens.astype(np.int64)


def decompress_file(
    in_path: str,
    out_path: str,
    cfg: DecompressConfig | None = None,
    report: bool = True,
) -> dict:
    cfg = cfg or DecompressConfig()
    timer = StageTimer(report=report)

    with timer.stage("read_archive"):
        with cf.ThreadPoolExecutor(cfg.resolved_threads()) as pool:
            meta, streams = archive.read_archive(in_path, pool=pool)

    num_reads = meta["num_reads"]
    reads_per_contig = np.asarray(meta["reads_per_contig"], dtype=np.int64)
    M = int(reads_per_contig.sum())
    num_lone = meta["num_lone"]

    with timer.stage("decode_streams"):
        all_ids = st.decode_id_stream(streams["id"]).astype(np.int64)
        member_ids, lone_ids = all_ids[:M], all_ids[M:]
        assert len(lone_ids) == num_lone, "id stream length mismatch"

        genome_flat, genome_lens = _split_lines(streams.get("genome", np.zeros(0, np.uint8)))
        genome_offsets = _excl_cumsum(genome_lens)
        contig_of_member = np.repeat(np.arange(len(reads_per_contig)), reads_per_contig)

        types_all, n_edits = _split_lines(streams.get("type", np.zeros(0, np.uint8)))
        assert len(n_edits) == M, "type stream read-count mismatch"

        pos_vals = st.decode_varints(streams.get("pos", np.zeros(0, np.uint8)))
        per_read = n_edits + 4
        p_offs = _excl_cumsum(per_read)
        start = pos_vals[p_offs].astype(np.int64) if M else np.zeros(0, np.int64)
        head = pos_vals[p_offs + 1].astype(np.int64) if M else np.zeros(0, np.int64)
        tail = (
            pos_vals[p_offs + per_read - 1].astype(np.int64) if M else np.zeros(0, np.int64)
        )
        run_idx = _expand_gather(p_offs + 2, n_edits + 1)
        runs_flat = pos_vals[run_idx].astype(np.int64)

        comp_flat, comp_lens = _split_lines(
            streams.get("complement", np.zeros(0, np.uint8))
        )
        strand = (comp_flat == ord("c")).astype(np.uint8)
        assert len(strand) == M, "complement stream read-count mismatch"

    budget_bases = int(cfg.memory_gb * 1e9) // 2  # replay + reorder buffers
    lone_flat, lone_lens = _split_lines(streams.get("lone", np.zeros(0, np.uint8)))
    exc_read, exc_pos, exc_byte = st.decode_exc_stream(
        streams.get("exc", np.zeros(0, np.uint8))
    )
    total_est = int(meta.get("total_bases", 0)) or (
        int(genome_lens.sum()) * 4 + int(lone_lens.sum())
    )

    if total_est <= budget_bases:
        with timer.stage("replay"):
            member_seq, member_lens = replay_members(
                genome_flat, genome_offsets, contig_of_member, start, head, tail,
                n_edits, runs_flat, types_all,
                streams.get("base", np.zeros(0, np.uint8)), strand,
            )

        with timer.stage("reorder+write"):
            # final lengths keyed by original read id; one native ordered
            # gather emits the newline-terminated output buffer directly
            final_lens = np.zeros(num_reads, dtype=np.int64)
            final_lens[member_ids] = member_lens
            final_lens[lone_ids] = lone_lens
            total = int(final_lens.sum())
            src_off = np.zeros(num_reads, dtype=np.int64)
            src_off[member_ids] = _excl_cumsum(member_lens)
            src_off[lone_ids] = _excl_cumsum(lone_lens)
            src_is_lone = np.zeros(num_reads, dtype=np.uint8)
            src_is_lone[lone_ids] = 1
            try:
                from . import native

                lib = native.get_lib()
            except Exception:
                lib = None
            if lib is not None:
                import ctypes

                buf = np.empty(total + num_reads, dtype=np.uint8)
                u8p = ctypes.POINTER(ctypes.c_uint8)
                i64p = ctypes.POINTER(ctypes.c_int64)
                member_seq = np.ascontiguousarray(member_seq)
                lone_c = np.ascontiguousarray(lone_flat)
                lib.ns_gather_reads(
                    member_seq.ctypes.data_as(u8p), lone_c.ctypes.data_as(u8p),
                    src_off.ctypes.data_as(i64p),
                    src_is_lone.ctypes.data_as(u8p),
                    final_lens.ctypes.data_as(i64p),
                    ctypes.c_int64(num_reads), buf.ctypes.data_as(u8p),
                )
                # non-ACGT exception restoration at newline-adjusted offsets
                if len(exc_read):
                    offs_nl = _excl_cumsum(final_lens + 1)
                    buf[offs_nl[exc_read] + exc_pos] = exc_byte
                with open(out_path, "wb") as f:
                    f.write(memoryview(buf))  # no 0.5 GB tobytes copy
            else:
                final_offs = _excl_cumsum(final_lens)
                out_buf = np.empty(total, dtype=np.uint8)
                out_buf[_expand_gather(final_offs[member_ids], member_lens)] = member_seq
                out_buf[_expand_gather(final_offs[lone_ids], lone_lens)] = lone_flat
                if len(exc_read):
                    out_buf[final_offs[exc_read] + exc_pos] = exc_byte
                with open(out_path, "wb") as f:
                    chunk = 1 << 20  # reads per write block
                    for i in range(0, num_reads, chunk):
                        lens = final_lens[i : i + chunk]
                        offs = final_offs[i : i + chunk]
                        blk = np.full(int(lens.sum()) + len(lens), ord("\n"),
                                      dtype=np.uint8)
                        boffs = _excl_cumsum(lens + 1)
                        blk[_expand_gather(boffs, lens)] = out_buf[
                            _expand_gather(offs, lens)
                        ]
                        f.write(blk.tobytes())
    else:
        total = _decompress_bounded(
            out_path, cfg, timer, budget_bases, num_reads,
            genome_flat, genome_offsets, contig_of_member, reads_per_contig,
            member_ids, lone_ids, start, head, tail, n_edits, runs_flat,
            types_all, streams.get("base", np.zeros(0, np.uint8)), strand,
            lone_flat, lone_lens, exc_read, exc_pos, exc_byte,
        )

    return {
        "num_reads": num_reads,
        "total_bases": total,
        "wall_s": timer.total(),
        "stage_s": timer.stage_s,
    }
