"""Lone-read recoverability analysis — the ``testLoneReads`` analog.

The reference ships a second binary that decompresses an archive, indexes
every contig consensus with minimap2, and measures how many lone reads could
have been aligned after all (reference: src/testLoneReads.cpp:18-180,
built at CMakeLists.txt:235-237). Same analysis here: minimizer-index the
consensus sequences, anchor each lone read, and banded-align the anchored
ones; report the recoverable fraction and mean edit distance.

This is the PyTorch port's copy of ``nanospring_tpu/pipeline/lone_stats.py``.
Like decompression it is host code only (the minimizer index, the anchors
and the C++ banded DP) and does no device work. The port's
``ns_banded_align`` clamps a row whose diagonal lies more than a band
outside the target, which a lone read's anchor can give; the reference's
copy writes past its row buffer there.
"""

from __future__ import annotations

import collections

import numpy as np

from ..config import CompressConfig
from ..io import archive
from ..io import packed as pk
from ..ops import align as al
from ..ops import minimizers as mz


def report(archive_path: str, cfg: CompressConfig | None = None) -> dict:
    cfg = cfg or CompressConfig()
    meta, streams = archive.read_archive(archive_path)

    genome = streams.get("genome", np.zeros(0, np.uint8))
    lone = streams.get("lone", np.zeros(0, np.uint8))

    def split_lines(buf):
        if len(buf) == 0:
            return []
        ends = np.flatnonzero(buf == ord("\n"))
        out, s = [], 0
        for e in ends:
            out.append(buf[s:e])
            s = e + 1
        return out

    contigs = [pk.encode_ascii(c) for c in split_lines(genome)]
    lone_reads = [pk.encode_ascii(r) for r in split_lines(lone)]
    n_lone = len(lone_reads)
    if n_lone == 0 or not contigs:
        print(f"lone-stats: {n_lone} lone reads, {len(contigs)} contigs — "
              "nothing to analyze")
        return {"lone": n_lone, "anchored": 0, "aligned": 0}

    # one minimizer index over all contig consensus sequences
    # (the reference builds one mm_idx over all .genome lines, :128)
    index = collections.defaultdict(list)
    anchors = []
    for ci, cons in enumerate(contigs):
        if len(cons) < cfg.seed_kmer_size + cfg.seed_window:
            anchors.append(None)
            continue
        h, p, f = mz.minimizers(cons, cfg.seed_kmer_size, cfg.seed_window)
        anchors.append((h, p.astype(np.int64), f))
        for hv in np.unique(h):
            index[int(hv)].append(ci)

    anchored = 0
    aligned = 0
    costs = []
    batch_t, batch_q, batch_d0 = [], [], []
    for r in lone_reads:
        if len(r) < cfg.seed_kmer_size + cfg.seed_window:
            continue
        rh, rp, rf = mz.minimizers(r, cfg.seed_kmer_size, cfg.seed_window)
        if len(rh) == 0:
            continue
        # vote for the contig sharing the most minimizer hashes
        votes = collections.Counter()
        for hv in np.unique(rh):
            for ci in index.get(int(hv), ()):
                votes[ci] += 1
        if not votes:
            continue
        ci = votes.most_common(1)[0][0]
        m = mz.match_anchors(
            anchors[ci][0], anchors[ci][1], anchors[ci][2],
            rh, rp.astype(np.int64), rf, len(r),
            cfg.seed_kmer_size, max_anchors=cfg.max_chain_iter,
        )
        if m is None:
            continue
        anchored += 1
        is_rc, d0, _votes = m
        codes = pk.revcomp_codes(r) if is_rc else r
        batch_t.append(contigs[ci])
        batch_q.append(codes)
        batch_d0.append(d0)

    if batch_q:
        t_len = np.array([len(t) for t in batch_t], np.int64)
        q_len = np.array([len(q) for q in batch_q], np.int64)
        t_off = np.zeros(len(batch_t), np.int64)
        np.cumsum(t_len[:-1], out=t_off[1:])
        q_off = np.zeros(len(batch_q), np.int64)
        np.cumsum(q_len[:-1], out=q_off[1:])
        res = al.banded_align_batch(
            np.concatenate(batch_t), t_off, t_len,
            np.concatenate(batch_q), q_off, q_len,
            np.array(batch_d0, np.int64), band=cfg.band_width,
            max_cost_per_kb=int(cfg.max_edit_frac * 1000),
        )
        ok = res.cost >= 0
        aligned = int(ok.sum())
        costs = res.cost[ok].tolist()

    mean_cost = float(np.mean(costs)) if costs else 0.0
    print(
        f"lone-stats: {n_lone} lone reads; anchored {anchored} "
        f"({100*anchored/max(n_lone,1):.1f}%), aligned {aligned} "
        f"({100*aligned/max(n_lone,1):.1f}%), mean edit cost {mean_cost:.1f}"
    )
    return {"lone": n_lone, "anchored": anchored, "aligned": aligned,
            "mean_cost": mean_cost}
