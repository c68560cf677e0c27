"""Multi-process compression over ``torch.distributed``, one rank per
device. Counterpart of ``nanospring_tpu/parallel/distributed.py``; every
rank runs the same program:

1. ``mesh.initialize`` wires the ranks into one process group (NCCL across
   cards, gloo on the CPU or for several ranks on one card),
2. each rank parses only its byte range of the FASTQ into a spill file on
   the shared filesystem; peers memmap each other's shards on demand
   (``_FederatedStore``), so no rank holds the whole packed dataset,
3. each rank sketches its own shard on its device with the sketch kernel
   and runs the two exchanges of the sharded join
   (``sharded_join.sharded_candidate_pairs``); the kept pairs stay on the
   rank that counted them,
4. components by label propagation: local relaxation, then an elementwise
   minimum of the N-sized label array over the ranks (``all_reduce(MIN)``),
   until no label moves; every rank derives the same owner-computes bins
   and rank d grows bin d, with the edges of its components sent to it by
   one more exchange,
5. each rank spills its groups and memory evidence as files (the analog of
   the reference's per-thread stream files, src/Consensus.cpp:36-37);
   after a barrier rank 0 merges them, serializes and writes the archive.

The JAX package re-slices the sketched rows into mesh order before its
join; the port need not, because the kept pair set does not depend on which
rank expands a group: groups are global after the value-owner shuffle, and
every pair is counted by its pair owner. With one rank the join is the
native single-host sort-join. Run one rank per process:

    python -m nanospring_tpu_torch.parallel.distributed \\
        reads.fastq out.nstpu work_dir NPROC PID PORT [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import time

import numpy as np
import torch

from ..config import ALIGNERS, CompressConfig
from ..utils.observe import FunnelStats
from . import mesh


class _FederatedStore:
    """Read store over per-process spill files on the shared filesystem.

    Every process memmaps every shard but touches only the pages it reads
    — no process materializes the full packed dataset. Per-read metadata
    (lengths, id offsets, exceptions) is small and replicated."""

    def __init__(self, spill_paths, id_off, lengths, exc_read, exc_pos,
                 exc_byte, local_pid, local_store):
        from ..io.read_store import ReadStore

        self.id_off = id_off
        self.lengths = np.ascontiguousarray(lengths, np.int64)
        self.exc_read = exc_read
        self.exc_pos = exc_pos
        self.exc_byte = exc_byte
        self._pid = local_pid
        self._stores = []
        for q, path in enumerate(spill_paths):
            if q == local_pid:
                self._stores.append(local_store)
                continue
            lens_q = self.lengths[id_off[q]: id_off[q + 1]]
            nb = (lens_q + 3) // 4
            off_q = np.zeros(len(lens_q), np.int64)
            if len(off_q) > 1:
                np.cumsum(nb[:-1], out=off_q[1:])
            mm = np.memmap(path, np.uint8, mode="r")
            st = ReadStore(packed_buf=mm, offsets=off_q, lengths=lens_q,
                           exc_read=np.zeros(0, np.int64),
                           exc_pos=np.zeros(0, np.int64),
                           exc_byte=np.zeros(0, np.uint8))
            self._stores.append(st)
        self.bytes_gathered = 0   # memory-evidence accounting

    @property
    def num_reads(self):
        return int(self.id_off[-1])

    @property
    def total_bases(self):
        return int(self.lengths.sum())

    @property
    def avg_len(self):
        return float(self.lengths.mean()) if self.num_reads else 0.0

    @property
    def max_len(self):
        return int(self.lengths.max()) if self.num_reads else 0

    def _shard_of(self, rids):
        return np.searchsorted(self.id_off, rids, side="right") - 1

    def get_codes(self, rid: int) -> np.ndarray:
        q = int(self._shard_of(np.array([rid]))[0])
        return self._stores[q].get_codes(int(rid - self.id_off[q]))

    def get_batch_padded(self, rids, pad_to=None):
        rids = np.asarray(rids, np.int64)
        lens = self.lengths[rids]
        pad = int(pad_to if pad_to is not None else
                  (lens.max() if len(lens) else 0))
        out = np.zeros((len(rids), pad), np.uint8)
        sh = self._shard_of(rids)
        for q in np.unique(sh):
            m = sh == q
            codes, _ = self._stores[q].get_batch_padded(
                rids[m] - self.id_off[q], pad_to=pad)
            out[m] = codes
        return out, lens

    def gather_substore(self, rids):
        """Contiguous packed buffer holding exactly ``rids`` (the reads a
        process grows), with full-size offsets valid at those ids — the
        engine's flat-buffer contract without copying the whole dataset."""
        from ..io.read_store import ReadStore

        rids = np.asarray(rids, np.int64)
        nbytes = (self.lengths[rids] + 3) // 4
        offs = np.zeros(self.num_reads, np.int64)
        pos = np.zeros(len(rids) + 1, np.int64)
        np.cumsum(nbytes, out=pos[1:])
        buf = np.empty(int(pos[-1]), np.uint8)
        sh = self._shard_of(rids)
        for i, r in enumerate(rids):
            q = sh[i]
            st = self._stores[q]
            lo = st.offsets[int(r - self.id_off[q])]
            buf[pos[i]: pos[i + 1]] = st.packed[lo: lo + int(nbytes[i])]
            offs[r] = pos[i]
        self.bytes_gathered += int(pos[-1])
        return ReadStore(packed_buf=buf, offsets=offs, lengths=self.lengths,
                         exc_read=np.zeros(0, np.int64),
                         exc_pos=np.zeros(0, np.int64),
                         exc_byte=np.zeros(0, np.uint8))


def _gather(group: mesh.Group, a: np.ndarray, comm: dict,
            key: str) -> list[np.ndarray]:
    """Every rank's ``a`` (any length), in rank order, as numpy; adds the
    payload bytes received to ``comm[key]``."""
    parts = [x.cpu().numpy() for x in mesh.all_gather_ragged(
        group, torch.from_numpy(np.ascontiguousarray(a)))]
    comm[key] = comm.get(key, 0) + sum(p.nbytes for p in parts)
    return parts


def _launch_counts() -> dict:
    """The kernel wrappers' launch counts in this process."""
    from ..ops import align_tpu as at
    from ..ops import sketch as sk

    return {"sketch": sk.sketch_reads.launches,
            "banded_dp16": at.banded_dp16.launches,
            "banded_dp32": at.banded_dp32.launches}


def compress_distributed(fq_path: str, out_path: str, work_dir: str,
                         cfg: CompressConfig | None = None,
                         group: mesh.Group | None = None) -> dict | None:
    """Run the distributed pipeline; returns the result dict on rank 0,
    None elsewhere. The process group must already be initialized
    (``mesh.initialize``); ``group`` defaults to it, on ``cfg.device``.
    ``work_dir`` must be one directory that every rank sees."""
    from ..io import read_store
    from ..pipeline import candidates as cand
    from ..pipeline import contigs as cg
    from . import sharded_join as sj

    cfg = cfg or CompressConfig()
    group = group or mesh.make_group(device=cfg.device)
    launches0 = _launch_counts()
    ph: dict[str, float] = {}
    _t0 = time.perf_counter()

    def _tick(name: str) -> None:
        nonlocal _t0
        now = time.perf_counter()
        ph[name] = round(ph.get(name, 0.0) + (now - _t0), 3)
        _t0 = now

    comm: dict[str, int] = {}   # bytes through each collective, this rank
    pid, nproc = group.rank, group.world

    # --- sharded ingestion: each rank parses only its byte range ---------
    my_store, my_n = read_store.load_fastq_shard(
        fq_path, pid, nproc, work_dir, spill_name=f"shard_{pid}.pack")
    shard_counts = np.concatenate(
        _gather(group, np.array([my_n], np.int64), comm, "meta_allgather"))
    id_off = np.zeros(nproc + 1, np.int64)
    np.cumsum(shard_counts, out=id_off[1:])
    N = int(id_off[-1])
    lengths_g = np.concatenate(_gather(
        group, np.asarray(my_store.lengths, np.int64), comm, "meta_allgather"))
    exc_read_g = np.concatenate(_gather(
        group, np.asarray(my_store.exc_read, np.int64) + id_off[pid], comm,
        "meta_allgather"))
    exc_pos_g = np.concatenate(_gather(
        group, np.asarray(my_store.exc_pos, np.int64), comm,
        "meta_allgather"))
    exc_byte_g = np.concatenate(_gather(
        group, np.asarray(my_store.exc_byte, np.uint8), comm,
        "meta_allgather"))
    mesh.barrier(group)         # every shard's spill file is complete
    _tick("ingest")
    store = _FederatedStore(
        [os.path.join(work_dir, f"shard_{q}.pack") for q in range(nproc)],
        id_off, lengths_g, exc_read_g, exc_pos_g, exc_byte_g,
        local_pid=pid, local_store=my_store)
    cfg = dataclasses.replace(
        cfg,
        seed_window=cfg.effective_seed_window(store.avg_len),
        min_overlap=cfg.effective_min_overlap(store.avg_len),
    )

    # --- each rank sketches its own shard on its device ------------------
    sketches = cg.sketch_rows(my_store, cfg)
    if sketches.is_cuda:
        torch.cuda.synchronize(sketches.device)
    _tick("sketch")

    if nproc == 1:
        # one rank: every collective is the identity, so the native
        # single-host sort-join computes the same thresholded pair set
        from ..ops import sketch as sk

        sk_host = sk.as_uint32(sketches)
        got = cand.all_pairs_native(sk_host, cfg.overlap_sketch_threshold,
                                    cfg.max_bucket)
        if got is not None:
            q_all, r_all = got[0], got[1]
        else:
            idx = cand.SketchIndex(sk_host, cfg.max_bucket)
            q_all, r_all, _ = idx.query(sk_host,
                                        cfg.overlap_sketch_threshold)
        keep = q_all < r_all  # canonical, matching the collective path
        my_q = np.asarray(q_all[keep], np.int64)
        my_r = np.asarray(r_all[keep], np.int64)
        for name in ("slot_shuffle", "pair_expand", "pair_exchange",
                     "threshold_count"):
            _tick(name)
    else:
        rids = torch.arange(int(id_off[pid]), int(id_off[pid + 1]),
                            device=sketches.device)
        my_q, my_r, _ = sj.sharded_candidate_pairs(
            group, sketches, rids, cfg.overlap_sketch_threshold,
            cfg.max_bucket, canonical=True, comm=comm, tick=_tick)
    del sketches

    return _finish_distributed(
        cfg, ph, _tick, group, store, my_store, id_off, N, my_q, my_r,
        work_dir, out_path, comm, launches0)


def _finish_distributed(cfg, ph, _tick, group, store, my_store, id_off, N,
                        my_q, my_r, work_dir, out_path, comm, launches0):
    """Shared back half: components -> bins -> grow -> merge/archive."""
    from ..pipeline import contigs as cg
    from .pipeline import lpt_bins

    pid, nproc = group.rank, group.world

    # --- distributed components: label propagation -----------------------
    # Pairs stay on the rank that counted them. Each round relaxes labels
    # along the local edges to a local fixpoint (with pointer jumping),
    # then takes the elementwise minimum over the ranks (8 B/read). Every
    # rank gets the same minimum, so the convergence test agrees globally.
    labels = np.arange(N, dtype=np.int64)
    label_rounds = 0
    for _round in range(64):
        label_rounds += 1
        prev = labels
        labels = labels.copy()
        for _ in range(16):
            lp = labels
            labels = labels.copy()
            if len(my_q):
                m = np.minimum(labels[my_q], labels[my_r])
                np.minimum.at(labels, my_q, m)
                np.minimum.at(labels, my_r, m)
            labels = labels[labels]
            if np.array_equal(labels, lp):
                break
        labels = mesh.all_reduce(group, torch.from_numpy(labels),
                                 torch.distributed.ReduceOp.MIN).numpy()
        if np.array_equal(labels, prev):
            break
    else:
        raise RuntimeError("label propagation did not converge")
    _tick("components")
    roots, comp_of = np.unique(labels, return_inverse=True)
    n_comp = len(roots)
    comp_sizes = np.bincount(comp_of, minlength=n_comp)
    comp_order = np.argsort(comp_of, kind="stable")
    boundaries = np.zeros(n_comp + 1, dtype=np.int64)
    np.cumsum(comp_sizes, out=boundaries[1:])

    # owner-computes bins (the same on every rank: the inputs are)
    bins = lpt_bins(comp_sizes, nproc)
    bin_of_comp = np.full(n_comp, -1, np.int64)
    for b, comps in enumerate(bins):
        bin_of_comp[comps] = b

    # --- edge exchange: each local pair to its component's owner ----------
    # (every pair lies in a component of >= 2 reads, so it has an owner)
    pairs = torch.from_numpy(np.stack([my_q, my_r], axis=1))
    dest = torch.from_numpy(bin_of_comp[comp_of[my_q]])
    inbox, sent, got = mesh.exchange(group, pairs, dest)
    comm["edge_exchange"] = sent + got
    inbox = inbox.cpu().numpy()
    eq, er = inbox[:, 0], inbox[:, 1]
    _tick("edge_exchange")
    # local adjacency CSR over owned edges only (global read-id space;
    # the engine walks it only inside owned components)
    src = np.concatenate([eq, er])
    dst = np.concatenate([er, eq])
    order2 = np.argsort(src, kind="stable")
    src, dst = src[order2], dst[order2]
    deg = np.bincount(src, minlength=N)
    adj_off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(deg, out=adj_off[1:])

    # repetitive screen on the local shard only; masks gathered
    rep_local = cg.repetitive_screen(my_store, cfg).astype(np.uint8)
    rep_mask = np.concatenate(
        _gather(group, rep_local, comm, "rep_mask_allgather")).astype(bool)
    _tick("screen_adj")
    graph = {"adj_off": adj_off, "dst": dst, "comp_of": comp_of,
             "n_comp": n_comp, "comp_order": comp_order,
             "boundaries": boundaries, "rep": rep_mask}

    # --- grow the bin this rank owns --------------------------------------
    # gather only the packed reads of owned components into a contiguous
    # buffer (the engine's flat contract) — ~1/P of the dataset each
    stats = FunnelStats()
    my_groups = []
    owned = bins[pid]
    if owned:
        need = np.sort(np.concatenate(
            [comp_order[boundaries[c]: boundaries[c + 1]] for c in owned]))
        sub = store.gather_substore(need)
        grp = cg._grow_components(sub, cfg, stats, graph, owned)
        grp.pop("timings", None)
        my_groups.append(grp)
    with open(os.path.join(work_dir, f"groups_{pid}.pkl"), "wb") as f:
        pickle.dump((my_groups, stats), f, protocol=pickle.HIGHEST_PROTOCOL)
    launches = _launch_counts()
    mem_evidence = {
        "proc": pid,
        "local_shard_bytes": int(
            ((store.lengths[id_off[pid]: id_off[pid + 1]] + 3) // 4).sum()),
        "gathered_bytes": store.bytes_gathered,
        "full_packed_bytes": int(((store.lengths + 3) // 4).sum()),
        "local_pairs": int(len(my_q)),
        "owned_edges": int(len(eq)),
        # global label rounds paid, each reducing the N-sized label array
        "label_allgather_rounds": int(label_rounds),
        "label_allgather_bytes": int(label_rounds) * int(N) * 8,
        "phase_times": dict(ph),
        # bytes through each collective on this rank: exchanges count what
        # was sent plus received (from the split sizes), gathers the
        # payload received; the label reduce counts its array per round
        # (the JAX key, though it is an all_reduce here)
        "comm_bytes": {
            **comm,
            "label_allgather": int(label_rounds) * int(N) * 8,
        },
        # kernel launches in this call, by wrapper
        "kernel_launches": {k: launches[k] - launches0[k] for k in launches},
    }
    with open(os.path.join(work_dir, f"mem_{pid}.pkl"), "wb") as f:
        pickle.dump(mem_evidence, f)
    _tick("grow")
    mesh.barrier(group)         # every rank's groups are spilled

    if pid != 0:
        return None

    # --- rank-0 streaming merge (per-thread file combine analog):
    # one rank's groups in memory at a time, serialized then dropped
    stats0 = FunnelStats()
    stats0.merge(stats)

    def _group_iter():
        for p in range(nproc):
            with open(os.path.join(work_dir, f"groups_{p}.pkl"), "rb") as f:
                gl, gstats = pickle.load(f)
            if p != 0:
                stats0.not_claimed += gstats.not_claimed
                stats0.aligned_ok += gstats.aligned_ok
            yield from gl

    res = _merge_and_archive(store, cfg, _group_iter(), stats0, out_path)
    _tick("merge_archive")
    res["phase_times"] = dict(ph)
    evidence = []
    for p in range(nproc):
        with open(os.path.join(work_dir, f"mem_{p}.pkl"), "rb") as f:
            evidence.append(pickle.load(f))
    res["mem_evidence"] = evidence
    return res


def _merge_and_archive(store, cfg, groups, stats, out_path: str) -> dict:
    """Streaming merge: ``groups`` is an iterable of per-bin group dicts;
    each is serialized into the stream set and dropped before the next is
    loaded — rank 0 never holds every group in memory."""
    from ..io import archive, serialize
    from ..io import streams as st
    from ..io.serialize import ContigBatch

    N = store.num_reads
    member_mask = np.zeros(N, dtype=bool)
    out = st.StreamSet()
    member_ids = []
    reads_per_contig = []
    for g_ in groups:
        member_mask[g_["ids"]] = True
        if not len(g_["consensus_list"]):
            continue
        cb = ContigBatch(
            consensus_list=g_["consensus_list"],
            reads_per_contig=g_["reads_per_contig"],
            ids=g_["ids"],
            strand=g_["strand"],
            start_pos=g_["es"].start_pos,
            head_ins=g_["es"].head_ins,
            tail_ins=g_["es"].tail_ins,
            n_edits=g_["es"].n_edits,
            runs_flat=g_["es"].runs_flat,
            types_flat=g_["es"].types_flat,
            bases_flat=g_["es"].bases_flat,
        )
        serialize.serialize_contigs(cb, out)
        member_ids.append(cb.ids)
        reads_per_contig.append(cb.reads_per_contig)
    lone = np.sort(np.flatnonzero(~member_mask).astype(np.int64))
    member_ids = (np.concatenate(member_ids) if member_ids
                  else np.zeros(0, np.int64))
    reads_per_contig = (np.concatenate(reads_per_contig)
                        if reads_per_contig else np.zeros(0, np.int64))
    serialize.serialize_lone(lone, store, out)
    all_ids = np.concatenate([member_ids, lone])
    out.append("id", st.encode_id_stream(all_ids))
    out.append("exc", st.encode_exc_stream(store.exc_read, store.exc_pos,
                                           store.exc_byte))
    meta = {
        "num_reads": store.num_reads,
        "num_lone": int(len(lone)),
        "num_contigs": int(len(reads_per_contig)),
        "reads_per_contig": reads_per_contig.tolist(),
        "total_bases": store.total_bases,
    }
    codec_map = {n: cfg.default_codec for n in st.STREAM_NAMES}
    codec_map["base"] = cfg.base_codec
    codec_map["pos"] = cfg.pos_codec
    sizes = archive.write_archive(out_path, out, meta, codec_map,
                                  device=cfg.torch_device())
    total_out = os.path.getsize(out_path)
    stats.contigs = int(len(reads_per_contig))
    return {
        "num_reads": N,
        "total_bases": store.total_bases,
        "compressed_bytes": total_out,
        "ratio": store.total_bases / max(total_out, 1),
        "stream_sizes": sizes,
        "funnel": stats,
    }


def _main(argv) -> int:
    """Rank entry: ``fq out work_dir nproc pid port`` as in the JAX package,
    plus where the rank runs and the config's DP route."""
    ap = argparse.ArgumentParser(
        prog="python -m nanospring_tpu_torch.parallel.distributed",
        description="one rank of a multi-process compress")
    ap.add_argument("fq")
    ap.add_argument("out")
    ap.add_argument("work_dir", help="a directory every rank sees")
    ap.add_argument("nproc", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("port", type=int, help="rank 0's port on 127.0.0.1")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=mesh.BACKENDS, default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--aligner", choices=ALIGNERS, default="device")
    ap.add_argument("--workers", type=int, default=0,
                    help="the config's pipeline_workers (a rank grows its "
                    "bin in its own process, so this only pins the config)")
    a = ap.parse_args(argv)
    group = mesh.initialize(f"127.0.0.1:{a.port}", a.nproc, a.pid,
                            device=a.device, backend=a.backend)
    try:
        cfg = CompressConfig(device=a.device, aligner=a.aligner,
                             pipeline_workers=a.workers)
        res = compress_distributed(a.fq, a.out, a.work_dir, cfg, group)
    finally:
        mesh.shutdown()
    if res is not None:
        print(f"distributed compress ok: ratio {res['ratio']:.2f} "
              f"contigs {res['funnel'].contigs}")
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
