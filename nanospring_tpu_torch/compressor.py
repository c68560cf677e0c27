"""Compression orchestrator — the reference Compressor's role
(reference: src/Compressor.cpp:47-161), restructured as:

  load reads -> pipeline (sketch/candidates/contigs/encode) -> streams
  -> host codec stage -> tar archive

This is the PyTorch port's copy of ``nanospring_tpu/compressor.py``; the
sketch and the engine's batch DP run on ``cfg.device``.

The pipeline stage is pluggable; ``pipeline.driver`` is the full
sketch+align+consensus engine, and a trivial all-lone pipeline exists for
testing the serialization path in isolation.
"""

from __future__ import annotations

import concurrent.futures as cf
import os

import numpy as np

from .config import CompressConfig
from .io import archive, read_store, serialize
from .io import streams as st
from .utils.observe import FunnelStats, StageTimer


def compress_file(
    in_path: str,
    out_path: str,
    cfg: CompressConfig | None = None,
    report: bool = True,
) -> dict:
    cfg = cfg or CompressConfig()
    cfg.torch_device()      # no card for device="cuda": raise before work
    timer = StageTimer(report=report)
    stats = FunnelStats()

    low_mem = cfg.low_mem
    if low_mem is None:
        # auto: disk-backed store above the threshold so neither the store
        # nor the per-worker fan-out duplicates a big dataset in RAM (the
        # reference hardwires its low-mem mode on, src/main.cpp:40)
        try:
            low_mem = os.path.getsize(in_path) >= cfg.low_mem_auto_bytes
        except OSError:
            low_mem = False
    with timer.active():
        with timer.stage("load_reads"):
            store = read_store.load_fastq(
                in_path, low_mem=low_mem, work_dir=cfg.resolved_work_root()
            )
        if report:
            print(
                f"[nstpu] {store.num_reads} reads, avg len "
                f"{store.avg_len:.0f}, total {store.total_bases/1e9:.3f} "
                f"Gbases"
            )

        try:
            res = _compress_loaded(store, out_path, cfg, timer, stats, report)
            res["low_mem"] = bool(low_mem)
            return res
        finally:
            store.cleanup()  # low-mem spill file (no-op in memory mode)


def _compress_loaded(store, out_path, cfg, timer, stats, report) -> dict:
    with timer.stage("pipeline"):
        from .pipeline import driver

        contig_batches, lone_ids = driver.run(store, cfg, stats, report=report)

    with timer.stage("serialize"):
        out = st.StreamSet()
        member_ids = []
        reads_per_contig = []
        for cb in contig_batches:
            serialize.serialize_contigs(cb, out)
            member_ids.append(cb.ids)
            reads_per_contig.append(cb.reads_per_contig)
        member_ids = (
            np.concatenate(member_ids) if member_ids else np.zeros(0, dtype=np.int64)
        )
        reads_per_contig = (
            np.concatenate(reads_per_contig)
            if reads_per_contig
            else np.zeros(0, dtype=np.int64)
        )
        lone_ids = np.sort(np.asarray(lone_ids, dtype=np.int64))
        serialize.serialize_lone(lone_ids, store, out)
        timer.add("lone_bases", int(store.lengths[lone_ids].sum()))
        all_ids = np.concatenate([member_ids, lone_ids])
        out.append("id", st.encode_id_stream(all_ids))
        out.append(
            "exc", st.encode_exc_stream(store.exc_read, store.exc_pos, store.exc_byte)
        )
        meta = {
            "num_reads": store.num_reads,
            "num_lone": int(len(lone_ids)),
            "num_contigs": int(len(reads_per_contig)),
            "reads_per_contig": reads_per_contig.tolist(),
            "total_bases": store.total_bases,
        }

    with timer.stage("codec+archive"):
        codec_map = {n: cfg.default_codec for n in st.STREAM_NAMES}
        codec_map["base"] = cfg.base_codec
        codec_map["pos"] = cfg.pos_codec
        codec_map["exc"] = getattr(cfg, "exc_codec", "nsbwt")
        threads = cfg.resolved_threads()
        timer.add("codec_threads", threads)
        with cf.ThreadPoolExecutor(threads) as pool:
            sizes = archive.write_archive(out_path, out, meta, codec_map,
                                          pool=pool, device=cfg.torch_device())

    stats.reads_in_contigs = int(len(member_ids))
    stats.lone_reads = int(len(lone_ids))
    stats.contigs = int(len(reads_per_contig))
    total_out = os.path.getsize(out_path)
    try:
        from .pipeline.contigs import DP_INFO as _dp_info
        dp_info = dict(_dp_info)
    except Exception:
        dp_info = {"dp_backend": "native"}
    result = {
        "dp_info": dp_info,
        "num_reads": store.num_reads,
        "total_bases": store.total_bases,
        "compressed_bytes": total_out,
        "ratio": store.total_bases / max(total_out, 1),
        "stream_sizes": sizes,
        "raw_stream_sizes": out.sizes(),
        "wall_s": timer.total(),
        "stage_s": timer.stage_s,
        "spans": timer.spans,
        "funnel": stats,
    }
    try:
        from .pipeline.contigs import PIPE_STAGES as _ps
        result["pipe_split"] = {k: round(float(v), 3) for k, v in _ps.items()}
    except Exception:
        result["pipe_split"] = {}
    if report:
        print(stats.report())
        print(
            f"[nstpu] compressed {store.total_bases} bases -> {total_out} bytes "
            f"(ratio {result['ratio']:.2f}x, {8/result['ratio']:.3f} bits/base) "
            f"in {result['wall_s']:.1f}s"
        )
    return result
