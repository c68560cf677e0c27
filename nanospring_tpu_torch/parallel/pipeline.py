"""Mesh compression: the whole pipeline laid out over the process group,
with the whole read store in every rank. Counterpart of
``nanospring_tpu/parallel/pipeline.py``:

1. rank d sketches its block of rows, [d*ceil(N/W), (d+1)*ceil(N/W)), on
   its device with the sketch kernel,
2. overlap candidates come from the sharded join (``sharded_join.py``),
   gathered to every rank in one order,
3. every rank derives the same overlap components (scipy) and the same
   owner-computes bins (greedy LPT, one bin per rank); rank d grows bin d,
4. funnel stats merge with one ``all_reduce``, per-rank contig metadata
   with an all-gather, and the groups reach rank 0 in rank order,
5. rank 0 serializes and writes the archive.

The archive is byte-equal to the JAX package's ``compress_mesh`` over a
mesh of as many devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import CompressConfig
from ..utils.observe import FunnelStats
from . import mesh
from . import sharded_join as sj


def lpt_bins(comp_sizes: np.ndarray, n_bins: int) -> list[list[int]]:
    """Components of >= 2 reads into ``n_bins`` bins, largest first, each to
    the least-loaded bin (the lowest index on ties): the same bins on every
    rank, as in the JAX package."""
    eligible = np.flatnonzero(comp_sizes >= 2)
    bins: list[list[int]] = [[] for _ in range(n_bins)]
    loads = np.zeros(n_bins, dtype=np.int64)
    for c in eligible[np.argsort(-comp_sizes[eligible])]:
        b = int(np.argmin(loads))
        bins[b].append(int(c))
        loads[b] += comp_sizes[c]
    return bins


def candidate_graph(pq: np.ndarray, pr: np.ndarray, N: int) -> dict:
    """The overlap graph of the unordered pairs (pq[i], pr[i]), each given
    once: the adjacency CSR over both directions (each read's neighbours
    above it, then those below, each run in the pairs' order) and the
    connected components (scipy), as the JAX package's ``compress_mesh``
    builds them."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    src = np.concatenate([pq, pr])
    dst = np.concatenate([pr, pq])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    adj_off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=N), out=adj_off[1:])
    g = sp.csr_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(N, N))
    n_comp, comp_of = csgraph.connected_components(g, directed=False)
    comp_sizes = np.bincount(comp_of, minlength=n_comp)
    boundaries = np.zeros(n_comp + 1, dtype=np.int64)
    np.cumsum(comp_sizes, out=boundaries[1:])
    return {"adj_off": adj_off, "dst": dst, "comp_of": comp_of,
            "n_comp": n_comp, "comp_order": np.argsort(comp_of, kind="stable"),
            "boundaries": boundaries}


def compress_mesh(store, out_path: str, cfg: CompressConfig,
                  group: mesh.Group | None = None,
                  report: bool = False) -> dict | None:
    """Compress ``store`` (the same store in every rank) with the pipeline
    laid out over ``group`` (default: the initialized process group, on
    ``cfg.device``). Returns the result dict on rank 0, None elsewhere."""
    from ..pipeline import contigs as cg
    from .distributed import _merge_and_archive

    group = group or mesh.make_group(device=cfg.device)
    W = group.world
    N = store.num_reads
    cfg = dataclasses.replace(
        cfg,
        seed_window=cfg.effective_seed_window(store.avg_len),
        min_overlap=cfg.effective_min_overlap(store.avg_len),
    )
    stats = FunnelStats()

    # 1-2: sketch this rank's rows, then the sharded join (each unordered
    # pair once, q < r: the adjacency below mirrors it)
    rows = -(-N // W)
    lo, hi = min(N, group.rank * rows), min(N, (group.rank + 1) * rows)
    sketches = cg.sketch_rows(store, cfg, lo, hi)
    rids = torch.arange(lo, hi, device=sketches.device)
    pq, pr, _cnt = sj.gather_pairs(group, *sj.sharded_candidate_pairs(
        group, sketches, rids, cfg.overlap_sketch_threshold, cfg.max_bucket,
        canonical=True))
    if report and group.rank == 0:
        print(f"[nstpu] mesh of {W} ranks: {len(pq)} candidate pairs")
    stats.minhash_hits += len(pq)

    # 3: adjacency + components, identical on every rank
    graph = candidate_graph(pq, pr, N)
    rep_mask = cg.repetitive_screen(store, cfg)
    stats.repetitive = int(rep_mask.sum())
    graph["rep"] = rep_mask
    comp_sizes = np.diff(graph["boundaries"])

    # rank d grows bin d
    mine = lpt_bins(comp_sizes, W)[group.rank]
    grp = None
    my_stats = np.zeros(4, dtype=np.int64)
    my_meta = np.zeros((1, 3), dtype=np.int64)
    if mine:
        dstats = FunnelStats()
        grp = cg._grow_components(store, cfg, dstats, graph, mine)
        grp.pop("timings", None)
        my_stats[:2] = (dstats.not_claimed, dstats.aligned_ok)
        my_meta[0] = (len(grp["consensus_list"]), len(grp["ids"]),
                      sum(len(c) for c in grp["consensus_list"]))

    # 4: collective merges (summed funnel, gathered metadata, groups)
    merged = mesh.all_reduce(group, torch.from_numpy(my_stats)).numpy()
    stats.not_claimed += int(merged[0])
    stats.aligned_ok += int(merged[1])
    gathered_meta = np.concatenate([
        x.cpu().numpy() for x in mesh.all_gather_ragged(
            group, torch.from_numpy(my_meta))])
    stats.contigs = int(gathered_meta[:, 0].sum())
    groups = [None] * W if group.rank == 0 else None
    dist.gather_object(grp, groups, dst=0)
    if group.rank != 0:
        return None

    # 5: serialize + archive on rank 0
    groups = [g_ for g_ in groups if g_ is not None]
    res = _merge_and_archive(store, cfg, groups, stats, out_path)
    res["n_devices"] = W
    res["pairs"] = int(len(pq))
    res["gathered_meta"] = gathered_meta.tolist()
    return res
