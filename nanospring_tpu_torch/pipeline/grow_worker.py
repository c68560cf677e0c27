"""Subprocess entry for owner-computes contig growth.

Invoked as ``python -m nanospring_tpu_torch.pipeline.grow_worker in.pkl
out.pkl`` by contigs.build_contigs. A plain subprocess (not
multiprocessing) because forking after CUDA initialization is unsafe, and
spawn/forkserver re-execute the caller's __main__, which breaks
embedded/stdin callers. Each worker installs its own device DP hook (one
CUDA context per worker); growth is numpy + the C++ engine (components are
disjoint, so there is no coordination at all). The group's ``timings``
carry the worker's hook counters back through the pickle: its DP
launches, whether it launched at all, its peak device memory and, under
``aligner="auto"``, its probe verdict and times.
"""

from __future__ import annotations

import pickle
import sys


def main(in_path: str, out_path: str) -> int:
    with open(in_path, "rb") as f:
        store_parts, cfg, graph, subset, omp_threads = pickle.load(f)
    import os

    os.environ["OMP_NUM_THREADS"] = str(omp_threads)
    from ..io.read_store import ReadStore
    from ..utils.observe import FunnelStats
    from . import contigs

    kind = store_parts[0]
    if kind == "lowmem":
        # re-map the parent's spill file read-only; the parent owns its
        # lifetime (ReadStore.temp_path stays unset here)
        import numpy as np

        buf = np.memmap(store_parts[1], dtype=np.uint8, mode="r")
        store = ReadStore(buf, *store_parts[2:])
    else:
        store = ReadStore(*store_parts[1:])
    stats = FunnelStats()
    group = contigs._grow_components(store, cfg, stats, graph, subset)
    with open(out_path, "wb") as f:
        pickle.dump((group, stats), f, protocol=pickle.HIGHEST_PROTOCOL)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
