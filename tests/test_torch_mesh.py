"""The port's ``compress_mesh`` on 2 and 4 gloo ranks on the CPU against
the JAX package's ``compress_mesh`` on a CPU mesh of as many devices:
byte-equal archives (``aligner="native"``, ``pipeline_workers=1`` on both
sides), the same pair count and per-rank contig metadata, and a lossless
round trip. The ranks are subprocesses; the JAX side runs in the test
process. Then where the mesh graph and the one-process graph differ."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.io import read_store as jrs
from nanospring_tpu.parallel import mesh as jmesh
from nanospring_tpu.parallel import pipeline as jpipe
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.decompressor import decompress_file
from nanospring_tpu_torch.io import read_store
from nanospring_tpu_torch.parallel import mesh
from nanospring_tpu_torch.parallel.pipeline import candidate_graph
from nanospring_tpu_torch.pipeline import candidates
from nanospring_tpu_torch.pipeline import contigs as cg
from nanospring_tpu_torch.utils.observe import FunnelStats
from nanospring_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r"""
import json
import sys
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.io import read_store
from nanospring_tpu_torch.parallel import mesh
from nanospring_tpu_torch.parallel.pipeline import compress_mesh

fq, arc, world, rank, port = sys.argv[1:6]
group = mesh.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                        device="cpu")
store = read_store.load_fastq(fq)
cfg = CompressConfig(device="cpu", aligner="native", pipeline_workers=1)
res = compress_mesh(store, arc, cfg, group)
mesh.shutdown()
if res is not None:
    print("RESULT " + json.dumps({k: res[k] for k in (
        "n_devices", "pairs", "gathered_meta", "ratio", "num_reads")}))
"""


def _reads(fq: str) -> list:
    """tests/test_distributed.py's dataset: 6 genomes of 12 kb, 32 reads
    of ~1,500 bases from each."""
    rng = np.random.default_rng(55)
    reads = []
    for _ in range(6):
        g = synth.random_genome(12_000, rng)
        reads += synth.make_reads(g, 32, 1_500, rng)
    synth.write_fastq(fq, reads, gz=False)
    return reads


@pytest.mark.parametrize("world", [2, 4])
def test_compress_mesh_matches_jax(tmp_path, world):
    fq = str(tmp_path / "r.fastq")
    reads = _reads(fq)
    arc = str(tmp_path / "port.nstpu")
    port = mesh.free_port()
    ranks = mesh.run_ranks(
        [[sys.executable, "-c", RANK, fq, arc, str(world), str(rank),
          str(port)] for rank in range(world)],
        env={"PYTHONPATH": REPO}, timeout=300)
    for rc, o in ranks:
        assert rc == 0, o[-3000:]
    outs = [o for _, o in ranks]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")]
    assert line and not any("RESULT " in o for o in outs[1:]), outs
    got = json.loads(line[0][len("RESULT "):])

    arc_j = str(tmp_path / "jax.nstpu")
    want = jpipe.compress_mesh(
        jrs.load_fastq(fq), arc_j,
        JaxConfig(aligner="native", pipeline_workers=1),
        mesh=jmesh.make_mesh(world))
    with open(arc, "rb") as f, open(arc_j, "rb") as g:
        assert f.read() == g.read(), "mesh archives differ"
    assert got["n_devices"] == want["n_devices"] == world
    assert got["pairs"] == want["pairs"] > 0
    assert got["gathered_meta"] == want["gathered_meta"]
    assert got["num_reads"] == len(reads)
    # every rank grew contigs
    assert all(m[0] > 0 for m in got["gathered_meta"])

    out = str(tmp_path / "r.reads")
    decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        assert f.read().splitlines() == reads


def _grown(store, cfg, graph, comps):
    g = cg._grow_components(store, cfg, FunnelStats(), dict(graph), comps)
    return (g["ids"].tolist(), g["strand"].tolist(),
            [c.tobytes() for c in g["consensus_list"]])


def test_mesh_graph_differs_from_one_process_only_in_neighbour_order(
        tmp_path):
    """Why ``compress_mesh`` (and ``compress_distributed``) compress a set
    otherwise than ``compress_file`` on the same pairs. The one-process
    graph holds every neighbour twice, in ascending order (the native join
    returns both directions of each pair and the CSR mirrors them again);
    the mesh graph holds each once, the neighbours above the read first.
    The components are the same. Dropping the duplicates changes no group;
    sorting the mesh graph's neighbours gives the one-process groups; left
    in its order, the mesh graph grows other contigs. The engine claims
    reads in adjacency order, so the order is what differs."""
    fq = str(tmp_path / "r.fastq")
    synth.make_dataset(fq, genome_len=60_000, num_reads=150, mean_len=3_000,
                       seed=1234, p_n_base=0.0005, realistic=True)
    store = read_store.load_fastq(fq)
    N = store.num_reads
    cfg = CompressConfig(device="cpu", aligner="native", pipeline_workers=1)
    cfg = dataclasses.replace(
        cfg, seed_window=cfg.effective_seed_window(store.avg_len),
        min_overlap=cfg.effective_min_overlap(store.avg_len))
    one = cg._build_candidate_graph(store, cfg, FunnelStats(), False)
    q, r, _ = candidates.all_pairs_native(
        cg.compute_all_sketches(store, cfg), cfg.overlap_sketch_threshold,
        cfg.max_bucket)
    meshg = dict(candidate_graph(q[q < r], r[q < r], N), rep=one["rep"])
    assert np.array_equal(one["comp_of"], meshg["comp_of"])

    def nbrs(g, i):
        return g["dst"][g["adj_off"][i]: g["adj_off"][i + 1]]

    assert len(one["dst"]) == 2 * len(meshg["dst"])
    for i in range(N):
        assert np.array_equal(np.unique(nbrs(one, i)),
                              np.sort(nbrs(meshg, i)))

    def reordered(g, key):
        lists = [key(i, nbrs(g, i)) for i in range(N)]
        off = np.zeros(N + 1, np.int64)
        np.cumsum([len(x) for x in lists], out=off[1:])
        return dict(g, dst=np.concatenate(lists), adj_off=off)

    sizes = np.diff(one["boundaries"])
    comps = np.flatnonzero(sizes >= 2).tolist()
    want = _grown(store, cfg, one, comps)
    assert _grown(store, cfg, reordered(one, lambda i, x: np.unique(x)),
                  comps) == want
    assert _grown(store, cfg, reordered(meshg, lambda i, x: np.sort(x)),
                  comps) == want
    assert _grown(store, cfg, meshg, comps) != want
