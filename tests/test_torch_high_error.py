"""The port on old-basecaller reads (~9.6% error, the ``hs1``
configuration's error law) on the CPU: the candidate graph's recovery pass
against the benchmark's plain reference (``benchmark/reference_join.py``),
the JAX package's archive, graph and recovery pass on the same set, a
device-route round trip, and the counters that the benchmark's
``resketch_s``, ``retry_dp_s`` and ``lone_base_pct`` read."""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from nanospring_tpu import compressor as jax_compressor
from nanospring_tpu import decompressor as jax_decompressor
from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.pipeline import contigs as jax_contigs
from nanospring_tpu_torch import compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.io import read_store
from nanospring_tpu_torch.pipeline import contigs
from nanospring_tpu_torch.utils.observe import FunnelStats

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
CLEAN = {"p_ins": 0.008, "p_del": 0.008, "p_sub": 0.009}   # sa's, zymo's
CLASSES = ("nochain", "stitchfail", "retry")


@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    """One OpenMP and one torch thread for this module's runs: the test
    workers share the host's cores, and with a thread for each core every
    parallel region waits at its barrier for threads that are not
    running."""
    gomp = ctypes.CDLL("libgomp.so.1")
    omp, nt = gomp.omp_get_max_threads(), torch.get_num_threads()
    gomp.omp_set_num_threads(1)
    torch.set_num_threads(1)
    yield
    gomp.omp_set_num_threads(omp)
    torch.set_num_threads(nt)


@pytest.fixture(scope="module")
def bench():
    """The benchmark's generator and plain references, imported from its
    folder as its own scripts import them (``reference_join`` imports
    ``reference`` as a sibling)."""
    sys.path.insert(0, BENCH)
    try:
        return {name: importlib.import_module(name)
                for name in ("gen", "reference", "reference_join")}
    finally:
        sys.path.remove(BENCH)


def _hs1(genome_len: int, num_reads: int, mean_len: int,
         law: dict | None = None) -> dict:
    """``hs1.json`` at a small scale: its error law (or ``law``), genome
    model and seed."""
    with open(os.path.join(BENCH, "configs", "hs1.json")) as f:
        cfg = json.load(f)
    cfg["genomes"][0]["length"] = genome_len
    cfg["num_reads"] = num_reads
    cfg["mean_read_len"] = mean_len
    cfg["reads"].update(law or {})
    return cfg


@pytest.fixture(scope="module")
def sets(bench, tmp_path_factory):
    """One 40 kb genome at 15x in reads of ~2 kb: at hs1's error law and
    at sa's."""
    out = {}
    for name, law in (("hs1", None), ("clean", CLEAN)):
        d = str(tmp_path_factory.mktemp(name))
        bench["gen"].write_run(_hs1(40_000, 300, 2_000, law), 4_100_000_007,
                               d, 16)
        out[name] = os.path.join(d, "reads.fastq")
    return out


@pytest.mark.parametrize("name,fired", [("hs1", 1), ("clean", 0)])
def test_graph_pairs_after_recovery_match_the_reference(bench, sets,
                                                        monkeypatch, name,
                                                        fired):
    cfg = CompressConfig(device="cpu", pipeline_workers=1, num_threads=1)
    monkeypatch.setattr(contigs, "PIPE_STAGES", {})
    store = read_store.load_fastq(sets[name])
    graph = contigs._build_candidate_graph(store, cfg, FunnelStats(), False)
    N = store.num_reads
    deg = np.diff(graph["adj_off"])
    got = np.stack([np.repeat(np.arange(N), deg), graph["dst"]])
    got = got[:, np.lexsort(got[::-1])]

    rj = bench["reference_join"]
    reads = bench["reference"].fastq_reads(sets[name])

    def rows_at(k):
        return rj.sketch_all(reads, k, cfg.num_hashes, cfg.sketch_seed,
                             cfg.min_read_len_for_sketch)
    ref = rj.graph_pairs(rows_at, N, cfg.kmer_size,
                         cfg.overlap_sketch_threshold, cfg.max_bucket)
    # the graph holds each pair both ways
    want = np.concatenate([np.stack([ref["q"], ref["r"]]),
                           np.stack([ref["r"], ref["q"]])], axis=1)
    want = want[:, np.lexsort(want[::-1])]
    assert len(ref["q"]) > N
    np.testing.assert_array_equal(got, want)
    split = contigs.PIPE_STAGES
    assert split["resketch_fired"] == fired == int(ref["fired"])
    assert split["join_pairs_first"] == ref["first"]
    assert split["join_pairs_kept"] == len(ref["q"])
    assert (split["join_pairs_first"] * 2 < 3 * N) == bool(fired)
    assert ref["k"] == (17 if fired else 23)


@pytest.fixture(scope="module")
def job(sets, tmp_path_factory):
    """One device-route compress of the hs1-like set (the DP's plain
    version), the lone reads' ids that the job serialized, and the pipeline
    split unrounded."""
    mp = pytest.MonkeyPatch()
    orig = compressor.serialize.serialize_lone
    lone = []

    def serialize_lone(ids, store, out, *a, **kw):
        lone.append(np.array(ids))
        return orig(ids, store, out, *a, **kw)
    mp.setattr(compressor.serialize, "serialize_lone", serialize_lone)
    try:
        arc = str(tmp_path_factory.mktemp("hs1job") / "o.nstpu")
        res = compressor.compress_file(
            sets["hs1"], arc, CompressConfig(device="cpu", aligner="device",
                                            pipeline_workers=1,
                                            num_threads=1),
            report=False)
    finally:
        mp.undo()
    return res, arc, np.concatenate(lone), dict(contigs.PIPE_STAGES)


def test_device_route_round_trips_at_high_error(bench, sets, job):
    res, arc, _, _ = job
    out = arc + ".reads"
    decompressor.decompress_file(arc, out, report=False)
    reads = bench["reference"].fastq_reads(sets["hs1"])
    assert bench["reference"].restored_mismatches(out, reads) == 0
    assert res["funnel"].contigs > 0
    assert res["ratio"] > 4.0


def test_high_error_counters_agree(bench, sets, job):
    res, _, lone, split = job
    reads = bench["reference"].fastq_reads(sets["hs1"])
    assert len(lone) == res["funnel"].lone_reads > 0
    assert res["stage_s"]["lone_bases"] == sum(len(reads[i]) for i in lone)
    for c in CLASSES:
        assert 0 <= split[c + "_accepted"] <= split[c + "_pairs"]
        assert split[c + "_dp_s"] >= 0
    assert split["retry_pairs"] <= split["dp_rejects"]
    # the recovery pass's span is there exactly when it ran
    spans = [s for s in res["spans"] if s["name"] == "graph.resketch"]
    assert split["resketch_fired"] == 1
    assert len(spans) == 1
    assert res["stage_s"]["graph.resketch"] == pytest.approx(
        spans[0]["end"] - spans[0]["start"])
    assert res["stage_s"]["graph.resketch"] < split["sketch_join"]


def test_clean_job_has_no_recovery_span(sets, tmp_path):
    res = compressor.compress_file(
        sets["clean"], str(tmp_path / "c.nstpu"),
        CompressConfig(device="cpu", aligner="native", pipeline_workers=1,
                       num_threads=1), report=False)
    assert res["pipe_split"]["resketch_fired"] == 0
    assert "graph.resketch" not in res["stage_s"]
    assert not [s for s in res["spans"] if s["name"] == "graph.resketch"]


def test_device_route_counts_its_host_retries(bench, tmp_path):
    """Band rejects that the kernel sends back are retried at the full
    band on the host, beside the kernel's pairs of the same batch: with a
    cost limit below the error rate most pairs are rejected, and every
    retry is counted, with its seconds."""
    d = str(tmp_path)
    bench["gen"].write_run(_hs1(10_000, 60, 1_000), 4_100_000_011, d, 8)
    res = compressor.compress_file(
        os.path.join(d, "reads.fastq"), os.path.join(d, "o.nstpu"),
        CompressConfig(device="cpu", aligner="device", pipeline_workers=1,
                       num_threads=1, max_edit_frac=0.08), report=False)
    split = contigs.PIPE_STAGES
    assert 0 < split["retry_pairs"] <= split["dp_rejects"]
    assert split["retry_accepted"] <= split["retry_pairs"]
    assert split["retry_dp_s"] > 0
    assert res["dp_info"]["dp_hook_batches"] > 0


def test_archive_bytes_equal_jax_native_at_high_error(bench, sets, tmp_path,
                                                      monkeypatch):
    """The JAX package stays the port's reference at hs1's error law: with
    the native sketch and DP pinned, both packages run the k=17 recovery
    pass, build the same candidate graph and write the same archive, and
    each decodes the other's."""
    monkeypatch.setenv("NSTPU_SKETCH", "native")
    seen = {}
    for name, mod in (("jax", jax_contigs), ("torch", contigs)):
        ks, graphs = [], []
        sketch, build = mod.compute_all_sketches, mod._build_candidate_graph

        def compute_all_sketches(store, c, *a, _f=sketch, _ks=ks, **kw):
            _ks.append(c.kmer_size)
            return _f(store, c, *a, **kw)

        def _build_candidate_graph(*a, _f=build, _g=graphs, **kw):
            _g.append(_f(*a, **kw))
            return _g[-1]
        monkeypatch.setattr(mod, "compute_all_sketches", compute_all_sketches)
        monkeypatch.setattr(mod, "_build_candidate_graph",
                            _build_candidate_graph)
        seen[name] = ks, graphs

    jcfg = JaxConfig(aligner="native", pipeline_workers=1, num_threads=1)
    jarc, tarc = str(tmp_path / "jax.nstpu"), str(tmp_path / "torch.nstpu")
    jres = jax_compressor.compress_file(sets["hs1"], jarc, jcfg, report=False)
    cfg = CompressConfig.from_reference(dataclasses.asdict(jcfg),
                                        device="cpu")
    tres = compressor.compress_file(sets["hs1"], tarc, cfg, report=False)
    assert seen["jax"][0] == seen["torch"][0] == [23, 17]
    (jg,), (tg,) = seen["jax"][1], seen["torch"][1]
    for key in ("adj_off", "dst"):
        np.testing.assert_array_equal(jg[key], tg[key])
    assert tres["pipe_split"]["resketch_fired"] == 1
    assert tres["pipe_split"]["join_pairs_kept"] * 2 == len(tg["dst"])
    with open(jarc, "rb") as f1, open(tarc, "rb") as f2:
        assert f1.read() == f2.read()
    assert tres["ratio"] == jres["ratio"] > 4.0
    reads = bench["reference"].fastq_reads(sets["hs1"])
    for decompress, arc in ((decompressor.decompress_file, jarc),
                            (jax_decompressor.decompress_file, tarc)):
        decompress(arc, arc + ".reads", report=False)
        assert bench["reference"].restored_mismatches(arc + ".reads",
                                                      reads) == 0


def test_auto_route_counts_each_retry_once(bench, tmp_path, monkeypatch):
    """``aligner="auto"``'s warm-up and probe batches run the device route
    and then the host's DP on the same batch, and keep the host's results:
    their full-band retries are counted once, so a probe that picks the
    host gives the native route's archive and its retry counters. Forty
    2 kb genomes keep many contigs growing at once, so batches reach the
    probe's 64 pairs; a cost limit of 3% at sa's error law fills them with
    retries."""
    d = str(tmp_path)
    cfg = _hs1(2_000, 800, 500, CLEAN)
    cfg["genomes"] = [{"name": f"g{i}", "length": 2_000, "base_share": 1 / 40}
                      for i in range(40)]
    bench["gen"].write_run(cfg, 4_100_000_013, d, 8)
    fq = os.path.join(d, "reads.fastq")

    class Slow(contigs._DeviceDpHook):
        def __init__(self, lib, device, max_read_len):
            # a row capacity no other test's hook has: the engine's verdict
            # is cached per kernel shape, and this one must be probed
            super().__init__(lib, device, 4 * max_read_len)

        def _run(self, n_pairs):
            super()._run(n_pairs)
            time.sleep(0.5)            # the probe picks the host's DP

    runs = {}
    for aligner in ("native", "auto"):
        with monkeypatch.context() as mp:
            mp.setattr(contigs, "_probe_wanted", lambda store, cfg: True)
            mp.setattr(contigs, "_DeviceDpHook", Slow)
            arc = os.path.join(d, aligner + ".nstpu")
            res = compressor.compress_file(
                fq, arc, CompressConfig(device="cpu", aligner=aligner,
                                        pipeline_workers=1, num_threads=1,
                                        max_edit_frac=0.03), report=False)
        with open(arc, "rb") as f:
            runs[aligner] = res["pipe_split"], res["dp_info"], f.read()
    (nat, _, nat_arc), (auto, info, auto_arc) = runs["native"], runs["auto"]
    assert info["dp_hook_batches"] == 2 and info["dp_backend"] == "native"
    assert auto_arc == nat_arc
    assert nat["retry_pairs"] > 0
    for c in CLASSES:
        for key in ("_pairs", "_accepted"):
            assert auto[c + key] == nat[c + key]
    assert auto["retry_pairs"] <= auto["dp_rejects"]
