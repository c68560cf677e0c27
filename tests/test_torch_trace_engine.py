"""The engine's and the device hook's spans and counters on the CPU
(``aligner="device"``, ``device="cpu"``: the hook runs the DP's plain
version), and ``nstpu -c --trace-out``."""

from __future__ import annotations

import gc
import json
import time
import weakref

import pytest

from nanospring_tpu_torch import cli, compressor, native
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.pipeline import contigs
from nanospring_tpu_torch.utils import synth

NEW_SPLIT = ("engine_wait_dp", "dp_starved")
DP_PHASES = ("dp.pack", "dp.hook", "dp.expand", "dp.host_routed")


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "in.fastq")
    synth.make_dataset(path, genome_len=30_000, num_reads=80, mean_len=900,
                       seed=3, realistic=True)
    return path


@pytest.fixture(scope="module")
def job(fastq, tmp_path_factory):
    """One compress job through the device hook, with ``perf_counter``
    read just before and after each engine run, and the garbage collector
    off; the engine's raw totals, and whether a hook outlived the job."""
    mp = pytest.MonkeyPatch()
    lib = native.get_lib()
    orig = lib.ns_engine_run
    init = contigs._DeviceDpHook.__init__
    runs, hooks = [], []

    def ns_engine_run(*args):
        t0 = time.perf_counter()
        h = orig(*args)
        runs.append((t0, time.perf_counter()))
        return h

    def hook_init(self, *args):
        init(self, *args)
        hooks.append(weakref.ref(self))
    mp.setattr(contigs._DeviceDpHook, "P_CAP", 32)
    mp.setattr(contigs._DeviceDpHook, "__init__", hook_init)
    mp.setattr(lib, "ns_engine_run", ns_engine_run)
    gc.disable()
    try:
        out = str(tmp_path_factory.mktemp("job") / "out.nstpu")
        res = compressor.compress_file(
            fastq, out, CompressConfig(device="cpu", aligner="device",
                                       pipeline_workers=1), report=False)
        alive = [h() is not None for h in hooks]
    finally:
        gc.enable()
        mp.undo()
    return res, runs, dict(contigs.PIPE_STAGES), alive


def test_the_hook_and_its_buffers_go_with_the_job(job):
    # the next job's pinned buffers must not find the last job's still
    # resident, waiting for the garbage collector
    assert job[3] == [False]


def test_new_engine_totals_are_present_and_split_the_dp(job):
    res, _, raw, _ = job
    for k in NEW_SPLIT:
        assert res["pipe_split"][k] >= 0
    assert res["dp_info"]["dp_hook_batches"] > 1
    # the DP phases' totals are those of the engine's per-batch records
    phase = {k: sum(s["end"] - s["start"] for s in res["spans"]
                    if s["name"] == k and s["thread"] in contigs.ENGINE_THREADS)
             for k in DP_PHASES}
    four = sum(phase.values())
    assert 0 < four <= raw["dp"]
    # on the device route the DP thread's time is these four phases
    assert four >= 0.98 * raw["dp"]
    assert phase["dp.hook"] > 0 and phase["dp.pack"] > 0
    assert res["dp_info"]["dp_kernel_event_s"] == 0.0      # no events on cpu


def test_engine_exports_its_full_band_dps_by_class(job):
    res, _, raw, _ = job
    for c in ("nochain", "stitchfail", "retry"):
        assert 0 <= raw[c + "_accepted"] <= raw[c + "_pairs"]
        assert raw[c + "_dp_s"] >= 0
        assert c + "_pairs" in res["pipe_split"]
    # every escalated retry comes from a band reject
    assert raw["retry_pairs"] <= raw["dp_rejects"]


def test_engine_spans_lie_inside_the_engine_run_on_the_shared_clock(job):
    res, runs, _, _ = job
    assert len(runs) == 1
    t0, t1 = runs[0]
    eng = [s for s in res["spans"]
           if s["thread"] in contigs.ENGINE_THREADS
           and s["name"] in contigs.ENGINE_SPANS]
    assert {s["name"] for s in eng} >= {
        "engine.collect", "engine.settle", "engine.wait_dp",
        "engine.dp_starved", "dp.pack", "dp.hook", "dp.expand",
        "dp.host_routed"}
    for s in eng:
        assert t0 <= s["start"] <= s["end"] <= t1
    batches = [s["args"]["batch"] for s in eng if s["name"] == "dp.hook"]
    assert len(batches) == res["dp_info"]["dp_hook_batches"]
    assert batches == sorted(batches) and len(set(batches)) == len(batches)
    settled = [s["args"]["batch"] for s in eng if s["name"] == "engine.settle"]
    assert set(batches) <= set(settled)


def test_hook_spans_carry_the_engine_batch_of_their_call(job):
    res, _, _, _ = job
    spans = res["spans"]
    hook = {s["args"]["batch"]: s for s in spans if s["name"] == "dp.hook"}
    kids = [s for s in spans if s["name"].startswith("dp.hook.")]
    assert {s["name"] for s in kids} == {
        "dp.hook.copy_in", "dp.hook.launch", "dp.hook.copy_out",
        "dp.hook.escape"}
    assert len(kids) == 4 * len(hook)
    # the engine's DP thread, or the thread that ran the engine for the
    # batches it runs itself
    thread = {"engine.dp": "engine.dp", "engine.main": "MainThread"}
    for s in kids:
        rec = hook[s["args"]["batch"]]
        assert s["thread"] == thread[rec["thread"]]
        assert rec["start"] <= s["start"] <= s["end"] <= rec["end"]
    assert {s["args"]["batch"] for s in kids} == set(hook)


def test_stage_totals_keep_the_top_level_stages(job):
    res, _, _, _ = job
    spans = res["spans"]
    top = [s for s in spans if s["parent"] is None
           and s["thread"] == "MainThread"]
    assert [s["name"] for s in top] == ["load_reads", "pipeline",
                                        "serialize", "codec+archive"]
    for s in top:
        assert res["stage_s"][s["name"]] == pytest.approx(
            s["end"] - s["start"], rel=1e-9)
        assert s["args"]["rss_gb"] > 0
    names = {s["name"] for s in spans}
    assert {"emit.fetch", "emit.unpack", "emit.scripts", "archive.crc",
            "archive.write", "graph.premz_wait"} <= names
    st = res["stage_s"]
    assert st["codec_threads"] >= 1
    assert 0 < st["codec_longest_chunk_s"] <= st["codec_chunk_s"]


def test_trace_out_leaves_the_archive_unchanged(fastq, tmp_path):
    args = ["-c", "-i", fastq, "--device", "cpu", "--workers", "1",
            "--aligner", "native", "-q"]
    plain, traced = str(tmp_path / "a.nstpu"), str(tmp_path / "b.nstpu")
    trace = str(tmp_path / "b.json")
    assert cli.main(args + ["-o", plain]) == 0
    assert cli.main(args + ["-o", traced, "--trace-out", trace]) == 0
    with open(plain, "rb") as f1, open(traced, "rb") as f2:
        assert f1.read() == f2.read()
    with open(trace) as f:
        doc = json.load(f)
    assert doc["clock"] == "CLOCK_MONOTONIC"
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M"}
    assert {"MainThread", "engine.main", "engine.dp"} <= threads
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"pipeline", "engine.collect", "engine.settle",
            "codec+archive"} <= names
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and "job" in e["args"]
