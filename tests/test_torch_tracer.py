"""The port's tracer (``utils/observe.py``), the codec pool's spans and
counters (``io/archive.py``) and the benchmark's readers of what they
record (``benchmark/metrics/``), on the CPU."""

from __future__ import annotations

import concurrent.futures as cf
import importlib.util
import json
import os
import sys
import threading

import numpy as np
import pytest

from nanospring_tpu_torch.codec import backends
from nanospring_tpu_torch.io import archive
from nanospring_tpu_torch.io import streams as st
from nanospring_tpu_torch.utils import observe

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "metrics")


def test_spans_nest_with_parents_per_thread():
    tr = observe.StageTimer(report=False)
    with tr.stage("outer"):
        with tr.stage("outer.inner"):
            tr.note(n=3)

        def other():
            with tr.stage("side"):
                with tr.stage("side.inner"):
                    pass
        t = threading.Thread(target=other, name="other")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    by = {s["name"]: (i, s) for i, s in enumerate(tr.spans)}
    assert by["outer"][1]["parent"] is None
    assert by["outer.inner"][1]["parent"] == by["outer"][0]
    assert by["outer.inner"][1]["args"] == {"n": 3}
    # a span opened on another thread has no parent on the main thread
    assert by["side"][1]["parent"] is None
    assert by["side"][1]["thread"] == "other"
    assert by["side.inner"][1]["parent"] == by["side"][0]
    for s in tr.spans:
        assert s["job"] == tr.job and s["start"] <= s["end"]
        if s["parent"] is not None:
            p = tr.spans[s["parent"]]
            assert p["start"] <= s["start"] and s["end"] <= p["end"]
    # the top-level stage carries the RSS at its end; nested spans do not
    assert by["outer"][1]["args"]["rss_gb"] > 0
    assert by["outer"][1]["args"]["ru_maxrss_gb"] > 0
    assert "rss_gb" not in by["side"][1]["args"]
    assert set(tr.stage_s) == {"outer", "outer.inner", "side", "side.inner"}


def test_totals_are_thread_safe_under_a_pool():
    tr = observe.StageTimer(report=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def job(i):
            with tr.stage("codec.x"):
                tr.add("n", 1)
                tr.peak("most", i)
        with cf.ThreadPoolExecutor(16) as pool:
            list(pool.map(job, range(2000)))
    finally:
        sys.setswitchinterval(old)
    assert tr.stage_s["n"] == 2000
    assert tr.stage_s["most"] == 1999
    spans = [s for s in tr.spans if s["name"] == "codec.x"]
    assert len(spans) == 2000
    assert all(s["parent"] is None for s in spans)
    total = sum(s["end"] - s["start"] for s in spans)
    assert tr.stage_s["codec.x"] == pytest.approx(total, rel=1e-9)


def test_top_level_totals_keep_their_names_and_values():
    tr = observe.StageTimer(report=False)
    for name in ("load_reads", "pipeline", "serialize", "codec+archive",
                 "pipeline"):
        with tr.stage(name):
            with tr.stage(name + ".part"):
                pass
    top = {s["name"] for s in tr.spans if s["parent"] is None}
    assert top == {"load_reads", "pipeline", "serialize", "codec+archive"}
    for name in top:
        assert tr.stage_s[name] == pytest.approx(sum(
            s["end"] - s["start"] for s in tr.spans if s["name"] == name),
            rel=1e-9)


def test_no_tracer_where_none_is_current():
    assert observe.current() is observe.NO_TRACER
    with observe.NO_TRACER.stage("x"):
        observe.NO_TRACER.note(a=1)
        observe.NO_TRACER.add("n", 1)
    assert observe.NO_TRACER.spans == ()
    last = observe.NO_TRACER.last()
    assert last["end"] - last["start"] == 0
    tr = observe.StageTimer(report=False)
    with tr.active():
        assert observe.current() is tr
        inner = observe.StageTimer(report=False)
        with inner.active():
            assert observe.current() is inner
        assert observe.current() is tr
    assert observe.current() is observe.NO_TRACER


def test_only_top_level_stages_print(capsys):
    tr = observe.StageTimer(report=True)
    with tr.stage("pipeline"):
        with tr.stage("emit.fetch"):
            pass

    def pool_thread():
        with tr.stage("codec.base"):
            pass
    t = threading.Thread(target=pool_thread)
    t.start()
    t.join(timeout=10)
    err = capsys.readouterr().err
    assert "[nstpu] pipeline:" in err
    assert "emit.fetch" not in err and "codec.base" not in err


def test_chrome_trace_names_threads_and_the_clock(tmp_path):
    tr = observe.StageTimer(report=False)
    with tr.stage("a"):
        tr.record("dp.hook", 1.0, 2.5, "engine.dp", batch=7)
    path = str(tmp_path / "t.json")
    observe.write_chrome_trace(path, tr.spans)
    with open(path) as f:
        doc = json.load(f)
    assert doc["clock"] == "CLOCK_MONOTONIC"
    names = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert set(names) == {"MainThread", "engine.dp"}
    ev = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert ev["dp.hook"]["ts"] == 1.0e6 and ev["dp.hook"]["dur"] == 1.5e6
    assert ev["dp.hook"]["tid"] == names["engine.dp"]
    assert ev["dp.hook"]["args"]["batch"] == 7
    assert ev["a"]["args"]["job"] == tr.job


def test_codec_pool_spans_one_per_chunk_job(monkeypatch, tmp_path):
    monkeypatch.setattr(backends, "_CHUNK", 4096)
    ss = st.StreamSet()
    rng = np.random.default_rng(3)
    ss.append("base", rng.integers(0, 4, 20_000, dtype="uint8"))
    ss.append("id", rng.integers(0, 255, 5_000, dtype="uint8"))
    codec_map = {n: "zlib" for n in st.STREAM_NAMES}
    jobs = sum(len(backends.split_chunks(ss.get(n))) for n in st.STREAM_NAMES)
    tr = observe.StageTimer(report=False)
    with tr.active(), cf.ThreadPoolExecutor(4) as pool:
        with tr.stage("codec+archive"):
            archive.write_archive(str(tmp_path / "a.nstpu"), ss, {},
                                  codec_map, pool=pool)
    codec = [s for s in tr.spans if s["name"].startswith("codec.")]
    assert len(codec) == jobs
    assert sorted(s["name"] for s in codec) == sorted(
        "codec." + n for n in st.STREAM_NAMES
        for _ in backends.split_chunks(ss.get(n)))
    for s in codec:
        assert set(s["args"]) == {"codec", "bytes_in", "bytes_out"}
    assert sum(s["args"]["bytes_in"] for s in codec) == sum(
        ss.sizes().values())
    main = {s["name"]: s for s in tr.spans}
    assert main["archive.crc"]["parent"] is not None
    assert main["archive.write"]["parent"] is not None
    assert 0 < tr.stage_s["codec_longest_chunk_s"] <= tr.stage_s[
        "codec_chunk_s"]
    # the counters are the chunk spans' own durations
    dur = [s["end"] - s["start"] for s in codec]
    assert tr.stage_s["codec_chunk_s"] == pytest.approx(sum(dur))
    assert tr.stage_s["codec_longest_chunk_s"] == max(dur)
    meta, out = archive.read_archive(str(tmp_path / "a.nstpu"))
    assert out["base"].tobytes() == ss.get("base")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _job(dp, starved, wait, emit, kernel, chunk, longest, threads, codec):
    return {"pipe_split": {"dp": dp, "dp_starved": starved,
                           "engine_wait_dp": wait, "emit": emit},
            "dp_info": {"dp_kernel_event_s": kernel},
            "stage_s": {"codec_chunk_s": chunk,
                        "codec_longest_chunk_s": longest,
                        "codec_threads": threads, "codec+archive": codec}}


READINGS = {"dp_starved_s": 0.5, "engine_wait_dp_s": 2.0, "dp_host_s": 1.25,
            "emit_s": 0.75, "codec_pool_busy_pct": 37.5,
            "codec_longest_chunk_s": 3.0}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_metric_reader_on_a_synthetic_record(name):
    mod = _reader(name)
    assert mod.NAME == name
    rec = {"jobs": [_job(6.0, 0.25, 1.5, 0.5, 4.0, 24.0, 2.0, 8, 8.0),
                    _job(5.0, 0.75, 2.5, 1.0, 4.5, 12.0, 4.0, 8, 4.0)]}
    assert mod.read(rec) == pytest.approx(READINGS[name])
    # a program that records none of it (the parent commit): no reading
    bare = {"jobs": [{"pipe_split": {"dp": 6.0}, "dp_info": {},
                      "stage_s": {"codec+archive": 8.0}}]}
    assert mod.read(bare) is None
    assert mod.read({"jobs": []}) is None


def _hs1_job(bases, fired, resketch, retry_s, lone):
    """A job record with the high-error regime's counters."""
    stage = {"lone_bases": lone}
    if resketch is not None:
        stage["graph.resketch"] = resketch
    return {"bases": bases, "stage_s": stage,
            "pipe_split": {"resketch_fired": fired, "retry_dp_s": retry_s},
            "dp_info": {}}


HS1_READINGS = {"resketch_s": 1.5, "retry_dp_s": 0.75, "lone_base_pct": 25.0}


@pytest.mark.parametrize("name", sorted(HS1_READINGS))
def test_high_error_metric_reader_on_a_synthetic_record(name):
    mod = _reader(name)
    assert mod.NAME == name
    # a job whose first join was dense enough has no recovery span: 0 s
    rec = {"jobs": [_hs1_job(1000, 1, 3.0, 1.0, 300),
                    _hs1_job(1000, 0, None, 0.5, 200)]}
    assert mod.read(rec) == pytest.approx(HS1_READINGS[name])
    # a program without the counters (the parent commit): no reading
    bare = {"jobs": [{"bases": 1000, "pipe_split": {"sketch_join": 2.0},
                      "dp_info": {}, "stage_s": {"serialize": 0.5}}]}
    assert mod.read(bare) is None
    assert mod.read({"jobs": []}) is None
