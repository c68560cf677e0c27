"""CPU tests of the benchmark's harness: finding cells, configurations,
traffic and metrics by name; the manifest's form; the import check; the
generator's shapes; the roofline arithmetic; the trace's reduction.

    python -m pytest benchmark
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import devtrace  # noqa: E402
import gen  # noqa: E402
import roofline  # noqa: E402
import run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = run.manifest()


def test_every_cell_finds_its_config_traffic_and_metrics():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        found = run.find_cell(MAN, w["name"])
        assert found["config"]["compress"]["aligner"] == "device"
        assert found["config"]["compress"]["pipeline_workers"] == 1
        assert found["traffic"]["entry"].endswith(".compress_file")
        names = [m["name"] for m in found["end_to_end"] + found["per_layer"]]
        assert "setup_s" in names and len(found["per_layer"]) >= 1
        assert len(e2e & set(names)) >= 2
        for m in found["per_layer"]:
            assert m["moves"] in names
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        mod = run.load_metric(m["name"])
        assert mod.NAME == m["name"] and mod.UNIT == m["unit"]
        if "layer" in m:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
    assert sorted(m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]) \
        == run.list_metrics()


def test_unknown_cell_is_refused():
    with pytest.raises(run.Refused):
        run.find_cell(MAN, "nosuch.device")


def test_manifest_keeps_the_contract_form():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert "assumed" in cfg
        names.add(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_a_metric_dropped_into_a_copy_is_listed_and_read(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    (tmp_path / "benchmark" / "metrics" / "jobs_in_window.py").write_text(
        'NAME = "jobs_in_window"\nUNIT = "jobs"\nLAYER = "entry"\n'
        'MOVES = "compress_mbase_per_s"\n\n\n'
        'def read(record):\n    return len(record["jobs"]) or None\n')
    root = str(tmp_path)
    assert "jobs_in_window" in run.list_metrics(root)
    assert "jobs_in_window" not in run.list_metrics()
    mod = run.load_metric("jobs_in_window", root)
    assert mod.read({"jobs": [{}, {}]}) == 2
    assert mod.read({"jobs": []}) is None


def test_import_check_compares_whole_top_level_names():
    assert run.forbidden_loaded(["nanospring_tpu_torch",
                                 "nanospring_tpu_torch.ops.sketch",
                                 "numpy", "jax_like", "flaxen"]) == []
    assert run.forbidden_loaded(["nanospring_tpu.ops", "jaxlib.xla_client",
                                 "jax", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "nanospring_tpu"]


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_and_the_reference_none_of_the_port():
    files = [os.path.join(d, f) for d, _, fs in os.walk(HERE) for f in fs
             if f.endswith(".py")]
    for path in files:
        assert not _imports(path) & set(run.FORBIDDEN), path
    for name in ("reference.py", "roofline.py", "gen.py", "devtrace.py"):
        assert "nanospring_tpu_torch" not in _imports(os.path.join(HERE,
                                                                   name))


def _small(name: str, reads: int) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["num_reads"] = reads
    return cfg


def test_generator_zymo_shares_and_lengths():
    cfg = _small("zymo", 3000)
    genomes, gidx, lens = gen.read_plan(cfg)
    assert len(lens) == 3000
    share = np.bincount(gidx, weights=lens, minlength=10) / lens.sum()
    want = np.array([g["base_share"] for g in cfg["genomes"]])
    # L. fermentum's reads are cut at its 19,050-base genome
    assert np.allclose(share, want, atol=0.02)
    assert [len(g) for g in genomes] == [g["length"] for g in cfg["genomes"]]
    assert abs(lens.mean() / cfg["mean_read_len"] - 1) < 0.08


def test_generator_is_seeded_and_keeps_the_work(tmp_path):
    cfg = _small("sa", 60)
    a, b, c = (tmp_path / x for x in "abc")
    for d, seed, w in ((a, 2**32 + 5, 1), (b, 2**32 + 5, 2), (c, 9, 1)):
        d.mkdir()
        gen.write_run(cfg, seed, str(d), warmup_reads=4, workers=w)
    ra, rb, rc = ((d / "reads.fastq").read_bytes() for d in (a, b, c))
    assert ra == rb and ra != rc
    ia, ic = (json.loads((d / "reads.json").read_text()) for d in (a, c))
    # another seed: the same reads in the same order, other names
    assert ia == ic and ia["num_reads"] == 60
    assert ra.split(b"\n")[1::4] == rc.split(b"\n")[1::4]
    assert ra.split(b"\n")[0::4] != rc.split(b"\n")[0::4]
    lines = ra.split(b"\n")
    seqs = lines[1::4][:60]
    assert [len(s) for s in seqs] == ia["lengths"]
    assert set(b"".join(seqs)) <= set(b"ACGT")
    assert all(len(x) == 17 and x[:1] == b"@" for x in lines[0::4][:60])
    warm = (a / "warmup.fastq").read_bytes().split(b"\n")[1::4]
    assert warm[:4] == seqs[:4]
    assert max(len(s) for s in warm) == ia["longest"]
    assert len(seqs[ia["longest_id"]]) == ia["longest"]


def test_generator_error_rate():
    cfg = _small("sa", 200)
    plan = gen.Plan(cfg)
    bases, lens = plan.chunk(0)
    err = abs(int(lens.sum()) - int(plan.lens[:len(lens)].sum()))
    # insertions and deletions balance to about 1.6% of the bases each
    assert err < 0.005 * lens.sum()


def test_sketch_bound_matches_the_recorded_headline():
    # the headline set: 59,759,697 k-mers, 60 seeds -> 0.4287 ms of
    # multiplies at 16.73 T op/s (PERF.md, kernel table)
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    b = roofline.sketch_bound_s(59_759_697, 12_000, 60_023_697, 60, peaks)
    assert abs(b * 1e3 - 0.4287) < 5e-4
    assert roofline.kmers(np.array([10, 23, 24, 100]), 23, 32) == 0 + 0 + 0 + 78


def test_dp16_bound_and_the_readers():
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    rows, pairs = 299_353_553, 14_205
    b = roofline.dp16_bound_s(rows, pairs, peaks)
    assert abs(b - rows * 1024 / peaks["int32_ops_per_s"]) < 1e-12
    rec = {"jobs": [{"dp_info": {"dp_kernel_rows": rows,
                                 "dp_kernel_pairs": pairs},
                     "sketch_calls": [{"k": 23, "min_len": 32,
                                       "num_hashes": 60}]}],
           "device_s": {"(anonymous namespace)::banded_dp16_kernel(int)":
                        2 * b,
                        "void sketch_kernel<2>(unsigned char const*)": 1.0},
           "lengths": np.array([1000, 2000]), "peaks": peaks}
    assert abs(run.load_metric("dp16_roofline").read(rec) - 50.0) < 1e-9
    sk = run.load_metric("sketch_roofline").read(rec)
    assert abs(sk - 100 * roofline.sketch_bound_s(2956, 2, 3000, 60, peaks)) \
        < 1e-9
    # no device time: a share of a roofline is left out, never 0
    rec["device_s"] = {}
    assert run.load_metric("dp16_roofline").read(rec) is None
    assert run.load_metric("sketch_roofline").read(rec) is None


def test_trace_summary_busy_and_idle_by_span(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
           "ts": 1000.0, "dur": 10_000.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 2000.0,
           "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 2500.0,
           "dur": 1000.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 8000.0,
           "dur": 500.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1500.0,
           "dur": 100.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    # host spans on another clock (offset 5 s): the window, a job, a stage
    spans = [(5.0, 5.010, devtrace.WINDOW), (5.0, 5.009, "bench.job"),
             (5.004, 5.006, "stage.pipeline")]
    s = devtrace.summary(str(path), spans)
    assert abs(s["window_s"] - 0.010) < 1e-9
    assert abs(s["busy_s"] - 0.002) < 1e-9
    assert abs(s["device_s"]["k1"] - 0.002) < 1e-9
    idle = s["idle_s"]
    assert abs(sum(idle.values()) - 0.008) < 1e-9
    assert abs(idle["stage.pipeline"] - 0.002) < 1e-9
    assert abs(idle["no_span"] - 0.001) < 1e-9
    assert abs(idle["bench.job"] - 0.005) < 1e-9
