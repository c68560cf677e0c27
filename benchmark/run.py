"""Run one cell of the benchmark once and print its result as one JSON line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is ``<config>.<traffic>`` as ``BENCHMARK.json`` lists it; the
configuration's file, the traffic's ``traffic/<traffic>.json`` and each
metric's ``metrics/<name>.py`` are found by name, so a new cell, traffic
mix or metric is new files and manifest entries.

One run: the reads are generated from the seed in a child process (the
harness's copy of the data never sets this process's memory high-water
mark) while the port and torch load; a warm-up job on a slice of the reads
that holds the longest one builds and loads every kernel at the cell's row
capacity; then whole-file compress jobs run back to back through the
traffic's entry while the elapsed time is under ``--seconds``. After the
window the archives are restored and the sketch rows and the device DP
outputs that the window's jobs produced are judged against the plain
reference (``reference.py``) on a sample drawn from the seed. With
``--trace 1`` the window runs under ``torch.profiler`` and the per-layer
metrics are reported; with ``--trace 0`` the end-to-end ones.

The configuration's ``env`` (thread counts) is set in this process's
environment before torch and the port load.

The run exits nonzero and prints no result where there is no card (or
fewer than the cell asks for), where the port cannot be imported, or where
JAX or the JAX package is loaded in this process once the window closes:
that look is the run's last step, after the check and the metric readers.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import importlib
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import reference  # noqa: E402
import roofline  # noqa: E402
import devtrace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nanospring_tpu")
KB = 1024


class Refused(Exception):
    """A run that prints no result (exit code 2)."""


def process_age_s() -> float:
    """Seconds since this process started (its start time from
    ``/proc/self/stat``, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def rss_peak_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * KB / 1e9


def forbidden_loaded(modules) -> list[str]:
    """Top-level names of ``modules`` that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


# --- finding things by name ----------------------------------------------

def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def bench_dir(root: str = ROOT) -> str:
    """The benchmark's folder in the checkout at ``root``."""
    return os.path.join(root, os.path.basename(HERE))


def find_cell(man: dict, name: str, root: str = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic loaded, and the
    manifest's metrics that it reports."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir(root), "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])

    return {"cell": cell, "config": config, "root": root, "config_file":
            os.path.join(root, cfg_entry["file"]), "traffic": traffic,
            "end_to_end": [m for m in man["end_to_end"] if mine(m)],
            "per_layer": [m for m in man["per_layer"] if mine(m)]}


def load_metric(name: str, root: str = ROOT):
    """The reader in ``metrics/<name>.py``."""
    path = os.path.join(bench_dir(root), "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def list_metrics(root: str = ROOT) -> list[str]:
    """The names of the metric readers in ``metrics/``."""
    d = os.path.join(bench_dir(root), "metrics")
    return sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py"))


def resolve(dotted: str):
    mod, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


# --- what the window's jobs produced, kept for the check -----------------

class Capture:
    """Wraps the port's sketch pass and its device DP hook at run time to
    keep, for the check, the sketch rows of a sample of reads from the
    window's first job and a sample of the DP pairs of every window job,
    drawn from the seed (reservoir sampling over the pairs), plus the
    longest pair. Copies are of the sampled rows and pairs only."""

    def __init__(self, contigs, rng: np.random.Generator, sketch_ids,
                 dp_sample: int):
        self.contigs = contigs
        self.rng = rng
        self.sketch_ids = np.asarray(sketch_ids, np.int64)
        self.dp_sample = dp_sample
        self.sketch = None
        self.pairs: list[dict] = []
        self.longest: dict | None = None
        self.seen = 0
        self.calls: list[dict] = []     # sketch passes of the current job
        self._orig = {}

    def install(self) -> None:
        c = self.contigs
        self._orig = {"sketch": c.compute_all_sketches,
                      "run": c._DeviceDpHook._run}
        orig_sketch, orig_run = self._orig["sketch"], self._orig["run"]
        cap = self

        def compute_all_sketches(store, cfg, report=False):
            rows = orig_sketch(store, cfg, report)
            min_len = max(cfg.kmer_size, cfg.min_read_len_for_sketch)
            cap.calls.append({"k": cfg.kmer_size, "min_len": min_len,
                              "num_hashes": cfg.num_hashes})
            if cap.sketch is None:
                cap.sketch = {"k": cfg.kmer_size, "min_len": min_len,
                              "num_hashes": cfg.num_hashes,
                              "seed": cfg.sketch_seed,
                              "rows": np.array(rows[cap.sketch_ids])}
            return rows

        def _run(hook, n_pairs):
            orig_run(hook, n_pairs)
            cap._keep(hook.np, int(n_pairs))

        c.compute_all_sketches = compute_all_sketches
        c._DeviceDpHook._run = _run

    def uninstall(self) -> None:
        if self._orig:
            self.contigs.compute_all_sketches = self._orig["sketch"]
            self.contigs._DeviceDpHook._run = self._orig["run"]
            self._orig = {}

    @staticmethod
    def _pair(h: dict, p: int) -> dict:
        q = int(h["q_len"][p])
        return {"d0": int(h["d0"][p]), "q_len": q, "t_len": int(h["t_len"][p]),
                "max_cost": int(h["max_cost"][p]),
                "tpad": h["tpad"][p, :q + reference.W].tobytes(),
                "query": h["queries"][p, :q].tobytes(),
                "cost": int(h["cost"][p]), "ts": int(h["ts"][p]),
                "te": int(h["te"][p]), "trace": h["trace"][p, :q].tobytes()}

    def _keep(self, h: dict, n_pairs: int) -> None:
        q_len = h["q_len"][:n_pairs]
        P = int(np.count_nonzero(q_len))
        if P == 0:
            return
        top = int(np.argmax(q_len[:P]))
        if self.longest is None or q_len[top] > self.longest["q_len"]:
            self.longest = self._pair(h, top)
        idx = self.seen + 1 + np.arange(P)
        self.seen += P
        K = self.dp_sample
        keep = np.flatnonzero(self.rng.random(P) * idx < K)
        for p in keep.tolist():
            if len(self.pairs) < K:
                self.pairs.append(self._pair(h, p))
            else:
                self.pairs[int(self.rng.integers(K))] = self._pair(h, p)


class SpanLog:
    """Host spans timed here by ``perf_counter``, on any thread: the
    profiler records ranges only on the thread that started it, and the
    engine calls the device DP hook from its own C++ thread."""

    def __init__(self):
        self.spans: list[tuple[float, float, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((t, time.perf_counter(), name))


@contextlib.contextmanager
def spans(log: SpanLog, contigs, observe):
    """Spans around the port's stages (``stage.<name>``), its candidate
    graph (``pipe.graph``), sketch pass (``pipe.sketch``), grow engine
    (``pipe.grow``) and each device DP batch (``dp.batch``), set at run
    time from here; the program's files are not changed."""
    c = contigs
    orig = {"stage": observe.StageTimer.stage,
            "graph": c._build_candidate_graph,
            "sketch": c.compute_all_sketches,
            "grow": c._grow_components_engine, "run": c._DeviceDpHook._run}

    @contextlib.contextmanager
    def stage(self, name):
        with log.span("stage." + name), orig["stage"](self, name):
            yield

    def wrap(fn, label):
        def inner(*a, **kw):
            with log.span(label):
                return fn(*a, **kw)
        return inner

    observe.StageTimer.stage = stage
    c._build_candidate_graph = wrap(orig["graph"], "pipe.graph")
    c.compute_all_sketches = wrap(orig["sketch"], "pipe.sketch")
    c._grow_components_engine = wrap(orig["grow"], "pipe.grow")
    c._DeviceDpHook._run = wrap(orig["run"], "dp.batch")
    try:
        yield
    finally:
        observe.StageTimer.stage = orig["stage"]
        c._build_candidate_graph = orig["graph"]
        c.compute_all_sketches = orig["sketch"]
        c._grow_components_engine = orig["grow"]
        c._DeviceDpHook._run = orig["run"]


def device_peak_tracker(torch):
    """``torch.cuda.max_memory_allocated`` over the whole run: the device
    DP hook resets the peak when it is made, so the peak before each reset
    is kept here. Returns (read, restore)."""
    seen = [0]
    orig = torch.cuda.reset_peak_memory_stats

    def reset(device=None):
        seen[0] = max(seen[0], torch.cuda.max_memory_allocated(device))
        orig(device)

    torch.cuda.reset_peak_memory_stats = reset

    def read():
        return max(seen[0], torch.cuda.max_memory_allocated(0))

    def restore():
        torch.cuda.reset_peak_memory_stats = orig

    return read, restore


# --- one run ---------------------------------------------------------------

def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, gen_workers: int = 4,
             err=sys.stderr, control: bool = False) -> dict:
    """Run cell ``name`` once; returns the result object. ``device="cpu"``
    runs the kernels' plain versions, for the tests on a host with no card;
    ``main`` runs only on ``cuda``. ``control`` judges the control's
    outputs (``reference``: the reference one precision down) in the
    program's place (``control.py``)."""
    found = find_cell(manifest(root), name, root)
    config, traffic = found["config"], found["traffic"]
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})
    work = tempfile.mkdtemp(prefix="bench_")
    gen = None
    try:
        gen = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "gen.py"), "--config",
             found["config_file"], "--seed", str(seed), "--out", work,
             "--warmup-reads", str(traffic["warmup_reads"]),
             "--workers", str(gen_workers)])
        return _run(found, seed, seconds, trace, device, work, gen, err,
                    control)
    finally:
        if gen is not None and gen.poll() is None:
            gen.kill()
        if gen is not None:
            gen.wait()
        shutil.rmtree(work, ignore_errors=True)


def _run(found, seed, seconds, trace, device, work, gen, err,
         control) -> dict:
    def say(msg):
        print(f"[bench] {msg}", file=err, flush=True)

    cell, config, traffic = found["cell"], found["config"], found["traffic"]
    t_import = process_age_s()
    try:
        import torch

        from nanospring_tpu_torch.config import CompressConfig
        from nanospring_tpu_torch.pipeline import contigs
        from nanospring_tpu_torch.utils import observe
        entry = resolve(traffic["entry"])
    except ImportError as e:
        raise Refused(f"the port cannot be imported: {e}") from e
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{torch.cuda.device_count()} cards, the cell asks "
                          f"for {cell['chips']}")
        torch.zeros(1, device="cuda")
    rss_import = rss_peak_gb()
    t_data = process_age_s()
    say(f"setup: import and CUDA context {t_data - t_import:.3f} s, rss "
        f"{rss_import:.3f} GB")
    if gen.wait() != 0:
        raise RuntimeError(f"the generator failed ({gen.returncode})")
    with open(os.path.join(work, "reads.json")) as f:
        reads_info = json.load(f)
    t_warm = process_age_s()
    say(f"setup: data {t_warm - t_data:.3f} s waited: "
        + ", ".join(f"{k} {v}" for k, v in reads_info.items()
                    if k != "lengths"))

    settings = dict(config["compress"])
    settings["device"] = device
    cfg = CompressConfig(**settings)
    fastq = os.path.join(work, "reads.fastq")
    log = SpanLog()
    with log.span("bench.warmup"):
        entry(os.path.join(work, "warmup.fastq"),
              os.path.join(work, "warmup.nstpu"), cfg, report=False)
    if device == "cuda":
        torch.cuda.synchronize()
    say(f"setup: warm-up {process_age_s() - t_warm:.3f} s "
        f"({reads_info['warmup_reads']} reads, longest "
        f"{reads_info['longest']})")

    chk = traffic["check"]
    rng = np.random.default_rng([seed, 1])
    n_reads = reads_info["num_reads"]
    sketch_ids = np.unique(np.concatenate([
        rng.choice(n_reads, min(n_reads, chk["sketch_sample_reads"]),
                   replace=False), [reads_info["longest_id"]]]))
    cap = Capture(contigs, rng, sketch_ids, chk["dp_sample_pairs"])
    peak_read, peak_restore = (device_peak_tracker(torch)
                               if device == "cuda" else (lambda: 0,
                                                         lambda: None))
    prof = None
    stack = contextlib.ExitStack()
    jobs, failed, attempted = [], 0, 0
    bases = int(reads_info["bases"])
    try:
        cap.install()
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(
                torch.profiler.profile(activities=acts))
            stack.enter_context(spans(log, contigs, observe))
        setup_s = process_age_s()
        w0 = time.perf_counter()
        with torch.profiler.record_function(tr.WINDOW), log.span(tr.WINDOW):
            while time.perf_counter() - w0 < seconds:
                attempted += 1
                out = os.path.join(work, f"job{attempted}.nstpu")
                cap.calls = []
                t = time.perf_counter()
                try:
                    with log.span("bench.job"):
                        res = entry(fastq, out, cfg, report=False)
                except Exception as e:  # noqa: BLE001 - a job that fails
                    failed += 1
                    say(f"job {attempted} failed: {e!r}")
                    break
                dt = time.perf_counter() - t
                jobs.append({"bases": bases, "archive": out,
                             "archive_bytes": os.path.getsize(out),
                             "wall_s": dt, "stage_s": dict(res["stage_s"]),
                             "pipe_split": dict(res["pipe_split"]),
                             "dp_info": dict(res["dp_info"]),
                             "sketch_calls": list(cap.calls)})
            if device == "cuda":
                torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
        peak_host = rss_peak_gb()
        mem_peak = peak_read()
    finally:
        stack.close()
        cap.uninstall()
        peak_restore()
    for j, job in enumerate(jobs, 1):
        say(f"job {j}: {job['wall_s']:.3f} s; stages "
            + " ".join(f"{k} {v:.3f}" for k, v in job["stage_s"].items())
            + "; engine " + " ".join(
                f"{k} {job['pipe_split'].get(k, 0)}" for k in
                ("sketch_join", "components", "screen", "place", "dp",
                 "apply", "polish", "engine_wall", "dp_pairs", "dp_rejects"))
            + f"; dp kernel launches {job['dp_info'].get('dp_kernel_launches')}"
            f" rows {job['dp_info'].get('dp_kernel_rows')}")
    say(f"window: {len(jobs)} jobs in {window_s:.3f} s")

    trace_path = os.path.join(work, "trace.json")
    if prof is not None:
        prof.export_chrome_trace(trace_path)
        del prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    with log.span("bench.check"):
        checks = judge(work, jobs, cap, failed, config, control, err)
    say(f"check: {log.spans[-1][1] - log.spans[-1][0]:.3f} s")

    lengths = np.array(reads_info["lengths"], np.int64)
    record = {"jobs": jobs, "window_s": window_s, "setup_s": setup_s,
              "peak_host_gb": peak_host, "rss_at_import_gb": rss_import,
              "lengths": lengths, "device_s": {}, "peaks": None}
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": int(cell["chips"]) if device == "cuda" else 0,
                "memory_peak_bytes": int(mem_peak)}
    record["peaks"] = roofline.PEAKS.get(dev_info["kind"])
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in checks.values()),
              "attempted": attempted, "failed": failed}
    breakdown = None
    if trace:
        summ = (tr.summary(trace_path, log.spans)
                if os.path.exists(trace_path) else {})
        record["device_s"] = summ.get("device_s", {})
        dev_info["busy_s"] = summ.get("busy_s", 0.0)
        dev_info["window_s"] = summ.get("window_s", window_s)
        breakdown = {"device_ops": tr.top(summ.get("device_s", {})),
                     "idle_gaps": tr.top(summ.get("idle_s", {}))}
        wanted = found["per_layer"]
    else:
        wanted = found["end_to_end"]
    metrics = {}
    for m in wanted:
        v = load_metric(m["name"], found["root"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    found_bad = forbidden_loaded(sys.modules)
    if found_bad:
        raise Refused(f"loaded in the run's process: {found_bad}")
    for k, v in checks.items():
        print(f"[bench] check {k} = {v['value']} (limit {v['limit']})",
              file=err, flush=True)
    return result


def judge(work: str, jobs: list, cap: Capture, failed: int, config: dict,
          control: bool = False, err=sys.stderr) -> dict:
    """The numbers that decide ``correct``, each with its limit: every
    distinct archive of the window restored and compared read by read with
    the generated reads; the sampled sketch rows and device DP pairs
    against the reference; the sampled pairs' inputs against the generated
    reads (each query a stretch of a read or of its reverse complement,
    each target window padded where ``d0`` and ``t_len`` put it outside
    the target); a failed job; nothing sampled where the configuration
    runs the device DP. With ``control`` the sketch rows and the DP
    outputs judged are the control's, worked out from the same inputs."""
    from nanospring_tpu_torch.decompressor import decompress_file

    reads = reference.fastq_reads(os.path.join(work, "reads.fastq"))
    wrong_reads = 0
    seen = set()
    for j in jobs:
        with open(j["archive"], "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest in seen:
            continue
        seen.add(digest)
        out = j["archive"] + ".reads"
        try:
            decompress_file(j["archive"], out, report=False)
            wrong_reads += reference.restored_mismatches(out, reads)
        except Exception as e:  # noqa: BLE001 - an archive that fails
            print(f"[bench] restore failed: {e!r}", file=err)
            wrong_reads += len(reads)
        finally:
            if os.path.exists(out):
                os.unlink(out)
    sk = cap.sketch
    wrong_rows = 0
    if sk is not None:
        seeds = reference.sketch_seeds(sk["num_hashes"], sk["seed"])
        for i, row in zip(cap.sketch_ids.tolist(), sk["rows"]):
            ref = reference.sketch_read(reads[i], sk["k"], seeds,
                                        sk["min_len"])
            if control:
                row = reference.control_sketch_read(reads[i], sk["k"], seeds,
                                                    sk["min_len"])
            wrong_rows += not np.array_equal(ref, row.view(np.uint32))
    pairs = list(cap.pairs)
    if cap.longest is not None:
        pairs.append(cap.longest)
    wrong_pairs = (reference.dp_mismatches(pairs, control=control) if pairs
                   else 0)
    bad_inputs = reference.dp_input_faults(pairs, reads) if pairs else 0
    device_dp = config["compress"].get("aligner") == "device"
    print(f"[bench] check compared: {len(seen)} distinct archives of "
          f"{len(jobs)} jobs, {len(reads)} reads each; "
          f"{0 if sk is None else len(sk['rows'])} sketch rows; "
          f"{len(pairs)} DP pairs, {sum(p['q_len'] for p in pairs)} rows, "
          f"longest {max((p['q_len'] for p in pairs), default=0)}",
          file=err, flush=True)
    return {"failed_jobs": {"value": failed, "limit": 0},
            "wrong_reads": {"value": wrong_reads, "limit": 0},
            "wrong_sketch_rows": {"value": wrong_rows, "limit": 0},
            "sketch_unchecked": {"value": int(sk is None), "limit": 0},
            "wrong_dp_pairs": {"value": wrong_pairs, "limit": 0},
            "bad_dp_inputs": {"value": bad_inputs, "limit": 0},
            "dp_unchecked": {"value": int(device_dp and not pairs),
                             "limit": 0}}


def emit(*args, **kw) -> int:
    """``run_cell(*args, **kw)`` with its result printed as the last line
    of standard output; a refused run prints no result and returns 2."""
    os.environ.setdefault("USE_FLAX", "0")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        res = run_cell(*args, **kw)
    except Refused as e:
        print(f"[bench] no result: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return emit(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
