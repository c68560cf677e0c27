"""The check that decides ``correct``, driven through whole runs of a tiny
cell on the CPU (the kernels' plain versions; the run's look for a card is
skipped): a sound run reads correct, the control reads not correct, and so
does a run with each fault planted underneath the timed path. The cells'
own sizes run on the card (``test_cells_on_the_card``).

    python -m pytest benchmark
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

import reference  # noqa: E402
import run  # noqa: E402

TINY = {
    "source": "test", "reduced": [], "assumed": {},
    "num_reads": 40, "mean_read_len": 1400,
    "genomes": [{"name": "g0", "length": 10000, "base_share": 0.75},
                {"name": "g1", "length": 8000, "base_share": 0.25}],
    "genome_model": {"p_hp": 0.12, "repeat_frac": 0.3,
                     "repeat_len": [2000, 20000],
                     "repeat_ident": [0.85, 0.98]},
    "reads": {"sigma": 0.5, "min_len": 50, "p_ins": 0.008, "p_del": 0.008,
              "p_sub": 0.009, "hp_bias": 4.0, "p_revcomp": 0.5},
    "shape_seed": 7,
    "compress": {"aligner": "device", "device": "cuda",
                 "pipeline_workers": 1, "num_threads": 2},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the benchmark and one more cell, ``tiny.device``,
    whose warm-up is a few reads."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, r / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (r / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    tr = json.loads((r / "benchmark" / "traffic" / "device.json").read_text())
    tr["warmup_reads"] = 2
    (r / "benchmark" / "traffic" / "device.json").write_text(json.dumps(tr))
    man = run.manifest()
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny.device", "config": "tiny",
                             "traffic": "device", "chips": 1, "why": "test"})
    for m in man["per_layer"]:
        m["workloads"].append("tiny.device")
    (r / "BENCHMARK.json").write_text(json.dumps(man))
    return str(r)


def _run(root, seed, trace=False, control=False) -> dict:
    err = io.StringIO()
    res = run.run_cell("tiny.device", seed, 0.1, trace, device="cpu",
                       root=root, gen_workers=1, err=err, control=control)
    return res, err.getvalue()


def _failed(res) -> list[str]:
    return [k for k, v in res["checks"].items() if v["value"] > v["limit"]]


def test_sound_run_is_correct_and_reports_its_metrics(root):
    res, log = _run(root, 2**31 + 12345)
    assert res["correct"], log
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"compress_mbase_per_s", "ratio",
                                   "peak_host_gb", "setup_s"}
    assert list(res)[-1] == "checks"
    assert "check compared" in log
    traced, log = _run(root, 77, trace=True)
    assert traced["correct"], log
    assert {"load_s", "grow_s", "dp_s", "codec_s"} <= set(traced["metrics"])
    # no device events on the CPU: no roofline share is reported
    assert "dp16_roofline" not in traced["metrics"]
    assert traced["breakdown"]["idle_gaps"]


def test_control_is_not_correct(root):
    res, _ = _run(root, 4242, control=True)
    assert not res["correct"]
    assert "wrong_sketch_rows" in _failed(res)


def _patch_hook_unchanged(mp, contigs):
    mp.setattr(contigs._DeviceDpHook, "_run", lambda self, n: None)


def _patch_dp(change):
    def patch(mp, contigs):
        at = contigs.at
        orig = at.banded_dp16

        def dp(d0, q_len, t_len, max_cost, tpad, queries, m_rows=None):
            return change(orig, d0, q_len, t_len, max_cost, tpad, queries,
                          m_rows)
        mp.setattr(at, "banded_dp16", dp)
    return patch


def _half(orig, d0, q_len, t_len, max_cost, tpad, queries, m_rows):
    """Half of the batch left out: the second half of the pairs never
    reaches the DP and comes back rejected."""
    h = max(1, len(d0) // 2)
    out = orig(d0[:h], q_len[:h], t_len[:h], max_cost[:h], tpad[:h],
               queries[:h], m_rows)
    cost, ln, ts, te, trace = (o.clone() for o in
                               orig(d0, q_len, t_len, max_cost, tpad,
                                    queries, m_rows))
    cost[:h], ln[:h], ts[:h], te[:h], trace[:h] = out
    cost[h:] = -1
    ts[h:] = 0
    te[h:] = 0
    return cost, ln, ts, te, trace


def _altered(orig, *args):
    """An answer altered where it is made: every accepted cost one more."""
    cost, ln, ts, te, trace = orig(*args)
    return cost + (cost >= 0).to(cost.dtype), ln, ts, te, trace


def _patch_sketch_altered(mp, contigs):
    sk = contigs.sk
    orig = sk.sketch_reads

    def sketch(*a, **kw):
        rows = orig(*a, **kw).clone()
        rows[:, 0] ^= 1
        return rows
    sketch.launches = 0
    mp.setattr(sk, "sketch_reads", sketch)


def _patch_read_altered(mp, contigs):
    """A base altered where the store is made: the archive then holds a
    read that is not the input's."""
    from nanospring_tpu_torch.io import read_store
    orig = read_store.load_fastq

    def load(*a, **kw):
        store = orig(*a, **kw)
        store.packed[0] ^= 1
        return store
    mp.setattr(read_store, "load_fastq", load)


def _patch_query_complemented(mp, contigs):
    """The hook's query bytes packed wrong (complemented, not reversed)
    before the kernel reads them: the kernel answers the wrong question
    consistently, so only the look at the inputs sees it."""
    orig = contigs._DeviceDpHook._run

    def _run(self, n_pairs):
        q = self.np["queries"]
        q[:n_pairs] = np.where(q[:n_pairs] < 4, 3 - q[:n_pairs],
                               q[:n_pairs])
        orig(self, n_pairs)
    mp.setattr(contigs._DeviceDpHook, "_run", _run)


FAULTS = {"dp_state_unchanged": _patch_hook_unchanged,
          "dp_query_packed_wrong": _patch_query_complemented,
          "dp_half_batch": _patch_dp(_half),
          "dp_answer_altered": _patch_dp(_altered),
          "sketch_answer_altered": _patch_sketch_altered,
          "read_altered": _patch_read_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(root, fault, monkeypatch):
    from nanospring_tpu_torch.pipeline import contigs

    FAULTS[fault](monkeypatch, contigs)
    res, log = _run(root, 9001)
    assert not res["correct"], log
    if fault == "dp_query_packed_wrong":
        assert "bad_dp_inputs" in _failed(res), res["checks"]


def test_jax_loaded_by_a_metric_reader_gives_no_result(root, tmp_path,
                                                       capsys):
    """The look for JAX comes after the metric readers: one that loads a
    JAX module (a stand-in entry here) leaves the run with no result."""
    r = tmp_path / "checkout"
    shutil.copytree(root, r)
    (r / "benchmark" / "metrics" / "loads_jax.py").write_text(
        'import sys\nimport types\n\nNAME = "loads_jax"\nUNIT = "s"\n'
        'LAYER = "entry"\nMOVES = "compress_mbase_per_s"\n\n\n'
        'def read(record):\n'
        '    sys.modules["jax"] = types.ModuleType("jax")\n'
        '    return 1.0\n')
    man = json.loads((r / "BENCHMARK.json").read_text())
    man["end_to_end"].append({"name": "loads_jax", "unit": "s",
                              "better": "lower", "bound": 0.25,
                              "source": "host_clock"})
    (r / "BENCHMARK.json").write_text(json.dumps(man))
    assert "jax" not in sys.modules
    try:
        rc = run.emit("tiny.device", 5, 0.1, False, device="cpu",
                      root=str(r), gen_workers=1, err=io.StringIO())
    finally:
        sys.modules.pop("jax", None)
    assert rc == 2
    assert capsys.readouterr().out == ""


def _tpad(t, d0, q_len):
    """A target window as the engine packs it: ``tpad[x] = t[x + d0 - 65]``
    on the target's columns, the pad byte elsewhere."""
    col = np.arange(q_len + reference.W) + d0 - 65
    inside = (col >= 0) & (col < len(t))
    out = np.full(len(col), reference.PAD, np.uint8)
    out[inside] = t[col[inside]]
    return out.tobytes()


def test_reference_dp_inputs_against_the_reads():
    rng = np.random.default_rng(5)
    reads = [bytes(reference.ASCII_OF[rng.integers(0, 4, n)])
             for n in (300, 500, 420)]
    codes = reference.BASE_CODE[np.frombuffer(reads[1], np.uint8)]
    t = rng.integers(0, 4, 200).astype(np.uint8)
    mid = codes[100:160]                 # a stretch inside a read
    rc = (3 - codes[::-1])[:80]          # the reverse strand, at an end
    pairs = [{"d0": d0, "q_len": len(q), "t_len": len(t),
              "tpad": _tpad(t, d0, len(q)), "query": q.tobytes()}
             for d0, q in ((80, mid), (3, rc))]
    assert reference.dp_input_faults(pairs, reads) == 0
    p = pairs[0]
    assert reference.dp_input_faults(
        [dict(p, query=(3 - mid).tobytes()), dict(p, t_len=len(t) - 1),
         dict(p, d0=p["d0"] + 1)], reads) == 3


def test_reference_dp_catches_one_flipped_trace_byte():
    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, 700).astype(np.uint8)
    q = np.delete(t, [100, 300])
    q[50] ^= 1
    tpad = np.concatenate([np.full(65, 9, np.uint8), t,
                           np.full(400, 9, np.uint8)])
    cost, ts, te, trace = reference.banded_dp16([0], [len(q)], [len(t)],
                                                [200], [tpad], [q])
    assert cost[0] == 3 and ts[0] == 0 and te[0] == len(t)
    pair = {"d0": 0, "q_len": len(q), "t_len": len(t), "max_cost": 200,
            "tpad": tpad.tobytes(), "query": q.tobytes(), "cost": 3,
            "ts": 0, "te": len(t), "trace": trace[0].tobytes()}
    assert reference.dp_mismatches([pair]) == 0
    bad = dict(pair, trace=bytes([trace[0][0] ^ 1]) + pair["trace"][1:])
    assert reference.dp_mismatches([bad]) == 1
    assert reference.dp_mismatches([pair], control=True) == 0


@pytest.mark.cuda
def test_cells_on_the_card():
    """Each cell at its own size, once sound and once as the control, on
    the card (a few minutes)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in run.manifest()["workloads"]:
        ok = run.run_cell(w["name"], 2**32 + 17, 1, False, err=io.StringIO())
        assert ok["correct"], ok["checks"]
        ctl = run.run_cell(w["name"], 2**32 + 17, 1, False,
                           err=io.StringIO(), control=True)
        assert not ctl["correct"], ctl["checks"]
