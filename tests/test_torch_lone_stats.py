"""The port's ``lone_stats`` against the JAX package's: the same report on
byte-equal archives, on a set whose lone reads anchor to diagonals more
than a band before a contig's start. There the reference's C++
``ns_banded_align`` writes past its row buffer, so its side runs the DP's
numpy oracle; the port's clamped C++ DP must give the oracle's answers on
such diagonals, in a process that exits cleanly."""

import ctypes
import functools
import os
import subprocess
import sys

import pytest
import torch

import nanospring_tpu.ops.align as jax_align
from nanospring_tpu import compressor as jax_compressor
from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.pipeline import lone_stats as jax_lone_stats
from nanospring_tpu.utils import synth
from nanospring_tpu_torch import cli, compressor
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.ops import minimizers as mz
from nanospring_tpu_torch.pipeline import lone_stats

REPO = __file__.rsplit("/tests/", 1)[0]


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
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_lone_stats")
    fq = str(d / "r.fastq")
    synth.make_dataset(fq, genome_len=60_000, num_reads=120, mean_len=2500,
                       seed=7, p_n_base=0.002, realistic=True)
    jarc, tarc = str(d / "j.nstpu"), str(d / "t.nstpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("NSTPU_SKETCH", "native")
    try:
        jax_compressor.compress_file(
            fq, jarc, JaxConfig(aligner="native", pipeline_workers=1,
                                num_threads=1),
            report=False)
    finally:
        mp.undo()
    compressor.compress_file(
        fq, tarc, CompressConfig(aligner="native", device="cpu",
                                 pipeline_workers=1, num_threads=1),
        report=False)
    return jarc, tarc


def test_report_equals_jax(archives, monkeypatch):
    jarc, tarc = archives
    with open(jarc, "rb") as f, open(tarc, "rb") as g:
        assert f.read() == g.read()
    d0s = []
    match = mz.match_anchors

    def recorded(*a, **kw):
        m = match(*a, **kw)
        if m is not None:
            d0s.append(m[1])
        return m

    monkeypatch.setattr(mz, "match_anchors", recorded)
    got = lone_stats.report(tarc)
    W = CompressConfig().band_width
    # the input reaches the fault: a row with no slot in the band
    assert min(d0s) < -(W + 1)
    monkeypatch.setattr(jax_align, "banded_align_batch", functools.partial(
        jax_align.banded_align_batch, use_native=False))
    want = jax_lone_stats.report(jarc)
    assert got == want
    assert got["anchored"] == len(d0s) and got["aligned"] > 0


CLAMP = r"""
import numpy as np
from nanospring_tpu_torch.ops import align as al

rng = np.random.default_rng(11)
W, n, m = 128, 900, 700
t = rng.integers(0, 4, n).astype(np.uint8)
q = t[100:100 + m].copy()
q[rng.integers(0, m, 30)] ^= 1
d0s = [-786, -235, -W - 2, -W - 1, -W, -W + 40, 0, 100, n - m,
       n + W - 40, n + W, n + W + 1, n + W + 2, n + 300, n + 5000]
P = len(d0s)
args = (np.tile(t, P), np.arange(P) * n, np.full(P, n),
        np.tile(q, P), np.arange(P) * m, np.full(P, m),
        np.array(d0s, np.int64), W, 500)
for _ in range(20):
    got = al.banded_align_batch(*args)
want = al.banded_align_batch(*args, use_native=False)
assert (got.cost >= 0).any() and (got.cost < 0).any(), got.cost
for p in range(P):
    assert got.cost[p] == want.cost[p], (d0s[p], got.cost[p], want.cost[p])
    if got.cost[p] < 0:
        continue
    # the two break ties otherwise, so a poor pair's script may differ;
    # each must still be an alignment of that cost over the whole query
    assert got.tend[p] == want.tend[p], d0s[p]
    for r in (got, want):
        ops = r.ops(p)
        assert len(ops) - ops.count(b"=") == r.cost[p], d0s[p]
        assert len(ops) - ops.count(b"d") == m, d0s[p]
        assert r.tend[p] - r.tstart[p] == len(ops) - ops.count(b"i")
    if got.cost[p] < 100:
        assert got.ops(p) == want.ops(p), d0s[p]
print("clamp ok")
"""


def test_banded_align_far_diagonals_match_numpy_oracle():
    """Diagonals far before the target's start and far past its end:
    rows with no valid slot write nothing out of bounds, and every pair's
    cost equals the numpy oracle's, with a script of that cost. A separate process, so
    that a corrupted heap shows as its exit code."""
    r = subprocess.run([sys.executable, "-c", CLAMP], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clamp ok" in r.stdout


def test_cli_lone_stats(archives, capsys):
    _, tarc = archives
    assert cli.main(["lone-stats", "-i", tarc]) == 0
    assert "lone-stats:" in capsys.readouterr().out
    with pytest.raises(SystemExit):         # -i is required
        cli.build_parser().parse_args(["lone-stats"])
