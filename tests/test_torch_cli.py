"""Port entry points on the CPU: the CLI round trip with ``--device cpu``,
and no silent fallback: ``cuda`` without a card raises, and a failing DP
hook makes ``compress_file`` raise instead of rerunning on the host."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanospring_tpu_torch import compressor
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.ops import align_tpu
from nanospring_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(17)
    genome = synth.random_genome(40_000, rng)
    reads = synth.make_reads(genome, 80, 2_500, rng)
    fq = str(d / "in.fastq")
    synth.write_fastq(fq, reads, gz=False)
    return d, fq, reads


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "nanospring_tpu_torch.cli",
                           *args], env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_round_trip_cpu(fastq):
    d, fq, reads = fastq
    arc, out = str(d / "c.nstpu"), str(d / "c.reads")
    r = _cli("-c", "-i", fq, "-o", arc, "--device", "cpu", "--workers", "1")
    assert r.returncode == 0, r.stderr
    r = _cli("-d", "-i", arc, "-o", out)
    assert r.returncode == 0, r.stderr
    with open(out, "rb") as f:
        assert f.read().split(b"\n")[:-1] == reads


def test_cuda_without_card_raises(fastq, monkeypatch):
    d, fq, _ = fastq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compressor.compress_file(fq, str(d / "x.nstpu"), CompressConfig(),
                                 report=False)
    if not torch.cuda.is_available():   # the CLI's own process: no card
        r = _cli("-c", "-i", fq, "-o", str(d / "y.nstpu"))
        assert r.returncode != 0 and "device='cpu'" in r.stderr


def test_failing_dp_hook_raises(fastq, monkeypatch):
    d, fq, _ = fastq

    def broken(*args, **kw):
        raise ValueError("DP kernel failed")

    monkeypatch.setattr(align_tpu, "banded_dp16", broken)
    with pytest.raises(RuntimeError, match="device DP hook failed") as ei:
        compressor.compress_file(
            fq, str(d / "z.nstpu"),
            CompressConfig(device="cpu", pipeline_workers=1), report=False)
    assert isinstance(ei.value.__cause__, ValueError)


def test_unknown_aligner_or_device_raises():
    with pytest.raises(ValueError):
        CompressConfig(aligner="tpu")        # the JAX package's name
    with pytest.raises(ValueError):
        CompressConfig(device="tpu")


def test_checks_path_matches_fast_path(fastq):
    """``checks=True`` takes the engine's full fetch, replays every member's
    edit script against its consensus and emits through ``_emit_group``;
    it must write the same archive as the sliced fast path."""
    d, fq, reads = fastq
    arcs = []
    for checks in (False, True):
        arc = str(d / f"checks{int(checks)}.nstpu")
        compressor.compress_file(
            fq, arc, CompressConfig(device="cpu", pipeline_workers=1,
                                    checks=checks), report=False)
        with open(arc, "rb") as f:
            arcs.append(f.read())
    assert arcs[0] == arcs[1]
