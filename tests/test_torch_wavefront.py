"""Port end to end through the Python wavefront: the JAX package's
wavefront with its v1 Pallas kernel (``aligner="tpu"`` with the C++ engine
switched off, ``_kernel`` in interpret mode) and the port's wavefront
(``aligner="python"``, ``banded_dp32``'s plain version on the CPU) write
byte-equal archives; plus the round trip and the checks path. The same
route's worker fan-out, its failures and the polish parity are in
``test_torch_wavefront_runs.py`` (a file of its own, so that the two
spread over test workers)."""

import dataclasses

import pytest

import nanospring_tpu.ops.align_tpu as jat
import nanospring_tpu.pipeline.contigs as jax_contigs
from nanospring_tpu import compressor as jax_compressor
from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.utils import synth
from nanospring_tpu_torch import compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The dataset and the port's wavefront archive of it."""
    d = tmp_path_factory.mktemp("torch_wavefront")
    fq = str(d / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=50_000, num_reads=160,
                               mean_len=1_500, seed=3, p_n_base=0.001,
                               realistic=True)
    arc = str(d / "port.nstpu")
    res = compressor.compress_file(
        fq, arc, CompressConfig(aligner="python", device="cpu",
                                pipeline_workers=1), report=False)
    with open(arc, "rb") as f:
        return d, fq, reads, res, f.read()


def _decoded(arc, out):
    decompressor.decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        return f.read().split(b"\n")[:-1]


def test_archive_equals_jax_wavefront_v1(port_run, monkeypatch):
    d, fq, reads, tres, tbytes = port_run
    assert max(len(r) for r in reads) <= jat.M_PAD_MAX   # F's own shape
    monkeypatch.setenv("NSTPU_SKETCH", "native")
    # the JAX wavefront's route through F: no C++ engine, a chip "attached",
    # the kernel in interpret mode; count the pairs it is given
    monkeypatch.setattr(jax_contigs, "_grow_components_engine",
                        lambda *a, **kw: None)
    monkeypatch.setattr(jax_contigs, "_tpu_attached", lambda: True)
    align_padded = jat._align_padded
    monkeypatch.setattr(jat, "_align_padded", lambda *a, **kw: align_padded(
        *a, **{**kw, "interpret": True}))
    batch_tpu = jat.banded_align_batch_tpu
    sent = []

    def counted(*a, **kw):
        sent.append(len(a[5]))
        return batch_tpu(*a, **kw)

    monkeypatch.setattr(jat, "banded_align_batch_tpu", counted)
    jcfg = JaxConfig(aligner="tpu", pipeline_workers=1)
    jarc = str(d / "jax.nstpu")
    jax_compressor.compress_file(fq, jarc, jcfg, report=False)
    assert len(sent) > 0
    cfg = CompressConfig.from_reference(dataclasses.asdict(jcfg),
                                        aligner="python", device="cpu")
    assert cfg.aligner == "python" and cfg.pipeline_workers == 1
    info = tres["dp_info"]
    assert info["dp_backend"] == "python" and info["device"] == "cpu"
    assert info["dp_kernel_pairs"] == sum(sent)
    assert info["dp_kernel_launches"] == 0          # no CUDA kernel on cpu
    with open(jarc, "rb") as f:
        assert f.read() == tbytes


def test_round_trip_lossless(port_run):
    d, fq, reads, res, _ = port_run
    assert res["ratio"] > 2.0
    info = res["dp_info"]
    assert info["dp_kernel_rows"] >= info["dp_kernel_longest_rows"] > 0
    assert _decoded(str(d / "port.nstpu"), str(d / "port.reads")) == reads


def test_checks_path_matches_fast_path(port_run):
    """``checks=True`` replays every accepted member's edit script against
    its live consensus; it must write the same archive."""
    d, fq, _, _, tbytes = port_run
    arc = str(d / "checks.nstpu")
    compressor.compress_file(
        fq, arc, CompressConfig(aligner="python", device="cpu",
                                pipeline_workers=1, checks=True),
        report=False)
    with open(arc, "rb") as f:
        assert f.read() == tbytes
