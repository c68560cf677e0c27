"""The Python wavefront on data with reads longer than 8,192 bases: the
reference's route rule. The JAX wavefront sends a frontier batch to its v1
Pallas kernel F only when the batch's longest query fits in ``M_PAD_MAX``
rows, and every longer batch to its host DP. The port keeps that split, so
its ``aligner="python"`` archive (``banded_dp32``'s plain version on the
CPU, the port's host DP for the long batches) equals the JAX
wavefront-through-F archive (engine off, F in interpret mode) byte for
byte, with the same pairs on each route. Plus the round trip, and the
engine hook's longest-query row counter."""

import dataclasses

import pytest

import nanospring_tpu.ops.align_tpu as jat
import nanospring_tpu.pipeline.contigs as jax_contigs
from nanospring_tpu import compressor as jax_compressor
from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.utils import synth
from nanospring_tpu_torch import compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.ops import align_tpu


@pytest.fixture(scope="module")
def long_run(tmp_path_factory):
    """A dataset with six reads over 8,192 bases (the longest 12,587), and
    the port's wavefront archive of it."""
    d = tmp_path_factory.mktemp("torch_wavefront_long")
    fq = str(d / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=20_000, num_reads=50,
                               mean_len=4_500, seed=14, p_n_base=0.001,
                               realistic=True)
    arc = str(d / "port.nstpu")
    res = compressor.compress_file(
        fq, arc, CompressConfig(aligner="python", device="cpu",
                                pipeline_workers=1), report=False)
    with open(arc, "rb") as f:
        return d, fq, reads, res, f.read()


def test_port_keeps_the_reference_route_constant():
    assert align_tpu.M_PAD_MAX == jat.M_PAD_MAX == 8192
    assert align_tpu.M_ROWS_MAX > align_tpu.M_PAD_MAX   # not a kernel cap


def test_archive_equals_jax_wavefront_with_long_reads(long_run, monkeypatch):
    d, fq, reads, tres, tbytes = long_run
    assert max(len(r) for r in reads) > jat.M_PAD_MAX
    monkeypatch.setenv("NSTPU_SKETCH", "native")
    monkeypatch.setattr(jax_contigs, "_grow_components_engine",
                        lambda *a, **kw: None)
    monkeypatch.setattr(jax_contigs, "_tpu_attached", lambda: True)
    align_padded = jat._align_padded
    monkeypatch.setattr(jat, "_align_padded", lambda *a, **kw: align_padded(
        *a, **{**kw, "interpret": True}))
    sent = {"kernel": 0, "host": 0}

    def counting(fn, route):
        def wrapped(*a, **kw):
            sent[route] += len(a[5])
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jat, "banded_align_batch_tpu",
                        counting(jat.banded_align_batch_tpu, "kernel"))
    monkeypatch.setattr(jax_contigs.al, "banded_align_batch",
                        counting(jax_contigs.al.banded_align_batch, "host"))
    jcfg = JaxConfig(aligner="tpu", pipeline_workers=1)
    jarc = str(d / "jax.nstpu")
    jax_compressor.compress_file(fq, jarc, jcfg, report=False)
    assert sent["kernel"] > 0 and sent["host"] > 0
    cfg = CompressConfig.from_reference(dataclasses.asdict(jcfg),
                                        aligner="python", device="cpu")
    assert cfg.band_width == jcfg.band_width
    info = tres["dp_info"]
    assert info["dp_kernel_pairs"] == sent["kernel"]
    assert info["host_routed_long_pairs"] == sent["host"]
    assert info["host_routed_long_rows"] > jat.M_PAD_MAX
    with open(jarc, "rb") as f:
        assert f.read() == tbytes


def test_long_reads_round_trip(long_run):
    d, fq, reads, res, _ = long_run
    info = res["dp_info"]
    assert info["dp_kernel_pairs"] > 0 and info["host_routed_long_pairs"] > 0
    out = str(d / "port.reads")
    decompressor.decompress_file(str(d / "port.nstpu"), out, report=False)
    with open(out, "rb") as f:
        assert f.read().split(b"\n")[:-1] == reads


def test_kernel_failure_still_raises_with_long_reads(long_run, monkeypatch):
    """The split is no fallback: a failing kernel on a short batch raises."""
    d, fq, _, _, _ = long_run

    def broken(*args, **kw):
        raise ValueError("DP kernel failed")

    broken.launches = 0
    monkeypatch.setattr(align_tpu, "banded_dp32", broken)
    with pytest.raises(ValueError, match="DP kernel failed"):
        compressor.compress_file(
            fq, str(d / "broken.nstpu"),
            CompressConfig(aligner="python", device="cpu",
                           pipeline_workers=1), report=False)


def test_hook_counts_longest_query_rows(tmp_path, monkeypatch):
    """The engine hook's ``dp_kernel_longest_rows`` is the sum over its
    batches of each batch's longest query."""
    fq = str(tmp_path / "in.fastq")
    synth.make_dataset(fq, genome_len=30_000, num_reads=80, mean_len=900,
                       seed=3, realistic=True)
    longest = []
    dp16 = align_tpu.banded_dp16

    def recording(*a, **kw):
        longest.append(int(a[1].max()))
        return dp16(*a, **kw)

    recording.launches = 0
    monkeypatch.setattr(align_tpu, "banded_dp16", recording)
    res = compressor.compress_file(
        fq, str(tmp_path / "o.nstpu"),
        CompressConfig(device="cpu", pipeline_workers=1), report=False)
    info = res["dp_info"]
    assert len(longest) == info["dp_hook_batches"] > 0
    assert info["dp_kernel_longest_rows"] == sum(longest) > 0
    assert info["dp_kernel_rows"] >= info["dp_kernel_longest_rows"]
