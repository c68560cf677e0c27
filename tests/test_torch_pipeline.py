"""Port end to end on the CPU: with the native DP pinned, the PyTorch
port writes the same archive bytes as the JAX package, and each package's
decompressor decodes the other's archive; with ``aligner="device"`` the
engine's batch DP runs through the port's hook (the DP's plain version on
the CPU) and stays lossless."""

import dataclasses

import pytest

from nanospring_tpu import compressor as jax_compressor
from nanospring_tpu import decompressor as jax_decompressor
from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.utils import synth
from nanospring_tpu_torch import compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    fq = str(d / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=60_000, num_reads=120,
                               mean_len=2_000, seed=5, p_n_base=0.001,
                               realistic=True)
    return d, fq, reads


def _decoded(decompress, arc, out):
    decompress(arc, out, report=False)
    with open(out, "rb") as f:
        return f.read().split(b"\n")[:-1]


def test_archive_bytes_equal_jax_native(dataset, monkeypatch):
    d, fq, reads = dataset
    monkeypatch.setenv("NSTPU_SKETCH", "native")
    jcfg = JaxConfig(aligner="native", pipeline_workers=1)
    jarc, tarc = str(d / "jax.nstpu"), str(d / "torch.nstpu")
    jres = jax_compressor.compress_file(fq, jarc, jcfg, report=False)
    cfg = CompressConfig.from_reference(dataclasses.asdict(jcfg),
                                        device="cpu")
    assert cfg.aligner == "native" and cfg.pipeline_workers == 1
    tres = compressor.compress_file(fq, tarc, cfg, report=False)
    with open(jarc, "rb") as f1, open(tarc, "rb") as f2:
        assert f1.read() == f2.read()
    assert tres["ratio"] == jres["ratio"] and tres["ratio"] > 2.0
    assert tres["dp_info"]["dp_backend"] == "native"
    # each package decodes the other's archive
    assert _decoded(decompressor.decompress_file, jarc,
                    str(d / "a.reads")) == reads
    assert _decoded(jax_decompressor.decompress_file, tarc,
                    str(d / "b.reads")) == reads


def test_device_aligner_on_cpu_lossless(dataset):
    d, fq, reads = dataset
    arc = str(d / "dev.nstpu")
    res = compressor.compress_file(
        fq, arc, CompressConfig(device="cpu", pipeline_workers=1),
        report=False)
    info = res["dp_info"]
    assert info["dp_backend"] == "device" and info["device"] == "cpu"
    assert info["dp_hook_batches"] > 0 and info["dp_kernel_pairs"] > 0
    assert info["dp_kernel_launches"] == 0          # no CUDA kernel on cpu
    assert info["host_routed_long_pairs"] == 0
    assert res["ratio"] > 2.0
    assert _decoded(decompressor.decompress_file, arc,
                    str(d / "dev.reads")) == reads


def test_device_aligner_two_workers_lossless(dataset):
    """Grow workers are spawned from the port's own module and each runs
    the hook; their counters sum into dp_info."""
    d, fq, reads = dataset
    arc = str(d / "dev2.nstpu")
    res = compressor.compress_file(
        fq, arc, CompressConfig(device="cpu", pipeline_workers=2),
        report=False)
    assert res["dp_info"]["dp_hook_batches"] > 0
    assert _decoded(decompressor.decompress_file, arc,
                    str(d / "dev2.reads")) == reads


def test_from_reference_maps_aligners():
    # the reference's default "auto" keeps its name (the engine's probe,
    # here between the card's DP and the engine's own); its "python"
    # wavefront keeps its name (its DP is banded_dp32 here)
    for ref, port in (("tpu", "device"), ("auto", "auto"),
                      ("native", "native"), ("python", "python")):
        cfg = CompressConfig.from_reference(
            dataclasses.asdict(JaxConfig(aligner=ref)))
        assert cfg.aligner == port and cfg.device == "cuda"
    with pytest.raises(ValueError):
        CompressConfig.from_reference(
            dataclasses.asdict(JaxConfig(aligner="python", band_width=200)))
    port = {f.name for f in dataclasses.fields(CompressConfig)}
    ref = {f.name for f in dataclasses.fields(JaxConfig)}
    assert port - ref == {"device"}
    # padding buckets and the window step have no counterpart in the port
    assert ref - port == {"max_read_len_bucket", "window_step_frac"}
