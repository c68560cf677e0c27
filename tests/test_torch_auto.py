"""``aligner="auto"``: the engine's probe mode (mode 2) from the port's
side. With no card it runs the engine's own DP, as the JAX package's
``auto`` does with no chip, and writes the same bytes as both packages'
native runs. With the gate patched on, the probe runs on the DP's plain
version on the CPU: a warm-up and a probe batch through the hook, the
host's results kept, the verdict read back; a failing hook raises.

The engine caches its verdict per process and kernel shape (the hook's
row capacity ``M_CAP``), so the test whose hook fails sizes its hook for
twice the longest read: another shape, which the engine probes afresh."""

import ctypes
import dataclasses
import types

import pytest
import torch

from nanospring_tpu import compressor as jax_compressor
from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.utils import synth
from nanospring_tpu_torch import compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig
import nanospring_tpu_torch.pipeline.contigs as contigs


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


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _decoded(arc, out):
    decompressor.decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        return f.read().split(b"\n")[:-1]


@pytest.fixture(scope="module")
def probe_set(tmp_path_factory):
    """Batches of 64 pairs and more (the engine's warm-up and probe size)
    from short reads of even length (the plain DP's cost follows the
    longest), and the port's native archive of it."""
    d = tmp_path_factory.mktemp("torch_auto")
    fq = str(d / "probe.fastq")
    reads = synth.make_dataset(fq, genome_len=6_000, num_reads=350,
                               mean_len=500, seed=5, p_n_base=0.001)
    arc = str(d / "native.nstpu")
    compressor.compress_file(fq, arc, CompressConfig(
        aligner="native", device="cpu", pipeline_workers=1, num_threads=1),
        report=False)
    return d, fq, reads, _bytes(arc)


def test_from_reference_maps_auto():
    cfg = CompressConfig.from_reference(dataclasses.asdict(JaxConfig()))
    assert JaxConfig().aligner == "auto" and cfg.aligner == "auto"
    assert CompressConfig().aligner == "device"     # the port's default


def test_auto_without_card_equals_jax_auto_and_native(probe_set,
                                                      monkeypatch):
    """With the gate off (no card), no hook is even made."""
    d, fq, reads, native = probe_set
    made = []

    class Recorded(contigs._DeviceDpHook):
        def __init__(self, *a, **kw):
            made.append(a)
            super().__init__(*a, **kw)

    monkeypatch.setattr(contigs, "_DeviceDpHook", Recorded)
    monkeypatch.setenv("NSTPU_SKETCH", "native")
    jcfg = JaxConfig(pipeline_workers=1, num_threads=1)
    jarc, tarc = str(d / "jax_auto.nstpu"), str(d / "auto.nstpu")
    jres = jax_compressor.compress_file(fq, jarc, jcfg, report=False)
    assert jres["dp_info"]["dp_backend"] == "native"
    cfg = CompressConfig.from_reference(dataclasses.asdict(jcfg),
                                        device="cpu")
    assert cfg.aligner == "auto"
    res = compressor.compress_file(fq, tarc, cfg, report=False)
    info = res["dp_info"]
    assert info["dp_backend"] == "native" and info["dp_hook_batches"] == 0
    assert info["dp_probe_device_workers"] == 0
    assert info["dp_probe_native_workers"] == 0
    assert made == []
    assert _bytes(tarc) == _bytes(jarc) == native


def test_probe_on_plain_version(probe_set, monkeypatch):
    d, fq, reads, native = probe_set
    monkeypatch.setattr(contigs, "_probe_wanted", lambda store, cfg: True)
    arc = str(d / "probe.nstpu")
    res = compressor.compress_file(fq, arc, CompressConfig(
        aligner="auto", device="cpu", pipeline_workers=1, num_threads=1),
        report=False)
    info = res["dp_info"]
    assert info["dp_hook_batches"] >= 2             # warm-up and probe
    assert info["dp_kernel_launches"] == 0          # no CUDA kernel on cpu
    dev_w, nat_w = (info["dp_probe_device_workers"],
                    info["dp_probe_native_workers"])
    assert dev_w + nat_w == 1
    assert info["dp_probe_device_s"] > 0 and info["dp_probe_native_s"] > 0
    assert info["dp_backend"] == ("device" if dev_w else "native")
    if nat_w:
        # the warm-up and probe batches keep the host's results
        assert info["dp_hook_batches"] == 2
        assert _bytes(arc) == native
    assert _decoded(arc, str(d / "probe.reads")) == reads


def test_probe_gate(monkeypatch):
    """``NSTPU_TPU_PROBE=0``, a store under ``NSTPU_PROBE_MIN_BASES`` or
    no card: no probe, so ``_grow_components_engine`` makes no hook."""
    big = types.SimpleNamespace(total_bases=20_000_000)
    small = types.SimpleNamespace(total_bases=19_999_999)
    card = CompressConfig(aligner="auto")
    monkeypatch.delenv("NSTPU_TPU_PROBE", raising=False)
    monkeypatch.delenv("NSTPU_PROBE_MIN_BASES", raising=False)
    assert contigs._probe_wanted(big, card)
    assert not contigs._probe_wanted(small, card)
    assert not contigs._probe_wanted(big, CompressConfig(aligner="auto",
                                                         device="cpu"))
    monkeypatch.setenv("NSTPU_PROBE_MIN_BASES", "1e3")
    assert contigs._probe_wanted(types.SimpleNamespace(total_bases=1000),
                                 card)
    monkeypatch.setenv("NSTPU_TPU_PROBE", "0")
    assert not contigs._probe_wanted(big, card)
    monkeypatch.setenv("NSTPU_TPU_PROBE", "1")
    monkeypatch.setenv("NSTPU_PROBE_MIN_BASES", "2e7")
    assert contigs._probe_wanted(small, card)


def test_failing_hook_raises_in_probe_mode(probe_set, monkeypatch):
    d, fq, reads, native = probe_set

    class Broken(contigs._DeviceDpHook):
        def __init__(self, lib, device, max_read_len):
            # a wider row capacity than test_probe_on_plain_version's hook:
            # no cached verdict keeps the engine from calling this one
            super().__init__(lib, device, 2 * max_read_len)

        def _run(self, n_pairs):
            raise ValueError("DP kernel failed")

    monkeypatch.setattr(contigs, "_probe_wanted", lambda store, cfg: True)
    monkeypatch.setattr(contigs, "_DeviceDpHook", Broken)
    with pytest.raises(RuntimeError, match="device DP hook failed") as ei:
        compressor.compress_file(fq, str(d / "x.nstpu"),
                                 CompressConfig(aligner="auto", device="cpu",
                                                pipeline_workers=1,
                                                num_threads=1),
                                 report=False)
    assert "DP kernel failed" in str(ei.value.__cause__)
