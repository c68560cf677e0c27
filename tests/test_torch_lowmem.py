"""The low-memory store (a spill file mapped read-only, on by itself above
``low_mem_auto_bytes``) and the bounded decompress through the port:
archives byte-equal to the JAX package's with one and two grow workers,
no spill file left behind, the same bytes as the in-memory store, the
spill map's sketch bit-equal to the in-memory store's (copied to the
device in chunks), and a decompress in a tiny memory budget that decodes
to the input."""

import ctypes
import os

import numpy as np
import pytest
import torch

from nanospring_tpu import compressor as jax_compressor
from nanospring_tpu.config import CompressConfig as JaxConfig
from nanospring_tpu.utils import synth
from nanospring_tpu_torch import cli, compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig, DecompressConfig
from nanospring_tpu_torch.io import read_store
from nanospring_tpu_torch.pipeline import contigs


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


def _spills(d):
    return [f for f in os.listdir(d) if f.endswith(".packed")]


def _reads(fq):
    with open(fq, "rb") as f:
        return f.read().split(b"\n")[1::4]


@pytest.fixture(scope="module")
def one_genome(tmp_path_factory):
    """240 kb: more than the bounded decompress's 0.0004 GB budget holds
    (2e5 bases)."""
    d = tmp_path_factory.mktemp("torch_lowmem")
    fq = str(d / "r.fastq")
    synth.make_dataset(fq, genome_len=40_000, num_reads=80, mean_len=3_000,
                       seed=13, p_n_base=0.002, realistic=True)
    return d, fq


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    """Short reads of even length, for the runs on the DP's plain version."""
    d = tmp_path_factory.mktemp("torch_lowmem_small")
    fq = str(d / "r.fastq")
    synth.make_dataset(fq, genome_len=8_000, num_reads=40, mean_len=800,
                       seed=13, p_n_base=0.002)
    return d, fq


def _both(d, fq, workers, monkeypatch):
    """The JAX package's and the port's low-memory native archives."""
    jdir, tdir = d / f"jax{workers}", d / f"port{workers}"
    jdir.mkdir()
    tdir.mkdir()
    monkeypatch.setenv("NSTPU_SKETCH", "native")
    jarc, tarc = str(d / f"j{workers}.nstpu"), str(d / f"t{workers}.nstpu")
    jax_compressor.compress_file(fq, jarc, JaxConfig(
        aligner="native", low_mem=True, work_dir=str(jdir),
        pipeline_workers=workers, num_threads=workers), report=False)
    res = compressor.compress_file(fq, tarc, CompressConfig(
        aligner="native", device="cpu", low_mem=True, work_dir=str(tdir),
        pipeline_workers=workers, num_threads=workers), report=False)
    assert res["low_mem"] is True
    assert _spills(jdir) == [] and _spills(tdir) == []
    return jarc, tarc, res


def test_low_mem_equals_jax_one_worker(one_genome, monkeypatch):
    d, fq = one_genome
    jarc, tarc, res = _both(d, fq, 1, monkeypatch)
    assert _bytes(jarc) == _bytes(tarc)
    assert res["ratio"] > 1.0
    out = str(d / "t1.reads")
    decompressor.decompress_file(tarc, out, report=False)
    assert _bytes(out).split(b"\n")[:-1] == _reads(fq)


def test_low_mem_equals_jax_two_workers(tmp_path, monkeypatch):
    """Two disjoint genomes, two components, two workers that each map
    the parent's spill file (``tests/test_roundtrip.py``'s set)."""
    rng = np.random.default_rng(24)
    g1 = synth.random_genome(15_000, rng)
    g2 = synth.random_genome(15_000, rng)
    reads = (synth.make_reads(g1, 25, 2_000, rng)
             + synth.make_reads(g2, 25, 2_000, rng))
    fq = str(tmp_path / "r.fastq")
    synth.write_fastq(fq, reads, gz=False)
    jarc, tarc, res = _both(tmp_path, fq, 2, monkeypatch)
    assert _bytes(jarc) == _bytes(tarc)
    assert res["funnel"].contigs >= 2
    assert res["dp_info"]["grow_workers"] == 2


def test_device_low_mem_equals_in_memory(small_set):
    """The device DP's plain version on a spill-backed store writes the
    in-memory store's bytes."""
    d, fq = small_set
    arcs = []
    for low_mem in (True, False):
        wd = d / f"dev_{low_mem}"
        wd.mkdir()
        arc = str(d / f"dev_{low_mem}.nstpu")
        res = compressor.compress_file(fq, arc, CompressConfig(
            device="cpu", low_mem=low_mem, work_dir=str(wd),
            pipeline_workers=1, num_threads=1), report=False)
        assert res["low_mem"] is low_mem and _spills(wd) == []
        assert res["dp_info"]["dp_hook_batches"] > 0
        arcs.append(_bytes(arc))
    assert arcs[0] == arcs[1]


def test_hook_keeps_first_and_largest_batch(tmp_path, monkeypatch):
    """``NSTPU_DP_RECORD``: the hook keeps its first batch and its largest
    (pairs x longest query), inputs and outputs, and the DP's plain
    version on those inputs gives those outputs. On this set the second
    of three batches is the largest."""
    from nanospring_tpu_torch.ops import align_tpu as at

    fq = str(tmp_path / "r.fastq")
    synth.make_dataset(fq, genome_len=8_000, num_reads=80, mean_len=800,
                       seed=13, p_n_base=0.002)
    rec = tmp_path / "rec"
    rec.mkdir()
    sizes = []
    run = contigs._DeviceDpHook._run

    def counted(self, n_pairs):
        q = self.np["q_len"][:n_pairs]
        sizes.append(int(np.count_nonzero(q)) * int(q.max()))
        run(self, n_pairs)

    monkeypatch.setattr(contigs._DeviceDpHook, "_run", counted)
    monkeypatch.setenv("NSTPU_DP_RECORD", str(rec))
    compressor.compress_file(fq, str(tmp_path / "r.nstpu"), CompressConfig(
        device="cpu", pipeline_workers=1, num_threads=1), report=False)
    kept = {f.rsplit("_", 1)[1]: np.load(rec / f) for f in os.listdir(rec)}
    # the largest is neither the first batch nor the last
    assert 0 < sizes.index(max(sizes)) < len(sizes) - 1
    assert set(kept) == {"first.npz", "largest.npz"}
    for name, b in kept.items():
        P, m = b["trace"].shape
        want = sizes[0] if name == "first.npz" else max(sizes)
        assert P * m == want and int(b["m_cap"]) >= m
        cost, _ln, ts, te, trace = at.banded_dp16_plain(*(
            torch.from_numpy(b[k]) for k in ("d0", "q_len", "t_len",
                                             "max_cost", "tpad", "queries")))
        assert np.array_equal(cost.numpy(), b["cost"])
        assert np.array_equal(ts.numpy(), b["ts"])
        assert np.array_equal(te.numpy(), b["te"])
        rows = np.arange(m)[None, :] < b["q_len"][:, None]
        assert np.array_equal(trace.numpy()[rows], b["trace"][rows])


def test_spill_sketch_equals_in_memory(small_set, monkeypatch):
    d, fq = small_set
    wd = d / "sketch"
    wd.mkdir()
    cfg = CompressConfig(device="cpu")
    mem = read_store.load_fastq(fq)
    spill = read_store.load_fastq(fq, low_mem=True, work_dir=str(wd))
    try:
        # a read-only map of the spill file
        assert os.path.exists(spill.temp_path)
        assert not spill.packed.flags["WRITEABLE"]
        # chunks smaller than the buffer, the last one partial
        monkeypatch.setattr(contigs, "STAGE_BYTES", 1021)
        assert len(spill.packed) > 3 * contigs.STAGE_BYTES
        dev = contigs.packed_on_device(np.asarray(spill.packed),
                                       torch.device("cpu"))
        assert np.array_equal(dev.numpy(), mem.packed)
        want = contigs.sketch_rows(mem, cfg)
        assert torch.equal(contigs.sketch_rows(spill, cfg), want)
        assert torch.equal(contigs.sketch_rows(spill, cfg, 10, 50),
                           want[10:50])
    finally:
        spill.cleanup()
    assert _spills(wd) == []


def test_low_mem_switches_on_by_size(small_set):
    d, fq = small_set
    wd = d / "auto"
    wd.mkdir()
    res = compressor.compress_file(fq, str(d / "auto.nstpu"), CompressConfig(
        aligner="native", device="cpu", work_dir=str(wd),
        low_mem_auto_bytes=os.path.getsize(fq), pipeline_workers=1,
        num_threads=1), report=False)
    assert res["low_mem"] is True and _spills(wd) == []


def test_bounded_decompress(one_genome, tmp_path):
    d, fq = one_genome
    arc = str(tmp_path / "o.nstpu")
    assert cli.main(["-c", "-i", fq, "-o", arc, "--device", "cpu",
                     "--aligner", "native", "--workers", "1", "-t", "1",
                     "--low-mem", "-w", str(tmp_path), "-q"]) == 0
    exp = _reads(fq)
    out = str(tmp_path / "a.reads")
    decompressor.decompress_file(arc, out, DecompressConfig(num_threads=1),
                                 report=False)
    assert _bytes(out).split(b"\n")[:-1] == exp
    # a tiny budget forces chunked replay and several reorder passes
    r = decompressor.decompress_file(
        arc, str(tmp_path / "b.reads"),
        DecompressConfig(memory_gb=0.0004, num_threads=1), report=False)
    assert _bytes(str(tmp_path / "b.reads")).split(b"\n")[:-1] == exp
    assert "reorder_passes" in r["stage_s"]
    assert cli.main(["-d", "-i", arc, "-o", str(tmp_path / "c.reads"),
                     "-m", "0.0004", "-t", "1", "-q"]) == 0
    assert _bytes(str(tmp_path / "c.reads")) == _bytes(out)
    assert _spills(tmp_path) == []
