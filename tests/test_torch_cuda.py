"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs (integers: equality, no tolerance), and a
small compression on ``cuda``. Marked ``cuda``: every test skips where
``torch.cuda.is_available()`` is False. This file imports only the port,
so it runs on a machine without JAX (``--noconftest`` skips the JAX
test setup):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nanospring_tpu_torch import compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.io import packed as pk
from nanospring_tpu_torch.ops import align_tpu as at
from nanospring_tpu_torch.ops import sketch as sk
from nanospring_tpu_torch.utils import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _pairs(rng, lens, err=0.09):
    tf, qf, t_off, t_len, q_off, q_len, d0 = [], [], [], [], [], [], []
    to = qo = 0
    for L in lens:
        t = rng.integers(0, 4, int(L) + 300).astype(np.uint8)
        q = t[100: 100 + int(L)].copy()
        mut = rng.random(len(q)) < err
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        for a, v in ((tf, t), (qf, q)):
            a.append(v)
        t_off.append(to)
        t_len.append(len(t))
        q_off.append(qo)
        q_len.append(len(q))
        d0.append(100)
        to += len(t)
        qo += len(q)
    return (np.concatenate(tf), np.array(t_off), np.array(t_len),
            np.concatenate(qf), np.array(q_off), np.array(q_len),
            np.array(d0))


def test_sketch_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    lens = np.array([0, 5, 17, 23, 31, 32, 33, 100, 1001, 5003, 20000],
                    np.int64)
    parts = [pk.pack_codes(rng.integers(0, 4, int(n)).astype(np.uint8))
             for n in lens]
    offs = np.cumsum([0] + [len(p) for p in parts[:-1]]).astype(np.int64)
    packed = np.concatenate(parts).astype(np.uint8)
    seeds = sk.make_seeds(60, 3).astype(np.int64)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    for k in (23, 17, 32):
        args = (t(packed), t(offs), t(lens), t(seeds), k, max(k, 32))
        n0 = sk.sketch_reads.launches
        got = sk.sketch_reads(*args)
        assert sk.sketch_reads.launches == n0 + 1
        ref = sk.sketch_reads_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), k


def test_sketch_kernel_edge_batch(dev):
    """The sketch kernel at the edges of its design (``chip_smoke.py``'s
    edge store): read lengths around k, the minimum length and the
    kernel's tiles, empty reads, the last read flush with a store whose
    bytes are no multiple of 8; k = 17, 23, 32 and 1 to 256 seeds; bit-equal
    to the plain version. 257 seeds raise."""
    import chip_smoke as cs

    n0 = sk.sketch_reads.launches
    cases = cs.sketch_edge_parity(dev)
    assert cases == len(cs.SKETCH_EDGE_KS) * (len(cs.SKETCH_EDGE_SEEDS) + 1)
    assert sk.sketch_reads.launches == n0 + cases
    store = [torch.from_numpy(a).to(dev) for a in
             cs.sketch_edge_store(np.random.default_rng(1), 23)]
    seeds = torch.ones((257, 2), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="at most 256 seeds"):
        sk.sketch_reads(*store, seeds, 23, 32)


def test_dp_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    lens = np.concatenate([[9000], rng.integers(200, 3000, 40)])
    _order, bufs = at.build_buffers(*_pairs(rng, lens), m_pad=16384)
    t = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
    args = [t[k] for k in ("d0", "q_len", "t_len", "max_cost", "tpad",
                           "queries")]
    args[1][-3:] = 0                              # padding pairs
    n0 = at.banded_dp16.launches
    got = at.banded_dp16(*args)
    assert at.banded_dp16.launches == n0 + 1
    ref = at.banded_dp16_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got[:4], ref[:4]):
        assert torch.equal(g, r)
    m = args[1].cpu().numpy()
    g4, r4 = got[4].cpu().numpy(), ref[4].cpu().numpy()
    for p in range(len(m)):
        assert np.array_equal(g4[p, : m[p]], r4[p, : m[p]]), p
    assert (got[0][-3:] == 0).all() and (got[0] >= 0).sum() > 30


def test_dp32_kernel_matches_plain(dev):
    """The v1 DP kernel against its plain version: one pair above the TPU
    kernel's 8,192-row cap, short pairs and padding pairs."""
    rng = np.random.default_rng(3)
    lens = np.concatenate([[9000], rng.integers(200, 3000, 40)])
    _order, bufs = at.build_buffers(*_pairs(rng, lens), slots=at.W32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
    args = [t[k] for k in ("d0", "q_len", "t_len", "max_cost", "tpad",
                           "queries")]
    args[1][-3:] = 0                              # padding pairs
    n0 = at.banded_dp32.launches
    got = at.banded_dp32(*args)
    assert at.banded_dp32.launches == n0 + 1
    ref = at.banded_dp32_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got[:4], ref[:4]):
        assert torch.equal(g, r)
    m = args[1].cpu().numpy()
    g4, r4 = got[4].cpu().numpy(), ref[4].cpu().numpy()
    for p in range(len(m)):
        assert np.array_equal(g4[p, : m[p]], r4[p, : m[p]]), p
    assert (got[0][-3:] == 0).all() and (got[0] >= 0).sum() > 30


@pytest.mark.parametrize("v1", [False, True], ids=["dp16", "dp32"])
def test_dp_kernel_edge_batch(dev, v1):
    """Both DP kernels at the edges of their design (``chip_smoke.py``'s
    edge batch): queries of 1, 31, 32, 33, 63, 65, 127, 129, 257 and
    131,072 rows,
    padding pairs, a rejected unrelated query, d0 at both ends of the
    target, and a 70-base deletion run (``banded_dp16``'s 255 escape);
    byte-equal to the plain version, run on the CPU copy of the inputs."""
    import chip_smoke as cs

    edge = cs.edge_pairs(np.random.default_rng(2026))
    kern = at.banded_dp32 if v1 else at.banded_dp16
    threads = torch.get_num_threads()
    try:
        ref, _ = cs.edge_plain(edge, v1)      # sets one thread
    finally:
        torch.set_num_threads(threads)
    got, err = cs.edge_parity(kern, ref, edge, dev, v1)
    torch.cuda.synchronize()
    assert err == 0
    assert int((got[0] < 0).sum()) == 1
    assert int((got[0] == 0).sum()) >= 2              # the padding pairs
    if not v1:
        q_len = torch.from_numpy(np.sort(edge[5])[::-1].copy())
        rows = torch.arange(got[4].shape[1])[None, :] < q_len[:, None]
        assert bool(((got[4] == 255) & rows).any())


def test_wavefront_on_cuda_lossless(dev, tmp_path):
    fq = str(tmp_path / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=100_000, num_reads=150,
                               mean_len=3_000, seed=4, realistic=True)
    arc, out = str(tmp_path / "w.nstpu"), str(tmp_path / "w.reads")
    res = compressor.compress_file(
        fq, arc, CompressConfig(aligner="python", pipeline_workers=1),
        report=False)
    decompressor.decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        assert f.read().split(b"\n")[:-1] == reads
    info = res["dp_info"]
    assert info["dp_backend"] == "python"
    assert info["dp_kernel_launches"] > 0 and info["dp_kernel_pairs"] > 0


def test_compress_on_cuda_lossless(dev, tmp_path):
    fq = str(tmp_path / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=100_000, num_reads=150,
                               mean_len=3_000, seed=4, realistic=True)
    arc, out = str(tmp_path / "o.nstpu"), str(tmp_path / "o.reads")
    res = compressor.compress_file(
        fq, arc, CompressConfig(pipeline_workers=1), report=False)
    decompressor.decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        assert f.read().split(b"\n")[:-1] == reads
    info = res["dp_info"]
    assert info["sketch_kernel_launches"] >= 1
    assert info["dp_kernel_launches"] > 0 and info["dp_kernel_pairs"] > 0


def test_sharded_join_nccl_one_rank(dev, tmp_path):
    """The sharded join on one NCCL rank, its tensors on the card, against
    the single-host join on the same sketches."""
    from nanospring_tpu_torch.io import read_store
    from nanospring_tpu_torch.parallel import mesh
    from nanospring_tpu_torch.parallel import sharded_join as sj
    from nanospring_tpu_torch.pipeline import candidates
    from nanospring_tpu_torch.pipeline import contigs

    fq = str(tmp_path / "in.fastq")
    synth.make_dataset(fq, genome_len=100_000, num_reads=300, mean_len=3_000,
                       seed=6, realistic=True)
    store = read_store.load_fastq(fq)
    cfg = CompressConfig()
    group = mesh.initialize(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                            device="cuda")
    try:
        assert group.backend == "nccl" and group.device.type == "cuda"
        sketches = contigs.sketch_rows(store, cfg)
        assert sketches.is_cuda
        rids = torch.arange(store.num_reads, device=sketches.device)
        q, r, c = sj.gather_pairs(group, *sj.sharded_candidate_pairs(
            group, sketches, rids, cfg.overlap_sketch_threshold))
    finally:
        mesh.shutdown()
    host = sk.as_uint32(sketches)
    wq, wr, wc = candidates.SketchIndex(host).query(
        host, cfg.overlap_sketch_threshold)
    keep = wq != wr
    assert len(q) > 0
    assert np.array_equal(q, wq[keep]) and np.array_equal(r, wr[keep])
    assert np.array_equal(c, wc[keep])


def _decodes(arc, out, reads):
    decompressor.decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        return f.read().split(b"\n")[:-1] == reads


def test_auto_on_cuda_probes(dev, tmp_path, monkeypatch):
    """``aligner="auto"`` with the probe forced on: the warm-up and probe
    batches go through ``banded_dp16`` on the card and the verdict is read
    back; a ``native`` verdict writes the native archive's bytes."""
    fq = str(tmp_path / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=30_000, num_reads=600,
                               mean_len=1_000, seed=5, p_n_base=0.001,
                               realistic=True)
    monkeypatch.setenv("NSTPU_TPU_PROBE", "1")
    arc, arc_n = str(tmp_path / "a.nstpu"), str(tmp_path / "n.nstpu")
    res = compressor.compress_file(
        fq, arc, CompressConfig(aligner="auto", pipeline_workers=1),
        report=False)
    compressor.compress_file(
        fq, arc_n, CompressConfig(aligner="native", pipeline_workers=1),
        report=False)
    info = res["dp_info"]
    assert info["dp_hook_batches"] >= 2 and info["dp_kernel_launches"] >= 2
    dev_w, nat_w = (info["dp_probe_device_workers"],
                    info["dp_probe_native_workers"])
    assert dev_w + nat_w == 1
    assert info["dp_backend"] == ("device" if dev_w else "native")
    assert _decodes(arc, str(tmp_path / "a.reads"), reads)
    if nat_w:
        with open(arc, "rb") as f, open(arc_n, "rb") as g:
            assert f.read() == g.read()


def test_two_workers_on_cuda(dev, tmp_path):
    """Two grow workers, each with its own CUDA context and hook on the
    one card: each launches ``banded_dp16``."""
    rng = np.random.default_rng(24)
    reads = []
    for _ in range(2):
        g = synth.random_genome(60_000, rng)
        reads += synth.make_reads(g, 80, 3_000, rng)
    fq = str(tmp_path / "in.fastq")
    synth.write_fastq(fq, reads, gz=False)
    arc = str(tmp_path / "w2.nstpu")
    res = compressor.compress_file(
        fq, arc, CompressConfig(pipeline_workers=2), report=False)
    info = res["dp_info"]
    assert info["grow_workers"] == 2
    assert info["dp_workers_launched"] == 2
    assert info["dp_worker_peak_bytes"] > 0
    assert _decodes(arc, str(tmp_path / "w2.reads"), reads)


def test_spill_store_sketch_on_cuda(dev, tmp_path, monkeypatch):
    """A spill-backed store goes to the card in chunks through a pinned
    staging buffer; its sketch equals the in-memory store's."""
    from nanospring_tpu_torch.io import read_store
    from nanospring_tpu_torch.pipeline import contigs

    fq = str(tmp_path / "in.fastq")
    synth.make_dataset(fq, genome_len=100_000, num_reads=300, mean_len=3_000,
                       seed=6, realistic=True)
    cfg = CompressConfig()
    mem = read_store.load_fastq(fq)
    spill = read_store.load_fastq(fq, low_mem=True, work_dir=str(tmp_path))
    try:
        monkeypatch.setattr(contigs, "STAGE_BYTES", 12_289)
        assert not spill.packed.flags["WRITEABLE"]
        assert torch.equal(contigs.sketch_rows(spill, cfg),
                           contigs.sketch_rows(mem, cfg))
    finally:
        spill.cleanup()


def _sais(block: np.ndarray, nck: int):
    import ctypes

    from nanospring_tpu_torch import native

    u8p, u32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
    out = np.empty(len(block), np.uint8)
    ck = np.zeros(32, np.uint32)
    primary = native.get_lib().ns_bwt_forward_host(
        block.ctypes.data_as(u8p), len(block), out.ctypes.data_as(u8p), nck,
        ck.ctypes.data_as(u32p))
    return out, [int(primary)] + [int(c) for c in ck[1:nck]]


def _lzp(block: np.ndarray) -> np.ndarray:
    import ctypes

    from nanospring_tpu_torch import native

    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = np.empty(2 * len(block) + 16, np.uint8)
    m = native.get_lib().ns_lzp_encode(block.ctypes.data_as(u8p), len(block),
                                       out.ctypes.data_as(u8p))
    return out[:m].copy()


def test_bwt_sa_kernel_matches_sais(dev, tmp_path):
    """The card's suffix sort against SA-IS's ``bwt_forward``: BWT bytes,
    primary and every checkpoint, on edge blocks (1 and 2 bytes, one byte
    repeated, periods 2 and 7, LZP's escape byte, a 20 MB block whose
    scans span several tile groups) and on the type, pos, genome and lone
    streams of a small sa-shaped compress, plain and LZP variants both."""
    from nanospring_tpu_torch.codec import backends
    from nanospring_tpu_torch.io import archive
    from nanospring_tpu_torch.ops import bwt_sa

    fq = str(tmp_path / "in.fastq")
    synth.make_dataset(fq, genome_len=300_000, num_reads=300, mean_len=12_000,
                       seed=7, realistic=True)
    arc = str(tmp_path / "o.nstpu")
    compressor.compress_file(fq, arc, CompressConfig(pipeline_workers=1),
                             report=False)
    _, raw = archive.read_archive(arc)
    rng = np.random.default_rng(3)
    blocks = [np.array([0x41], np.uint8), np.zeros(2, np.uint8),
              np.full(70_000, 7, np.uint8),
              (np.arange(50_001) % 2).astype(np.uint8),
              np.tile(np.frombuffer(b"ACGTTGA", np.uint8), 10_000),
              np.full(40_000, 0xFB, np.uint8),
              rng.integers(0, 4, 20 << 20).astype(np.uint8)]
    for name in ("type", "pos", "genome", "lone"):
        assert len(raw[name]) > 1_000, name
        for ch in backends.split_chunks(raw[name].tobytes()):
            c = np.frombuffer(ch, np.uint8).copy()
            blocks += [c, _lzp(c)]
    n0 = bwt_sa.bwt_sa.launches
    for b in blocks:
        nck = int(min(16, max(1, len(b) >> 16)))
        bwt, info = bwt_sa.bwt_sa(torch.from_numpy(b).to(dev), nck)
        ref, ref_info = _sais(b, nck)
        assert np.array_equal(bwt.cpu().numpy(), ref), len(b)
        assert info.cpu().tolist() == ref_info, len(b)
    assert bwt_sa.bwt_sa.launches == n0 + len(blocks)


def test_archive_same_with_card_sort(dev, tmp_path, monkeypatch):
    """An archive written with the card's suffix sort is the one written
    without it, on the ``device`` and ``native`` routes (the set's genome
    stream is over the hook's 256 KB bound), each card sort a
    ``codec.sa_card`` span inside its chunk's ``codec.<stream>`` span;
    ``bwt_card_bytes`` counts on ``cuda`` and stays 0 on ``cpu``."""
    import contextlib

    from nanospring_tpu_torch.codec import backends

    fq = str(tmp_path / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=1_200_000, num_reads=1_200,
                               mean_len=10_000, seed=7, realistic=True)
    for aligner in ("device", "native"):
        cfg = CompressConfig(aligner=aligner, pipeline_workers=1)
        on, off = str(tmp_path / "on.nstpu"), str(tmp_path / "off.nstpu")
        res = compressor.compress_file(fq, on, cfg, report=False)
        with monkeypatch.context() as mp:
            mp.setattr(backends, "card_suffix_sort",
                       lambda device: contextlib.nullcontext())
            res_off = compressor.compress_file(fq, off, cfg, report=False)
        with open(on, "rb") as f1, open(off, "rb") as f2:
            assert f1.read() == f2.read(), aligner
        assert res["stage_s"]["bwt_card_bytes"] >= 1 << 20, aligner
        assert res_off["stage_s"]["bwt_card_bytes"] == 0
        sorts = [s for s in res["spans"] if s["name"] == "codec.sa_card"]
        assert sorts and all(
            res["spans"][s["parent"]]["name"].startswith("codec.")
            and s["args"]["bytes_in"] >= 1 << 18 for s in sorts), aligner
    assert _decodes(on, str(tmp_path / "on.reads"), reads)
    small = str(tmp_path / "small.fastq")
    synth.make_dataset(small, genome_len=100_000, num_reads=150,
                       mean_len=3_000, seed=4, realistic=True)
    res = compressor.compress_file(
        small, str(tmp_path / "cpu.nstpu"),
        CompressConfig(device="cpu", aligner="native", pipeline_workers=1),
        report=False)
    assert res["stage_s"].get("bwt_card_bytes", 0) == 0
    assert res["stage_s"]["bwt_host_bytes"] > 0
