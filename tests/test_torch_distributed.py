"""The port's multi-process compress (``python -m
nanospring_tpu_torch.parallel.distributed``) on gloo ranks on the CPU:
byte-equal to the JAX package's ``compress_distributed`` with as many
processes (one CPU device each, ``aligner="native"``,
``pipeline_workers=1``), lossless at 4 ranks with the memory-evidence
bounds of tests/test_distributed.py, and a run whose ranks have ``jax``
and ``nanospring_tpu`` blocked."""

import os
import pickle
import sys

import numpy as np
import pytest

from nanospring_tpu_torch.decompressor import decompress_file
from nanospring_tpu_torch.parallel import mesh
from nanospring_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ARGS = ["--device", "cpu", "--aligner", "native", "--workers", "1"]

# the JAX package's rank: one CPU device per process, so its mesh has as
# many devices as there are processes
JAX_RANK = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)
from nanospring_tpu.config import CompressConfig
from nanospring_tpu.parallel import distributed as d

fq, out, work, nproc, pid, port = sys.argv[1:7]
if int(nproc) > 1:
    d.initialize(f"127.0.0.1:{port}", int(nproc), int(pid))
assert len(jax.devices()) == int(nproc)
cfg = CompressConfig(aligner="native", pipeline_workers=1)
d.compress_distributed(fq, out, work, cfg=cfg)
"""

# the port's rank with the JAX package blocked
BLOCKED_RANK = r"""
import sys
sys.modules["jax"] = None
sys.modules["nanospring_tpu"] = None
from nanospring_tpu_torch.parallel import distributed

rc = distributed._main(sys.argv[1:])
assert not any(m == "jax" or m.startswith(("jax.", "nanospring_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("BLOCKED OK")
sys.exit(rc)
"""


def _launch(cmd, fq, arc, work, nproc, extra=()) -> list[str]:
    """Run ``nproc`` ranks of ``cmd`` (argv prefix) and wait for them."""
    os.makedirs(work, exist_ok=True)
    port = mesh.free_port()
    ranks = mesh.run_ranks(
        [list(cmd) + [fq, arc, work, str(nproc), str(pid), str(port)]
         + list(extra) for pid in range(nproc)],
        env={"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}, timeout=300)
    for rc, o in ranks:
        assert rc == 0, o[-3000:]
    return [o for _, o in ranks]


def _port_ranks(fq, arc, work, nproc) -> list[str]:
    outs = _launch([sys.executable, "-m",
                    "nanospring_tpu_torch.parallel.distributed"],
                   fq, arc, work, nproc, PORT_ARGS)
    assert "distributed compress ok" in outs[0], outs[0][-2000:]
    return outs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_distributed.py's dataset: 6 genomes of 12 kb, 32 reads
    of ~1,500 bases from each."""
    rng = np.random.default_rng(55)
    reads = []
    for _ in range(6):
        g = synth.random_genome(12_000, rng)
        reads += synth.make_reads(g, 32, 1_500, rng)
    fq = str(tmp_path_factory.mktemp("data") / "r.fastq")
    synth.write_fastq(fq, reads, gz=False)
    return fq, reads


def _lossless(arc, tmp_path, reads) -> None:
    out = str(tmp_path / "r.reads")
    decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        assert f.read().splitlines() == reads, "archive not byte-identical"


@pytest.mark.parametrize("nproc", [1, 2])
def test_distributed_matches_jax(tmp_path, dataset, nproc):
    fq, reads = dataset
    arc = str(tmp_path / "port.nstpu")
    _port_ranks(fq, arc, str(tmp_path / "port"), nproc)
    arc_j = str(tmp_path / "jax.nstpu")
    _launch([sys.executable, "-c", JAX_RANK], fq, arc_j,
            str(tmp_path / "jax"), nproc)
    with open(arc, "rb") as f, open(arc_j, "rb") as g:
        assert f.read() == g.read(), "archives differ"
    _lossless(arc, tmp_path, reads)
    with open(tmp_path / "port" / "mem_0.pkl", "rb") as f:
        ev = pickle.load(f)
    with open(tmp_path / "jax" / "mem_0.pkl", "rb") as f:
        ev_j = pickle.load(f)
    for key in ("local_pairs", "owned_edges", "label_allgather_rounds",
                "full_packed_bytes", "local_shard_bytes", "gathered_bytes"):
        assert ev[key] == ev_j[key], key
    assert set(ev["phase_times"]) == set(ev_j["phase_times"])


def test_distributed_four_ranks_lossless_and_bounded(tmp_path, dataset):
    fq, reads = dataset
    arc = str(tmp_path / "r.nstpu")
    work = tmp_path / "work"
    _port_ranks(fq, arc, str(work), 4)
    _lossless(arc, tmp_path, reads)
    # memory evidence: no rank's shard, nor what it gathered to grow its
    # components, is the full packed dataset; with 4 ranks a rank's working
    # set is a strict minority of it, and the gathers partition the reads
    # of the grown components
    tot_gathered = 0
    for pid in range(4):
        with open(work / f"mem_{pid}.pkl", "rb") as f:
            ev = pickle.load(f)
        full = ev["full_packed_bytes"]
        assert ev["local_shard_bytes"] < full, ev
        assert ev["gathered_bytes"] < full, ev
        assert ev["local_shard_bytes"] + ev["gathered_bytes"] < 0.75 * full
        tot_gathered += ev["gathered_bytes"]
        comm = ev["comm_bytes"]
        for key in ("meta_allgather", "slot_shuffle", "pair_exchange",
                    "edge_exchange", "label_allgather", "rep_mask_allgather"):
            assert comm[key] > 0, (key, comm)
        assert ev["kernel_launches"] == {"sketch": 0, "banded_dp16": 0,
                                         "banded_dp32": 0}   # cpu: plain
    assert tot_gathered < 1.5 * full


def test_distributed_with_jax_blocked(tmp_path, dataset):
    fq, reads = dataset
    arc = str(tmp_path / "r.nstpu")
    outs = _launch([sys.executable, "-c", BLOCKED_RANK], fq, arc,
                   str(tmp_path / "work"), 2, PORT_ARGS)
    assert all("BLOCKED OK" in o for o in outs), outs
    _lossless(arc, tmp_path, reads)
