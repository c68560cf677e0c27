"""The port's Python wavefront (``aligner="python"``, ``banded_dp32``'s
plain version on the CPU): worker processes, a failing DP kernel, the
band and card checks, and the native polish against its numpy version on
the port's own wavefront states. The archive parity with the JAX
package's wavefront is in ``test_torch_wavefront.py``."""

import collections
import copy

import numpy as np
import pytest
import torch

from nanospring_tpu.utils import synth
from nanospring_tpu_torch import compressor, decompressor
from nanospring_tpu_torch.config import CompressConfig
from nanospring_tpu_torch.io import read_store
from nanospring_tpu_torch.ops import align_tpu
from nanospring_tpu_torch.pipeline import contigs as cg
from nanospring_tpu_torch.utils.observe import FunnelStats


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """``test_torch_wavefront.py``'s dataset."""
    d = tmp_path_factory.mktemp("torch_wavefront_runs")
    fq = str(d / "in.fastq")
    reads = synth.make_dataset(fq, genome_len=50_000, num_reads=160,
                               mean_len=1_500, seed=3, p_n_base=0.001,
                               realistic=True)
    return d, fq, reads


def _decoded(arc, out):
    decompressor.decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        return f.read().split(b"\n")[:-1]


def test_two_workers_lossless(dataset):
    """Grow workers run the wavefront in their own processes; their DP
    counters sum into dp_info."""
    d, fq, reads = dataset
    arc = str(d / "w2.nstpu")
    res2 = compressor.compress_file(
        fq, arc, CompressConfig(aligner="python", device="cpu",
                                pipeline_workers=2), report=False)
    assert res2["dp_info"]["dp_kernel_pairs"] > 0
    assert _decoded(arc, str(d / "w2.reads")) == reads


def test_broken_dp_kernel_raises(dataset, monkeypatch):
    d, fq, _ = dataset

    def broken(*args, **kw):
        raise ValueError("DP kernel failed")

    broken.launches = 0
    monkeypatch.setattr(align_tpu, "banded_dp32", broken)
    with pytest.raises(ValueError, match="DP kernel failed"):
        compressor.compress_file(
            fq, str(d / "broken.nstpu"),
            CompressConfig(aligner="python", device="cpu",
                           pipeline_workers=1), report=False)


def test_python_aligner_needs_card_and_band(dataset, monkeypatch):
    d, fq, _ = dataset
    with pytest.raises(ValueError, match="band"):
        CompressConfig(aligner="python", band_width=129)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compressor.compress_file(fq, str(d / "x.nstpu"),
                                 CompressConfig(aligner="python"),
                                 report=False)


@pytest.fixture(scope="module")
def grown_states(tmp_path_factory):
    """Unpolished contigs grown by the port's own ``_Wavefront``."""
    d = tmp_path_factory.mktemp("torch_wf_polish")
    fq = str(d / "t.fastq")
    synth.make_dataset(fq, genome_len=30_000, num_reads=160, mean_len=1200,
                       seed=21, p_n_base=0.0)
    store = read_store.load_fastq(fq)
    cfg = CompressConfig(aligner="python", device="cpu", pipeline_workers=1,
                         polish_rounds=0)
    stats = FunnelStats()
    graph = cg._build_candidate_graph(store, cfg, stats, False)
    assert graph["premz"] is None               # the wavefront needs none
    bounds = graph["boundaries"]
    wf = cg._Wavefront(store, cfg, stats, graph["adj_off"], graph["dst"],
                       graph["rep"].copy(), graph["comp_of"])
    expand = collections.deque()
    for comp in np.flatnonzero(np.diff(bounds) >= 2).tolist():
        wf.register_component(comp, graph["comp_order"][bounds[comp]:
                                                        bounds[comp + 1]])
        expand.append(comp)
    while True:
        while len(wf.queue) < cfg.frontier_target and expand:
            if wf.activate_next_in_comp(expand[0], fresh_only=True):
                expand.rotate(-1)
            else:
                expand.popleft()
        if not wf.queue:
            break
        wf.run_batch()
    for comp in list(wf._comp_members.keys()):
        while wf.activate_next_in_comp(comp):
            while wf.queue:
                wf.run_batch()
    for st in list(wf.states.values()):
        wf._finalize(st)
    assert wf.done, "no contigs grown"
    assert wf.dp_pairs > 0 and wf.dp_launches == 0
    return store, wf.done


def test_polish_native_matches_numpy(grown_states):
    store, done = grown_states
    states_np = copy.deepcopy(done)
    states_nat = copy.deepcopy(done)
    for st in states_np:
        cg._polish_contig(st, store)
        cg._polish_indels(st, store)
        cg._polish_contig(st, store)
    assert cg._polish_batch_native(states_nat, store)
    changed = 0
    for a, b, c in zip(states_np, states_nat, done):
        assert np.array_equal(a.cons, b.cons)
        changed += not np.array_equal(a.cons, c.cons)
        for ma, mb in zip(a.members, b.members):
            assert ma.tstart == mb.tstart
            assert np.array_equal(ma.ops, mb.ops)
    assert changed > 0                          # the polish did something
