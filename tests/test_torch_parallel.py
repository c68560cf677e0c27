"""The port's sharded sketch join (``nanospring_tpu_torch/parallel``) on
gloo ranks on the CPU, against the JAX package's ``sharded_candidate_pairs``
on the 8-device CPU mesh and against the single-host ``SketchIndex``: the
same pairs, the same shared-slot counts, in the same order. The ranks are
subprocesses; the JAX side runs in the test process."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanospring_tpu.ops import sketch as jsk
from nanospring_tpu.parallel import mesh as jmesh
from nanospring_tpu.parallel import sharded_join as jsj
from nanospring_tpu.pipeline import candidates
from nanospring_tpu_torch.parallel import mesh
from nanospring_tpu_torch.parallel import sharded_join as sj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rank script: each rank joins its block of rows of every case, rank 0
# saves the gathered (q, r, counts) of each case and threshold
RANK = r"""
import os
import sys
import numpy as np
import torch
from nanospring_tpu_torch.parallel import mesh, sharded_join as sj

world, rank = int(sys.argv[1]), int(sys.argv[2])
port, out, cases = sys.argv[3], sys.argv[4], sys.argv[5:]
group = mesh.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
res = {}
for path in cases:
    sk = np.load(path)
    N = len(sk)
    rows = -(-N // world)
    lo, hi = min(N, rank * rows), min(N, (rank + 1) * rows)
    local = torch.from_numpy(sk[lo:hi].view(np.int32))
    rids = torch.arange(lo, hi)
    for thr in (2, 4):
        q, r, c = sj.gather_pairs(group, *sj.sharded_candidate_pairs(
            group, local, rids, thr))
        res[f"{os.path.basename(path)}:{thr}:q"] = q
        res[f"{os.path.basename(path)}:{thr}:r"] = r
        res[f"{os.path.basename(path)}:{thr}:c"] = c
mesh.shutdown()
if rank == 0:
    np.savez(out, **res)
"""


def _run_ranks(tmp_path, world, cases: dict) -> dict:
    """Join every case (name -> (N, S) uint32 sketches) on ``world`` gloo
    ranks; returns {(name, threshold): (q, r, counts)}."""
    paths = []
    for name, sk in cases.items():
        p = str(tmp_path / f"{name}.npy")
        np.save(p, sk)
        paths.append(p)
    out = str(tmp_path / f"pairs_{world}.npz")
    port = mesh.free_port()
    ranks = mesh.run_ranks(
        [[sys.executable, "-c", RANK, str(world), str(rank), str(port), out]
         + paths for rank in range(world)],
        env={"PYTHONPATH": REPO}, timeout=120)
    for rc, o in ranks:
        assert rc == 0, o[-3000:]
    got = np.load(out)
    return {(name, thr): tuple(got[f"{name}.npy:{thr}:{x}"] for x in "qrc")
            for name in cases for thr in (2, 4)}


def _sketches(N=64, L=512, k=23, nh=16, seed=0):
    """tests/test_parallel.py's sketches: reads from a 4,096-base genome
    with 5% substitutions, sketched by the JAX package."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 4096).astype(np.uint8)
    codes = np.zeros((N, L), dtype=np.uint8)
    lengths = np.full(N, L, dtype=np.int32)
    for i in range(N):
        s = rng.integers(0, 4096 - L)
        r = genome[s: s + L].copy()
        m = rng.random(L) < 0.05
        r[m] = rng.integers(0, 4, int(m.sum()))
        codes[i] = r
    seeds = np.asarray(jsk.make_seeds(nh, 7))
    return np.asarray(jsk.sketch_batch(codes, lengths, seeds, k=k))


def _skewed(N=96, S=16, world=4, seed=3):
    """Reads in clusters of 8 that share their value in each slot, every
    value drawn from the hash range of rank 0: the whole slot shuffle lands
    on one owner, which expands every pair."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32 - 1, 200_000, dtype=np.uint64)
    own = sj.value_owner(torch.from_numpy(pool.astype(np.int64)), world)
    pool = pool[(own == 0).numpy()].astype(np.uint32)
    sk = np.empty((N, S), np.uint32)
    for c0 in range(0, N, 8):
        vals = rng.choice(pool, S, replace=False)
        sk[c0: c0 + 8] = vals
        # each read keeps its cluster's value in a random 12 of the slots
        for i in range(c0, c0 + 8):
            off = rng.choice(S, 4, replace=False)
            sk[i, off] = rng.choice(pool, 4)
    return sk


def _single_host(sketches, threshold):
    index = candidates.SketchIndex(sketches)
    q, r, c = index.query(sketches, threshold)
    keep = q != r
    return {(a, b): n for a, b, n in zip(q[keep].tolist(), r[keep].tolist(),
                                         c[keep].tolist())}


@pytest.fixture(scope="module")
def cases():
    return {"base": _sketches(), "skewed": _skewed()}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_join_matches_jax_and_single_host(tmp_path, cases, world):
    got = _run_ranks(tmp_path, world, cases)
    jmesh8 = jmesh.make_mesh(8)
    for (name, thr), (q, r, c) in got.items():
        jq, jr, jc = jsj.sharded_candidate_pairs(jmesh8, cases[name], thr)
        assert np.array_equal(q, jq) and np.array_equal(r, jr), (name, thr)
        assert np.array_equal(c, jc), (name, thr)
        want = _single_host(cases[name], thr)
        assert dict(zip(zip(q.tolist(), r.tolist()), c.tolist())) == want
        assert len(q) > 0, (name, thr)


def test_sharded_join_skewed_set_loses_no_pair(tmp_path, cases):
    sk = cases["skewed"]
    vals = torch.from_numpy(sk.astype(np.int64).reshape(-1))
    assert bool((sj.value_owner(vals, 4) == 0).all())   # the skew is real
    got = _run_ranks(tmp_path, 4, {"skewed": sk})
    for thr in (2, 4):
        q, r, c = got[("skewed", thr)]
        want = _single_host(sk, thr)
        assert dict(zip(zip(q.tolist(), r.tolist()), c.tolist())) == want
        # every pair within a cluster of 8 shares at least 4 slots
        assert len(want) >= (len(sk) // 8) * 8 * 7


def test_sharded_join_all_empty(tmp_path):
    empty = np.full((16, 8), jsk.EMPTY_SLOT, dtype=np.uint32)
    got = _run_ranks(tmp_path, 2, {"empty": empty})
    for thr in (2, 4):
        q, r, c = got[("empty", thr)]
        assert len(q) == len(r) == len(c) == 0


def test_owner_functions_match_the_jax_package():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    vals[:3] = (0, 2**32 - 2, 2**31)
    for world in (1, 2, 3, 4, 8):
        bits = max(1, (world - 1).bit_length())
        v = jnp.asarray(vals.astype(np.uint32))
        mixed = v * jnp.uint32(0x9E3779B1)
        mixed = mixed ^ (mixed >> 16)
        want = jnp.minimum((mixed >> jnp.uint32(32 - bits)).astype(jnp.int32),
                           world - 1)
        got = sj.value_owner(torch.from_numpy(vals.astype(np.int64)), world)
        assert np.array_equal(got.numpy(), np.asarray(want)), world
    q = rng.integers(0, 2**31, 5000)
    r = rng.integers(0, 2**31, 5000)
    # a pair whose mix is exactly -2^31, where int32's |x| wraps to itself
    c1, c2 = 0x45D9F3B, 0x2545F491
    inv2 = pow(c2, -1, 2**32)
    q[0] = next(a for a in range(1, 1000)
                if ((a * c1 ^ 2**31) * inv2) % 2**32 < 2**31)
    r[0] = ((int(q[0]) * c1 ^ 2**31) * inv2) % 2**32
    for world in (1, 2, 3, 5, 8):
        jq, jr = jnp.asarray(q, jnp.int32), jnp.asarray(r, jnp.int32)
        mixed = (jq * jnp.int32(c1)) ^ (jr * jnp.int32(c2))
        assert int(mixed[0]) == -(2**31)
        want = np.asarray(jnp.abs(mixed) % world)
        got = sj.pair_owner(torch.from_numpy(q), torch.from_numpy(r), world)
        assert np.array_equal(got.numpy(), want), world


def test_initialize_refuses_nccl_ranks_sharing_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        mesh.initialize("127.0.0.1:1", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()


def test_initialize_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.initialize("127.0.0.1:1", 1, 0, device="cuda")
    with pytest.raises(RuntimeError, match="not initialized"):
        mesh.make_group()
