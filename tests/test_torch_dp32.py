"""Port parity for the v1 DP: ``banded_dp32`` (the CPU side of
``csrc/banded_dp32.cu``) against the JAX package's v1 Pallas kernel
``_kernel`` in interpret mode. Outputs are integers: equality, no
tolerance. ``banded_align_batch_32`` is held against
``banded_align_batch_tpu`` (cost, tstart, tend, op bytes) and the raw int32
records against ``_align_padded``'s trace on the same buffers."""

import numpy as np
import pytest
import torch

import nanospring_tpu.ops.align_tpu as jat
from nanospring_tpu.ops.align import banded_align_batch as jax_native_align
from nanospring_tpu_torch.ops import align_tpu as tat
from test_align_tpu import _mkbatch, _replay_ok
from test_torch_dp_v2 import SCALARS, pad_bufs


def assert_results_equal(got, ref):
    for name in ("cost", "tstart", "tend", "ops_len", "ops_off"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    np.testing.assert_array_equal(got.ops_flat, ref.ops_flat)


@pytest.mark.parametrize("P", [5, 19, 33])
def test_batch_matches_jax_v1(P):
    """P=5 leaves a 4-block program mostly padding, P=19 and P=33 fill
    several 8-pair blocks with mixed lengths."""
    rng = np.random.default_rng(P)
    args = _mkbatch(P, rng)
    ref = jat.banded_align_batch_tpu(*args, interpret=True)
    got = tat.banded_align_batch_32(*args, device="cpu")
    assert_results_equal(got, ref)
    assert (got.cost >= 0).sum() >= P - 1
    for p in range(P):
        if got.cost[p] >= 0:
            assert _replay_ok(args, got, p), p


def test_garbage_rejected():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 4, 500).astype(np.uint8)
    q = rng.integers(0, 4, 400).astype(np.uint8)   # unrelated
    args = (t, np.array([0]), np.array([500]), q, np.array([0]),
            np.array([400]), np.array([0]))
    ref = jat.banded_align_batch_tpu(*args, max_cost_per_kb=100,
                                     interpret=True)
    got = tat.banded_align_batch_32(*args, max_cost_per_kb=100,
                                    device="cpu")
    assert got.cost[0] == -1 and got.ops_len[0] == 0
    assert_results_equal(got, ref)


def test_plain_records_match_align_padded():
    """Raw outputs on one set of buffers, widened to the JAX layout
    (targets ``m_pad + 512`` wide, 0xFF padded; queries ``m_pad + 256``,
    int32 for JAX), three 8-pair blocks with padding pairs: cost, ops_len,
    tstart, tend and every record of rows below q_len."""
    rng = np.random.default_rng(11)
    args = _mkbatch(21, rng)
    m_pad = 1024
    _order, bufs = tat.build_buffers(*args, max_cost_per_kb=500, m_pad=m_pad,
                                     slots=tat.W32)
    bufs["tpad"] = np.pad(bufs["tpad"], ((0, 0), (0, tat.W32)),
                          constant_values=0xFF)
    bufs["queries"] = np.pad(bufs["queries"], ((0, 0), (0, tat.W32)))
    padded = pad_bufs(bufs, 24)
    out = jat._align_padded(
        *(padded[k] for k in SCALARS), padded["tpad"].reshape(3, 8, -1),
        padded["queries"].astype(np.int32).reshape(3, 8, -1),
        m_pad=m_pad, interpret=True)
    ref = [np.asarray(o) for o in out[:4]]
    ref_trace = np.asarray(out[4]).reshape(24, m_pad)
    got = tat.banded_dp32_plain(*(torch.from_numpy(padded[k])
                                  for k in SCALARS + ("tpad", "queries")))
    for name, r, g in zip(("cost", "ops_len", "tstart", "tend"), ref, got):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert (ref[0][21:] == 0).all() and (ref[0][:21] >= 0).sum() >= 20
    trace = got[4].numpy()
    for p in range(24):
        m = int(padded["q_len"][p])
        np.testing.assert_array_equal(trace[p, :m], ref_trace[p, :m],
                                      err_msg=f"records of pair {p}")


def test_long_query_above_tpu_cap():
    """A pair of ~9,000 rows: F's JAX wrapper refuses it (its 8,192-row
    VMEM cap), the port takes it; the cost equals the exact C++ DP at band
    128 and the ops replay."""
    rng = np.random.default_rng(23)
    t = rng.integers(0, 4, 9400).astype(np.uint8)
    src = t[100:9300]
    r = rng.random(len(src))            # 3% sub, 3% del, 3% ins
    q = np.repeat(src, np.where(r < 0.06, np.where(r < 0.03, 1, 0),
                                np.where(r < 0.09, 2, 1)))
    mut = rng.random(len(q)) < 0.03
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    args = (t, np.array([0]), np.array([len(t)]), q, np.array([0]),
            np.array([len(q)]), np.array([100]))
    assert len(q) > jat.M_PAD_MAX
    with pytest.raises(ValueError):
        jat.banded_align_batch_tpu(*args, interpret=True)
    got = tat.banded_align_batch_32(*args, device="cpu")
    ref = jax_native_align(*args, band=128, use_native=True)
    assert got.cost[0] >= 0
    assert got.cost[0] == ref.cost[0]
    assert _replay_ok(args, got, 0)
