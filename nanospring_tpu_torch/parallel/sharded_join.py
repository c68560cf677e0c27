"""Sharded sketch hash-join over the process group: the multi-device
overlap-candidate step, the counterpart of
``nanospring_tpu/parallel/sharded_join.py``.

1. every rank holds the sketches of its own reads (on its device),
2. slot shuffle: each (slot, value, read id) goes to the rank that owns the
   value's hash range (the same remix and top bits as the JAX package), in
   one ragged all-to-all for all slots together (``mesh.exchange``),
3. each owner sorts its (slot, value) keys on the host and expands every
   group of 2 to ``max_bucket`` reads into read pairs,
4. pair exchange: each pair goes to the rank its (q, r) hash names,
5. each owner counts the slots every pair shares and keeps the pairs that
   reach the threshold.

The JAX package pads every bucket to a fixed capacity (XLA needs static
shapes), counts what overflows and re-runs at double the capacity. Here the
counts go first and the payload follows with those split sizes, so nothing
overflows and nothing is re-run. The bucketing is plain torch on the rank's
device (the JAX package's are XLA ops outside any Pallas kernel), the
expansion numpy on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sketch as sk
from . import mesh

_M32 = 0xFFFFFFFF
_EMPTY = int(sk.EMPTY_SLOT)


def value_owner(vals: torch.Tensor, world: int) -> torch.Tensor:
    """The rank owning each uint32 value (held in int64): the top bits of
    the value remixed by the golden-ratio multiply and a shift xor, since
    MinHash values are per-read minima and bunch near 0
    (``sharded_join.py:40-45``)."""
    mixed = sk._mul32(vals, 0x9E3779B1)
    mixed = mixed ^ (mixed >> 16)
    bits = max(1, (world - 1).bit_length())
    return torch.clamp(mixed >> (32 - bits), max=world - 1)


def pair_owner(q: torch.Tensor, r: torch.Tensor, world: int) -> torch.Tensor:
    """The rank owning each pair: ``|int32(q*0x45D9F3B ^ r*0x2545F491)|
    mod world`` with the JAX package's int32 wrap
    (``sharded_join.py:120-121``), computed in int64: the low 32 bits as a
    signed int32, whose absolute value wraps at -2^31 as int32's does, then
    the floor modulo."""
    mixed = ((q * 0x45D9F3B) ^ (r * 0x2545F491)) & _M32
    mixed = torch.where(mixed >= 1 << 31, mixed - (1 << 32), mixed)
    mixed = torch.where(mixed == -(1 << 31), mixed, mixed.abs())
    return torch.remainder(mixed, world)


def slot_shuffle(group: mesh.Group, sketches: torch.Tensor,
                 rids: torch.Tensor):
    """Send every real (slot, value, read id) of this rank's sketches
    ((n, S) int32 holding the uint32 bits, on ``group.device``) to its value
    owner. Returns (keys ``slot << 32 | value``, read ids) received, as
    numpy int64, and the bytes sent and received."""
    n, S = sketches.shape
    vals = sketches.to(torch.int64).reshape(-1) & _M32
    slot = torch.arange(S, device=vals.device).repeat(n)
    rid = rids.to(torch.int64).repeat_interleave(S)
    real = vals != _EMPTY
    vals, slot, rid = vals[real], slot[real], rid[real]
    payload = torch.stack([(slot << 32) | vals, rid], dim=1)
    recv, sent, got = mesh.exchange(group, payload,
                                    value_owner(vals, group.world))
    recv = recv.cpu().numpy()
    return recv[:, 0], recv[:, 1], sent, got


def expand_groups(keys: np.ndarray, ids: np.ndarray, max_bucket: int = 256,
                  canonical: bool = False):
    """Every group of equal keys with 2 to ``max_bucket`` members -> its
    ordered read pairs (a != b), or with ``canonical`` only a < b (each
    unordered pair once per shared slot). Vectorized: sort by key, find the
    group boundaries, expand all groups' g^2 pairs in one repeat/divmod."""
    order = np.argsort(keys, kind="stable")
    keys, ids = keys[order], ids[order]
    bnd = np.ones(len(keys), dtype=bool)
    bnd[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(bnd)
    sizes = np.diff(np.append(starts, len(keys)))
    keepg = (sizes >= 2) & (sizes <= max_bucket)
    gs = starts[keepg].astype(np.int64)
    gz = sizes[keepg].astype(np.int64)
    sq = gz * gz
    total = int(sq.sum())
    if not total:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    excl = np.zeros(len(sq), np.int64)
    np.cumsum(sq[:-1], out=excl[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(excl, sq)
    base = np.repeat(gs, sq)
    gsz = np.repeat(gz, sq)
    a = ids[base + within // gsz].astype(np.int64)
    b = ids[base + within % gsz].astype(np.int64)
    keep = a < b if canonical else a != b
    return a[keep], b[keep]


def pair_exchange(group: mesh.Group, q: np.ndarray, r: np.ndarray):
    """Send each pair (q[i], r[i]) to its pair owner. Returns the pairs
    received (numpy int64) and the bytes sent and received."""
    qt = torch.from_numpy(np.ascontiguousarray(q, np.int64)).to(group.device)
    rt = torch.from_numpy(np.ascontiguousarray(r, np.int64)).to(group.device)
    recv, sent, got = mesh.exchange(group, torch.stack([qt, rt], dim=1),
                                    pair_owner(qt, rt, group.world))
    recv = recv.cpu().numpy()
    return recv[:, 0], recv[:, 1], sent, got


def threshold_count(q: np.ndarray, r: np.ndarray, threshold: int):
    """Count each pair's copies (one per shared slot) and keep those with at
    least ``threshold``: (q, r, counts) sorted by (q, r)."""
    key = (q.astype(np.int64) << 32) | r.astype(np.int64)
    key.sort()
    bnd = np.ones(len(key), dtype=bool)
    bnd[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(bnd)
    counts = np.diff(np.append(starts, len(key)))
    keep = counts >= threshold
    uk = key[starts[keep]]
    return uk >> 32, uk & _M32, counts[keep]


def sharded_candidate_pairs(group: mesh.Group, local_sketches: torch.Tensor,
                            local_rids: torch.Tensor, threshold: int,
                            max_bucket: int = 256, canonical: bool = False,
                            comm: dict | None = None, tick=None):
    """The distributed overlap-candidate join over the group.

    ``local_sketches`` (n, S) int32 sketch bits and ``local_rids`` (n,)
    global read ids are this rank's reads. Returns this rank's share of the
    pairs with >= ``threshold`` shared slots, (q, r, counts) sorted by
    (q, r); each pair lies on exactly one rank. Both directions of each
    pair, or only q < r with ``canonical``. ``comm``, if given, receives the
    bytes each exchange sent and received on this rank; ``tick``, if given,
    is called with each step's name as it ends."""
    tick = tick or (lambda name: None)
    keys, ids, s1, r1 = slot_shuffle(group, local_sketches, local_rids)
    tick("slot_shuffle")
    q, r = expand_groups(keys, ids, max_bucket, canonical)
    tick("pair_expand")
    rq, rr, s2, r2 = pair_exchange(group, q, r)
    tick("pair_exchange")
    if comm is not None:
        comm["slot_shuffle"] = s1 + r1
        comm["pair_exchange"] = s2 + r2
    out = threshold_count(rq, rr, threshold)
    tick("threshold_count")
    return out


def gather_pairs(group: mesh.Group, q: np.ndarray, r: np.ndarray,
                 counts: np.ndarray):
    """All ranks' shares of ``sharded_candidate_pairs`` on every rank, in one
    order: sorted by (q, r), as the JAX function returns them."""
    local = torch.from_numpy(np.stack([q, r, counts], axis=1).astype(np.int64))
    rows = np.concatenate([x.cpu().numpy()
                           for x in mesh.all_gather_ragged(group, local)])
    order = np.lexsort((rows[:, 1], rows[:, 0]))
    rows = rows[order]
    return rows[:, 0], rows[:, 1], rows[:, 2]

