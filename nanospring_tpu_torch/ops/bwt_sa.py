"""The BWT of an ``nsbwt`` block from its suffix array: the CUDA kernel's
wrapper (``csrc/bwt_sa.cu``) and its plain PyTorch version.

Both compute what ``native/codec.cpp::bwt_forward`` computes with SA-IS on
the host: with ``s = data + 1`` and a sentinel 0 after it, the BWT bytes
(``data[SA[r] - 1]`` for every row ``r`` whose suffix is not the whole
block), the primary index (that row) and the inverse-BWT chain
checkpoints ``ck[c] = ISA[n - c * (n // nck)]`` for ``c`` in ``[1, nck)``.
They return ``(bwt, info)``: ``bwt`` uint8 of length n, ``info`` int32 of
length ``nck`` holding the primary and then ``ck[1:]``.

The plain version runs the kernel's rounds with ``torch.sort``: round 0
ranks each suffix by its first 7 bytes and ``min(length, 7)`` (so a suffix
that ends sorts before a longer one with the same bytes, as the sentinel
makes it); round r >= 1 sorts the suffixes still tied by
``(rank[i], rank[i + h])``, ``h = 7 << (r - 1)``; a rank is the row of its
group's first suffix, and a suffix alone in its group leaves the rounds
with its final row. Ties keep their order in both (a stable sort, and the
kernel's stable LSD radix sort), though no result depends on it.
"""

from __future__ import annotations

import torch

MAX_NCK = 32       # csrc/bwt_sa.cu: the checkpoint words a launch writes


def _check(data: torch.Tensor, nck: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("bwt_sa takes a contiguous 1-D uint8 tensor")
    if not 1 <= data.numel() < 1 << 31:
        raise ValueError(f"bwt_sa takes 1 to 2**31 - 1 bytes, got "
                         f"{data.numel()}")
    if not 1 <= nck <= MAX_NCK:
        raise ValueError(f"nck must lie in [1, {MAX_NCK}], got {nck}")


def bwt_sa_plain(data: torch.Tensor, nck: int) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The kernel's prefix-doubling rounds with ``torch.sort``, on the
    tensor's device; returns ``(bwt, info)``."""
    n, dev = data.numel(), data.device
    d = torch.cat([data.to(torch.int64),
                   torch.zeros(7, dtype=torch.int64, device=dev)])
    i = torch.arange(n + 1, device=dev)
    # the kernel's unsigned 64-bit key (bytes big-endian, then the length
    # byte), shifted by 2**63 so that int64 order is the unsigned order
    key = (d[i] - 128) * (1 << 56) + torch.clamp(n - i, max=7)
    for j in range(1, 7):
        key += d[i + j] << (56 - 8 * j)
    rank = torch.empty(n + 1, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    idx, pos = i, i.clone()
    rb = n.bit_length()
    rounds = 0
    while True:
        key, order = torch.sort(key, stable=True)
        idx = idx[order]
        differs = key[1:] != key[:-1]
        head = torch.cat([one, differs])
        last = torch.cat([differs, one])
        rank[idx] = torch.cummax(torch.where(head, pos, 0), 0).values
        keep = ~(head & last)
        idx, pos = idx[keep], pos[keep]
        rounds += 1
        if idx.numel() == 0:
            break
        h = 7 << (rounds - 1)
        key = (rank[idx] << rb) | rank[idx + h]
    primary = rank[0]
    r = rank[1:]
    bwt = torch.empty(n, dtype=torch.uint8, device=dev)
    bwt[r - (r > primary).to(torch.int64)] = data
    L = n // nck
    info = torch.stack([primary] + [rank[n - c * L] for c in range(1, nck)])
    return bwt, info.to(torch.int32)


def bwt_sa(data: torch.Tensor, nck: int) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``(bwt, info)`` of the block ``data``.

    A CUDA tensor launches ``csrc/bwt_sa.cu`` on the current stream, which
    synchronises once a round; a CPU tensor takes the plain version.
    ``bwt_sa.launches`` counts the kernel's launcher calls."""
    _check(data, nck)
    dev = data.device
    if dev.type == "cpu":
        return bwt_sa_plain(data, nck)
    if dev.type != "cuda":
        raise ValueError(f"bwt_sa runs on cuda or cpu, not {dev}")
    from . import _cuda

    lib = _cuda.get_lib()
    n = data.numel()
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    info = torch.empty(nck, dtype=torch.int32, device=dev)
    scratch = torch.empty(int(lib.ns_bwt_sa_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    rc = lib.ns_bwt_sa_launch(
        data.data_ptr(), n, nck, out.data_ptr(), info.data_ptr(),
        scratch.data_ptr(), scratch.numel(), _cuda.stream_handle(dev))
    _cuda.check(rc, "bwt_sa kernel")
    bwt_sa.launches += 1
    return out, info


bwt_sa.launches = 0
