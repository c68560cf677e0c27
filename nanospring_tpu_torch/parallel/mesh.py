"""The process group: one rank per device, the counterpart of the JAX
package's ``reads`` mesh axis (``nanospring_tpu/parallel/mesh.py``).

``initialize`` wires the ranks together with ``torch.distributed`` and
returns a ``Group``: the rank, the world size, the torch device the rank
computes on, and the backend its collectives ride. Under ``nccl`` the
collectives take tensors on the rank's card; under ``gloo`` they take CPU
tensors, so the helpers here stage what they send on the host.

The helpers are the collectives the parallel modules use, all in the forms
that every supported torch version has (list-form ``all_gather``,
``all_to_all_single``):

- ``exchange``: a ragged all-to-all. The per-destination counts go first
  (one ``all_to_all_single``), then the payload with those split sizes, so
  no bucket has a fixed capacity and nothing can overflow;
- ``all_gather_ragged``: every rank's tensor, whatever its length;
- ``all_reduce`` and ``barrier``.

``free_port`` and ``run_ranks`` start a group's ranks as processes on this
host, as the tests and the smoke test do.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Group:
    """This rank's place in the process group."""

    rank: int
    world: int
    device: torch.device     # where the rank's kernels run
    backend: str             # "nccl" | "gloo"

    @property
    def comm_device(self) -> torch.device:
        """Where tensors must lie to go through a collective."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def _check_backend(backend: str, device: str, world: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("backend='nccl' needs device='cuda'")
        cards = torch.cuda.device_count()
        if world > cards:
            # NCCL refuses two ranks on one card ("Duplicate GPU detected")
            raise RuntimeError(
                f"{world} ranks on {cards} card(s): under NCCL each rank "
                f"needs a card of its own. Pass backend='gloo' to run several "
                f"ranks on one card, or start at most {cards} ranks")


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str = "cuda", backend: str | None = None,
               timeout: float = 600.0) -> Group:
    """Join the process group at ``tcp://{coordinator}`` as rank
    ``process_id`` of ``num_processes`` (all ranks on one host).

    On ``cuda`` rank r takes card ``r % device_count`` and makes it the
    current device, so ``device="cuda"`` inside the rank means its own
    card. ``backend`` defaults to ``nccl`` on ``cuda`` and ``gloo`` on
    ``cpu``; asking for ``nccl`` with more ranks than cards raises (it is
    never switched to ``gloo`` quietly). ``timeout`` (seconds) bounds every
    collective, so a rank whose peer died fails instead of hanging."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False: pass device='cpu' (CLI: --device cpu)")
    _check_backend(backend, device, num_processes)
    if device == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    return make_group(num_processes, device)


def make_group(n_ranks: int | None = None, device=None) -> Group:
    """The ``Group`` of this process, from the initialized process group.
    ``device`` ("cuda", "cpu" or a ``torch.device``) is where the rank
    computes; it defaults to the current card under ``nccl`` and to the CPU
    under ``gloo``.

    As ``make_mesh`` refuses to build a smaller mesh than asked for, this
    refuses a process group of another size than ``n_ranks``: a one-rank
    "two-way" group would make every sharding check pass vacuously."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.mesh.initialize first")
    world = dist.get_world_size()
    if n_ranks is not None and n_ranks != world:
        raise RuntimeError(f"requested a {n_ranks}-rank group but the process "
                           f"group has {world} rank(s)")
    backend = dist.get_backend()
    dev = torch.device(device or ("cuda" if backend == "nccl" else "cpu"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Group(rank=dist.get_rank(), world=world, device=dev,
                 backend=backend)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(group: Group) -> None:
    if group.backend == "nccl":
        dist.barrier(device_ids=[group.device.index])
    else:
        dist.barrier()


def all_reduce(group: Group, t: torch.Tensor, op=dist.ReduceOp.SUM):
    """Reduce ``t`` over the ranks; returns the result on ``t``'s device."""
    x = t.to(group.comm_device).clone()
    dist.all_reduce(x, op=op)
    return x.to(t.device)


def all_gather_ragged(group: Group, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (any length along dim 0, the rest of the shape
    equal), in rank order, on the comm device."""
    x = t.to(group.comm_device).contiguous()
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.empty_like(n) for _ in range(group.world)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    cap = max(sizes)
    pad = x.new_zeros((cap,) + tuple(x.shape[1:]))
    pad[: x.shape[0]] = x
    rows = [torch.empty_like(pad) for _ in range(group.world)]
    dist.all_gather(rows, pad)
    return [r[:s] for r, s in zip(rows, sizes)]


def exchange(group: Group, payload: torch.Tensor, dest: torch.Tensor):
    """Send row i of ``payload`` to rank ``dest[i]``: a ragged all-to-all.

    Rows are ordered by destination (stable), the per-destination counts go
    through one ``all_to_all_single``, then the payload with those split
    sizes. Returns (rows received, in source-rank order and each source's
    order kept, on the comm device; bytes sent; bytes received)."""
    order = torch.argsort(dest, stable=True)
    send = payload[order].to(group.comm_device).contiguous()
    counts = torch.bincount(dest, minlength=group.world).to(
        device=group.comm_device, dtype=torch.int64)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts)
    in_splits = counts.tolist()
    out_splits = recv_counts.tolist()
    recv = send.new_empty((sum(out_splits),) + tuple(send.shape[1:]))
    dist.all_to_all_single(recv, send, output_split_sizes=out_splits,
                           input_split_sizes=in_splits)
    row = send.element_size() * math.prod(send.shape[1:])
    return recv, sum(in_splits) * row, sum(out_splits) * row


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago (for a rank 0 to
    listen on)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs, env: dict | None = None,
              timeout: float = 600.0) -> list[tuple[int, str]]:
    """Start one process per argv (``env`` added to this process's
    environment), wait for all, and return each one's (exit code, output
    with stderr merged). Each rank writes to a file of its own, so a rank
    that writes a lot never blocks while its peers wait for it in a
    collective. ``timeout`` (seconds) is one deadline for the whole call:
    past it this raises ``subprocess.TimeoutExpired``. A rank still
    running when this returns or raises is killed: a rank whose peer died
    must not outlive the caller."""
    env = dict(os.environ, **(env or {}))
    deadline = time.monotonic() + timeout
    procs = []
    with tempfile.TemporaryDirectory(prefix="nstpu_ranks_") as d:
        outs = [os.path.join(d, f"rank_{r}.log") for r in range(len(argvs))]
        try:
            for a, path in zip(argvs, outs):
                with open(path, "wb") as f:
                    procs.append(subprocess.Popen(
                        a, env=env, stdout=f, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        res = []
        for p, path in zip(procs, outs):
            with open(path, encoding="utf-8", errors="replace") as f:
                res.append((p.returncode, f.read()))
    return res
