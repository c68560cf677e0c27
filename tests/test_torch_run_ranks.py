"""``parallel.mesh.run_ranks`` drains every rank's output at once: a rank
that writes more than a pipe holds before a collective must not stall its
peers, which wait for it there, until the deadline."""

import os
import subprocess
import sys
import time

import pytest

from nanospring_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = r"""
import sys
from nanospring_tpu_torch.parallel import mesh

world, rank, port = map(int, sys.argv[1:4])
group = mesh.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
if rank == world - 1:
    sys.stdout.write("x" * (256 << 10) + "\n")
    sys.stdout.flush()
mesh.barrier(group)
mesh.shutdown()
print(f"rank {rank} done")
"""


def test_rank_filling_its_pipe_before_a_barrier():
    port = mesh.free_port()
    t0 = time.monotonic()
    ranks = mesh.run_ranks(
        [[sys.executable, "-c", RANK, "2", str(r), str(port)]
         for r in range(2)], env={"PYTHONPATH": REPO}, timeout=60)
    assert time.monotonic() - t0 < 60
    for r, (rc, out) in enumerate(ranks):
        assert rc == 0, out[-2000:]
        assert f"rank {r} done" in out
    assert ranks[1][1].count("x") == 256 << 10


def test_one_deadline_for_all_ranks():
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        mesh.run_ranks([[sys.executable, "-c", "import time; time.sleep(60)"]]
                       * 3, timeout=2)
    # the ranks share the deadline, and none outlives the call
    assert time.monotonic() - t0 < 10
