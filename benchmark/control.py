"""The control of a cell's check: one run of the cell whose sketch rows
and device DP outputs are replaced, before they are judged, by the
reference's own worked out one precision down (16-bit hashes, 8-bit DP
cells; ``reference.py``). Its numbers are the upper readings that the
check's limits are set against; a sound check reads ``correct`` false.

    python benchmark/control.py --workload <cell> --seed <n> [--seconds 1]

It prints the run's result line, whose ``checks`` are the control's
readings. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    return run.emit(a.workload, a.seed, a.seconds, False, control=True)


if __name__ == "__main__":
    sys.exit(main())
