"""Bases compressed per second of the window: every job's bases (counted
from the generated reads) over the window's wall time, first job's start
to last job's end."""

NAME = "compress_mbase_per_s"
UNIT = "Mbase/s"
LAYER = None
MOVES = None


def read(record: dict):
    if not record["jobs"] or record["window_s"] <= 0:
        return None
    return sum(j["bases"] for j in record["jobs"]) / record["window_s"] / 1e6
