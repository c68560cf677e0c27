"""Seconds per job in the grow engine's call (``pipe_split``
``engine_wall``: placement, DP, apply and polish)."""

NAME = "grow_s"
UNIT = "s"
LAYER = "grow engine"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "engine_wall" in j["pipe_split"]]
    if not jobs:
        return None
    return sum(j["pipe_split"]["engine_wall"] for j in jobs) / len(jobs)
