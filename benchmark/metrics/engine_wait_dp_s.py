"""Seconds per job that the grow engine's main thread was blocked on an
unfinished DP batch (``pipe_split["engine_wait_dp"]``)."""

NAME = "engine_wait_dp_s"
UNIT = "s"
LAYER = "grow engine"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "engine_wait_dp" in j["pipe_split"]]
    if not jobs:
        return None
    return sum(j["pipe_split"]["engine_wait_dp"] for j in jobs) / len(jobs)
