"""Seconds per job in the engine's DP stage (``pipe_split`` ``dp``): the
device hook's copies, launches and checks around ``banded_dp16``."""

NAME = "dp_s"
UNIT = "s"
LAYER = "device DP"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "dp" in j["pipe_split"]]
    if not jobs:
        return None
    return sum(j["pipe_split"]["dp"] for j in jobs) / len(jobs)
