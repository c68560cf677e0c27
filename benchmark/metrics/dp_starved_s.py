"""Seconds per job that the grow engine's DP thread waited on an empty
queue (``pipe_split["dp_starved"]``): placement and apply had no batch
ready for the device DP."""

NAME = "dp_starved_s"
UNIT = "s"
LAYER = "grow engine"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "dp_starved" in j["pipe_split"]]
    if not jobs:
        return None
    return sum(j["pipe_split"]["dp_starved"] for j in jobs) / len(jobs)
