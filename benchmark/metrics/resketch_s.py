"""Seconds per job of the candidate graph's recovery pass (the span
``graph.resketch``, ``stage_s``: the k=17 sketch and the second join),
0 in a job whose first join was dense enough (``resketch_fired`` 0). A
program without the counter reports nothing."""

NAME = "resketch_s"
UNIT = "s"
LAYER = "join, components, screen"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "resketch_fired" in j["pipe_split"]]
    if not jobs:
        return None
    return sum(j["stage_s"].get("graph.resketch", 0.0)
               for j in jobs) / len(jobs)
