"""Seconds per job in the port's sketch-join, components and screen
(``pipe_split``: ``sketch_join`` + ``components`` + ``screen``; the
sketch pass itself is inside ``sketch_join``)."""

NAME = "join_s"
UNIT = "s"
LAYER = "join, components, screen"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(sum(j["pipe_split"].get(k, 0.0) for k in
                   ("sketch_join", "components", "screen"))
               for j in jobs) / len(jobs)
