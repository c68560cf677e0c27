"""High-water resident memory of the process that ran the jobs
(``ru_maxrss``), read when the window ends."""

NAME = "peak_host_gb"
UNIT = "GB"
LAYER = None
MOVES = None


def read(record: dict):
    return record["peak_host_gb"]
