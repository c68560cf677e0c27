"""Host seconds per job of the escalated full-band retries
(``pipe_split["retry_dp_s"]``): the DP of each band reject placed again
at the full band, on the host's scalar DP, summed over its threads. A
program without the counter reports nothing."""

NAME = "retry_dp_s"
UNIT = "s"
LAYER = "grow engine"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "retry_dp_s" in j["pipe_split"]]
    if not jobs:
        return None
    return sum(j["pipe_split"]["retry_dp_s"] for j in jobs) / len(jobs)
