"""Seconds per job of the slowest codec chunk job
(``stage_s["codec_longest_chunk_s"]``): the floor under the codec stage
at any number of threads."""

NAME = "codec_longest_chunk_s"
UNIT = "s"
LAYER = "emit, serialize, codecs, archive"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"]
            if "codec_longest_chunk_s" in j["stage_s"]]
    if not jobs:
        return None
    return sum(j["stage_s"]["codec_longest_chunk_s"]
               for j in jobs) / len(jobs)
