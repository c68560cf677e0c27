"""Seconds per job in the port's ``serialize`` and ``codec+archive``
stages (streams, host codecs, the archive)."""

NAME = "codec_s"
UNIT = "s"
LAYER = "emit, serialize, codecs, archive"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(j["stage_s"].get("serialize", 0.0)
               + j["stage_s"].get("codec+archive", 0.0)
               for j in jobs) / len(jobs)
