"""Seconds per job in the port's ``load_reads`` stage (FASTQ scan and
2-bit packing)."""

NAME = "load_s"
UNIT = "s"
LAYER = "load and pack"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(j["stage_s"].get("load_reads", 0.0) for j in jobs) / len(jobs)
