"""Seconds per job in emit (``pipe_split["emit"]``, around the
``emit.fetch``, ``emit.unpack`` and ``emit.scripts`` spans): the engine's
contigs fetched, the members' bases unpacked, and edit scripts made."""

NAME = "emit_s"
UNIT = "s"
LAYER = "emit, serialize, codecs, archive"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "emit" in j["pipe_split"]]
    if not jobs:
        return None
    return sum(j["pipe_split"]["emit"] for j in jobs) / len(jobs)
