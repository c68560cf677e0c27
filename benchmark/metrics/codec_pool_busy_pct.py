"""How full the codec pool was, per job: the chunk jobs' summed seconds
(``stage_s["codec_chunk_s"]``) over the pool's threads
(``stage_s["codec_threads"]``) times the ``codec+archive`` stage."""

NAME = "codec_pool_busy_pct"
UNIT = "%"
LAYER = "emit, serialize, codecs, archive"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j["stage_s"] for j in record["jobs"]
            if "codec_chunk_s" in j["stage_s"]
            and j["stage_s"].get("codec_threads", 0) > 0
            and j["stage_s"].get("codec+archive", 0) > 0]
    if not jobs:
        return None
    return sum(100.0 * s["codec_chunk_s"]
               / (s["codec_threads"] * s["codec+archive"])
               for s in jobs) / len(jobs)
