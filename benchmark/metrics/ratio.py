"""Compression ratio: the window's bases over the summed bytes of the
archives its jobs wrote."""

NAME = "ratio"
UNIT = "base/B"
LAYER = None
MOVES = None


def read(record: dict):
    out = sum(j["archive_bytes"] for j in record["jobs"])
    return sum(j["bases"] for j in record["jobs"]) / out if out else None
