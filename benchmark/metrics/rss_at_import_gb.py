"""High-water resident memory right after importing the port and torch
and making the CUDA context, before any data or job."""

NAME = "rss_at_import_gb"
UNIT = "GB"
LAYER = "process start"
MOVES = "peak_host_gb"


def read(record: dict):
    return record["rss_at_import_gb"]
