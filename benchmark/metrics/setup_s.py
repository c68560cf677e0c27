"""Seconds from the process's start to the window's: importing the port,
loading or building its libraries, making the data, warming up."""

NAME = "setup_s"
UNIT = "s"
LAYER = None
MOVES = None


def read(record: dict):
    return record["setup_s"]
