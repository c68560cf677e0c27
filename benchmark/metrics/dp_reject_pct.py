"""Share of the engine's DP pairs that the DP rejected (``dp_rejects``
over ``dp_pairs``): rejected reads go lone, which costs ratio."""

NAME = "dp_reject_pct"
UNIT = "%"
LAYER = "grow engine"
MOVES = "ratio"


def read(record: dict):
    pairs = sum(j["pipe_split"].get("dp_pairs", 0.0) for j in record["jobs"])
    rej = sum(j["pipe_split"].get("dp_rejects", 0.0) for j in record["jobs"])
    return 100.0 * rej / pairs if pairs else None
