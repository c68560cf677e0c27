"""Share of the window's nsbwt bytes whose suffix array the card built:
100 x ``stage_s["bwt_card_bytes"]`` over that plus
``stage_s["bwt_host_bytes"]``, summed over the jobs (plain and LZP
variants of every block both count). A program without the counters
reports nothing."""

NAME = "bwt_card_pct"
UNIT = "%"
LAYER = "emit, serialize, codecs, archive"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j["stage_s"] for j in record["jobs"]
            if "bwt_card_bytes" in j["stage_s"]]
    card = sum(s["bwt_card_bytes"] for s in jobs)
    host = sum(s.get("bwt_host_bytes", 0.0) for s in jobs)
    if card + host <= 0:
        return None
    return 100.0 * card / (card + host)
