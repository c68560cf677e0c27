"""Share of the window's bases stored lone: 100 x ``stage_s["lone_bases"]``
over the jobs' bases, summed over the jobs. Lone reads go to the ``lone``
stream whole, which costs ratio. A program without the counter reports
nothing."""

NAME = "lone_base_pct"
UNIT = "%"
LAYER = "grow engine"
MOVES = "ratio"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "lone_bases" in j["stage_s"]]
    bases = sum(j["bases"] for j in jobs)
    if not bases:
        return None
    return 100.0 * sum(j["stage_s"]["lone_bases"] for j in jobs) / bases
