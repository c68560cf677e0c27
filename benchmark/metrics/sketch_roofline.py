"""The sketch kernel's share of its roofline: the least time of the
window's sketch passes (``roofline.sketch_bound_s``: 2 multiplies per
(k-mer, seed) against the packed bases in and the rows out) over the
traced time of the device events named ``sketch_kernel``."""

import roofline

NAME = "sketch_roofline"
UNIT = "%"
LAYER = "sketch"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    peaks = record.get("peaks")
    spent = sum(s for n, s in record.get("device_s", {}).items()
                if "sketch_kernel" in n)
    if not peaks or spent <= 0:
        return None
    lens = record["lengths"]
    bound = sum(roofline.sketch_bound_s(
        roofline.kmers(lens, c["k"], c["min_len"]), len(lens),
        int(lens.sum()), c["num_hashes"], peaks)
        for j in record["jobs"] for c in j["sketch_calls"])
    return 100.0 * bound / spent
