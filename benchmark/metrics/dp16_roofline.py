"""The banded DP kernel's share of its roofline: the least time of the
rows and pairs the window's jobs sent to it (``dp_kernel_rows``,
``dp_kernel_pairs``; ``roofline.dp16_bound_s``) over the traced time of
the device events named ``banded_dp16``."""

import roofline

NAME = "dp16_roofline"
UNIT = "%"
LAYER = "device DP"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    peaks = record.get("peaks")
    spent = sum(s for n, s in record.get("device_s", {}).items()
                if "banded_dp16" in n)
    if not peaks or spent <= 0:
        return None
    bound = sum(roofline.dp16_bound_s(j["dp_info"].get("dp_kernel_rows", 0),
                                      j["dp_info"].get("dp_kernel_pairs", 0),
                                      peaks)
                for j in record["jobs"])
    return 100.0 * bound / spent
