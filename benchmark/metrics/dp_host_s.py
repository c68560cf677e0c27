"""Seconds per job of the DP thread's host work on the device route: the
engine's DP stage (``pipe_split["dp"]``) less the kernel's device seconds
by CUDA events (``dp_info["dp_kernel_event_s"]``): packing, the hook's
copies and checks, trace expansion and the pairs the kernel did not
take."""

NAME = "dp_host_s"
UNIT = "s"
LAYER = "device DP"
MOVES = "compress_mbase_per_s"


def read(record: dict):
    jobs = [j for j in record["jobs"] if "dp" in j["pipe_split"]
            and "dp_kernel_event_s" in j["dp_info"]]
    if not jobs:
        return None
    return sum(j["pipe_split"]["dp"] - j["dp_info"]["dp_kernel_event_s"]
               for j in jobs) / len(jobs)
