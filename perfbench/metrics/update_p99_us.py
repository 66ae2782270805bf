"""99th percentile, over every update of the window, of the time from the
client's call to its acknowledgement (host clock), in microseconds."""
from perfbench.harness import percentile


def read(run):
    p = percentile(run.samples.get("update_s", []), 99)
    return None if p is None else p * 1e6
