"""99th percentile over every gap between two successive tokens of a
session in the window, the step's commit included (host clock), in ms."""
from perfbench.harness import percentile


def read(run):
    p = percentile(run.samples.get("token_gap_s", []), 99)
    return None if p is None else p * 1e3
