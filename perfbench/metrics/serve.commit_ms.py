"""Median host ms a decode step spends in ``CurpSessionStore.commit_batch``
(timed by a wrapper the benchmark sets on the driver's store in the traced
run)."""
from perfbench.harness import median


def read(run):
    m = median(run.samples.get("commit_s", []))
    return None if m is None else m * 1e3
