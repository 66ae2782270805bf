"""Median host ms of the window's ``update_batch`` calls that the fused
driver took (its ``fused_batches`` counter rose)."""
from perfbench.harness import median


def read(run):
    m = median(run.samples.get("fused_batch_s", []))
    return None if m is None else m * 1e3
