"""Blocking waits for the card an operation: the program's
``kernels.host_wait`` spans (one a copy of an op's results to the host, the
round trip every gang and table op ends in) over the window's operations.
Reads ``device.host_waits_per_op.<cell kind>`` for every kind; each name
moves the end-to-end metric of its own cells."""
from perfbench.program_spans import spans


def read(run):
    waits = spans(run, "kernels.host_wait")
    n = run.counts.get("ops")
    if not waits or not n:
        return None
    return len(waits) / n
