"""K5 ``gang_groups``, the record kernel each lone update launches at each
witness: the least time its bytes take at the HBM rate, over its device
time a call, in percent (``counts.groups_bytes``; the device time of the
K5 launches that start inside the ``gang_record_groups`` spans the
benchmark sets around each call, over the calls)."""
from perfbench import counts


def read(run):
    b = run.samples.get("gang_groups_bytes")
    if run.trace is None or not b:
        return None
    spans = run.trace.spans("gang_record_groups")
    t = run.trace.kernel_within(("gang_groups_kernel",), spans)
    if not spans or t <= 0:
        return None
    return 100.0 * (sum(b) / len(b) / counts.PEAK_HBM_BYTES) / (t / len(spans))
