"""K3 ``gang_fastpath`` with its K2 record stage: the least time its bytes
take at the HBM rate, over its device time a call, in percent.  Bytes a
call: ``counts.fastpath_bytes`` of each call's own operands and verdicts;
time a call: the device time of the K3 and K2 launches that start inside
the ``gang_fastpath`` spans the benchmark sets around each call, over the
calls (a K2 launched on its own, outside a fused call, is not counted)."""
from perfbench import counts


def read(run):
    b = run.samples.get("gang_fastpath_bytes")
    if run.trace is None or not b:
        return None
    spans = run.trace.spans("gang_fastpath")
    t = run.trace.kernel_within(("gang_fastpath_kernel", "gang_record_kernel"),
                                spans)
    if not spans or t <= 0:
        return None
    return 100.0 * (sum(b) / len(b) / counts.PEAK_HBM_BYTES) / (t / len(spans))
