"""The decode graph (PyTorch's own kernels, one replay a step): the least
bytes a step must move (``counts.decode_bytes`` at each live row's real
context) at the HBM rate, over ``serve.decode_ms``, in percent."""
from perfbench import counts


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans("decode")
    steps = run.samples.get("traced_step_bytes")
    if not spans or not steps:
        return None
    t = run.trace.device_s_within(spans) / len(spans)
    return 100.0 * (sum(steps) / len(steps) / counts.PEAK_HBM_BYTES) / t
