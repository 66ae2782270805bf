"""The whole serving step's model FLOPs (``counts.decode_flops`` at each
live row's real context) over the traced window, as a share of the bf16
peak, in percent."""
from perfbench import counts


def read(run):
    flops = run.samples.get("traced_step_flops")
    if run.trace is None or not flops:
        return None
    return 100.0 * sum(flops) / (run.trace.window_s * counts.PEAK_BF16_FLOPS)
