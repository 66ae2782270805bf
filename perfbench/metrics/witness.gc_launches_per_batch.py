"""K4 ``gang_gc`` launches in the window per fused batch, from the
program's launch counters (``kernels.ops.GANG_GC.launches``)."""


def read(run):
    n = run.counts.get("fused_batches")
    if not n or run.device != "cuda":
        return None
    return run.counts["gc_launches"] / n
