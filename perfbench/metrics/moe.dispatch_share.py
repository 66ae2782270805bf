"""Share of the rows the MoE dispatch multiplies that carry a live pick,
over the window, in percent: the program's ``moe.routed`` (live
token-expert picks: live rows x top-k x MoE layers, the driver's count at
each step) over ``moe.rows_computed`` (the rows the step's dispatch
buffers hold, E x C an MoE layer in the capacity dispatch, as the step
was built; the driver's count at each step).  A program without the
counters leaves the metric out."""


def read(run):
    rows = run.counts.get("moe.rows_computed")
    if not rows or "moe.routed" not in run.counts:
        return None
    return 100.0 * run.counts["moe.routed"] / rows
