"""Share of the latent slots the MLA decode attention reads that hold a
live row's context, over the window, in percent: the program's
``mla.slots_live`` (each live row's context x MLA layers, the driver's
count at each step) over ``mla.slots_read`` (every row's whole latent
cache x MLA layers, as the step was built; the driver's count at each
step).  A program without the counters leaves the metric out."""


def read(run):
    slots = run.counts.get("mla.slots_read")
    if not slots or "mla.slots_live" not in run.counts:
        return None
    return 100.0 * run.counts["mla.slots_live"] / slots
