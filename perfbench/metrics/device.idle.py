"""The card's idle share over the traced window, in percent: 1 - the
union of every device operation's time (kernels, copies, fills) over the
window's host-clock length.  Reads ``device.idle.<cell kind>`` for every
kind; each name moves the end-to-end metric of its own cells."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.idle_share
