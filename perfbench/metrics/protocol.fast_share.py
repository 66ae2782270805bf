"""Share of the window's updates acknowledged in 1 RTT (the program's
``OpOutcome.fast_path``), in percent."""


def read(run):
    n = run.counts.get("updates")
    return 100.0 * run.counts["fast_updates"] / n if n else None
