"""KV operations acknowledged (reads and updates) over the whole window,
by the host clock."""


def read(run):
    if not run.counts.get("ops"):
        return None
    return run.counts["ops"] / run.values["window_s"]
