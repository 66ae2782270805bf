"""Tokens generated and committed over the whole window, by the host
clock."""


def read(run):
    if not run.counts.get("tokens"):
        return None
    return run.counts["tokens"] / run.values["window_s"]
