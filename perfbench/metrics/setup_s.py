"""Set-up: loading, building and warming up, up to the window (host clock)."""


def read(run):
    return run.values.get("setup_s")
