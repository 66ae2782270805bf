"""Host ms of the window's master crash and recovery
(``ShardedCluster.crash_master``)."""


def read(run):
    s = run.samples.get("recovery_s")
    return s[0] * 1e3 if s else None
