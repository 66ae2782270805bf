"""Sync rounds a read runs: the program's ``shard.sync_round`` spans inside
the benchmark's ``reads`` spans, over the window's reads (``ops`` -
``updates``).  A read of a key with an unsynced update drains its shard's
syncs first; each round is a backup sync and a ``gc_many`` round."""
from perfbench.program_spans import per_outer, spans


def read(run):
    calls, rounds = spans(run, "reads"), spans(run, "shard.sync_round")
    reads = run.counts.get("ops", 0) - run.counts.get("updates", 0)
    if not calls or not rounds or reads <= 0:
        return None
    return sum(n for n, _t in per_outer(calls, rounds)) / reads
