"""Mean us a lone update spends in its master round: the program's
``shard.master_round`` spans inside the benchmark's ``update`` calls, their
total over the updates (so a sync is spread over the updates, not lost in a
median of 0)."""
from perfbench.program_spans import update_us


def read(run):
    return update_us(run, "shard.master_round")
