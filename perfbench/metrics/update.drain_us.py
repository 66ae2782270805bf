"""Mean us a lone update spends in its syncs (every ``sync_batch`` updates
a shard drains): the program's ``shard.drain`` spans inside the benchmark's
``update`` calls, their total over the updates (so a sync is spread over
the updates, not lost in a median of 0)."""
from perfbench.program_spans import update_us


def read(run):
    return update_us(run, "shard.drain")
