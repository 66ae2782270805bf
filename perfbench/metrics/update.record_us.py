"""Mean us a lone update spends in its f witness records: the program's
``witness.record`` spans inside the benchmark's ``update`` calls, their
total over the updates (so a sync is spread over the updates, not lost in a
median of 0)."""
from perfbench.program_spans import update_us


def read(run):
    return update_us(run, "witness.record")
