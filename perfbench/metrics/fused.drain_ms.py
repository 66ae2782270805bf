"""Median host ms of a fused batch's ``fused.drain`` stage: the rings'
bookkeeping and each shard's sync and gc rounds (the program's span, over
the benchmark's ``update_batch`` calls that the fused driver took)."""
from perfbench.program_spans import fused_stage_ms


def read(run):
    return fused_stage_ms(run, "fused.drain")
