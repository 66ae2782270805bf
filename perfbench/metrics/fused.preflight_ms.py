"""Median host ms of a fused batch's ``fused.preflight`` stage: routing,
RIFL prediction and the rings' ``ensure`` (the program's span, over the
benchmark's ``update_batch`` calls that the fused driver took)."""
from perfbench.program_spans import fused_stage_ms


def read(run):
    return fused_stage_ms(run, "fused.preflight")
