"""On the card, at the cells' own sizes: a short run of each KV cell is
correct and its control is not.  Skipped without a CUDA device; the serving
cell's control readings come from ``perfbench/control.py``."""
from __future__ import annotations

import pytest

from perfbench import run as bench_run

KV_CELLS = ["ycsb-a.batched", "ycsb-a.lone", "ycsb-b.batched"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", KV_CELLS)
def test_kv_cell_on_the_card_is_correct(card, workload):
    result, run = bench_run.execute(workload, 2**31 + 41, 3.0, False)
    assert run.correct, result["compared"]
    assert result["device"]["kind"] == card


@pytest.mark.gpu
@pytest.mark.parametrize("workload", KV_CELLS)
def test_kv_control_on_the_card_is_not_correct(card, workload):
    result, run = bench_run.execute(workload, 2**31 + 43, 3.0, False,
                                    control=True)
    assert not run.correct
    assert result["compared"]["outcome_mismatches"]["value"] > 0
