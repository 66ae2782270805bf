"""The readers of the program's own spans (``perfbench/program_spans.py``
and the metrics that read it), over traced runs on the CPU at a small size:
every new metric reads a number in its cells, and the fused batch's five
stages account for its time."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT, small_hymba, small_kv
from perfbench import harness
from perfbench.program_spans import per_outer

FUSED = ["fused.preflight_ms", "fused.kernel_ms", "fused.settle_ms",
         "fused.master_ms", "fused.drain_ms"]
NEW = {
    "ycsb-a.batched": FUSED + ["sync.rounds_per_read",
                               "device.host_waits_per_op.batched"],
    "ycsb-a.lone": ["device.host_waits_per_op.lone", "update.record_us",
                    "update.master_us", "update.drain_us"],
    "hymba.decode": ["serve.encode_ms"],
}
PROGRAM_PREFIXES = ("fused.", "shard.", "witness.", "kernels.", "serve.",
                    "recovery.")


def traced_run(workload, round_ops=None):
    """One traced run on the CPU; KV rounds cut to ``round_ops`` so that a
    short window holds tens of fused batches."""
    resolved = harness.resolve_cell(harness.load_bench(), workload)
    if workload.startswith("hymba"):
        resolved["config"] = small_hymba(resolved["config"])
    else:
        resolved["config"] = small_kv(resolved["config"], 4)
    if round_ops:
        resolved["traffic"] = dict(resolved["traffic"], round_ops=round_ops)
    run = harness.Run(workload, resolved, 2**31 + 29, 2.0, True, "cpu")
    harness.entry_module(resolved["traffic"]).run(run)
    assert run.correct and run.trace is not None
    return run


@pytest.fixture(scope="module")
def runs():
    return {"ycsb-a.batched": traced_run("ycsb-a.batched", 256),
            "ycsb-a.lone": traced_run("ycsb-a.lone"),
            "hymba.decode": traced_run("hymba.decode")}


def read(name, run):
    return harness.metric_reader(name)(run)


def test_the_new_metrics_are_listed_in_their_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, names in NEW.items():
        per_layer = harness.resolve_cell(bench, cell)["per_layer"]
        listed = {m["name"] for m in per_layer
                  if m["source"] == "program_span"}
        assert listed == set(names)


@pytest.mark.parametrize("cell, name", [(c, n) for c, ns in NEW.items()
                                        for n in ns])
def test_every_new_metric_reads_a_number(runs, cell, name):
    v = read(name, runs[cell])
    assert v is not None and v >= 0


@pytest.mark.parametrize("cell, name", [(c, n) for c, ns in NEW.items()
                                        for n in ns])
def test_a_trace_without_the_program_spans_reads_nothing(runs, cell, name):
    """The parent's program opens none of these spans: its traced run
    keeps the benchmark's spans alone, and each new metric is left out."""
    run = runs[cell]
    bench_spans = {"update_batch", "reads", "update", "crash_master",
                   "gang_fastpath", "gang_record_groups", "decode",
                   "commit"}
    full = run.trace.host_spans
    try:
        run.trace.host_spans = [s for s in full if s[0] in bench_spans]
        assert read(name, run) is None
    finally:
        run.trace.host_spans = full


def test_the_five_stages_sum_to_the_fused_batch(runs):
    run = runs["ycsb-a.batched"]
    stages = sum(read(n, run) for n in FUSED)
    batch = read("fused.batch_ms", run)
    assert abs(stages - batch) <= 0.05 * batch
    # and inside each fused call they leave almost nothing uncovered
    calls = run.trace.spans("update_batch")
    inner = [per_outer(calls, run.trace.spans(n[:-3])) for n in FUSED]
    for k, (a, b) in enumerate(calls):
        if inner[1][k][0]:
            assert sum(c[k][1] for c in inner) >= 0.95 * (b - a)


def test_a_lone_update_is_its_parts(runs):
    run = runs["ycsb-a.lone"]
    parts = sum(read(n, run) for n in NEW["ycsb-a.lone"][1:])
    updates = run.samples["update_s"]
    assert 0 < parts <= sum(updates) / len(updates) * 1e6


@pytest.mark.parametrize("cell", sorted(NEW))
def test_the_breakdown_names_program_spans(runs, cell):
    """On the CPU there is no device trace: the breakdown is taken with a
    device operation at each blocking copy to the host and each decode
    replay, where the card's work ends on a card."""
    tr = runs[cell].trace
    view = harness.TraceView.__new__(harness.TraceView)
    view.window_s, view.host_spans = tr.window_s, tr.host_spans
    view.device_ops = sorted(
        (n, a, b) for n, a, b in tr.host_spans
        if n in ("kernels.host_wait", "decode"))
    gaps = dict(view.breakdown(top=100)["idle_gaps"])
    named = {n for n in gaps if n.startswith(PROGRAM_PREFIXES)}
    assert named
    if cell == "ycsb-a.batched":
        inside = sum(gaps[n] for n in named) + gaps.get("update_batch", 0)
        assert gaps.get("update_batch", 0) <= 0.10 * inside
