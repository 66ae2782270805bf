"""Metric arithmetic, the yardstick's counts at hand-worked shapes, and
the loader finding a configuration, traffic mix and metric added as new
files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from conftest import ROOT, small_kv
from perfbench import counts, harness
from perfbench import run as bench_run


class FakeRun:
    def __init__(self, **kw):
        self.samples, self.counts, self.values = {}, {}, {}
        self.trace, self.device = None, "cuda"
        self.__dict__.update(kw)


def read(name, run):
    return harness.metric_reader(name)(run)


def test_percentile_is_over_every_sample():
    xs = list(range(1, 1001))
    assert harness.percentile(xs, 99) == 990
    assert harness.percentile(xs[::-1], 50) == 500
    assert harness.percentile([7.0], 99) == 7.0
    assert harness.percentile([], 99) is None
    run = FakeRun(samples={"update_s": [i * 1e-6 for i in range(1, 1001)]})
    assert read("update_p99_us", run) == pytest.approx(990.0)
    run = FakeRun(samples={"token_gap_s": [0.01] * 98 + [0.5, 0.7]})
    assert read("token_gap_p99_ms", run) == pytest.approx(500.0)


def test_rates_are_over_the_whole_window():
    run = FakeRun(counts={"ops": 1000}, values={"window_s": 4.0})
    assert read("ops_per_s", run) == 250.0
    run = FakeRun(counts={"tokens": 80}, values={"window_s": 0.5})
    assert read("tokens_per_s", run) == 160.0
    assert read("ops_per_s", FakeRun(values={"window_s": 1.0})) is None


def _trace(ops, spans, window_s):
    t = harness.TraceView.__new__(harness.TraceView)
    t.device_ops, t.host_spans, t.window_s = ops, spans, window_s
    return t


def test_trace_arithmetic():
    ms = 1_000_000
    t = _trace([("k1", 0, 2 * ms), ("k2", 1 * ms, 3 * ms),
                ("k1", 10 * ms, 11 * ms)],
               [("decode", 0, 4 * ms), ("commit", 4 * ms, 12 * ms)], 0.02)
    assert t.busy_s == pytest.approx(0.004)
    assert t.idle_share == pytest.approx(0.8)
    assert t.kernel("k1") == pytest.approx([0.002, 0.001])
    assert t.device_s_within(t.spans("decode")) == pytest.approx(0.003)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(0.003)]
    assert b["idle_gaps"] == [["commit", pytest.approx(0.007)]]
    run = FakeRun(trace=t)
    for cells in ("batched", "lone", "serve"):
        assert read(f"device.idle.{cells}", run) == pytest.approx(80.0)


def test_launches_inside_spans_only():
    ms = 1_000_000
    t = _trace([("gang_fastpath_kernel", 1 * ms, 2 * ms),
                ("gang_record_kernel", 2 * ms, 4 * ms),
                ("Memcpy DtoH", 4 * ms, 5 * ms),
                ("gang_record_kernel", 8 * ms, 11 * ms)],
               [("gang_fastpath", 0, 6 * ms)], 0.02)
    parts = ("gang_fastpath_kernel", "gang_record_kernel")
    # The K2 launch at 8 ms lies outside every fused call's span.
    assert t.kernel_within(parts, t.spans("gang_fastpath")) \
        == pytest.approx(0.003)
    run = FakeRun(trace=t, samples={"gang_fastpath_bytes": [3.35e6]})
    # 1 us of bytes at the HBM rate over 3 ms a call
    assert read("gang_fastpath_roofline", run) == pytest.approx(100 / 3000)


def test_an_idle_share_is_not_clamped():
    t = _trace([("k", 0, 30_000_000)], [], 0.02)
    assert t.idle_share == pytest.approx(-0.5)


def test_fastpath_bytes_by_hand():
    b = counts.fastpath_bytes(
        n_ops=2, f=1, n_shards=1, n_slots=4, n_classes=1, live_ring=3,
        appends=2, rows=np.array([5, 5]), row_lanes=np.array([0, 0]),
        reasons=np.array([1, 3]), n_ways=4)
    # operands 48, slot map 16, lane map/tail/count 12, class row 4, ring
    # span 36, appends and counts 28, outputs 40, one probed row 80, one
    # inserted occ 4, two counters 16
    assert b == 284


def test_groups_bytes_by_hand():
    b = counts.groups_bytes(key_valid=np.array([[True]]),
                            rows=np.array([9]), lanes=np.array([2]),
                            reasons=np.array([1]), n_ways=4)
    assert b == 20 + 16 + 80 + 4 + 8


TINY = dict(d_model=2, d_head=1, n_heads=2, n_kv_heads=1, d_ff=1,
            ssm_expand=1, ssm_head_dim=2, ssm_state=1, ssm_conv=2, vocab=3,
            n_layers=2, global_attn_layers=[0], swa_window=2)


def test_decode_counts_by_hand():
    assert counts.matmul_params(TINY) == 120
    # weights 240, embedding row 4, cached K/V 12, new K/V 8, states 48,
    # logits 12
    assert counts.decode_bytes(TINY, [3]) == 324
    # 2 x 120, attention 4 x 2 x (3 + 2), SSM 2 x 6 x 2
    assert counts.decode_flops(TINY, [3]) == 304


def test_the_loader_finds_files_added_by_name(tmp_path: Path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    src = json.loads((ROOT / "perfbench/configs/kv-ycsb-64x3.json")
                     .read_text())
    cfg = small_kv(src, 4, 3000)
    cfg["name"] = "kv-ycsb-4x3"
    (tmp_path / "perfbench/configs/kv-ycsb-4x3.json").write_text(
        json.dumps(cfg))
    (tmp_path / "perfbench/traffic/ycsb-d.batched.json").write_text(
        json.dumps({"entry": "kv", "mode": "batched", "round_ops": 128,
                    "read_share": 0.9, "crash_at": None}))
    (tmp_path / "perfbench/metrics/kv.rounds.py").write_text(
        "def read(run):\n    return run.counts.get('rounds')\n")
    # a metric with no file of its own, read by its prefix's
    bench["per_layer"].append({
        "name": "kv.rounds.new", "unit": "rounds", "better": "higher",
        "source": "program_counter", "layer": "core.shard",
        "moves": "ops_per_s", "workloads": ["new.cell"]})
    bench["configs"].append({
        "name": "kv-ycsb-4x3", "source": "https://example.org/x",
        "file": "perfbench/configs/kv-ycsb-4x3.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "new.cell", "config": "kv-ycsb-4x3",
        "traffic": "ycsb-d.batched", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("new.cell")
    bench["per_layer"].append({
        "name": "kv.rounds", "unit": "rounds", "better": "higher",
        "source": "program_counter", "layer": "core.shard",
        "moves": "ops_per_s", "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res, run = bench_run.execute("new.cell", 3, 0.5, False, device="cpu",
                                 root=tmp_path)
    assert run.correct
    assert set(res["metrics"]) == {"ops_per_s", "setup_s"}
    per_layer = harness.resolve_cell(harness.load_bench(tmp_path),
                                     "new.cell", tmp_path)["per_layer"]
    got = harness.read_metrics(run, per_layer, tmp_path)
    assert got["kv.rounds"]["value"] == run.counts["rounds"] > 0
    assert got["kv.rounds.new"] == got["kv.rounds"]
