"""The port's wall-clock spans (``repro_torch.core.telemetry.span``).

Each span is read as the benchmark's trace reads it: the host events of
``prof.profiler.kineto_results.events()`` that are user annotations.  The
clusters use the device witness backend on the CPU, where the gang ops run
their plain versions and still end in ``kernels.ops._to_host``.
"""
import re
import tracemalloc
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.kernels.ops as kops
from repro_torch.configs import ARCHS
from repro_torch.core import ShardedCluster, telemetry
from repro_torch.models.config import reduced
from repro_torch.serving import CurpServeDriver, ServeConfig

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# The spans the benchmark sets around its calls into the program.
BENCHMARK_SPANS = {"update_batch", "reads", "update", "crash_master",
                   "gang_fastpath", "gang_record_groups", "decode", "commit"}
PROGRAM_SPANS = {
    "fused.preflight", "fused.kernel", "fused.settle", "fused.master",
    "fused.drain", "shard.update", "shard.master_round", "witness.record",
    "shard.drain", "shard.sync_round", "witness.gc_round",
    "kernels.host_wait", "recovery.restore", "recovery.replay",
    "recovery.sync", "recovery.witnesses", "recovery.new_witnesses",
    "serve.step", "serve.commit", "serve.commit.encode",
}
FUSED_STAGES = ["fused.preflight", "fused.kernel", "fused.settle",
                "fused.master", "fused.drain"]
F = 3


def host_spans(prof):
    """(name, start ns, end ns) of every host user annotation, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and str(e.device_type()).endswith("CPU"):
            start = int(e.start_ns())
            out.append((e.name(), start, start + int(e.duration_ns())))
    return sorted(out, key=lambda t: t[1])


def traced(fn, ops=()):
    """``fn()``'s result and its host spans, followed by the host operator
    events named in ``ops`` (as ``("op:" + name, start, end)``)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    extra = [("op:" + e.name(), int(e.start_ns()),
              int(e.start_ns()) + int(e.duration_ns()))
             for e in prof.profiler.kineto_results.events()
             if e.name() in ops and not e.is_user_annotation()]
    return result, host_spans(prof) + extra


def named(spans, name):
    return [(a, b) for n, a, b in spans if n == name]


def inside(span, outer):
    return any(a <= span[0] and span[1] <= b for a, b in outer)


# ---------------------------------------------------------------------------
# scenarios: set-up (untraced), then the call under test
# ---------------------------------------------------------------------------
def _cluster():
    return ShardedCluster(n_shards=2, f=F, sync_batch=4,
                          witness_backend="device", device="cpu")


def _loaded(n=6):
    cl = _cluster()
    s = cl.new_client()
    for i in range(n):
        cl.update(s, s.op_set(f"k{i}", f"v{i}"))
    return cl, s


def _state(cl):
    """Everything the scenario left behind that a span must not change."""
    return (
        [[(e.op.op_type, e.op.keys, e.op.args, e.op.rpc_id, e.result)
          for e in b.get_log()] for g in cl.shards for b in g.backups],
        [repr(g.master.store.snapshot()) for g in cl.shards],
        [g.master.synced_index for g in cl.shards],
    )


def batch():
    """One fused batch whose repeated keys conflict in the ring, so it
    ends in syncs and gc rounds."""
    cl = _cluster()
    s = cl.new_client()
    ops = [s.op_set(f"b{i % 5}", f"x{i}") for i in range(24)]
    return cl, lambda: cl.update_batch(s, ops)


def update():
    cl, s = _loaded(2)
    op = s.op_set("u", "1")
    return cl, lambda: cl.update(s, op)


def read():
    """A read of a key whose update is not synced yet."""
    cl, s = _loaded(0)
    cl.update(s, s.op_set("r", "1"))
    assert cl.shards[cl.shard_of("r")].master.unsynced_count > 0
    return cl, lambda: cl.read(s, s.op_get("r"))


def crash():
    cl, s = _loaded(6)
    return cl, lambda: cl.crash_master(0)


SCENARIOS = {"batch": batch, "update": update, "read": read, "crash": crash}


def _serve():
    cfg = reduced(ARCHS["llama3.2-1b"])
    d = CurpServeDriver(cfg, ServeConfig(max_batch=2, max_seq=32, f=F,
                                         witness_backend="device",
                                         device="cpu"), seed=0)
    d.submit("a", [1, 2])
    d.submit("b", [3])
    return d


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_span_without_a_profiler_is_one_shared_null(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = telemetry.span("x")
    assert all(telemetry.span(n) is first for n in PROGRAM_SPANS)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with telemetry.span("x"):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024


def test_a_span_under_a_profiler_is_a_host_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("outer"):
            with telemetry.span("inner"):
                pass
    spans = host_spans(prof)
    assert [n for n, _a, _b in spans] == ["outer", "inner"]
    assert inside(spans[1][1:], [spans[0][1:]])


def test_fused_batch_opens_five_stages_in_order():
    cl, call = batch()
    before = cl._fused.stats["fused_batches"]
    _, spans = traced(call)
    assert cl._fused.stats["fused_batches"] == before + 1
    stages = [t for t in spans if t[0] in FUSED_STAGES]
    assert [n for n, _a, _b in stages] == FUSED_STAGES
    for (_n0, _a0, b0), (_n1, a1, _b1) in zip(stages, stages[1:]):
        assert b0 <= a1
    drain = named(spans, "fused.drain")
    rounds = named(spans, "shard.sync_round")
    gcs = named(spans, "witness.gc_round")
    assert rounds and len(gcs) == len(rounds)
    assert all(inside(s, drain) for s in rounds + gcs)


@pytest.mark.parametrize("scenario, outer, inner, count", [
    ("update", None, "shard.update", 1),
    ("update", "shard.update", "witness.record", 1),
    ("update", "shard.update", "shard.master_round", 1),
    ("read", None, "shard.drain", 1),
    ("read", None, "witness.record", 0),
    ("read", "shard.drain", "shard.sync_round", 1),
    ("crash", None, "recovery.new_witnesses", 1),
    ("crash", None, "recovery.restore", 1),
    ("crash", None, "recovery.replay", 1),
    ("crash", None, "recovery.sync", 1),
    ("crash", None, "recovery.witnesses", 1),
    ("batch", None, "shard.update", 0),
    ("batch", "fused.kernel", "kernels.host_wait", 1),
])
def test_spans_nest_at_layer_boundaries(scenario, outer, inner, count):
    """``count`` spans ``inner`` in the call (inside an ``outer`` span)."""
    _cl, call = SCENARIOS[scenario]()
    _, spans = traced(call)
    got = named(spans, inner)
    if outer is not None:
        assert named(spans, outer)
        got = [s for s in got if inside(s, named(spans, outer))]
    assert len(got) == count


@pytest.mark.parametrize("outer, inner", [
    ("serve.step", "serve.commit"),
    ("serve.commit", "serve.commit.encode"),
    ("serve.commit", "fused.kernel"),
])
def test_serving_step_spans_nest(outer, inner):
    d = _serve()
    d.step()
    _, spans = traced(d.step)
    assert len(named(spans, "serve.step")) == 1
    got = named(spans, inner)
    assert len(got) == 1
    assert inside(got[0], named(spans, outer))


@pytest.mark.parametrize("scenario", ["batch", "read", "update"])
def test_one_host_wait_a_copy_to_the_host(monkeypatch, scenario):
    calls = []
    to_host = kops._to_host

    def counted(*tensors):
        calls.append(len(tensors))
        return to_host(*tensors)

    _cl, call = SCENARIOS[scenario]()
    monkeypatch.setattr(kops, "_to_host", counted)
    _, spans = traced(call, ops=("aten::cat",))
    assert calls
    waits = named(spans, "kernels.host_wait")
    assert len(waits) == len(calls)
    # each wait holds its copy: the one ``cat`` of the results
    assert all(per == 1 for per in
               [sum(a <= c[0] < b for c in named(spans, "op:aten::cat"))
                for a, b in waits])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_outcomes_bit_equal_with_and_without_a_profiler(scenario):
    cl_a, call_a = SCENARIOS[scenario]()
    plain = call_a()
    cl_b, call_b = SCENARIOS[scenario]()
    got, spans = traced(call_b)
    assert spans
    assert repr(got) == repr(plain)
    assert _state(cl_b) == _state(cl_a)


def test_serving_tokens_bit_equal_with_and_without_a_profiler():
    a, b = _serve(), _serve()
    want = [a.step() for _ in range(3)]
    got, spans = traced(lambda: [b.step() for _ in range(3)])
    assert spans and got == want
    assert b.store.load("a").tokens == a.store.load("a").tokens


def test_no_program_span_shares_a_benchmark_name():
    found = set()
    for path in PORT.rglob("*.py"):
        found |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert found == PROGRAM_SPANS
    assert not found & BENCHMARK_SPANS
    # and none that a run opens
    seen = set()
    for make in SCENARIOS.values():
        _cl, call = make()
        seen |= {n for n, _a, _b in traced(call)[1]}
    assert seen <= PROGRAM_SPANS
