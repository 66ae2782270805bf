"""The port's device-backend cluster against the JAX package's Python one.

``repro_torch.core.ShardedCluster(witness_backend="device", device="cpu")``
runs the fused cluster batch, the witness gang and gc on the plain PyTorch
versions of the CUDA kernels; ``repro.core.ShardedCluster`` with the Python
witness backend is the protocol reference.  Per-op outcomes and every
master's stats must be identical, with exactly one dispatch (by the port's
own counter) per eligible cross-shard batch.  Each side builds its ops from
its own client sessions; only plain values cross between the packages.
"""
import random
from collections import Counter

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
import repro_torch.core.shard as tshard
import repro_torch.kernels as tkernels
from repro_torch.core import DeviceWitness, ShardedCluster
from repro_torch.core.client import ClientSession
from repro_torch.core.device_witness import WitnessGang, gc_many, record_many
from repro_torch.core.txn import prepare_op
from repro_torch.core.types import RecordStatus
from repro_torch.kernels import dispatch_count, reset_dispatch_count

_R_INSERT, _R_DUP, _R_CONFLICT, _R_FULL = 1, 2, 3, 4
_STAT_OF = {_R_INSERT: "reason_insert", _R_DUP: "reason_dup",
            _R_CONFLICT: "reason_conflict", _R_FULL: "reason_full"}


def _port(**kw):
    kw.setdefault("geometry", tcore.WitnessGeometry(256, 4))
    c = ShardedCluster(n_shards=4, f=3, witness_backend="device", seed=7,
                       device="cpu", **kw)
    return c, c.new_client()


def _reference(**kw):
    kw.setdefault("geometry", jcore.WitnessGeometry(256, 4))
    c = jcore.ShardedCluster(n_shards=4, f=3, witness_backend="python",
                             seed=7, **kw)
    return c, c.new_client()


def _outcome(o):
    return (o.value, o.rtts, o.fast_path, o.synced_path, o.witness_accepts)


# ---------------------------------------------------------------------------
# The seven fused-batch contracts (tests/test_fastpath.py TestFusedClusterBatch)
# ---------------------------------------------------------------------------
class TestFusedClusterBatch:
    def test_cross_shard_batch_single_dispatch(self):
        c, s = _port()
        c.update_batch(s, [s.op_set(f"w{i}", "v") for i in range(8)])
        ops = [s.op_set(f"k{i}", "v") for i in range(16)]
        assert len({c.shard_of(op.keys[0]) for op in ops}) > 1
        reset_dispatch_count()
        outs = c.update_batch(s, ops)
        assert dispatch_count() == 1      # ONE dispatch, all shards
        assert all(o.fast_path and o.witness_accepts == 3 for o in outs)
        assert c._fused.stats["fused_batches"] == 2

    def test_single_shard_batch_single_dispatch(self):
        c, s = _port()
        keys = [f"s{i}" for i in range(200) if c.shard_of(f"s{i}") == 0][:8]
        c.update_batch(s, [s.op_set(k + "_warm", "v") for k in keys])
        reset_dispatch_count()
        c.update_batch(s, [s.op_set(k, "v") for k in keys])
        assert dispatch_count() == 1

    def test_outcomes_match_python_backend(self):
        """Conflicts, increments, a RIFL retry and drains: per-op outcomes
        and master stats identical to the reference's Python backend."""
        def drive(c, s):
            rng_ = random.Random(5)
            seen, out = [], []
            for r in range(6):
                ops = []
                for _ in range(12):
                    k = f"k{rng_.randrange(8)}"
                    ops.append(s.op_set(k, f"v{r}") if rng_.random() < .7
                               else s.op_incr(k))
                if seen and r == 4:
                    ops[0] = seen[0]          # RIFL retry of an old op
                seen.extend(ops)
                out += [_outcome(o) for o in c.update_batch(s, ops)]
            return out

        cd, sd = _port(sync_batch=10)
        cp, sp = _reference(sync_batch=10)
        assert drive(cd, sd) == drive(cp, sp)
        for sid in range(4):
            assert cd.shards[sid].master.stats == cp.shards[sid].master.stats
        assert cd._fused.stats["fused_ops"] > 0

    def test_ring_window_conflicts_match_host(self):
        """auto_sync=False keeps the unsynced window alive across batches:
        the device ring flags the conflicts the host window would."""
        def drive(c, s):
            o1 = c.update_batch(s, [s.op_set("a", "1"), s.op_set("b", "2")])
            o2 = c.update_batch(s, [s.op_set("a", "3"), s.op_set("c", "4")])
            return [(o.fast_path, o.synced_path, o.rtts) for o in o1 + o2]

        assert drive(*_port(auto_sync=False, sync_batch=1000)) == \
            drive(*_reference(auto_sync=False, sync_batch=1000))

    def test_multikey_op_declines_to_fallback(self):
        c = ShardedCluster(n_shards=1, f=3, witness_backend="device",
                           geometry=tcore.WitnessGeometry(256, 4),
                           device="cpu")
        s = c.new_client()
        op = s.session_for(0).op_mset([("m1", "1"), ("m2", "2")])
        outs = c.update_batch(s, [op, s.op_set("plain", "3")])
        assert all(o.witness_accepts == 3 for o in outs)
        assert c._fused.stats["declined"] == 1
        assert c._fused.stats["fused_batches"] == 0
        # The NEXT all-plain batch fuses again (ring rebuilds from the log).
        outs2 = c.update_batch(s, [s.op_set("p2", "4")])
        assert outs2[0].fast_path
        assert c._fused.stats["fused_batches"] == 1

    def test_crash_recovery_invalidates_ring(self):
        c, s = _port(auto_sync=False, sync_batch=1000)
        c.update_batch(s, [s.op_set(f"k{i}", f"v{i}") for i in range(12)])
        for sid in range(4):
            c.shards[sid].crash_master()
        outs = c.update_batch(s, [s.op_set(f"k{i}", "post")
                                  for i in range(12)])
        assert len(outs) == 12
        for i in range(12):
            assert c.read(s, s.op_get(f"k{i}")).value == "post"

    def test_fused_respects_dropped_witness(self):
        c, s = _port()
        c.shards[0].witness_drop(0)
        keys = [f"d{i}" for i in range(400) if c.shard_of(f"d{i}") == 0][:4]
        outs = c.update_batch(s, [s.op_set(k, "v") for k in keys])
        assert all(not o.fast_path and o.witness_accepts == 2 for o in outs)
        assert c._fused.stats["declined"] >= 1


# ---------------------------------------------------------------------------
# Reason-counter plane parity (tests/test_telemetry.py TestReasonCounterParity)
# ---------------------------------------------------------------------------
def _drain_total(gang: WitnessGang) -> np.ndarray:
    return gang.drain_counters().sum(axis=0)


def _host_reasons(*witnesses) -> np.ndarray:
    out = np.zeros(5, np.int64)
    for w in witnesses:
        for code, stat in _STAT_OF.items():
            out[code] += w.stats[stat]
    return out


def _dw(n_sets, n_ways):
    dw = DeviceWitness(n_sets, n_ways, device="cpu")
    dw.start(master_id=1)
    return dw


class TestReasonCounterParity:
    def test_collision_heavy_setparallel_batch(self):
        s = ClientSession(client_id=1)
        dw = _dw(16, 2)
        ops = [s.op_set(f"k{i % 6}", "v") for i in range(40)]
        st = dw.record_batch(1, ops)
        st += dw.record_batch(1, ops[:10])   # exact dup retries
        device = _drain_total(dw.gang)
        np.testing.assert_array_equal(device, _host_reasons(dw))
        assert device[_R_INSERT] > 0 and device[_R_CONFLICT] > 0
        assert device[_R_DUP] > 0
        assert device.sum() == len(st)

    def test_dup_retry_single_op_grouped_path(self):
        s = ClientSession(client_id=2)
        dw = _dw(16, 2)
        op = s.op_set("x", "v")
        for _ in range(3):
            assert dw.record(1, op.key_hashes(), op.rpc_id, op) \
                is RecordStatus.ACCEPTED
        op2 = s.op_set("x", "w")
        assert dw.record(1, op2.key_hashes(), op2.rpc_id, op2) \
            is RecordStatus.REJECTED
        device = _drain_total(dw.gang)
        np.testing.assert_array_equal(device, _host_reasons(dw))
        assert list(device[1:]) == [1, 2, 1, 0]

    def test_multikey_groups_batch(self):
        s = ClientSession(client_id=3)
        dw = _dw(16, 2)
        ops = [s.op_mset([(f"a{i}", "1"), (f"b{i % 3}", "2")])
               for i in range(12)]
        dw.record_batch(1, ops)
        dw.record_batch(1, ops[:4])          # multi-key dup retries
        device = _drain_total(dw.gang)
        np.testing.assert_array_equal(device, _host_reasons(dw))
        assert device.sum() == 16            # one count per GROUP

    def test_full_sets_reason_full(self):
        s = ClientSession(client_id=4)
        dw = _dw(2, 1)
        dw.record_batch(1, [s.op_set(f"u{i}", "v") for i in range(16)])
        device = _drain_total(dw.gang)
        np.testing.assert_array_equal(device, _host_reasons(dw))
        assert device[_R_FULL] + device[_R_CONFLICT] > 0

    def test_parity_matches_python_witness_outcomes(self):
        """The same batch on the port's device witness and the reference's
        Python witness: same statuses, and the counter plane agrees with the
        reference's own outcome bookkeeping."""
        js = jcore.ClientSession(client_id=5)
        ts = ClientSession(client_id=5)
        jops = [js.op_set(f"k{i % 5}", "v") for i in range(30)]
        tops = [ts.op_set(f"k{i % 5}", "v") for i in range(30)]
        pw = jcore.Witness(64, 4)
        pw.start(master_id=9)
        dw = DeviceWitness(64, 4, device="cpu")
        dw.start(master_id=9)
        want = [st.name for st in pw.record_batch(9, jops)]
        assert [st.name for st in dw.record_batch(9, tops)] == want
        device = _drain_total(dw.gang)
        assert device[_R_INSERT] == \
            pw.stats["accepts"] - pw.stats["accepts_dup"]
        assert device[_R_DUP] == pw.stats["accepts_dup"]
        assert device[_R_CONFLICT] == pw.stats["rejects_conflict"]
        assert device[_R_FULL] == pw.stats["rejects_full"]

    def test_fused_cluster_fastpath_parity(self):
        """The one-dispatch multi-shard path accumulates one count per
        (op, witness copy), the granularity the driver settles at."""
        cluster = ShardedCluster(n_shards=2, f=2, seed=3,
                                 witness_backend="device", device="cpu")
        s = cluster.new_client()
        rng = random.Random(3)
        for _ in range(3):
            cluster.update_batch(s, [
                s.op_set(f"hot{rng.randrange(4)}" if rng.random() < .3
                         else f"cold{rng.randrange(10**6)}", "v")
                for _ in range(32)])
        witnesses = [w for sh in cluster.shards for w in sh.witnesses]
        device = _drain_total(cluster.gang)
        np.testing.assert_array_equal(device, _host_reasons(*witnesses))
        assert device.sum() > 0 and device[_R_INSERT] > 0

    def test_drain_zeroes_and_lane_recycle_resets(self):
        s = ClientSession(client_id=6)
        gang = WitnessGang(16, 2, n_lanes=2, device="cpu")
        w = DeviceWitness(16, 2, gang=gang)
        w.start(master_id=1)
        op = s.op_set("x", "v")
        w.record(1, op.key_hashes(), op.rpc_id, op)
        assert _drain_total(gang).sum() == 1
        assert _drain_total(gang).sum() == 0
        op2 = s.op_set("y", "v")
        w.record(1, op2.key_hashes(), op2.rpc_id, op2)
        lane = w.lane
        w.end()
        w2 = DeviceWitness(16, 2, gang=gang)
        w2.start(master_id=2)
        w3 = DeviceWitness(16, 2, gang=gang)
        w3.start(master_id=3)
        assert lane in (w2.lane, w3.lane)
        assert int(gang.counters[lane].sum()) == 0


def test_gc_many_one_dispatch_matches_per_witness():
    def build():
        gang = WitnessGang(64, 4, n_lanes=4, device="cpu")
        ws = [DeviceWitness(64, 4, gang=gang) for _ in range(3)]
        for w in ws:
            w.start(master_id=1)
        s = ClientSession(client_id=25)
        ops = [s.op_set(f"g{i}", "v") for i in range(8)]
        for w in ws:
            w.record_batch(1, ops)
        return ws, ops

    ws, ops = build()
    entries = tuple((kh, op.rpc_id) for op in ops[:4]
                    for kh in op.key_hashes())
    reset_dispatch_count()
    resps = gc_many(ws, entries)
    assert dispatch_count() == 1
    ws2, _ = build()
    resps2 = [w.gc(entries) for w in ws2]
    assert [r.stale_requests for r in resps] == \
        [r.stale_requests for r in resps2]
    assert [w.occupancy for w in ws] == [w.occupancy for w in ws2] \
        == [4, 4, 4]


def _twin_witnesses(n_sets, n_ways, f=3):
    gang = WitnessGang(n_sets, n_ways, n_lanes=4, device="cpu")
    ws = [DeviceWitness(n_sets, n_ways, gang=gang) for _ in range(f)]
    for w in ws:
        w.start(master_id=1)
    return gang, ws


def _lone_stream(seed, n_ops=48):
    """(op, master_id, freeze) steps: SETs on a few hot keys, merge-lattice
    INCR/SADD/APPEND/MAX, MSET and HMSET of 2-4 keys, RIFL retries of
    earlier ops, and now and then a wrong master id; ``freeze`` puts one
    witness into RECOVERY or ENDS it before the step."""
    rng = random.Random(seed)
    s = ClientSession(client_id=40 + seed)
    hot = [f"h{i}" for i in range(5)]
    cold = iter(f"c{seed}_{i}" for i in range(10**6))

    def key():
        return rng.choice(hot) if rng.random() < 0.6 else next(cold)

    made, steps = [], []
    for step in range(n_ops):
        r = rng.random()
        if step == 1 or (made and r < 0.15):
            op = made[-1] if step == 1 or rng.random() < 0.5 \
                else rng.choice(made)
        elif r < 0.35:
            op = s.op_set(key(), step)
        elif r < 0.55:
            op = rng.choice([s.op_incr(key()), s.op_sadd(key(), step),
                             s.op_append(key(), "x"), s.op_max(key(), step)])
        elif r < 0.8:
            op = s.op_mset([(key(), step)
                            for _ in range(rng.randint(2, 4))])
        else:
            op = s.op_hmset(key(), [(f"f{rng.randrange(4)}", step)
                                    for _ in range(rng.randint(1, 3))])
        made.append(op)
        freeze = {n_ops // 2: "recovery", 3 * n_ops // 4: "end"}.get(step)
        steps.append((op, 2 if rng.random() < 0.08 else 1, freeze))
    return steps


def _witness_state(gang, ws):
    return ([p.clone() for p in gang.table], gang.counters.clone(),
            [dict(w.stats) for w in ws],
            [{k: dict(v) for k, v in w._held.items()} for w in ws],
            [w.mode for w in ws])


@pytest.mark.parametrize("seed", range(6))
def test_record_many_matches_sequential_records(seed):
    """One grouped record at f = 3 witnesses equals three sequential
    ``record`` calls on a twin gang: statuses, every table plane, the
    counter plane, stats and the held mirror, at a geometry small enough
    to reject FULL, through RIFL retries, multi-key and merge-lattice ops,
    a wrong master id and witnesses in RECOVERY and ENDED."""
    g_many, many = _twin_witnesses(4, 2)
    g_seq, seq = _twin_witnesses(4, 2)
    got_reasons = set()
    for op, master_id, freeze in _lone_stream(seed):
        if freeze == "recovery":
            many[1].get_recovery_data(1)
            seq[1].get_recovery_data(1)
        elif freeze == "end":
            many[2].end()
            seq[2].end()
        reset_dispatch_count()
        got = record_many(many, master_id, op.key_hashes(), op.rpc_id, op)
        live = master_id == 1 and many[0].mode.value == "NORMAL"
        assert dispatch_count() == (1 if live else 0)
        want = [w.record(master_id, op.key_hashes(), op.rpc_id, op)
                for w in seq]
        assert got == want
        a, b = _witness_state(g_many, many), _witness_state(g_seq, seq)
        for x, y in zip(a[0] + [a[1]], b[0] + [b[1]]):
            assert torch.equal(x, y)
        assert a[2:] == b[2:]
        got_reasons |= {k for k in _STAT_OF.values()
                        if many[0].stats[k]}
    assert got_reasons == set(_STAT_OF.values())
    assert many[0].stats["rejects_mode"] > 0
    assert many[1].stats["rejects_mode"] > many[0].stats["rejects_mode"]


def _kernel_batches(witnesses):
    return sum(w.stats.get("kernel_batches", 0) for w in witnesses)


@pytest.mark.parametrize("backend, dropped, grouped", [
    ("device", (), 3), ("device", (1,), 2), ("python", (), 0)])
def test_lone_update_is_one_grouped_record(backend, dropped, grouped):
    """A lone update that runs no sync costs ONE grouped-record dispatch
    on the device backend, in which each live witness counts one kernel
    batch; a dropped witness rejects unrecorded; the Python backend
    records one witness at a time, with no dispatch."""
    c = ShardedCluster(n_shards=2, f=3, witness_backend=backend, seed=7,
                       sync_batch=1000, geometry=tcore.WitnessGeometry(64, 4),
                       device="cpu")
    s = c.new_client()
    c.update(s, s.op_set("warm", "v"))
    op = s.op_set("lone", "v")
    group = c.shards[c.shard_of("lone")]
    for i in dropped:
        group.witness_drop(i)
    sub = s.session_for(group.shard_id)
    before = _kernel_batches(group.witnesses)
    reset_dispatch_count()
    if dropped:     # a reject needs a sync before the reply: attempt only
        _verdict, _result, statuses = group.attempt_update(op, sub.acks())
        assert [st is RecordStatus.ACCEPTED for st in statuses] == \
            [i not in dropped for i in range(3)]
    else:
        out = group.update(sub, op)
        assert out.fast_path and out.witness_accepts == 3
    assert dispatch_count() == (1 if backend == "device" else 0)
    assert _kernel_batches(group.witnesses) - before == grouped


def test_txn_prepare_leg_is_one_grouped_record():
    c = ShardedCluster(n_shards=2, f=3, witness_backend="device", seed=7,
                       geometry=tcore.WitnessGeometry(64, 4), device="cpu")
    s = c.new_client()
    keys = [f"t{i}" for i in range(16)]
    assert len({c.shard_of(k) for k in keys}) == 2
    spec = s.txn_spec([(k, 1) for k in keys])
    part = spec.parts[0]
    group = c.shards[part.shard_id]
    before = _kernel_batches(group.witnesses)
    reset_dispatch_count()
    vote = group.txn_prepare(s.session_for(part.shard_id),
                             prepare_op(spec, part))
    assert vote.granted and vote.fast and vote.rtts == 1
    assert dispatch_count() == 1
    assert _kernel_batches(group.witnesses) - before == 3


def _ack_rounds(s):
    """Two rounds of one client's updates.  Round 1: an update of k1, one
    of k2, and one of k1 again, which the master answers SYNCED and the
    witnesses reject (k1 is held).  Round 2, after the syncs: a RIFL retry
    of the first update (DUP at the master; the witnesses, gc'd, record it
    afresh), then an update of k1 that the master takes as fast and the
    witnesses, holding the retry, reject."""
    first = s.op_set("k1", "1")
    return [[first, s.op_set("k2", "2"), s.op_set("k1", "3")],
            [first, s.op_set("k1", "4")]]


# (value, rtts, fast_path, synced_path, witness_accepts) of each update.
_ACK_OUTCOMES = [[("OK", 1, True, False, 3), ("OK", 1, True, False, 3),
                  ("OK", 2, False, True, 0)],
                 [(None, 1, False, False, 3), ("OK", 2, False, False, 0)]]


@pytest.mark.parametrize("path", ["update", "declined_batch", "fused_batch"])
def test_acknowledgement_rule_is_the_same_on_every_path(path, monkeypatch):
    """One acknowledgement rule: a stream holding a RIFL retry, a SYNCED
    verdict and witness rejects gives the same outcomes through ``update``,
    through an ``update_batch`` the fused driver declines and through a
    fused batch, and one history entry an invocation (the retry adds
    none)."""
    c, s = _port()
    if path == "declined_batch":
        monkeypatch.setattr(c._fused, "_eligible_group", lambda sid: False)
    rounds = _ack_rounds(s)
    got = []
    for ops in rounds:
        if path == "update":
            outs = [c.update(s, op) for op in ops]
        else:
            outs = c.update_batch(s, ops)
        got.append([_outcome(o) for o in outs])
    assert got == _ACK_OUTCOMES
    fused = c._fused.stats
    assert (fused["fused_batches"], fused["declined"]) == {
        "update": (0, 0), "declined_batch": (0, 2),
        "fused_batch": (2, 0)}[path]
    invocations = {op.rpc_id for ops in rounds for op in ops}
    assert Counter(e["op"].rpc_id for e in c.history) == \
        Counter(invocations)


def _count_calls(monkeypatch, calls, *names):
    """Replace ``repro_torch.kernels.<name>`` for each name, as the
    benchmark does, by a wrapper that counts its calls into ``calls``."""
    for name in names:
        real = getattr(tkernels, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tkernels, name, counted)


@pytest.mark.parametrize("decline", ["retry", "dropped"])
def test_declined_batch_is_one_record_dispatch_a_live_witness(monkeypatch,
                                                              decline):
    """A batch the fused driver declines (an in-batch retry of one rpc, or
    a dropped witness) takes the per-shard path: one ``gang_record``
    dispatch for each live witness of each shard it touches, and no
    grouped or fused record."""
    c, s = _port()
    ops = [s.op_set(f"d{i}", "v") for i in range(12)]
    touched = sorted({c.shard_of(op.keys[0]) for op in ops})
    assert len(touched) > 1
    if decline == "retry":
        ops.append(ops[0])
    else:
        c.shards[touched[0]].witness_drop(1)
    calls = Counter()
    _count_calls(monkeypatch, calls, "gang_record", "gang_record_groups",
                 "gang_fastpath_batch")
    outs = c.update_batch(s, ops)
    assert c._fused.stats["declined"] == 1
    live = 3 * len(touched) - (decline == "dropped")
    assert calls == {"gang_record": live}
    assert sum(o.witness_accepts for o in outs) == \
        3 * len(ops) - (decline == "dropped") * sum(
            c.shard_of(op.keys[0]) == touched[0] for op in ops)


@pytest.mark.parametrize("path", ["lone", "txn_prepare", "fused"])
def test_benchmark_hooks_are_read_at_call_time(monkeypatch, path):
    """The benchmark counts bytes by replacing
    ``repro_torch.kernels.gang_record_groups`` / ``gang_fastpath_batch``,
    and its KV control replaces ``repro_torch.core.shard.decide``, after
    the cluster is built: a lone update, a txn prepare leg and a fused
    batch each reach the replacements."""
    c, s = _port()
    calls = Counter()
    _count_calls(monkeypatch, calls, "gang_record_groups",
                 "gang_fastpath_batch")
    decide = tshard.decide

    def counted_decide(result, statuses):
        calls["decide"] += 1
        return decide(result, statuses)
    monkeypatch.setattr(tshard, "decide", counted_decide)
    if path == "lone":
        assert c.update(s, s.op_set("h", "v")).fast_path
        want = {"gang_record_groups": 1, "decide": 1}
    elif path == "txn_prepare":
        spec = s.txn_spec([(f"t{i}", 1) for i in range(16)])
        part = spec.parts[0]
        vote = c.shards[part.shard_id].txn_prepare(
            s.session_for(part.shard_id), prepare_op(spec, part))
        assert vote.granted and vote.fast
        want = {"gang_record_groups": 1, "decide": 1}
    else:
        outs = c.update_batch(s, [s.op_set(f"f{i}", "v") for i in range(8)])
        assert all(o.fast_path for o in outs)
        assert c._fused.stats["fused_batches"] == 1
        want = {"gang_fastpath_batch": 1, "decide": 8}
    assert calls == want


def test_record_keys_rollback_leaves_table_unchanged_on_reject():
    s = ClientSession(client_id=27)
    dw = _dw(16, 1)
    hold = s.op_set("b", "v")
    assert dw.record(1, hold.key_hashes(), hold.rpc_id, hold) \
        is RecordStatus.ACCEPTED
    before = [p.clone() for p in dw.gang.table]
    op = s.op_mset([("a", "1"), ("b", "2")])
    assert dw._record_keys_rollback(op.key_hashes(), op.rpc_id, op) \
        is RecordStatus.REJECTED
    # The rollback gc clears occupancy and age; key and rpc planes under
    # occ == 0 are never read.
    assert torch.equal(dw.gang.table.occ, before[2])
    assert torch.equal(dw.gang.table.age, before[5])


def test_gang_grows_by_doubling_and_keeps_held_records():
    s = ClientSession(client_id=28)
    gang = WitnessGang(16, 2, n_lanes=1, device="cpu")
    first = DeviceWitness(16, 2, gang=gang)
    first.start(master_id=1)
    op = s.op_set("kept", "v")
    first.record(1, op.key_hashes(), op.rpc_id, op)
    others = [DeviceWitness(16, 2, gang=gang) for _ in range(2)]
    for w in others:
        w.start(master_id=1)
    assert gang.n_lanes == 4
    assert all(p.shape == (4 * 16, 2) for p in gang.table)
    assert tuple(gang.counters.shape) == (4, 5)
    assert int((gang.table.occ > 0).sum()) == 1
    assert first.record(1, op.key_hashes(), op.rpc_id, op) \
        is RecordStatus.ACCEPTED
    assert first.stats["reason_dup"] == 1


# ---------------------------------------------------------------------------
# The slice end to end: a zipfian update stream, 20 batches
# ---------------------------------------------------------------------------
def _zipf_stream(seed, n_batches, batch, n_keys, theta=0.99):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_keys + 1) ** theta
    keys = rng.choice(n_keys, size=(n_batches, batch), p=p / p.sum())
    incr = rng.random((n_batches, batch)) < 0.1
    return keys, incr


def _drive_stream(c, s, keys, incr):
    outs, model = [], {}
    for b in range(keys.shape[0]):
        ops = [s.op_incr(f"user{k}") if inc else s.op_set(f"user{k}", f"v{b}")
               for k, inc in zip(keys[b], incr[b])]
        for (k, inc), o in zip(zip(keys[b], incr[b]), c.update_batch(s, ops)):
            outs.append(_outcome(o))
            model[f"user{k}"] = o.value if inc else f"v{b}"
    return outs, model


def test_zipfian_stream_matches_python_backend_and_reads_back():
    keys, incr = _zipf_stream(11, 20, 48, 5000)
    cd, sd = _port(sync_batch=50)
    cp, sp = _reference(sync_batch=50)
    reset_dispatch_count()
    od, model = _drive_stream(cd, sd, keys, incr)
    fused = cd._fused.stats["fused_batches"]
    assert fused == 20 and dispatch_count() >= fused
    op_, _ = _drive_stream(cp, sp, keys, incr)
    assert od == op_
    for sid in range(4):
        assert cd.shards[sid].master.stats == cp.shards[sid].master.stats
    for key, value in model.items():
        assert cd.read(sd, sd.op_get(key)).value == value
        assert cp.read(sp, sp.op_get(key)).value == value
    assert any(not o[2] for o in od) and any(o[2] for o in od)


@pytest.mark.parametrize("crash", [(0, 3)])
def test_zipfian_stream_survives_master_crashes(crash):
    keys, incr = _zipf_stream(12, 10, 48, 2000)
    c, s = _port(sync_batch=50)
    half = keys.shape[0] // 2
    _, model = _drive_stream(c, s, keys[:half], incr[:half])
    for sid in crash:
        c.shards[sid].crash_master()
    _, model2 = _drive_stream(c, s, keys[half:], incr[half:])
    model.update(model2)
    for key, value in model.items():
        assert c.read(s, s.op_get(key)).value == value
