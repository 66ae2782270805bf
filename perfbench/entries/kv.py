"""The KV cells: YCSB traffic from one client into ``ShardedCluster``.

Traffic parameters (``traffic/<mix>.json``): ``mode`` ``batched`` (each
round's updates as one ``update_batch`` call, a front end batching for its
users, then its reads one ``read`` each) or ``lone`` (one operation at a
time: ``update`` or ``read``); ``round_ops`` operations a round;
``read_share``; ``crash_at``, the share of the window after which the
master of one shard, drawn from the seed, crashes and recovers between two
rounds (null: no crash).

A closed loop: the next call starts when the last returned.  There is no
network in the program (its nodes are objects in one process), so no
message delay is injected: a latency is the processor time of host and
card, and a call returns only after the card's verdicts are on the host.

The store starts loaded: YCSB's load phase of ``records`` records is
installed at set-up as synced state (``load``), outside the window.

After the window every operation is replayed through the plain reference
(``reference/kv.py``), loaded with the same records, and compared: each
update's outcome (value, RTTs, fast path, synced path, witness accepts),
each read's value, every key the window wrote and a sample of the loaded
ones read back from its master, and every backup's log of every shard
replayed against the reference's store.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from perfbench import counts, traffic
from perfbench.reference.kv import KVReference


def _cluster(cfg: dict, device: str):
    from repro_torch.core import ShardedCluster, WitnessGeometry

    c = cfg["cluster"]
    return ShardedCluster(
        n_shards=c["n_shards"], f=c["f"],
        geometry=WitnessGeometry(c["witness_sets"], c["witness_ways"]),
        sync_batch=c["sync_batch"], witness_backend=c["witness_backend"],
        n_slots=c["n_slots"], device=device)


def load(run, cluster):
    """YCSB's load phase, installed as synced state: each shard's records
    appended to the logs of its f backups, and its master restored from
    that log (``Master.restore_from_log``, the recovery path), so the
    window starts with every record on the master and its backups, and
    none in a witness or an unsynced window.  The backups share the log's
    entries, as a restored master shares them with its backup.  The
    records' owners are the reference's placement; a record on the wrong
    shard would read back as missing.  Returns the records (keys, values
    and owners), which the reference is loaded with after the window."""
    from repro_torch.core.backup import LogEntry
    from repro_torch.core.types import Op, OpType

    cfg = run.config
    n, prefix = cfg["records"], cfg["key_prefix"]
    keys = [prefix + str(k) for k in range(n)]
    values = traffic.load_values(run.seed, n, cfg["value_bytes"])
    shards = new_reference(cfg).shards_of_ranks(prefix, n)
    cid = cluster.new_client().client_id
    logs = [[] for _ in cluster.shards]
    for i, (k, v, sh) in enumerate(zip(keys, values, shards.tolist())):
        logs[sh].append(LogEntry(Op(OpType.SET, (k,), (v,), (cid, i + 1)),
                                 "OK"))
    for g, log in zip(cluster.shards, logs):
        for b in g.backups:
            b.log.extend(log)
        g.master.restore_from_log(log)
    return keys, values, shards


def new_reference(cfg: dict) -> KVReference:
    c = cfg["cluster"]
    return KVReference(c["n_shards"], c["f"], c["witness_sets"],
                       c["witness_ways"], c["sync_batch"], c["n_slots"])


def code(value, rtts, fast, synced, accepts) -> int:
    """An update's outcome as one small int: (value is "OK"), RTTs, fast
    path, synced path and witness accepts.  The window keeps these in one
    array a round, so that what the benchmark records adds few objects to
    the heap the program's garbage collections walk."""
    return ((value == "OK") | rtts << 1 | bool(fast) << 4
            | bool(synced) << 5 | accepts << 6)


class _Drive:
    """One client driving one cluster through the cell's rounds.  ``log``
    holds, in call order, ("round", r, update codes, read values) and
    ("crash", shard); the keys and values are drawn again from the seed
    when the log is checked."""

    def __init__(self, run, cluster, prefix: str) -> None:
        self.run, self.cluster = run, cluster
        self.session = cluster.new_client()
        self.prefix = prefix
        self.log = []
        self.ops = 0
        self.updates = 0
        self.fast = 0

    def round(self, zipf, r: int) -> None:
        run, cl, s = self.run, self.cluster, self.session
        tr = run.traffic
        keys, is_read, values = round_ops(run, zipf, r, self.prefix)
        reads = []
        if tr["mode"] == "batched":
            ops = [s.op_set(keys[i], values[i])
                   for i in np.flatnonzero(~is_read).tolist()]
            fused = cl._fused
            before = fused.stats["fused_batches"] if fused else 0
            with run.span("update_batch"):
                t0 = time.perf_counter()
                outs = cl.update_batch(s, ops)
                t1 = time.perf_counter()
            if fused is not None and fused.stats["fused_batches"] > before:
                run.samples["fused_batch_s"].append(t1 - t0)
            codes = np.fromiter((code(o.value, o.rtts, o.fast_path,
                                      o.synced_path, o.witness_accepts)
                                 for o in outs), np.int16, len(outs))
            with run.span("reads"):
                for i in np.flatnonzero(is_read).tolist():
                    reads.append(cl.read(s, s.op_get(keys[i])).value)
        else:
            samples = run.samples["update_s"]
            codes = np.zeros(int((~is_read).sum()), np.int16)
            j = 0
            for i, key in enumerate(keys):
                if is_read[i]:
                    reads.append(cl.read(s, s.op_get(key)).value)
                    continue
                op = s.op_set(key, values[i])
                with run.span("update"):
                    t0 = time.perf_counter()
                    o = cl.update(s, op)
                    t1 = time.perf_counter()
                samples.append(t1 - t0)
                codes[j] = code(o.value, o.rtts, o.fast_path, o.synced_path,
                                o.witness_accepts)
                j += 1
        self.log.append(("round", r, codes, reads))
        self.fast += int(((codes >> 4) & 1).sum())
        self.updates += len(codes)
        self.ops += len(keys)

    def crash(self, shard: int) -> None:
        with self.run.span("crash_master"):
            t0 = time.perf_counter()
            self.cluster.crash_master(shard)
            self.run.samples["recovery_s"].append(time.perf_counter() - t0)
        self.log.append(("crash", shard))


def round_ops(run, zipf, r: int, prefix: str):
    """Round ``r``'s keys, read mask and update values (None for reads)."""
    is_read, ranks = traffic.kv_round(zipf, run.seed, r,
                                      run.traffic["round_ops"],
                                      run.traffic["read_share"])
    keys = [prefix + str(k) for k in ranks.tolist()]
    vb = run.config["value_bytes"]
    values = [None if rd else traffic.value_of(run.seed, r, i, vb)
              for i, rd in enumerate(is_read.tolist())]
    return keys, is_read, values


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# byte counts of the kernels the window launches (traced runs only)
# ---------------------------------------------------------------------------
def _count_bytes(run):
    """Wrap the program's two gang entry points so that each call's bytes
    (``counts``) are recorded; returns the undo."""
    import repro_torch.kernels as K

    fp0, gr0 = K.gang_fastpath_batch, K.gang_record_groups

    def fastpath(table, n_sets, k_hi, k_lo, r_hi, r_lo, exec_pred,
                 slot_map, lane_map, ring_hi, ring_lo, tail, count, **kw):
        before = np.asarray(count).copy()
        # The call returns its verdicts on the host, so its span holds the
        # device work it launched.
        with run.span("gang_fastpath"):
            res = fp0(table, n_sets, k_hi, k_lo, r_hi, r_lo, exec_pred,
                      slot_map, lane_map, ring_hi, ring_lo, tail, count,
                      **kw)
        sid = np.asarray(res.shard_ids, np.int64)
        lanes = np.asarray(lane_map)[sid]                      # [B, f]
        rows = (lanes.astype(np.int64) * n_sets
                + (np.asarray(res.q_lo).astype(np.int64)
                   & (n_sets - 1))[:, None])
        cls = kw.get("key_cls")
        run.samples["gang_fastpath_bytes"].append(counts.fastpath_bytes(
            n_ops=len(sid), f=lanes.shape[1],
            n_shards=np.asarray(lane_map).shape[0],
            n_slots=np.asarray(slot_map).size,
            n_classes=1 if cls is None else int(np.unique(cls).size),
            live_ring=int(before[np.unique(sid)].sum()),
            appends=int(np.asarray(exec_pred).sum()),
            rows=rows, row_lanes=lanes.reshape(-1),
            reasons=np.asarray(res.reasons).reshape(-1),
            n_ways=table.occ.shape[1]))
        return res

    def groups(table, n_sets, key_hi, key_lo, key_valid, lanes, *a, **kw):
        with run.span("gang_record_groups"):
            res = gr0(table, n_sets, key_hi, key_lo, key_valid, lanes, *a,
                      **kw)
        valid = np.asarray(key_valid) == 1
        rows = (np.asarray(lanes).astype(np.int64)[:, None] * n_sets
                + (np.asarray(res.q_lo).astype(np.int64) & (n_sets - 1)))
        run.samples["gang_groups_bytes"].append(counts.groups_bytes(
            key_valid=valid, rows=rows[valid], lanes=np.asarray(lanes),
            reasons=np.asarray(res.reasons), n_ways=table.occ.shape[1]))
        return res

    K.gang_fastpath_batch, K.gang_record_groups = fastpath, groups

    def undo():
        K.gang_fastpath_batch, K.gang_record_groups = fp0, gr0
    return undo


def _control():
    """The control: the program with one guarantee broken, every
    acknowledged update durable at f witnesses or the backups.  The master
    takes every update as commutative with its unsynced window, and a
    client completes an update in 1 RTT even when the witnesses rejected
    its record, so a conflicting update is acknowledged with no sync and
    no witness holding it.  Returns the undo."""
    import repro_torch.core.shard as shard
    from repro_torch.core.client import Decision
    from repro_torch.core.master import Master

    decide0, handle0 = shard.decide, Master.handle_update

    def handle(self, op, wlv, acks=(), now=0.0, commutes=None):
        return handle0(self, op, wlv, acks, now, commutes=True)

    shard.decide = lambda result, statuses: Decision.COMPLETE
    Master.handle_update = handle

    def undo():
        shard.decide, Master.handle_update = decide0, handle0
    return undo


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
def run(run) -> None:
    from repro_torch.kernels import ops as kops

    cfg, tr, dev = run.config, run.traffic, run.device
    zipf = traffic.Zipfian(cfg["records"], cfg["zipf_theta"])

    # Set-up: build the kernels and warm every path of the cell on a
    # cluster of its own, over keys the window never uses; then the cluster
    # under test, loaded with the records.  The loaded records are then
    # moved out of the collector's generations (``gc.freeze``), as a store
    # that loads its data at start-up would, so that no collection in the
    # window walks them.
    warm = _Drive(run, _cluster(cfg, dev), "warm")
    for r in range(2):
        warm.round(zipf, r)
        if tr.get("crash_at") is not None:
            warm.crash(r)
    warm.cluster.sync_all()
    _sync(dev)
    del warm
    run.samples.clear()
    gc.disable()
    drive = _Drive(run, _cluster(cfg, dev), cfg["key_prefix"])
    records = load(run, drive.cluster)
    crash_shard = traffic.crash_shard(run.seed, cfg["cluster"]["n_shards"])
    gc.enable()
    gc.collect()
    gc.freeze()
    _sync(dev)
    run.setup_done()

    # The window.
    undo = _count_bytes(run) if run.trace_on else None
    undo_control = _control() if run.control else None
    gc0 = kops.GANG_GC.launches
    fused0 = drive.cluster._fused.stats["fused_batches"] \
        if drive.cluster._fused else 0
    run.start_trace()
    t0 = time.perf_counter()
    crashed = tr.get("crash_at") is None
    r = 0
    while True:
        drive.round(zipf, r)
        r += 1
        elapsed = time.perf_counter() - t0
        if not crashed and elapsed >= run.seconds * tr["crash_at"]:
            drive.crash(crash_shard)
            crashed = True
        if elapsed >= run.seconds:
            break
    _sync(dev)
    run.values["window_s"] = time.perf_counter() - t0
    run.stop_trace()
    if undo is not None:
        undo()
    if undo_control is not None:
        undo_control()
    run.read_memory_peak()
    run.counts["ops"] = drive.ops
    run.counts["rounds"] = r
    run.counts["updates"] = drive.updates
    run.counts["fast_updates"] = drive.fast
    if drive.cluster._fused is not None:
        run.counts["fused_batches"] = \
            drive.cluster._fused.stats["fused_batches"] - fused0
    run.counts["gc_launches"] = kops.GANG_GC.launches - gc0
    run.attempted = drive.ops
    check(run, drive, zipf, records)


def check(run, drive, zipf, records) -> None:
    """Replay the window through the reference, loaded as the program was,
    and compare."""
    ref = new_reference(run.config)
    ref.load(*records)
    batched = run.traffic["mode"] == "batched"
    bad_outcome = bad_read = compared = 0
    for rec in drive.log:
        if rec[0] == "crash":
            ref.crash(rec[1])
            continue
        _k, r, codes, reads = rec
        keys, is_read, values = round_ops(run, zipf, r, drive.prefix)
        want, got = [], []
        if batched:
            want = ref.update_batch([(keys[i], values[i]) for i in
                                     np.flatnonzero(~is_read).tolist()])
            got = [ref.read(keys[i]) for i in np.flatnonzero(is_read).tolist()]
        else:
            for i, key in enumerate(keys):
                if is_read[i]:
                    got.append(ref.read(key))
                else:
                    want.append(ref.update(key, values[i]))
        want = np.array([code(*o) for o in want], np.int16)
        bad_outcome += int((want != codes).sum()) if len(want) == len(codes) \
            else len(codes)
        bad_read += sum(a != b for a, b in zip(got, reads)) \
            + abs(len(got) - len(reads))
        compared += len(codes) + len(reads)
    cl, s = drive.cluster, drive.session
    cfg = run.config
    sample = [cfg["key_prefix"] + str(k) for k in
              traffic.sample_ranks(run.seed, cfg["records"], 1024).tolist()]
    readback = sum(cl.read(s, s.op_get(k)).value != ref.store.get(k)
                   for k in sorted(ref.written.union(sample)))
    cl.sync_all()
    replicas = 0
    for g, want in zip(cl.shards, ref.by_shard()):
        for b in g.backups:
            got = {}
            for e in b.get_log():
                if e.op.op_type.name == "SET":
                    got[e.op.keys[0]] = e.op.args[0]
            replicas += got != want
    run.failed = bad_outcome + bad_read
    run.check("outcome_mismatches", bad_outcome, 0)
    run.check("read_mismatches", bad_read, 0)
    run.check("readback_mismatches", readback, 0)
    run.check("replica_mismatches", replicas, 0)
    run.check("ops_not_compared", run.attempted - compared, 0)
