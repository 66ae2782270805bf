#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the CURP hot path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

0. Build every CUDA kernel of ``src/repro_torch/kernels/csrc`` with nvcc
   (all sources at once) and print ptxas's register report.
1. Kernel parity at full size: a 64-lane x 1024-set x 4-way gang, 64 shard
   rings of 1024 slots, f = 3.  Each of the four kernels runs on the same
   CUDA tensors as its plain PyTorch version; every output, all six table
   planes, the rings and the counter plane must agree bit for bit.
2. The slice end to end: ``ShardedCluster(n_shards=64, f=3,
   geometry=WitnessGeometry(1024, 4), sync_batch=50,
   witness_backend="device")`` on the card, driven by the update half of
   YCSB core workload A (zipfian 0.99 over 1,000,000 keys, 90% SET and 10%
   INCR) in 48 batches of 1024, two lone updates per batch (the single-op
   record path) and the read half (1024 GETs per batch).  The same stream
   runs through the same backend on the CPU (the plain versions: per-op
   outcomes, reads, master stats and reason counters must be identical) and
   through the port's Python witness backend (op results, reads and the
   acknowledged writes must be identical; the device witness's set
   placement differs from the Python witness's, so their capacity (FULL)
   rejects differ, and an op's path fields may differ only in a shard
   that has had a FULL reject, on either backend, by the op's batch).
   Also the four single-table kernels, each against its plain version on
   the same CUDA tensors, outputs and all three table planes bit for bit:
   keyhash (K1) over the 1,000,000 keys of phase 2's keyspace, with and
   without the slot route; witness_record (K6) at figure 11's shapes (4096
   slots at 1, 2, 4 and 8 ways, 8192 queries), at fig_fastpath's
   collision-heavy parity cases (B = 512) and on a pre-filled 1024 x 4
   table with classes; fastpath_record_scan (K7) at 1024 x 4 and 1024 x 8,
   B = 4096, against a 1024-entry window of mixed classes; conflict_scan
   (K8) at B = 4096, U = 1024 and at B = 1000, U = 777.
3. Durability: the masters of 4 shards crash half-way through phase 2; at
   the end every acknowledged key is read back and compared with a model of
   the acknowledged writes.
5. The single-table path through its public ops (run after phase 3; its
   launches are counted from 0 over this phase alone), at the paper's
   witness geometry (1024 sets x 4 ways), reproducing the claims of
   benchmarks/fig_fastpath.py and fig11_witness_capacity.py on the card:
   the per-op path (keyhash2x32 -> witness_record -> conflict_scan, 64
   ops) takes at least 3 dispatches per op and fastpath_batch exactly 1
   per batch; fastpath_batch's records/s (CUDA events around the op) over
   {256x4, 1024x4, 1024x8} x {64, 512, 4096} rise with the batch at
   1024x4; figure 11's mean inserts before the first reject at 4096 slots
   (12 trials) are more than 2.5x higher at 4 ways than direct-mapped; and
   shard_route places keys as the host SlotRouter does, on the default
   and on a random slot map.
4. Times at phase 2's shapes: each kernel and its plain version (CUDA
   events, state restored between calls; gang_record as the record stage
   the fused batch launches, so gang_fastpath's time includes it), each
   kernel's device time (torch.profiler), the least time the card could
   take for the same work (the bytes and operations this run's data needs),
   the fused batches' wall time, the device's idle share during one more
   fused batch, and the host's self time by source file in another.  K1
   and K6-K8 are timed the same way at phase 5's shapes.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``;
the line before them names the card and its power limit.  Details also go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12         # H100 SXM non-tensor-core 32-bit rate
N_SHARDS, F, N_SETS, N_WAYS = 64, 3, 1024, 4
N_BATCHES, BATCH, N_KEYS, THETA = 48, 1024, 1_000_000, 0.99
CRASH_AT, CRASH_SHARDS = 24, (0, 17, 33, 50)
SEED = 20171026
# The single-table path: the paper's witness geometry (§B.1), fig11's
# capacity runs, fig_fastpath's sweep, and the window of a 1024-slot ring.
TABLE_SETS, TABLE_WAYS, WINDOW, TABLE_BATCH = 1024, 4, 1024, 4096
FIG11_SLOTS, FIG11_WAYS, FIG11_TRIALS = 4096, (1, 2, 4, 8), 12
SWEEP_GEOMETRIES = ((256, 4), (1024, 4), (1024, 8))
SWEEP_BATCHES, SWEEP_REPS = (64, 512, 4096), 20
ROUTE_KEYS = 200_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Phase 1: parity at full size
# ---------------------------------------------------------------------------
def phase_parity(np, parity, card, device, sync):
    rng = np.random.default_rng(SEED)
    L, NS, CAP = 64, 64, 1024
    pool = parity.key_pool(rng, 4 * N_SETS, N_SETS)
    planes = parity.gang_planes(rng, pool, L, N_SETS, N_WAYS, 256, fill=0.5)
    rec = parity.record_batch(rng, pool, BATCH * F, L, N_SETS, 256, flood=9)
    grp = parity.group_batch(rng, pool, 64, 4, L, 256)
    gc = parity.gc_batch(rng, planes, N_SETS, 600, 256)
    fp = parity.fastpath_batch(rng, pool, BATCH, NS, CAP, F, L, 256, 256)
    check((fp["tail_slot"] + fp["count"] > CAP).any(), "no ring span wraps")
    results = parity.check_kernels(planes, N_SETS, rec, grp, gc, fp, F,
                                   device=device)
    sync()
    for r in results:
        say(card, f"parity {r.name}: {r.outputs} integers, "
                  f"max_abs_err {r.max_abs_err}, outcomes by value "
                  f"{r.coverage.tolist()}")
        check(r.outputs > 0 and r.max_abs_err == 0,
              f"{r.name} disagrees with its plain version")
        check(not r.missed, f"{r.name}: the inputs never reach {r.missed}")
    return {r.name: r for r in results}


def ycsb_key_lanes(np):
    """Raw keyhash lanes of phase 2's keyspace (keys user0 .. user999999):
    (hi, lo) uint32 and the 64-bit hashes."""
    from repro_torch.core.types import keyhash

    kh = np.fromiter((keyhash(f"user{k}") for k in range(N_KEYS)),
                     np.uint64, N_KEYS)
    return (kh >> np.uint64(32)).astype(np.uint32), kh.astype(np.uint32), kh


def _empty_planes(np, n_sets, n_ways):
    return (np.zeros((n_sets, n_ways), np.uint32),
            np.zeros((n_sets, n_ways), np.uint32),
            np.zeros((n_sets, n_ways), np.int32))


def _random_lanes(np, rng, n):
    return (rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32))


def phase_table_parity(np, parity, card, device, sync, key_lanes):
    """K1 and K6-K8 against their plain versions at full size."""
    rng = np.random.default_rng(SEED + 4)
    keys = dict(hi=key_lanes[0], lo=key_lanes[1],
                slot_map=rng.integers(0, N_SHARDS, 256).astype(np.int32))
    records = []
    for W in FIG11_WAYS:                 # figure 11: empty tables, SET
        q_hi, q_lo = _random_lanes(np, rng, 2 * FIG11_SLOTS)
        records.append((_empty_planes(np, FIG11_SLOTS // W, W),
                        dict(q_hi=q_hi, q_lo=q_lo)))
    r7 = np.random.default_rng(7)        # fig_fastpath.check_parity's cases
    for S, W in ((16, 2), (64, 4), (1024, 4)):
        for span, kspan in ((8, 4), (S * 2, 8), (S * 8, 2**32 - 1)):
            records.append((_empty_planes(np, S, W), dict(
                q_hi=r7.integers(0, kspan, 512).astype(np.uint32),
                q_lo=r7.integers(0, span, 512).astype(np.uint32))))
    pool = parity.key_pool(rng, 4 * TABLE_SETS, TABLE_SETS)
    records.append((parity.table_planes(rng, pool, TABLE_SETS, TABLE_WAYS),
                    parity.table_batch(rng, pool, 2 * FIG11_SLOTS,
                                       TABLE_WAYS)))
    fastpaths = []
    for W in (4, 8):
        pool = parity.key_pool(rng, 4 * TABLE_SETS, TABLE_SETS)
        fastpaths.append((parity.table_planes(rng, pool, TABLE_SETS, W),
                          parity.table_fastpath_batch(
                              rng, pool, TABLE_BATCH, WINDOW, W, N_SHARDS)))
    scans = [parity.scan_batch(rng, pool, TABLE_BATCH, WINDOW),
             parity.scan_batch(rng, pool, 1000, 777)]
    results = parity.check_table_kernels(keys, records, fastpaths, scans,
                                         device=device)
    sync()
    for r in results:
        say(card, f"parity {r.name}: {r.outputs} integers, "
                  f"max_abs_err {r.max_abs_err}, outcomes by code "
                  f"{r.coverage.tolist()}")
        check(r.outputs > 0 and r.max_abs_err == 0,
              f"{r.name} disagrees with its plain version")
        check(not r.missed, f"{r.name}: the inputs never reach {r.missed}")
    return {r.name: r for r in results}


# ---------------------------------------------------------------------------
# Phases 2 and 3: the slice end to end, with crashes, against the Python
# witness backend
# ---------------------------------------------------------------------------
def ycsb_a(np):
    rng = np.random.default_rng(SEED + 1)
    p = np.arange(1, N_KEYS + 1, dtype=np.float64) ** -THETA
    p /= p.sum()
    updates = rng.choice(N_KEYS, size=(N_BATCHES, BATCH), p=p)
    incr = rng.random((N_BATCHES, BATCH)) < 0.10
    lone = rng.choice(N_KEYS, size=(N_BATCHES, 2), p=p)
    reads = rng.choice(N_KEYS, size=(N_BATCHES, BATCH), p=p)
    return updates, incr, lone, reads


def _full_by_shard(cluster):
    """FULL rejects so far at each shard's current witnesses."""
    return [sum(w.stats["rejects_full"] for w in g.witnesses)
            for g in cluster.shards]


def drive(cluster, stream, sync):
    """One client drives the stream.  Returns the per-op outcomes and
    (batch, shard) of each, the read values, the model of acknowledged
    writes, each fused batch's wall time, and the witnesses' FULL rejects:
    the first batch in which each shard had one, and their total."""
    updates, incr, lone, reads = stream
    s = cluster.new_client()
    outcomes, where, read_values, model, batch_s = [], [], [], {}, []
    first_full, n_full = {}, 0

    def ack(key, op_incr, outcome, value):
        outcomes.append((outcome.value, outcome.rtts, outcome.fast_path,
                         outcome.synced_path, outcome.witness_accepts))
        where.append((b, cluster.shard_of(key)))
        model[key] = outcome.value if op_incr else value

    full_before = _full_by_shard(cluster)
    for b in range(updates.shape[0]):
        if b == CRASH_AT:
            for sid in CRASH_SHARDS:
                cluster.shards[sid].crash_master()
            full_before = _full_by_shard(cluster)   # fresh witnesses
        keys = [f"user{k}" for k in updates[b]]
        ops = [s.op_incr(k) if inc else s.op_set(k, f"v{b}")
               for k, inc in zip(keys, incr[b])]
        fused_before = (cluster._fused.stats["fused_batches"]
                        if cluster._fused is not None else 0)
        t0 = time.perf_counter()
        outs = cluster.update_batch(s, ops)
        sync()
        t1 = time.perf_counter()
        if (cluster._fused is not None
                and cluster._fused.stats["fused_batches"] > fused_before):
            batch_s.append(t1 - t0)
        for k, inc, o in zip(keys, incr[b], outs):
            ack(k, inc, o, f"v{b}")
        for j, k in enumerate(lone[b]):
            key = f"user{k}"
            inc = j == 1
            op = s.op_incr(key) if inc else s.op_set(key, f"lone{b}")
            ack(key, inc, cluster.update(s, op), f"lone{b}")
        full_now = _full_by_shard(cluster)
        for sid, (was, now) in enumerate(zip(full_before, full_now)):
            if now > was:
                first_full.setdefault(sid, b)
                n_full += now - was
        full_before = full_now
        for k in reads[b]:
            key = f"user{k}"
            v = cluster.read(s, s.op_get(key)).value
            check(v == model.get(key), f"read of {key} is {v!r}, "
                                       f"acknowledged {model.get(key)!r}")
            read_values.append(v)
    sync()
    for key, value in model.items():       # durability read-back
        v = cluster.read(s, s.op_get(key)).value
        check(v == value, f"read-back of {key} is {v!r}, acknowledged "
                          f"{value!r}")
    return dict(outcomes=outcomes, where=where, reads=read_values,
                model=model, batch_s=batch_s, first_full=first_full,
                n_full=n_full)


def unexplained_path_diffs(run_a, run_b):
    """Ops whose outcomes differ between two runs of one stream although
    no witness of their shard had rejected a record as FULL, in either run,
    by the end of the op's batch.  Until a shard's first FULL reject both
    runs hold the same records for it, so its ops must agree; after it,
    a rejected record takes the sync path and later windows may differ."""
    out = []
    for i, (a, b) in enumerate(zip(run_a["outcomes"], run_b["outcomes"])):
        batch, sid = run_a["where"][i]
        first = min(run_a["first_full"].get(sid, N_BATCHES),
                    run_b["first_full"].get(sid, N_BATCHES))
        if a != b and batch < first:
            out.append(i)
    return out


def phase_slice(np, card, device, sync):
    """The stream through three clusters: the device backend on ``device``
    (the main path, its launches counted), the same backend on the CPU
    (the plain versions: everything must be identical) and the Python
    witness backend (values, reads and the acknowledged writes must be
    identical; see the note on set placement below)."""
    from repro_torch.core import ShardedCluster, WitnessGeometry
    from repro_torch.kernels import ops as kops

    stream = ycsb_a(np)

    def cluster(backend, on):
        return ShardedCluster(n_shards=N_SHARDS, f=F,
                              geometry=WitnessGeometry(N_SETS, N_WAYS),
                              sync_batch=50, witness_backend=backend, seed=7,
                              device=on)

    dev = cluster("device", device)
    check(dev.gang.device.type == device, f"the gang is not on {device}")
    check(dev.gang.n_lanes >= N_SHARDS * F, f"{dev.gang.n_lanes} gang lanes")
    kops.reset_dispatch_count()
    kops.reset_launch_counts()                  # counts start here ...
    t0 = time.perf_counter()
    run_d = drive(dev, stream, sync)
    wall_d = time.perf_counter() - t0
    launches = {k.name: k.launches               # ... and are read here
                for k in kops.GANG_KERNELS}
    dispatches = kops.dispatch_count()
    fused = dict(dev._fused.stats)
    check(fused["fused_batches"] > 0, "no batch took the fused path")
    check(launches["gang_fastpath"] == fused["fused_batches"],
          "fused batches and fast-path launches differ")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    plain = cluster("device", "cpu")
    t0 = time.perf_counter()
    run_c = drive(plain, stream, lambda: None)
    wall_c = time.perf_counter() - t0
    for k in ("outcomes", "where", "reads", "first_full", "n_full"):
        check(run_d[k] == run_c[k], f"{k} differ from the plain versions")
    for sid in range(N_SHARDS):
        check(dev.shards[sid].master.stats == plain.shards[sid].master.stats,
              f"shard {sid} master stats differ from the plain versions")
    check((dev.gang.drain_counters() == plain.gang.drain_counters()).all(),
          "reason counters differ from the plain versions")

    ref = cluster("python", "cpu")
    t0 = time.perf_counter()
    run_p = drive(ref, stream, lambda: None)
    wall_p = time.perf_counter() - t0
    out_d, out_p = run_d["outcomes"], run_p["outcomes"]
    check(run_d["where"] == run_p["where"],
          "ops routed to other shards than in the Python backend")
    check([o[0] for o in out_d] == [o[0] for o in out_p],
          "op results differ from the Python backend")
    check(run_d["reads"] == run_p["reads"],
          "reads differ from the Python backend")
    check(run_d["model"] == run_p["model"],
          "acknowledged writes differ from the Python backend")
    # The device witness places a key in set (mixed low lane & (S-1)), the
    # Python witness in set (key hash % S); the slot route also reads the
    # mixed low lane, so on 64 shards a device witness fills 16 of its 1024
    # sets and rejects more records as FULL.  Those ops take the sync path,
    # so their path fields, and later windows of their shard, differ; an op
    # of a shard with no FULL reject yet, on either backend, may not.
    path_diff = sum(a != b for a, b in zip(out_d, out_p))
    stray = unexplained_path_diffs(run_d, run_p)
    check(not stray, f"{len(stray)} ops (first: {stray[:5]}) differ from "
                     f"the Python backend in a shard with no FULL reject")
    full_d, full_p = run_d["n_full"], run_p["n_full"]
    full_shards = sorted(set(run_d["first_full"]) | set(run_p["first_full"]))
    model, reads_d, batch_s = run_d["model"], run_d["reads"], run_d["batch_s"]

    n_ops = len(out_d)
    fast = sum(o[2] for o in out_d)
    say(card, f"slice: {n_ops} updates + {len(reads_d)} reads, fast-path "
              f"share {fast / n_ops:.4f}, fused batches "
              f"{fused['fused_batches']}/{N_BATCHES} "
              f"({fused['fused_batches'] / N_BATCHES:.3f}), declined "
              f"{fused['declined']}, fast-path dispatches per fused batch "
              f"{launches['gang_fastpath'] / fused['fused_batches']:.0f}, "
              f"all dispatches {dispatches}")
    say(card, f"slice: kernel launches {launches}")
    say(card, "slice: outcomes, reads, master stats and reason counters "
              "identical to the same backend on the CPU (plain versions)")
    say(card, f"slice: results, reads and {len(model)} acknowledged keys "
              f"(read back after crashing shards {list(CRASH_SHARDS)} at "
              f"batch {CRASH_AT}) identical to the Python backend; path "
              f"fields differ on {path_diff} of {n_ops} ops, each in a "
              f"shard after its first witness FULL reject (FULL rejects: "
              f"device {full_d}, Python {full_p}, in {len(full_shards)} of "
              f"{N_SHARDS} shards)")
    lat = np.array(batch_s) * 1e3
    timing = dict(
        fused_batch_ms_p50=float(np.percentile(lat, 50)),
        fused_batch_ms_p99=float(np.percentile(lat, 99)),
        fused_updates_per_s=float(BATCH * len(lat) / (lat.sum() / 1e3)),
        device_run_s=wall_d, plain_run_s=wall_c, python_run_s=wall_p)
    say(card, "slice times: fused batch p50 {fused_batch_ms_p50:.3f} ms, "
              "p99 {fused_batch_ms_p99:.3f} ms, {fused_updates_per_s:.0f} "
              "updates/s in fused batches; whole runs: device "
              "{device_run_s:.2f} s, plain versions on the CPU "
              "{plain_run_s:.2f} s, Python backend {python_run_s:.2f} s"
        .format(**timing))
    return dev, launches, dict(
        timing, fused=fused, dispatches=dispatches, ops=n_ops,
        fast_share=fast / n_ops, path_diff_vs_python=path_diff,
        full_rejects_device=full_d, full_rejects_python=full_p,
        full_shards=len(full_shards))


# ---------------------------------------------------------------------------
# Phase 5: the single-table path through its public ops
# ---------------------------------------------------------------------------
def phase_table_path(np, torch, card, device, key_lanes):
    """fig_fastpath's and fig11's claims on the card, and shard_route
    against the host SlotRouter.  Returns the launches of K1 and K6-K8 over
    this phase and what it measured."""
    from repro_torch.core.shard import SlotRouter
    from repro_torch.kernels import (
        WitnessTable,
        conflict_scan,
        default_slot_map,
        fastpath_batch,
        keyhash2x32,
        ops as kops,
        shard_route,
        witness_record,
    )

    rng = np.random.default_rng(SEED + 5)
    kops.reset_dispatch_count()
    kops.reset_launch_counts()                  # counts start here ...

    # Dispatches: the per-op pipeline against one fused batch.
    khi, klo = _random_lanes(np, rng, 64)
    win, wv = np.zeros(8, np.uint32), np.zeros(8, np.int32)
    table = WitnessTable.empty(TABLE_SETS, TABLE_WAYS, device=device)
    per_op_acc = []
    for i in range(64):
        qh, ql = keyhash2x32(khi[i:i + 1], klo[i:i + 1], device=device)
        acc, table = witness_record(table, qh, ql)
        conflict_scan(win, win, wv, qh, ql, device=device)
        per_op_acc.append(int(acc[0]))
    per_op = kops.dispatch_count() / 64
    before = kops.dispatch_count()
    res = fastpath_batch(WitnessTable.empty(TABLE_SETS, TABLE_WAYS,
                                            device=device),
                         khi, klo, window_hi=win, window_lo=win,
                         window_valid=wv)
    fused = kops.dispatch_count() - before
    check(per_op >= 3, f"the per-op path took {per_op} dispatches per op")
    check(fused == 1, f"fastpath_batch took {fused} dispatches")
    check(list(res.accepted) == per_op_acc,
          "the fused batch and the per-op path accept differently")
    say(card, f"table path: per-op path {per_op:.0f} dispatches per op "
              f"(64 ops), fastpath_batch {fused} per batch")

    # Records/s against batch size, over fig_fastpath's geometries.
    sweep = []
    for S, W in SWEEP_GEOMETRIES:
        for B in SWEEP_BATCHES:
            bhi, blo = _random_lanes(np, rng, B)
            t = WitnessTable.empty(S, W, device=device)
            us = _event_ms(torch, lambda: fastpath_batch(t, bhi, blo),
                           lambda: [p.zero_() for p in t], SWEEP_REPS) * 1e3
            sweep.append(dict(geometry=f"{S}x{W}", batch=B, us_per_batch=us,
                              records_per_s=B / us * 1e6))
            say(card, f"sweep {S}x{W} batch {B}: {us:.1f} us per batch, "
                      f"{B / us * 1e6:.0f} records/s")
    base = [r["records_per_s"] for r in sweep if r["geometry"] == "1024x4"]
    check(all(a < b for a, b in zip(base, base[1:])),
          f"records/s do not rise with the batch at 1024x4: {base}")

    # Figure 11: inserts before the first reject, by associativity.
    fig11 = {}
    for W in FIG11_WAYS:
        firsts = []
        for trial in range(FIG11_TRIALS):
            r = np.random.default_rng(trial)
            t = WitnessTable.empty(FIG11_SLOTS // W, W, device=device)
            qh = r.integers(0, 2**32, 2 * FIG11_SLOTS, dtype=np.uint32)
            ql = r.integers(0, 2**32, 2 * FIG11_SLOTS, dtype=np.uint32)
            acc, _ = witness_record(t, qh, ql)
            rejects = np.flatnonzero(acc == 0)
            firsts.append(int(rejects[0]) if len(rejects) else len(acc))
        fig11[W] = float(np.mean(firsts))
    check(fig11[4] > 2.5 * fig11[1],
          f"4-way capacity {fig11[4]} is not 2.5x direct-mapped {fig11[1]}")
    say(card, f"fig11: mean inserts before the first reject at "
              f"{FIG11_SLOTS} slots over {FIG11_TRIALS} trials, by ways "
              f"{fig11}; direct-mapped {fig11[1]:.2f} (the paper: about 80); "
              f"4-way / direct {fig11[4] / fig11[1]:.2f}")

    # shard_route against the host SlotRouter, on the phase 2 keyspace.
    hi, lo, kh = (a[:ROUTE_KEYS] for a in key_lanes)
    maps = dict(default=default_slot_map(N_SHARDS),
                random=rng.integers(0, N_SHARDS, 256).astype(np.int32))
    for label, sm in maps.items():
        got = (shard_route(hi, lo, N_SHARDS, device=device)
               if label == "default" else
               shard_route(hi, lo, slot_map=sm, device=device))
        router = SlotRouter(sm.tolist())
        want = np.fromiter((router.shard_of_hash(int(h)) for h in kh),
                           np.int32, len(kh))
        check((got == want).all(),
              f"shard_route and SlotRouter disagree on the {label} map")
    say(card, f"shard_route equals SlotRouter on {ROUTE_KEYS} keys, on the "
              f"default and a random slot map of {N_SHARDS} shards")

    breakdown = _table_breakdown(np, torch, card, rng, device)

    launches = {k.name: k.launches              # ... and are read here
                for k in kops.TABLE_KERNELS}
    dispatches = kops.dispatch_count()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the table path")
    say(card, f"table path: kernel launches {launches}, dispatches "
              f"{dispatches}")
    return launches, dict(per_op_dispatches=per_op, fused_dispatches=fused,
                          sweep=sweep, fig11=fig11, dispatches=dispatches,
                          breakdown=breakdown)


def _table_breakdown(np, torch, card, rng, device):
    """Where one fastpath_batch call of TABLE_BATCH ops at 1024 x 4 spends
    its time: device busy against wall under the profiler, then the host's
    self time by function over 20 calls under cProfile (shares only:
    cProfile inflates Python-heavy code)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import WitnessTable, fastpath_batch

    bhi, blo = _random_lanes(np, rng, TABLE_BATCH)
    t = WitnessTable.empty(TABLE_SETS, TABLE_WAYS, device=device)
    fastpath_batch(t, bhi, blo)
    for p in t:
        p.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fastpath_batch(t, bhi, blo)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = _device_us(prof)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(20):
        fastpath_batch(t, bhi, blo)
    torch.cuda.synchronize()
    prof.disable()
    by_fn = {}
    for (path, _line, fn), (_cc, _nc, tt, _ct, _callers) in \
            pstats.Stats(prof).stats.items():
        name = fn if path == "~" else f"{Path(path).name}:{fn}"
        by_fn[name] = by_fn.get(name, 0.0) + tt
    total = sum(by_fn.values())
    shares = sorted(((v / total, k) for k, v in by_fn.items()), reverse=True)
    idle = None if busy_us is None else 1.0 - busy_us / wall_us
    say(card, f"table path: one fastpath_batch of {TABLE_BATCH} at "
              f"{TABLE_SETS}x{TABLE_WAYS}: wall {wall_us:.1f} us, device "
              + ("busy not measured" if busy_us is None else
                 f"busy {busy_us:.1f} us, idle share {idle:.4f}"))
    say(card, f"table path: host self time of 20 calls under cProfile, "
              f"{total * 1e3:.1f} ms, by function: "
              + ", ".join(f"{k} {sh:.3f}" for sh, k in shares[:8]))
    return dict(wall_us=wall_us, busy_us=busy_us, idle_share=idle,
                host_ms=total * 1e3,
                shares={k: sh for sh, k in shares[:20]})


# ---------------------------------------------------------------------------
# Phase 4: times at phase 2's shapes
# ---------------------------------------------------------------------------
def _event_ms(torch, fn, restore, iters):
    for _ in range(2):
        restore()
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        restore()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def _device_us(prof, only=None):
    """Device time in a torch.profiler trace taken with CUDA activity only
    (kernels, fills and copies), in µs; with ``only``, of the entries whose
    name holds it.  None if the trace saw none."""
    total = 0.0
    for e in prof.key_averages():
        if only is None or only in e.key:
            total += (getattr(e, "self_device_time_total", 0)
                      or getattr(e, "self_cuda_time_total", 0))
    return total or None


def _device_ms(torch, fn, iters=20, before=None, only=None):
    """Device time of one call, from a profiler trace of ``iters`` calls
    back to back (state not restored, so later calls meet their own
    records).  ``before`` runs ahead of each call (e.g. an L2 flush) and
    ``only`` keeps the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    us = _device_us(prof, only)
    return None if us is None else us / 1e3 / iters


def _bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _probe_bytes(np, rows, n_ways):
    """A probe reads occ, keys_hi, keys_lo, rpc_hi and rpc_lo of each way
    of its row once (age is written, never read)."""
    return int(np.unique(rows).size) * n_ways * 20


def _write_bytes(np, planes_before, table, counters=None):
    """Bytes a call must write: each table word it changed, and each
    reason counter it bumped (read and written; counters start at 0)."""
    from repro_torch.kernels import gang_to_numpy

    n = sum(int((a != b).sum())
            for a, b in zip(planes_before, gang_to_numpy(table)))
    c = 0 if counters is None else int((counters != 0).sum())
    return 4 * n + 8 * c


def phase_times(np, torch, dev_cluster, card, device):
    """Each kernel at phase 2's shapes.  Bounds count the bytes this run's
    inputs need: operands without padding or valid flags, the five planes
    a probe reads for each probed row, the table words and counters the
    call changed, and one matrix row per class present."""
    from repro_torch.kernels import gang_to_numpy, ops as kops, parity, ref

    dev = torch.device(device)
    table0 = dev_cluster.gang.table.clone()
    planes = gang_to_numpy(table0)
    L = table0.occ.shape[0] // N_SETS
    W = N_WAYS
    rng = np.random.default_rng(SEED + 2)
    pool = parity.key_pool(rng, 4 * N_SETS, N_SETS)
    counters = torch.zeros((L, 5), dtype=torch.int32, device=dev)
    table = table0.clone()
    fp = parity.fastpath_batch(rng, pool, BATCH, N_SHARDS, 1024, F, L, 256,
                               256)
    rings0 = ref.ring_from_numpy(fp.pop("ring_hi"), fp.pop("ring_lo"),
                                 fp.pop("ring_cls"), dev)
    rings = [r.clone() for r in rings0]

    def restore():
        for p, p0 in zip([*table, *rings], [*table0, *rings0]):
            p.copy_(p0)
        counters.zero_()

    def once(fn):
        """One call from the restored state; returns the bytes it wrote."""
        restore()
        fn()
        torch.cuda.synchronize()
        return _write_bytes(np, planes, table, counters)

    def timed(kernel, plain, nbytes, nops):
        t = dict(ms=_event_ms(torch, kernel, restore, 50),
                 plain_ms=_event_ms(torch, plain, restore, 5),
                 bytes=nbytes, bound=_bound_ms(nbytes, nops))
        restore()
        t["device_ms"] = _device_ms(torch, kernel)
        return t

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    out = {}
    # One fused batch: 1024 ops over 64 shard rings, each op recorded at
    # its shard's f witness lanes.
    fargs = kops.fastpath_operands(table0, N_SETS, **fp)
    k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, ex, sm, lm, tail, count = fargs
    qh, ql = ref.np_keyhash2x32(fp["key_hi"], fp["key_lo"])
    shard = fp["slot_map"][ql % np.uint32(fp["slot_map"].size)]
    rows_e = (fp["lane_map"][shard].astype(np.int64) * N_SETS
              + (ql & np.uint32(N_SETS - 1)).astype(np.int64)[:, None]
              ).reshape(-1)
    n_cls = int(np.unique(fp["key_cls"]).size)

    # K2 as the main path launches it: K3's record stage (rep = f) over
    # the batch's B * f witness copies.
    t_rows = on_card(rows_e.astype(np.int32))
    t_qh, t_ql = on_card(qh), on_card(ql)
    ones_e = torch.ones(BATCH * F, dtype=torch.int32, device=dev)

    def stage():
        return kops._record_runs(table, N_SETS, t_rows, F, t_qh, t_ql, r_hi,
                                 r_lo, k_cls, counters)

    def stage_plain():
        rep = lambda x: torch.repeat_interleave(x, F)  # noqa: E731
        rsn = ref.record_rows_plain(table, t_rows, rep(t_qh), rep(t_ql),
                                    rep(r_hi), rep(r_lo), rep(k_cls), ones_e)
        ref.reason_counts_update(counters, t_rows // N_SETS, rsn, ones_e)
        return rsn

    nbytes = (BATCH * F * 4 * 2          # rows in, reasons out
              + BATCH * 5 * 4            # q_hi, q_lo, rpc_hi, rpc_lo, class
              + n_cls * 4 + _probe_bytes(np, rows_e, W) + once(stage))
    out["gang_record"] = timed(stage, stage_plain, nbytes,
                               BATCH * F * W * 10)

    # K3: the whole fused batch (its time includes K2's record stage).
    def run_fp(fn):
        return fn(table, N_SETS, F, k_hi, k_lo, k_cls, k_valid, r_hi, r_lo,
                  ex, sm, lm, *rings, tail, count, counters)

    live = int(fp["count"][np.unique(shard)].sum())
    appends = int(fp["exec_pred"].sum())
    nbytes = (BATCH * 6 * 4              # keys, class, rpc, exec_pred
              + fp["slot_map"].size * 4  # slot map
              + N_SHARDS * (F + 2) * 4   # lane map, tail, count
              + n_cls * 4                # matrix rows
              + live * 12              # live ring spans of touched shards
              + appends * 12 + N_SHARDS * 4  # ring appends, new counts
              + BATCH * (F + 4) * 4      # reasons, conflicts, shard, q_hi/lo
              + _probe_bytes(np, rows_e, W)
              + once(lambda: run_fp(kops.gang_fastpath_cuda)))
    scanned = int(fp["count"][shard].sum())     # ring entries the ops scan
    nops = BATCH * (BATCH - 1) // 2 * 6 + scanned * 6 + BATCH * F * W * 10
    out["gang_fastpath"] = timed(
        lambda: run_fp(kops.gang_fastpath_cuda),
        lambda: run_fp(ref.gang_fastpath_plain), nbytes, nops)

    # K4: one sync round's gc_many: entries at a shard's f aged lanes.
    gc = parity.gc_batch(rng, planes, N_SETS, 150, 256)
    aged = [w.lane for w in dev_cluster.shards[1].witnesses]
    gc["aged_lanes"] = np.zeros(L, np.int32)
    gc["aged_lanes"][aged] = 1
    gargs = kops.gc_operands(table0, N_SETS, **gc)
    wrote = once(lambda: kops.gang_gc_cuda(table, N_SETS, *gargs, True))
    G = len(gc["g_hi"])
    probed = np.zeros((L * N_SETS, W), bool)
    probed[gc["g_lane"].astype(np.int64) * N_SETS
           + (gc["g_lo"] & np.uint32(N_SETS - 1))] = True
    in_aged = np.zeros((L, N_SETS * W), bool)
    in_aged[aged] = True
    in_aged = in_aged.reshape(L * N_SETS, W)
    occ_after = gang_to_numpy(table)[2]
    nbytes = (G * 5 * 4 + len(aged) * 4 + G * 4  # entries, lane ids, bits
              + int(probed.sum()) * 16            # keys, rpcs of probed rows
              + int((probed | in_aged).sum()) * 4  # occ, read once
              + int((in_aged & (occ_after > 0)).sum()) * 4  # ages that grow
              + wrote)
    out["gang_gc"] = timed(
        lambda: kops.gang_gc_cuda(table, N_SETS, *gargs, True),
        lambda: ref.gang_gc_plain(table, N_SETS, *gargs, True), nbytes,
        G * W * 10 + int(in_aged.sum()) * 3)

    # K5: DeviceWitness.record, one single-key op (G = K = 1): key, class,
    # lane and rpc in; one row probed; reason and mixed lanes out.
    grp = parity.group_batch(rng, pool, 1, 1, L, 256)
    rargs = kops.groups_operands(table0, N_SETS, **grp)
    row = (grp["lanes"][:1].astype(np.int64) * N_SETS
           + (ref.np_keyhash2x32(grp["key_hi"][0, :1], grp["key_lo"][0, :1])[1]
              & np.uint32(N_SETS - 1)))
    nbytes = (6 * 4 + 4 + _probe_bytes(np, row, W) + 3 * 4
              + once(lambda: kops.gang_groups_cuda(table, N_SETS, *rargs,
                                                   counters)))
    out["gang_record_groups"] = timed(
        lambda: kops.gang_groups_cuda(table, N_SETS, *rargs, counters),
        lambda: ref.gang_groups_plain(table, N_SETS, *rargs, counters),
        nbytes, W * 10)
    for name, t in out.items():
        dms = ("not measured" if t["device_ms"] is None
               else f"{t['device_ms']:.4f} ms")
        say(card, f"time {name}: {t['ms']:.4f} ms per call (CUDA events), "
                  f"device time {dms} (profiler), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms "
                  f"({t['bound'][1]}, {t['bytes']} B)")
    return out


def phase_table_times(np, torch, card, device, key_lanes):
    """K1 and K6-K8 at phase 5's shapes.  Bounds count what this run's data
    needs: each operand once without padding or valid flags, the three
    planes of each probed set once, each table word the call changed, and
    for a scan every (query, window entry) pair up to the query's first
    hit, at 6 integer operations a pair."""
    from repro_torch.kernels import WitnessTable, ops as kops, parity, ref

    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 6)

    def on_card(*arrays):
        return kops._to_device(dev, *arrays)

    def timed(kernel, plain, restore, nbytes, nops):
        t = dict(ms=_event_ms(torch, kernel, restore, 50),
                 plain_ms=_event_ms(torch, plain, restore, 5),
                 bytes=nbytes, ops=nops, bound=_bound_ms(nbytes, nops))
        restore()
        t["device_ms"] = _device_ms(torch, kernel)
        return t

    def changed_bytes(fn, table, restore):
        restore()
        before = [p.clone() for p in table]
        fn()
        torch.cuda.synchronize()
        return 4 * sum(int((a != b).sum()) for a, b in zip(before, table))

    def scan_pairs(q_hi, q_lo, q_cls, w_hi, w_lo, w_valid):
        """Pairs a scan needs: up to each query's first conflicting entry,
        the whole window for a query with none."""
        mrow = ref.conflict_matrix_np()[q_cls]
        wcls = np.maximum(w_valid - 1, 0)
        hit = ((q_hi[:, None] == w_hi[None]) & (q_lo[:, None] == w_lo[None])
               & (w_valid[None] > 0)
               & (((mrow[:, None] >> wcls[None]) & 1) == 1))
        first = np.where(hit.any(1), hit.argmax(1) + 1, w_hi.size)
        return int(first.sum())

    out = {}
    # K1: keyhash2x32 over phase 2's keyspace, 16 B per key.  Back to back
    # its 16 MB stay in the 50 MB L2; the cold time writes 128 MB between
    # calls first.
    n = N_KEYS
    hi, lo = on_card(key_lanes[0], key_lanes[1])
    out["keyhash"] = timed(lambda: kops.keyhash_cuda(hi, lo),
                           lambda: ref.keyhash_plain(hi, lo), lambda: None,
                           16 * n, 29 * n)
    flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    out["keyhash"]["device_ms_cold"] = _device_ms(
        torch, lambda: kops.keyhash_cuda(hi, lo), before=flush.zero_,
        only="keyhash_kernel")
    del flush

    # K6: figure 11's record at the paper's geometry, 8192 random queries
    # into an empty 1024 x 4 table.
    table = WitnessTable.empty(TABLE_SETS, TABLE_WAYS, device=dev)

    def clear():
        for p in table:
            p.zero_()

    q_hi, q_lo = _random_lanes(np, rng, 2 * FIG11_SLOTS)
    args = kops.table_record_operands(table, q_hi, q_lo)
    B = q_hi.size
    sets = np.unique(q_lo & np.uint32(TABLE_SETS - 1)).size
    nbytes = (B * 16 + sets * TABLE_WAYS * 12
              + changed_bytes(lambda: kops.witness_record_cuda(table, *args),
                              table, clear))
    out["witness_record"] = timed(
        lambda: kops.witness_record_cuda(table, *args),
        lambda: ref.witness_record_plain(table, *args), clear, nbytes,
        B * TABLE_WAYS * 6)

    # K7: one fused batch of 4096 ops against a 1024-entry window.
    pool = parity.key_pool(rng, 4 * TABLE_SETS, TABLE_SETS)
    planes = parity.table_planes(rng, pool, TABLE_SETS, TABLE_WAYS)
    fp = parity.table_fastpath_batch(rng, pool, TABLE_BATCH, WINDOW,
                                     TABLE_WAYS, N_SHARDS)
    table0 = ref.witness_table_from_numpy(planes, dev)
    table = table0.clone()

    def restore():
        for p, p0 in zip(table, table0):
            p.copy_(p0)

    fargs = kops.table_fastpath_operands(table0, **fp)
    qh, ql = ref.np_keyhash2x32(fp["key_hi"], fp["key_lo"])
    sets = np.unique(ql & np.uint32(TABLE_SETS - 1)).size
    pairs = scan_pairs(qh, ql, fp["key_cls"], fp["window_hi"],
                       fp["window_lo"], fp["window_valid"])
    nbytes = (TABLE_BATCH * 12 + WINDOW * 12 + fp["slot_map"].size * 4
              + TABLE_BATCH * 20 + sets * TABLE_WAYS * 12
              + changed_bytes(
                  lambda: kops.fastpath_record_scan_cuda(table, *fargs),
                  table, restore))
    out["fastpath_record_scan"] = timed(
        lambda: kops.fastpath_record_scan_cuda(table, *fargs),
        lambda: ref.fastpath_record_scan_plain(table, *fargs), restore,
        nbytes, pairs * 6 + TABLE_BATCH * (29 + TABLE_WAYS * 6))

    # K8: 4096 queries against a 1024-entry window.
    sc = parity.scan_batch(rng, pool, TABLE_BATCH, WINDOW)
    sargs = kops.scan_operands(dev, **sc)
    pairs = scan_pairs(sc["q_hi"], sc["q_lo"], sc["q_cls"], sc["w_hi"],
                       sc["w_lo"], sc["w_valid"])
    out["conflict_scan"] = timed(
        lambda: kops.conflict_scan_cuda(*sargs),
        lambda: ref.conflict_scan_plain(*sargs), lambda: None,
        TABLE_BATCH * 16 + WINDOW * 12, pairs * 6)
    for name, t in out.items():
        dms = ("not measured" if t["device_ms"] is None
               else f"{t['device_ms']:.4f} ms")
        if "device_ms_cold" in t:
            dms += (", cold L2 not measured" if t["device_ms_cold"] is None
                    else f", cold L2 {t['device_ms_cold']:.4f} ms")
        say(card, f"time {name}: {t['ms']:.4f} ms per call (CUDA events), "
                  f"device time {dms} (profiler), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms "
                  f"({t['bound'][1]}, {t['bytes']} B, {t['ops']} ops)")
    return out


def phase_idle(np, torch, dev_cluster, card):
    """One more fused batch of the stream's shape under the profiler: the
    device's busy time against the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 3)
    p = np.arange(1, N_KEYS + 1, dtype=np.float64) ** -THETA
    keys = rng.choice(N_KEYS, size=BATCH, p=p / p.sum())
    s = dev_cluster.new_client()
    ops = [s.op_set(f"user{k}", "idle") for k in keys]
    fused = dev_cluster._fused.stats["fused_batches"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dev_cluster.update_batch(s, ops)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(dev_cluster._fused.stats["fused_batches"] == fused + 1,
          "the profiled batch did not fuse")
    us = _device_us(prof)
    busy_ms = None if us is None else us / 1e3
    idle = None if busy_ms is None else 1.0 - busy_ms / wall_ms
    say(card, f"idle: one fused batch of {BATCH} SETs under the profiler: "
              f"wall {wall_ms:.3f} ms, device busy "
              + ("not measured" if busy_ms is None else
                 f"{busy_ms:.3f} ms, idle share {idle:.4f}"))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=idle,
                host=_host_profile(np, torch, dev_cluster, card, rng, p))


def _host_profile(np, torch, dev_cluster, card, rng, p):
    """One more fused batch under cProfile: the host's self time summed by
    source file, the layers of the slice (cProfile inflates Python-heavy
    code, so read the shares, not the total)."""
    import cProfile
    import pstats

    s = dev_cluster.new_client()
    ops = [s.op_set(f"user{k}", "host")
           for k in rng.choice(N_KEYS, size=BATCH, p=p / p.sum())]
    prof = cProfile.Profile()
    prof.enable()
    dev_cluster.update_batch(s, ops)
    torch.cuda.synchronize()
    prof.disable()
    by_file = {}
    for (path, _line, fn), (_cc, _nc, tt, _ct, _callers) in \
            pstats.Stats(prof).stats.items():
        if path.startswith(str(SRC)):
            name = str(Path(path).relative_to(SRC))
        elif path == "~":                       # a C function, by its name
            name = fn
        elif "site-packages" in path:           # a package, by its name
            name = path.split("site-packages/")[1].split("/")[0]
        else:
            name = Path(path).name
        by_file[name] = by_file.get(name, 0.0) + tt
    total = sum(by_file.values())
    shares = sorted(((t / total, f) for f, t in by_file.items()),
                    reverse=True)
    say(card, f"host: self time of one fused batch under cProfile, "
              f"{total * 1e3:.1f} ms, by file: "
              + ", ".join(f"{f} {sh:.3f}" for sh, f in shares[:8]))
    return dict(total_ms=total * 1e3,
                shares={f: sh for sh, f in shares})


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 3
    from repro_torch.kernels import build, ops as kops, parity

    card = card_label()
    t0 = time.perf_counter()
    build.build_all()
    say(card, f"build: {len(list(build.CSRC.glob('*.cu')))} sources in "
              f"{time.perf_counter() - t0:.1f} s into {build.build_dir()}")
    for line in build.ptxas_reports():
        print(f"  {line}")
    sync = torch.cuda.synchronize
    key_lanes = ycsb_key_lanes(np)
    par = phase_parity(np, parity, card, "cuda", sync)
    par.update(phase_table_parity(np, parity, card, "cuda", sync, key_lanes))
    dev_cluster, launches, slice_info = phase_slice(np, card, "cuda", sync)
    table_launches, table_info = phase_table_path(np, torch, card, "cuda",
                                                  key_lanes)
    launches.update(table_launches)
    times = phase_times(np, torch, dev_cluster, card, "cuda")
    times.update(phase_table_times(np, torch, card, "cuda", key_lanes))
    idle = phase_idle(np, torch, dev_cluster, card)
    kernels = []
    for k in kops.KERNELS:
        t = times[k.name]
        kernels.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[k.name], max_abs_err=par[k.name].max_abs_err,
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=None))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, slice=slice_info, table_path=table_info,
        times=times, idle=idle,
        ptxas=build.ptxas_reports()), indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
