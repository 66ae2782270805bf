"""Fused cluster batches: the whole multi-shard update hot loop in ONE
device dispatch (DESIGN.md §4, paper §3.2.3 + §4.2 + §4.4).

Two pieces live here:

``DeviceRing`` — the device-resident master window.  Each shard's unsynced
keyhashes (the contents of ``Master._unsynced_keyhash``) live in one row of
a [n_shards, CAP] ring buffer of mixed 2x32 keyhash lanes.  Entries are
appended by the fused kernel itself (one slot per executed op, batch order),
and the tail advances by pure host arithmetic when a sync round moves
``Master.synced_index`` — the kernel's liveness test ``(slot - tail) % CAP <
count`` needs no device writes to expire entries.  The ring is a *cache* of
master log state: each shard carries a coherence snapshot (log list
identity, log length, synced index) and any divergence — a crash, a
migration, an op that took the unfused path — just invalidates the row,
which rebuilds from ``log[synced_index:]`` on the next fused batch.

``FusedBatchDriver`` — drives ``ShardedCluster.update_batch`` through
``repro_torch.kernels.gang_fastpath_batch``: keyhash -> slot route -> ring
conflict scan -> ring append -> witness record at every target shard's f
stacked gang lanes, ONE dispatch for the whole routed batch.  The master
rounds then run with the kernel's conflict bit passed as the ``commutes``
override, so the host ``_unsynced_keyhash`` dict is never consulted.

The driver is an *opportunistic* fast path: ``try_update_batch`` returns
None whenever anything falls off its eligibility envelope (multi-key or txn
ops, dropped witnesses, mid-reconfiguration state, ring overflow...) and the
caller runs the regular per-shard path.  Conflict bits from the ring can
only over-approximate the host window (mixed-lane collisions; intra-batch
predicted-execute ops that later RIFL-dup) — an op is never under-synced.
RIFL duplicates are predicted exactly in preflight (acks are applied first,
mirroring ``Master.handle_update`` order), so the ring admits exactly the
ops the masters go on to log.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from .client import Decision
from .master import DUP, ERROR, SYNCED
from .telemetry import span
from .types import Op, OpType, RecordStatus, WitnessMode

_M32 = 0xFFFFFFFF

# Ops the fused kernel understands: single-key plain updates whose merge
# lattice expands to exactly ONE (key_hash, class) pair — the kernel carries
# one class lane per op slot.  Everything else (txn legs, migration ops,
# multi-key msets, HMSETs with per-field FIELD pairs) has protocol side
# effects or pair fan-out the one-dispatch pipeline doesn't model and takes
# the regular path.
_PLAIN_UPDATES = {OpType.SET, OpType.INCR, OpType.HMSET, OpType.DEL,
                  OpType.SADD, OpType.APPEND, OpType.MAX}

RING_CAP = 1024


@dataclass
class _RingSnap:
    """Coherence snapshot of one shard's master log vs its ring row.

    ``log_ref`` pins the log *list object*: the log is append-only in place,
    so (same list, same length, same synced index) implies the unsynced
    window is bit-identical to what the ring row holds.  Recovery installs
    a fresh list (``restore_from_log``), failover installs a fresh master —
    both change the identity and invalidate the row.
    """
    log_ref: List[Any]
    log_len: int
    synced: int


class DeviceRing:
    """[n_shards, CAP] device-resident unsynced-window rings (mixed lanes,
    uint32 bits held in int32 tensors on ``device``)."""

    def __init__(self, n_shards: int, cap: int = RING_CAP,
                 device="cuda") -> None:
        self.cap = cap
        self.n_shards = n_shards
        self.device = torch.device(device)
        self.hi = torch.zeros((n_shards, cap), dtype=torch.int32,
                              device=self.device)
        self.lo = torch.zeros_like(self.hi)
        self.cls = torch.zeros_like(self.hi)
        self.tail = np.zeros(n_shards, np.int32)
        self.count = np.zeros(n_shards, np.int32)
        self._snap: Dict[int, _RingSnap] = {}

    # -- coherence ----------------------------------------------------------
    def invalidate(self, shard_id: int) -> None:
        self._snap.pop(shard_id, None)

    def _coherent(self, shard_id: int, master) -> bool:
        snap = self._snap.get(shard_id)
        return (
            snap is not None
            and snap.log_ref is master.log
            and snap.log_len == len(master.log)
            and snap.synced == master.synced_index
        )

    def ensure(self, shard_id: int, master, reserve: int) -> bool:
        """Make the shard's row mirror ``log[synced_index:]`` with room for
        ``reserve`` more appends; False means the window doesn't fit and the
        caller must decline (or drain first)."""
        if not self._coherent(shard_id, master):
            pairs = [pair for e in master.log[master.synced_index:]
                     for pair in e.op.hash_classes()]
            n = len(pairs)
            if n + reserve > self.cap:
                return False
            self._rebuild_row(shard_id, pairs)
            self._snap[shard_id] = _RingSnap(
                master.log, len(master.log), master.synced_index
            )
        return int(self.count[shard_id]) + reserve <= self.cap

    def _rebuild_row(self, shard_id: int, pairs: Sequence) -> None:
        """Mirror ``log[synced_index:]`` as (key_hash, class) lattice pairs —
        the same expansion the master's host window refcounts, so the
        kernel's matrix consult sees exactly the host conflict set.  Only
        this shard's row is written, on the device."""
        from ..kernels import np_keyhash2x32

        row = np.zeros((3, self.cap), np.int32)
        if pairs:
            khs = [kh for kh, _c in pairs]
            k_hi = np.fromiter(((k >> 32) & _M32 for k in khs),
                               np.uint32, len(khs))
            k_lo = np.fromiter((k & _M32 for k in khs), np.uint32, len(khs))
            qh, ql = np_keyhash2x32(k_hi, k_lo)
            row[0, :len(khs)] = qh.view(np.int32)
            row[1, :len(khs)] = ql.view(np.int32)
            row[2, :len(khs)] = [c for _kh, c in pairs]
        row = torch.from_numpy(row).to(self.device)
        self.hi[shard_id] = row[0]
        self.lo[shard_id] = row[1]
        self.cls[shard_id] = row[2]
        self.tail[shard_id] = 0
        self.count[shard_id] = len(pairs)

    def committed(self, shard_id: int, master, appended: int) -> None:
        """The fused batch's master rounds are done: verify the masters
        logged exactly the ops the kernel appended, else drop the row."""
        snap = self._snap.get(shard_id)
        if snap is None:
            return
        if (snap.log_ref is master.log
                and len(master.log) == snap.log_len + appended
                and master.synced_index == snap.synced):
            snap.log_len += appended
        else:
            self.invalidate(shard_id)

    def advance(self, shard_id: int, master) -> None:
        """Expire entries a sync round just gc'd: pure host arithmetic on
        (tail, count) — the device rows are untouched."""
        snap = self._snap.get(shard_id)
        if snap is None:
            return
        if snap.log_ref is not master.log or snap.log_len != len(master.log):
            self.invalidate(shard_id)
            return
        if master.synced_index == snap.synced:
            return
        adv = sum(len(e.op.hash_classes())
                  for e in master.log[snap.synced:master.synced_index])
        if adv > int(self.count[shard_id]):
            self.invalidate(shard_id)
            return
        self.tail[shard_id] = (self.tail[shard_id] + adv) % self.cap
        self.count[shard_id] -= adv
        snap.synced = master.synced_index


class FusedBatchDriver:
    """One-dispatch multi-shard batches over the cluster's shared gang."""

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self.ring = DeviceRing(len(cluster.shards), device=cluster.gang.device)
        self.stats = {"fused_batches": 0, "fused_ops": 0, "declined": 0}

    # -- plumbing -----------------------------------------------------------
    def _resize(self) -> None:
        if self.ring.n_shards != len(self.cluster.shards):
            self.ring = DeviceRing(len(self.cluster.shards),
                                   device=self.cluster.gang.device)

    def _eligible_group(self, shard_id: int) -> bool:
        g = self.cluster.shards[shard_id]
        if g.retired or g._dropped_witnesses:
            return False
        cfg = self.cluster.config.fetch(shard_id)
        if (cfg.master_id != g.master.master_id
                or cfg.witness_list_version != g.master.witness_list_version):
            return False
        from .device_witness import DeviceWitness

        for w in g.witnesses:
            if (not isinstance(w, DeviceWitness)
                    or w.mode is not WitnessMode.NORMAL
                    or w.gang is not self.cluster.gang
                    or w.lane is None):
                return False
        return True

    # -- the fused path -----------------------------------------------------
    def try_update_batch(self, session, ops: Sequence[Op],
                         now: float = 0.0) -> Optional[List[Any]]:
        """Run the batch through the fused kernel; None = not eligible (the
        caller falls back to the per-shard path).  Raises SlotMoving for
        mid-handover slots exactly like the unfused route."""
        out = self._try(session, ops, now)
        if out is None:
            self.stats["declined"] += 1
        return out

    def _try(self, session, ops: Sequence[Op], now: float):
        # Five stage spans a fused batch: preflight here, then kernel,
        # settle, master and drain in _run (a declined batch opens only
        # preflight).
        with span("fused.preflight"):
            plan = self._preflight(session, ops)
        if plan is None:
            return None
        return self._run(session, ops, now, *plan)

    def _preflight(self, session, ops: Sequence[Op]):
        """Eligibility, routing, RIFL prediction and ring ``ensure``:
        (shard_ids, touched, exec_pred, per_shard_appends), or None when
        the batch is declined."""
        cluster = self.cluster
        if cluster.gang is None or not ops:
            return None
        for op in ops:
            if op.op_type not in _PLAIN_UPDATES or len(op.keys) != 1:
                return None
            if len(op.hash_classes()) != 1:
                # HMSET with fields fans out to FIELD sub-pairs; the fused
                # kernel carries exactly one (hash, class) lane per op.
                return None
        if len({op.rpc_id for op in ops}) != len(ops):
            # An in-batch retry of the same rpc breaks exec prediction
            # (the first copy's completion lands mid-batch); rare — punt.
            return None
        self._resize()

        # Route every op (redirects raise SlotMoving before any side effect,
        # matching ShardedCluster._group_for's contract).
        slots = [cluster.router.slot_of(op.keys[0]) for op in ops]
        for s in slots:
            cluster.migration.check_slots({s})
        shard_ids = [cluster.router.slot_map[s] for s in slots]
        touched = sorted(set(shard_ids))
        for sid in touched:
            if not self._eligible_group(sid):
                return None

        # Master-side preflight: exact RIFL-duplicate prediction (acks are
        # applied FIRST, in handle_update order — idempotent, so the real
        # rounds re-applying them is harmless) + the error gates the per-op
        # path would retry or surface (txn locks, ownership).
        acks = session.acks()
        for sid in touched:
            cluster.shards[sid].master.rifl.apply_client_acks(acks)
        exec_pred = np.zeros(len(ops), np.int32)
        for b, op in enumerate(ops):
            m = cluster.shards[shard_ids[b]].master
            if not m.owns(op):
                return None
            if m.store.txn_lock_conflict(op.keys) is not None:
                return None
            dup = ((op.rpc_id, op.key_hashes()) in m.migrated_rifl
                   or m.rifl.check_duplicate(op.rpc_id) is not None)
            exec_pred[b] = 0 if dup else 1

        # Ring coherence + capacity (reserve = this batch's appends).
        per_shard_appends = {sid: 0 for sid in touched}
        for b, sid in enumerate(shard_ids):
            per_shard_appends[sid] += int(exec_pred[b])
        for sid in touched:
            if not self.ring.ensure(sid, cluster.shards[sid].master,
                                    per_shard_appends[sid]):
                return None

        # Committed to the fused path: feed the per-slot load counters the
        # routing step normally feeds.
        for s, sid in zip(slots, shard_ids):
            g = cluster.shards[sid]
            g.slot_ops[s] = g.slot_ops.get(s, 0) + 1

        return shard_ids, touched, exec_pred, per_shard_appends

    def _run(self, session, ops, now, shard_ids, touched, exec_pred,
             per_shard_appends):
        from ..kernels import gang_fastpath_batch

        from .local import OpOutcome

        cluster = self.cluster
        gang = cluster.gang
        with span("fused.kernel"):
            f = len(cluster.shards[touched[0]].witnesses)
            lane_map = np.zeros((len(cluster.shards), f), np.int32)
            for g in cluster.shards:
                for j, w in enumerate(g.witnesses[:f]):
                    lane_map[g.shard_id, j] = \
                        w.lane if w.lane is not None else 0

            # eligibility: one pair an op
            pairs = [op.hash_classes()[0] for op in ops]
            khs = [kh for kh, _c in pairs]
            k_hi = np.fromiter(((k >> 32) & _M32 for k in khs),
                               np.uint32, len(khs))
            k_lo = np.fromiter((k & _M32 for k in khs), np.uint32,
                               len(khs))
            k_cls = np.fromiter((c for _kh, c in pairs), np.int32,
                                len(pairs))
            r_hi = np.fromiter((op.rpc_id[0] & _M32 for op in ops),
                               np.uint32, len(ops))
            r_lo = np.fromiter((op.rpc_id[1] & _M32 for op in ops),
                               np.uint32, len(ops))

            res = gang_fastpath_batch(
                gang.table, gang.n_sets, k_hi, k_lo, r_hi, r_lo, exec_pred,
                np.asarray(cluster.router.slot_map, np.int32), lane_map,
                self.ring.hi, self.ring.lo, self.ring.tail, self.ring.count,
                key_cls=k_cls, ring_cls=self.ring.cls,
                counters=gang.counters,
            )
            gang.table = res.table
            gang.counters = res.counters
            self.ring.hi = res.ring_hi
            self.ring.lo = res.ring_lo
            self.ring.cls = res.ring_cls
            self.ring.count = np.asarray(res.counts, np.int32).copy()
            assert list(res.shard_ids) == shard_ids, \
                "device slot routing diverged from the host router"
            self.stats["fused_batches"] += 1
            self.stats["fused_ops"] += len(ops)

        # Witness settle: fold each op's per-lane reason codes into mirror +
        # stats + RecordStatus, exactly as DeviceWitness.record_batch does.
        with span("fused.settle"):
            witnesses = {sid: cluster.shards[sid].witnesses
                         for sid in touched}
            for ws in witnesses.values():
                for w in ws:
                    w.stats["kernel_batches"] += 1
            statuses_per_op: List[List[RecordStatus]] = []
            for b, op in enumerate(ops):
                key = (int(res.q_hi[b]), int(res.q_lo[b]))
                statuses_per_op.append([
                    w._settle(int(res.reasons[b, j]), [key], op.rpc_id, op,
                              [int(k_cls[b])])
                    for j, w in enumerate(witnesses[shard_ids[b]])
                ])

        # Master rounds in op order, the ring's conflict bit standing in for
        # the host window lookup.
        with span("fused.master"):
            acks = session.acks()
            need_drain: Set[int] = set()
            outcomes: List[OpOutcome] = []
            for b, op in enumerate(ops):
                g = cluster.shards[shard_ids[b]]
                cfg = cluster.config.fetch(g.shard_id)
                verdict, result = g.master.handle_update(
                    op, cfg.witness_list_version, acks, now,
                    commutes=not bool(res.conflicts[b]),
                )
                if verdict == ERROR:
                    # Preflight closed every ERROR path; reaching here means
                    # the invariants broke mid-batch.
                    raise RuntimeError(
                        f"fused master round failed: {result.error}"
                    )
                decision, rtts, fast = g._classify(
                    verdict, result, statuses_per_op[b]
                )
                if verdict == SYNCED or decision is Decision.NEED_SYNC:
                    need_drain.add(g.shard_id)
                session.mark_completed(op.rpc_id)
                if verdict != DUP:   # dups re-externalize the original, once
                    g.record(op, result.value, session.client_id)
                outcomes.append(OpOutcome(
                    value=result.value,
                    rtts=rtts,
                    fast_path=fast,
                    synced_path=verdict == SYNCED,
                    witness_accepts=sum(
                        1 for s in statuses_per_op[b]
                        if s is RecordStatus.ACCEPTED
                    ),
                ))

        # Ring bookkeeping + the batched sync/gc tail (one drain per shard).
        with span("fused.drain"):
            for sid in touched:
                g = cluster.shards[sid]
                self.ring.committed(sid, g.master, per_shard_appends[sid])
                if sid in need_drain or (g.auto_sync and g.master.want_sync):
                    g._drain_syncs()
                self.ring.advance(sid, g.master)
        return outcomes
