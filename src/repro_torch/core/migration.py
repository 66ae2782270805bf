"""Live reconfiguration: online slot handover between CURP shard groups.

CURP §3.6 covers three reconfigurations: master crash (epoch fence), witness
replacement (WitnessListVersion fence), and DATA MIGRATION — a partition
moves to another master and "requests in witnesses that belong to the
migrated partition are ignored".  This module builds the third one on top of
the slot router (repro.core.shard.SlotRouter): the unit of movement is a
hash SLOT, and a handover walks the same fences the paper uses.

Handover protocol (SlotMigration, donor -> receiver)
----------------------------------------------------
  freeze    The moving slots are registered with the MigrationManager; any
            client op touching them gets a RETRYABLE REDIRECT (SlotMoving)
            *before* any master or witness contact, so it can safely be
            re-issued under a fresh identity once the map settles.  Ops on
            every other slot never leave the 1-RTT fast path.  Undecided
            transaction intents held by the donor are resolved first (their
            key locks must not straddle the handover).
  sync      The donor drains its batched backup syncs: the moving slots'
            unsynced window empties and their witness records are gc'ed, so
            the snapshot below is stable AND f-fault durable.
  transfer  The moved slots' key/value residents plus their live RIFL
            completion records ship to the receiver as ONE ``MIGRATE_IN``
            op through the receiver master's ordinary update path (log entry
            + backup sync), so either side crashing mid-handover loses
            nothing: the receiver re-surfaces absorbed state from its own
            backups, and a resumed handover just re-sends the snapshot
            (idempotent).  Completion records move key-scoped (RAMCloud's
            per-object RIFL), so a client retry across the move dedups at
            the receiver instead of double-applying.
  handover  The commit point.  The donor durably drops the moved keys
            (``MIGRATE_OUT`` log entry), BOTH ends take a ConfigManager
            ``migration_fence`` (epoch + WitnessListVersion bump — in-flight
            records against old witness lists are refused and clients
            refetch, §3.6), and the router's slot map flips.  Witness
            takeover is implicit: new records for the moved slots land at
            the receiver's witnesses; the donor's witnesses hold no moved
            records (gc'ed by the sync stage), and any straggler replayed
            during a later donor recovery is ignored by the ownership filter
            (``Master.owns``), exactly the paper's migrated-partition rule.

Crash recovery is FORWARD-ONLY: the router flip is the single commit point,
every stage before it is idempotent, and ``resume()`` restarts from ``sync``
after a donor or receiver failover.

Hot-shard auto-split
--------------------
``plan_rebalance`` turns per-slot op counters (kept on the shard groups,
fed by the cluster's routing layer) into a greedy move plan: shed the
hottest slots of the hottest shard onto the coldest shards until the load
imbalance drops under a tolerance.  ``ShardedCluster.rebalance`` executes
the plan as live handovers — the attack on the skew80 scaling cap in
benchmarks/fig_scaling.py (see benchmarks/fig_migration.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .client import ClientSession
from .master import DUP, ERROR, FAST, SYNCED
from .telemetry import get_registry
from .types import Op, OpType


class SlotMoving(Exception):
    """Retryable redirect: the op touches a slot that is mid-handover.

    Raised at the ROUTING stage, before any master or witness saw the op —
    nothing was recorded anywhere under its identity, so the client may
    safely re-issue the op (fresh rpc_id) once the slot map settles.  A
    caller that just allocated the redirected op's identity should release
    it (``session.abandon(op.rpc_id)``) so the RIFL ack frontier keeps
    advancing; ``ShardedCluster.mset``/``txn`` do this automatically for
    identities they allocate.  An op that may ALREADY have reached a master
    (a timeout retry) must instead be re-sent under its ORIGINAL identity
    after the map settles — RIFL (including the migrated completion
    records) dedups it at the new owner.
    """

    def __init__(self, slot: int, src: int, dst: int) -> None:
        super().__init__(
            f"slot {slot} is migrating shard {src} -> {dst}; "
            "refetch the slot map and retry"
        )
        self.slot = slot
        self.src = src
        self.dst = dst


@dataclass
class MigrationReport:
    """Outcome of one donor -> receiver slot handover."""
    slots: Tuple[int, ...]
    src: int
    dst: int
    keys_moved: int
    rifl_moved: int          # completion records shipped with the data
    txn_resolved: int        # donor intents decided at freeze
    src_epoch: int
    dst_epoch: int
    src_wlv: int
    dst_wlv: int
    resumed: int = 0         # crash-resumes survived mid-handover


class SlotMigration:
    """One slot-set handover, driven in idempotent stages (module docstring).

    ``step()`` advances one stage (benchmarks interleave client traffic
    between steps); ``run()`` drives to completion; ``resume()`` restarts
    from ``sync`` after a donor/receiver crash — safe because the router
    flip in ``handover`` is the only non-idempotent effect and it is the
    last one.
    """

    STAGES = ("freeze", "sync", "transfer", "handover", "done")

    def __init__(self, cluster, slots: Sequence[int], src: int,
                 dst: int) -> None:
        self.cluster = cluster
        self.slots = tuple(sorted(set(slots)))
        self._slot_set = frozenset(self.slots)
        self.src = src
        self.dst = dst
        self.stage = "freeze"
        self.keys_moved = 0
        self.rifl_moved = 0
        self.txn_resolved = 0
        self.resumed = 0

    # ------------------------------------------------------------- driving
    def step(self) -> str:
        """Run the next stage; returns the stage now pending (or 'done')."""
        stage = self.stage
        t0 = time.perf_counter()
        if stage == "freeze":
            self._freeze()
            self.stage = "sync"
        elif stage == "sync":
            self._sync()
            self.stage = "transfer"
        elif stage == "transfer":
            self._transfer()
            self.stage = "handover"
        elif stage == "handover":
            self._handover()
            self.stage = "done"
        if stage != "done":
            reg = get_registry()
            reg.histogram(f"migration.stage_us.{stage}").record(
                (time.perf_counter() - t0) * 1e6
            )
            reg.counter("migration.stages").inc()
        return self.stage

    def run(self) -> MigrationReport:
        while self.stage != "done":
            self.step()
        return self.report()

    def resume(self) -> None:
        """Restart after a donor or receiver failover mid-handover.  The
        recovered master rebuilt all synced state from its backups (incl.
        any absorbed MIGRATE_IN), so redoing sync -> transfer -> handover is
        safe and re-sends nothing the receiver can't dedup."""
        if self.stage == "done":
            return
        self.resumed += 1
        self.stage = "sync"

    def report(self) -> MigrationReport:
        src_cfg = self.cluster.config.fetch(self.src)
        dst_cfg = self.cluster.config.fetch(self.dst)
        return MigrationReport(
            slots=self.slots, src=self.src, dst=self.dst,
            keys_moved=self.keys_moved, rifl_moved=self.rifl_moved,
            txn_resolved=self.txn_resolved,
            src_epoch=src_cfg.epoch, dst_epoch=dst_cfg.epoch,
            src_wlv=src_cfg.witness_list_version,
            dst_wlv=dst_cfg.witness_list_version,
            resumed=self.resumed,
        )

    # -------------------------------------------------------------- stages
    def _freeze(self) -> None:
        """Decide every undecided intent the donor holds: an intent lock on
        a moving key cannot straddle the handover (the intent's 2PC legs are
        pinned to the pre-move owner)."""
        from .txn import resolve_txn

        donor = self.cluster.shards[self.src]
        for _txn_id, (spec, _part) in list(
            donor.master.store.txn_intents().items()
        ):
            resolve_txn(self.cluster, spec)
            self.txn_resolved += 1

    def _sync(self) -> None:
        self.cluster.shards[self.src].sync_now()

    def _transfer(self) -> None:
        """Ship the moved slots' residents + live RIFL completions to the
        receiver as one MIGRATE_IN log entry, then make it backup-durable."""
        cluster = self.cluster
        donor = cluster.shards[self.src]
        recv = cluster.shards[self.dst]
        slot_set = self._slot_set
        router = cluster.router

        store = donor.master.store
        kvs = tuple(
            (k, store.get(k)) for k in store.keys()
            if router.slot_of(k) in slot_set
        )
        # Completion records ride with the data: every log entry wholly
        # inside the moved slots whose completion is still live (un-acked)
        # moves, keyed (rpc_id, key_hashes) — see Master.migrated_rifl.
        records: Dict[Tuple, Tuple] = {}
        for e in donor.master.log:
            op = e.op
            if op.op_type in (OpType.MIGRATE_IN, OpType.MIGRATE_OUT):
                continue
            if not op.keys or not all(
                router.slot_of(k) in slot_set for k in op.keys
            ):
                continue
            rec = donor.master.rifl.check_duplicate(op.rpc_id)
            if rec is None:
                continue
            # Live records migrate verbatim; already-ACKED ops migrate the
            # synthetic ignore-as-duplicate marker (result None) the donor
            # itself would serve, so retry behavior is identical either way.
            records[(op.rpc_id, op.key_hashes())] = (
                op.rpc_id, op.key_hashes(), rec.result
            )
        # Chain migrations: completions that arrived here WITH an earlier
        # handover forward onward with the slots they cover.
        for (rpc_id, khs), result in donor.master.migrated_rifl.items():
            if all(router.slot_of_hash(kh) in slot_set for kh in khs):
                records[(rpc_id, khs)] = (rpc_id, khs, result)

        self.keys_moved = len(kvs)
        self.rifl_moved = len(records)
        if not kvs and not records:
            return
        op = Op(
            OpType.MIGRATE_IN,
            tuple(k for k, _ in kvs),
            (kvs, tuple(records.values())),
            cluster.migration.session.next_rpc_id(),
        )
        cfg = cluster.config.fetch(self.dst)
        verdict, result = recv.master.handle_update(
            op, cfg.witness_list_version, (), 0.0
        )
        assert verdict in (FAST, SYNCED, DUP), (verdict, result.error)
        recv.sync_now()  # the absorb must be f-fault durable pre-commit

    def _handover(self) -> None:
        """The commit point: donor drops, both ends fence, the map flips."""
        cluster = self.cluster
        donor = cluster.shards[self.src]
        recv = cluster.shards[self.dst]
        slot_set = self._slot_set
        router = cluster.router

        # 1. Donor durably forgets the moved keys (its backups replay the
        #    drop, so a later donor failover cannot resurrect them).
        moved = tuple(
            k for k in donor.master.store.keys()
            if router.slot_of(k) in slot_set
        )
        if moved:
            cfg = cluster.config.fetch(self.src)
            op = Op(OpType.MIGRATE_OUT, moved, (),
                    cluster.migration.session.next_rpc_id())
            verdict, result = donor.master.handle_update(
                op, cfg.witness_list_version, (), 0.0
            )
            assert verdict != ERROR, result.error
            donor.sync_now()

        # 2. Fence both ends (§3.6): epoch + WitnessListVersion bumps pushed
        #    into the live masters and their backups.  In-flight records
        #    against the pre-handover witness lists are refused at the
        #    masters and the clients refetch.
        jr = cluster.migration.journal
        for sid, group in ((self.src, donor), (self.dst, recv)):
            cfg = cluster.config.migration_fence(sid)
            group.master.epoch = cfg.epoch
            group.master.witness_list_version = cfg.witness_list_version
            for b in group.backups:
                b.set_epoch(cfg.epoch)
            if jr is not None:
                jr.emit("fence", actor="migration", shard=sid,
                        epoch=cfg.epoch, wlv=cfg.witness_list_version,
                        reason="migration")

        # 3. Commit: flip the slot map; new ops route to (and record at) the
        #    receiver and its witnesses.
        router.assign(self.slots, self.dst)
        if jr is not None:
            jr.emit("handover", actor="migration", slots=self.slots,
                    src=self.src, dst=self.dst)
        cluster.migration.finish(self)


class MigrationManager:
    """The cluster's live-reconfiguration control plane.

    Owns the set of in-flight handovers (the routing layer consults it for
    redirects), the migration RPC identity space (MIGRATE_IN/OUT transfer
    ops carry rpc_ids from a reserved internal client), and the completed-
    handover history.
    """

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self.session = ClientSession(client_id=cluster._node_id())
        self.active: Dict[int, SlotMigration] = {}   # moving slot -> handover
        self.history: List[MigrationReport] = []
        # Optional black-box journal: freeze/fence/handover events feed the
        # watchdog's single-owner-per-slot monitor.
        self.journal = None

    # ------------------------------------------------------------ redirects
    def check_slots(self, slots) -> None:
        """Raise the retryable redirect if any slot is mid-handover."""
        for s in slots:
            mig = self.active.get(s)
            if mig is not None:
                get_registry().counter("migration.redirects").inc()
                raise SlotMoving(s, mig.src, mig.dst)

    def check_keys(self, keys) -> None:
        self.check_slots(self.cluster.router.slot_of(k) for k in keys)

    # -------------------------------------------------------------- control
    def start(self, slots: Sequence[int], dst: int) -> List[SlotMigration]:
        """Register handovers moving ``slots`` to shard ``dst`` (one
        SlotMigration per donor), freezing the slots immediately.  Returns
        the handles; drive them with ``step()``/``run()``."""
        router = self.cluster.router
        group = self.cluster.shards[dst]
        if getattr(group, "retired", False):
            raise ValueError(f"shard {dst} is retired")
        by_src: Dict[int, List[int]] = {}
        for s in set(slots):
            if not 0 <= s < router.n_slots:
                raise ValueError(f"slot {s} out of range")
            if s in self.active:
                raise ValueError(f"slot {s} already migrating")
            src = router.slot_map[s]
            if src == dst:
                continue
            by_src.setdefault(src, []).append(s)
        migs = [
            SlotMigration(self.cluster, sl, src, dst)
            for src, sl in sorted(by_src.items())
        ]
        for m in migs:
            for s in m.slots:
                self.active[s] = m
            if self.journal is not None:
                self.journal.emit("freeze", actor="migration", slots=m.slots,
                                  src=m.src, dst=m.dst)
        return migs

    def migrate(self, slots: Sequence[int], dst: int) -> List[MigrationReport]:
        """Run the full handover(s) to completion (no traffic interleave)."""
        return [m.run() for m in self.start(slots, dst)]

    def finish(self, mig: SlotMigration) -> None:
        for s in mig.slots:
            self.active.pop(s, None)
        self.history.append(mig.report())
        get_registry().counter("migration.handovers").inc()


def plan_rebalance(
    slot_loads: Sequence[int],
    slot_map: Sequence[int],
    shard_ids: Sequence[int],
    max_moves: int = 64,
    tolerance: float = 1.1,
) -> Dict[int, List[int]]:
    """Greedy hot-slot shedding: {dst_shard: [slots to move there]}.

    Repeatedly take the hottest shard's hottest slot and hand it to the
    coldest shard, until the hottest shard is within ``tolerance`` of the
    mean load, every shard keeps at least one slot, or ``max_moves`` is
    spent.  A move must strictly reduce the donor/receiver gap (the slot
    fits under the donor's load at the receiver), which guarantees
    termination without oscillation.
    """
    shard_ids = list(shard_ids)
    if len(shard_ids) < 2:
        return {}
    loads = {sid: 0 for sid in shard_ids}
    owner_slots: Dict[int, List[int]] = {sid: [] for sid in shard_ids}
    for slot, owner in enumerate(slot_map):
        if owner in loads:
            loads[owner] += slot_loads[slot]
            owner_slots[owner].append(slot)
    total = sum(loads.values())
    if total == 0:
        return {}
    target = total / len(shard_ids)
    for slots in owner_slots.values():
        slots.sort(key=lambda s: -slot_loads[s])   # hottest first

    # A slot may be shed more than once while planning (to the coldest
    # shard, which later becomes hottest); only its FINAL owner is emitted,
    # so each slot pays at most one handover and the executed placement is
    # exactly the planned one regardless of migration order.
    final: Dict[int, int] = {}
    for _ in range(max_moves):
        hot = max(shard_ids, key=lambda sid: loads[sid])
        cold = min(shard_ids, key=lambda sid: loads[sid])
        if loads[hot] <= tolerance * target or hot == cold:
            break
        candidates = [
            s for s in owner_slots[hot]
            if slot_loads[s] > 0
            and loads[cold] + slot_loads[s] < loads[hot]
        ]
        if not candidates or len(owner_slots[hot]) <= 1:
            break
        slot = candidates[0]                        # hottest movable slot
        owner_slots[hot].remove(slot)
        owner_slots[cold].append(slot)
        loads[hot] -= slot_loads[slot]
        loads[cold] += slot_loads[slot]
        if slot_map[slot] == cold:
            final.pop(slot, None)                   # shed back to its owner
        else:
            final[slot] = cold
    moves: Dict[int, List[int]] = {}
    for slot, dst in sorted(final.items()):
        moves.setdefault(dst, []).append(slot)
    return moves
