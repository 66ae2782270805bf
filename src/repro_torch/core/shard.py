"""Sharded CURP: multi-master partitioning (§4, Fig. 3).

CURP is designed for partitioned stores: each master owns a key partition and
has its *own* witness group and backups; commutativity is judged per shard, so
disjoint partitions proceed entirely in parallel and one master crash only
replays that shard's witnesses.

Three pieces live here:

  * ``SlotRouter`` — slot-table placement.  The mix is the pure-Python
    mirror of the CUDA ``keyhash2x32`` mix (repro_torch/kernels/csrc/keyhash.cuh): the
    64-bit splitmix key hash is split into (hi, lo) uint32 lanes, pushed
    through the murmur3 fmix32 chain, and the low output lane mod
    ``n_slots`` picks a SLOT; a slot -> shard table names the owner.  Live
    reconfiguration (repro.core.migration) moves slots between shards by
    editing the table — the hash never changes.  The fused gang kernel
    (``repro_torch.kernels.ops.gang_fastpath_batch``) computes the same
    placement on the device (table gather); Python and CUDA must agree
    bit-for-bit on ANY slot map.
    ``KeyRouter`` survives as the mod-N compatibility constructor (the
    round-robin default map).
  * ``ShardGroup`` — one master + its witness group + its backups, with the
    full protocol drive loop (speculative update, witness records, batched
    syncs + gc, crash recovery, witness reconfiguration).  This is the unit
    ``LocalCluster`` wraps exactly once and ``ShardedCluster`` wraps N times.
  * ``ShardedCluster`` — a set of shards behind a ``SlotRouter``, with
    cross-shard multi-key ops (``mset``): each shard's sub-op takes the
    per-shard 1-RTT fast path; if any shard's witnesses reject, only that
    shard falls back to an explicit sync (2 RTTs overall).  The cluster also
    owns the live-reconfiguration control plane (``migrate_slots`` /
    ``add_shard`` / ``remove_shard`` / ``rebalance``), per-slot op counters
    feeding the hot-shard auto-split policy, and the retryable-redirect
    check for mid-handover slots.

Client identity (``ShardedClientSession``) is ONE RIFL space per client,
shared across shards: (client_id, seq) pairs are globally unique, which is
what lets a completion record MIGRATE with its key's slot and still dedup a
retry at the new owner without ever colliding with the receiver's own
records.  (The earlier per-shard sequence spaces reused (client_id, seq)
across shards — safe while placement was static, fatally ambiguous once
records can move.)
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .backup import Backup
from .client import ClientSession, Decision, combine_decisions, decide
from .config import ConfigManager, WitnessGeometry
from .master import DUP, ERROR, FAST, SYNCED, Master
from .recovery import RecoveryReport, recover_master
from .telemetry import span
from .txn import (
    CoordinatorCrash,
    TxnCoordinator,
    TxnOutcome,
    TxnPart,
    TxnPending,
    TxnSpec,
    TxnStatus,
    TxnVote,
    resolve_pending,
    resolve_txn,
)
from .types import ClusterConfig, ExecResult, Op, OpType, RecordStatus, keyhash
from .witness import Witness

_M32 = 0xFFFFFFFF


def _fmix32(x: int) -> int:
    """murmur3 32-bit finalizer — must match kernels/csrc/keyhash.cuh ``fmix32``."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def mix2x32(hi: int, lo: int) -> Tuple[int, int]:
    """Pure-Python mirror of ``ref_keyhash2x32``: (hi, lo) -> (h2, h3)."""
    h1 = _fmix32((lo + 0x9E3779B9) & _M32)
    h2 = _fmix32(hi ^ h1)
    h3 = _fmix32((h1 + h2 * 5 + 0xE6546B64) & _M32)
    return h2, h3


# Default slot-table size.  The device slot-table gather in
# repro_torch.kernels.ops and this router share the table layout.
N_SLOTS = 256


class SlotRouter:
    """Deterministic key -> shard placement shared by Python and CUDA.

    Two-stage: the canonical 64-bit key hash (types.keyhash) is split into
    uint32 lanes and keyhash2x32-mixed; the low lane mod ``n_slots`` picks a
    SLOT, and ``slot_map[slot]`` names the owning shard.  The slot is the
    unit of live migration (repro.core.migration): a handover edits the
    table (``assign``) and bumps ``version`` so cached placements (e.g. the
    serving store's session cache) know to refetch.  The fused gang kernel
    computes the same placement batched on-device from the same table.
    """

    def __init__(self, slot_map: Sequence[int],
                 n_shards: Optional[int] = None) -> None:
        self.slot_map = list(slot_map)
        self.n_slots = len(self.slot_map)
        assert self.n_slots >= 1
        self.n_shards = (max(self.slot_map) + 1) if n_shards is None \
            else n_shards
        self.version = 0

    @classmethod
    def uniform(cls, n_shards: int, n_slots: int = N_SLOTS) -> "SlotRouter":
        """The round-robin default map (slot i -> shard i % N).  For
        power-of-two shard counts dividing ``n_slots`` this is bit-identical
        to the pre-slot-map mod-N placement."""
        assert n_shards >= 1
        return cls([i % n_shards for i in range(n_slots)], n_shards=n_shards)

    # ------------------------------------------------------------ placement
    def slot_of_hash(self, kh64: int) -> int:
        _, h3 = mix2x32((kh64 >> 32) & _M32, kh64 & _M32)
        return h3 % self.n_slots

    def slot_of(self, key: Any) -> int:
        return self.slot_of_hash(keyhash(key))

    def shard_of_hash(self, kh64: int) -> int:
        return self.slot_map[self.slot_of_hash(kh64)]

    def shard_of(self, key: Any) -> int:
        return self.slot_map[self.slot_of(key)]

    def slots_of_shard(self, shard_id: int) -> List[int]:
        return [s for s, owner in enumerate(self.slot_map)
                if owner == shard_id]

    def split_keys(self, keys: Sequence[Any]) -> Dict[int, List[int]]:
        """Group key *positions* by owning shard (stable within a shard)."""
        parts: Dict[int, List[int]] = {}
        for i, k in enumerate(keys):
            parts.setdefault(self.shard_of(k), []).append(i)
        return parts

    # ------------------------------------------------------ reconfiguration
    def assign(self, slots: Sequence[int], shard_id: int) -> None:
        """Flip slots to a new owner (a handover's commit point) and bump
        the map version so cached placements refetch."""
        for s in slots:
            self.slot_map[s] = shard_id
        self.version += 1


class KeyRouter(SlotRouter):
    """Mod-N compatibility constructor: a SlotRouter over the uniform map."""

    def __init__(self, n_shards: int, n_slots: int = N_SLOTS) -> None:
        super().__init__([i % n_shards for i in range(n_slots)],
                         n_shards=n_shards)


class HistoryRecorder:
    """Linearizability-checkable op log shared by the in-process harnesses.

    Entries carry logical (invoke, complete) windows: sequential ops get
    disjoint windows; sub-ops of one multi-shard op share a window (they ran
    concurrently, and linearizability decomposes per key).  The entry shape
    is what repro.sim.linearizability's checker consumes.
    """

    def __init__(self) -> None:
        self.history: List[dict] = []
        self._tick = 0

    def next_window(self) -> Tuple[float, float]:
        t = float(self._tick)
        self._tick += 1
        return (t, t + 0.5)

    def __call__(self, op: Op, value: Any, client_id: int,
                 window: Optional[Tuple[float, float]] = None) -> None:
        if window is None:
            window = self.next_window()
        self.history.append({
            "op": op, "value": value, "client": client_id,
            "invoke": window[0], "complete": window[1], "failed": False,
        })


# ---------------------------------------------------------------------------
# One shard = one master group
# ---------------------------------------------------------------------------
class ShardGroup:
    """One CURP replica group: master + f witnesses + f backups.

    Transport is instant function calls (the timed mirror is repro.sim); the
    protocol steps are the real ones.  The enclosing cluster owns node-id
    allocation (``alloc_id``), the shared ConfigManager, and history
    recording (``record``).
    """

    def __init__(
        self,
        shard_id: int,
        config: ConfigManager,
        alloc_id: Callable[[], int],
        f: int = 3,
        sync_batch: int = 50,
        witness_sets: int = 1024,
        witness_ways: int = 4,
        hot_key_window: float = 0.0,
        auto_sync: bool = True,
        record: Optional[Callable[[Op, Any, int], None]] = None,
        geometry: Optional[WitnessGeometry] = None,
        witness_backend: str = "python",
        gang=None,
        device: str = "cuda",
    ) -> None:
        self.shard_id = shard_id
        self.config = config
        self.alloc_id = alloc_id
        self.f = f
        self.auto_sync = auto_sync
        self.record = record or (lambda op, value, client_id: None)
        if geometry is None:
            geometry = WitnessGeometry(witness_sets, witness_ways)
        self.geometry = geometry
        assert witness_backend in ("python", "device"), witness_backend
        self.witness_backend = witness_backend
        # Device witnesses stack their tables into one device-resident gang
        # (repro_torch.core.device_witness.WitnessGang) on ``device``:
        # cluster-provided when the group belongs to a ShardedCluster (all
        # shards share one gang so a routed batch is ONE dispatch),
        # group-local otherwise.
        self.device = device
        self.gang = gang
        if witness_backend == "device" and self.gang is None:
            from .device_witness import WitnessGang

            lanes = 1
            while lanes < f:
                lanes <<= 1
            self.gang = WitnessGang(geometry.n_sets, geometry.n_ways, lanes,
                                    device=device)
        self.master = Master(
            alloc_id(), epoch=0, sync_batch=sync_batch,
            hot_key_window=hot_key_window,
        )
        self.backups = [Backup(alloc_id()) for _ in range(f)]
        self.witnesses = [self._new_witness() for _ in range(f)]
        self._witness_ids = tuple(alloc_id() for _ in range(f))
        for w in self.witnesses:
            w.start(self.master.master_id)
        config.publish(shard_id, ClusterConfig(
            master_id=self.master.master_id,
            epoch=0,
            backup_ids=tuple(b.backup_id for b in self.backups),
            witness_ids=self._witness_ids,
            witness_list_version=0,
        ))
        self._dropped_witnesses: set[int] = set()
        # Live-reconfiguration state (repro.core.migration): per-slot op
        # counters feeding the hot-shard rebalance policy (kept on the group
        # so they survive master failovers), the ownership filter re-applied
        # to every recovered master (§3.6: replayed ops for migrated slots
        # are ignored), and the retired flag a drained-and-removed shard
        # carries.
        self.slot_ops: Dict[int, int] = {}
        self.owned_filter: Optional[Callable[[Any], bool]] = None
        self.retired = False

    def _new_witness(self):
        """Build one witness at this group's geometry: the protocol-reference
        Python witness, or the kernel-backed device witness (one CUDA
        dispatch per record batch; see repro_torch.core.device_witness)."""
        if self.witness_backend == "device":
            from .device_witness import DeviceWitness

            return DeviceWitness(self.geometry.n_sets, self.geometry.n_ways,
                                 gang=self.gang)
        return Witness(self.geometry.n_sets, self.geometry.n_ways)

    # ------------------------------------------------------------------ faults
    def witness_drop(self, witness_idx: int, dropped: bool = True) -> None:
        if dropped:
            self._dropped_witnesses.add(witness_idx)
        else:
            self._dropped_witnesses.discard(witness_idx)

    # ----------------------------------------------------------------- updates
    def _master_round(
        self, op: Op, acks: Tuple[Tuple[int, int], ...], now: float,
    ) -> Tuple[str, ExecResult, ClusterConfig]:
        """Master half of one update round, retrying stale-config errors
        (§3.6).  Shared by the per-op and batched paths."""
        with span("shard.master_round"):
            for _attempt in range(4):
                cfg = self.config.fetch(self.shard_id)
                verdict, result = self.master.handle_update(
                    op, cfg.witness_list_version, acks, now
                )
                if verdict != ERROR:
                    return verdict, result, cfg
                if result.error == "TXN_PENDING":
                    # Blocked by an undecided transaction intent: retrying
                    # at the master is useless — the caller must resolve
                    # the transaction (the blocking spec rides in
                    # result.value).
                    raise TxnPending(result.value)
            raise RuntimeError("update retries exhausted")

    @staticmethod
    def _classify(verdict: str, result: ExecResult,
                  statuses: Sequence[RecordStatus]) -> Tuple[Decision, int, bool]:
        """Fold (master verdict, witness statuses) into the client view:
        (decision, rtts, fast).  Single source of truth for both the per-op
        and batched paths' accounting."""
        if verdict == SYNCED:
            return Decision.COMPLETE, 2, False
        decision = decide(result, statuses)
        if decision is Decision.COMPLETE:
            return decision, 1, verdict == FAST
        return decision, 2, False

    def attempt_update(
        self, op: Op, acks: Tuple[Tuple[int, int], ...], now: float = 0.0,
    ) -> Tuple[str, ExecResult, List[RecordStatus]]:
        """One 1-RTT round: update RPC to the master + parallel witness
        records.  Retries internally on stale-config errors (§3.6)."""
        verdict, result, cfg = self._master_round(op, acks, now)
        return verdict, result, self._record_witnesses(cfg.master_id, op)

    def _record_witnesses(self, master_id: int,
                          op: Op) -> List[RecordStatus]:
        """One op's parallel witness records, statuses in witness order: the
        live device witnesses sharing the group's gang record in ONE grouped
        dispatch (``record_many``), any other live witness on its own; a
        dropped witness rejects with no record (timeout == reject)."""
        statuses = [RecordStatus.REJECTED] * len(self.witnesses)
        live = [i for i in range(len(self.witnesses))
                if i not in self._dropped_witnesses]
        if self.witness_backend == "device":
            from .device_witness import DeviceWitness, record_many

            grouped = [i for i in live
                       if isinstance(self.witnesses[i], DeviceWitness)
                       and self.witnesses[i].gang is self.gang]
            if grouped:
                with span("witness.record"):
                    got = record_many([self.witnesses[i] for i in grouped],
                                      master_id, op.key_hashes(), op.rpc_id,
                                      op)
                for i, st in zip(grouped, got):
                    statuses[i] = st
                live = [i for i in live if i not in grouped]
        for i in live:
            with span("witness.record"):
                statuses[i] = self.witnesses[i].record(
                    master_id, op.key_hashes(), op.rpc_id, op)
        return statuses

    def update(self, session: ClientSession, op: Op, now: float = 0.0):
        """Full CURP update; returns an OpOutcome (see local.py)."""
        from .local import OpOutcome

        with span("shard.update"):
            verdict, result, statuses = self.attempt_update(
                op, session.acks(), now)
            decision, rtts, fast = self._classify(verdict, result, statuses)

            if verdict == SYNCED or decision is Decision.NEED_SYNC:
                # Conflict path / slow path: sync before the reply
                # externalizes.
                self._drain_syncs()

            if self.auto_sync and self.master.want_sync:
                self._drain_syncs()

            session.mark_completed(op.rpc_id)
            if verdict != DUP:
                # A RIFL-duplicate retry re-externalizes the ORIGINAL
                # completion; the op already has its one history entry —
                # recording again would demand two linearization points
                # for one invocation.
                self.record(op, result.value, session.client_id)
            return OpOutcome(
                value=result.value,
                rtts=rtts,
                fast_path=fast,
                synced_path=verdict == SYNCED,
                witness_accepts=sum(
                    1 for s in statuses if s is RecordStatus.ACCEPTED
                ),
            )

    def update_batch(self, session: ClientSession, ops: Sequence[Op],
                     now: float = 0.0) -> List["OpOutcome"]:
        """Batched CURP updates: one master round (ops executed in order) +
        ONE record invocation per witness for the whole batch (a single
        set-parallel kernel dispatch on the device backend).

        Per-op accept/reject and fast/slow-path accounting are preserved —
        op j's witness statuses see exactly the accepts of ops < j, as the
        per-op path would.  Syncs and gc don't interleave inside a batch
        (that's the batching window); any op that needs a sync is drained
        once before the batch returns, so nothing is externalized early.
        """
        from .local import OpOutcome

        results = [self._master_round(op, session.acks(), now) for op in ops]
        cfg = self.config.fetch(self.shard_id)
        per_witness: List[List[RecordStatus]] = []
        for i, w in enumerate(self.witnesses):
            if i in self._dropped_witnesses:
                per_witness.append([RecordStatus.REJECTED] * len(ops))
            else:
                per_witness.append(w.record_batch(cfg.master_id, list(ops)))

        outcomes: List[OpOutcome] = []
        need_drain = False
        for j, op in enumerate(ops):
            verdict, result, _cfg = results[j]
            statuses = [pw[j] for pw in per_witness]
            decision, rtts, fast = self._classify(verdict, result, statuses)
            if verdict == SYNCED or decision is Decision.NEED_SYNC:
                need_drain = True
            session.mark_completed(op.rpc_id)
            if verdict != DUP:   # see update(): dups re-externalize, once
                self.record(op, result.value, session.client_id)
            outcomes.append(OpOutcome(
                value=result.value,
                rtts=rtts,
                fast_path=fast,
                synced_path=verdict == SYNCED,
                witness_accepts=sum(
                    1 for s in statuses if s is RecordStatus.ACCEPTED
                ),
            ))
        if need_drain or (self.auto_sync and self.master.want_sync):
            self._drain_syncs()
        return outcomes

    def read(self, session: ClientSession, op: Op, now: float = 0.0):
        from .local import OpOutcome

        verdict, result = self.master.handle_read(op, now)
        if verdict == ERROR and result.error == "TXN_PENDING":
            raise TxnPending(result.value)
        if verdict == SYNCED:
            self._drain_syncs()
        self.record(op, result.value, session.client_id)
        return OpOutcome(
            value=result.value,
            rtts=1 if verdict == FAST else 2,
            fast_path=verdict == FAST,
            synced_path=verdict == SYNCED,
            witness_accepts=0,
        )

    def read_from_backup(
        self, session: ClientSession, op: Op, backup_idx: int = 0,
        witness_idx: int = 0,
    ) -> Tuple[Any, bool]:
        """§A.1 consistent read from a (local) backup: check commutativity with
        a (local) witness first.  Returns (value, served_by_backup)."""
        w = self.witnesses[witness_idx]
        if w.commutes_with_all(op.key_hashes()):
            from .store import KVStore

            view = KVStore()
            for e in self.backups[backup_idx].get_log():
                view.execute(e.op)
            return view.get(op.keys[0]), True
        out = self.read(session, op)
        return out.value, False

    # ---------------------------------------------- 2PC participant (txn.py)
    def txn_prepare(self, session: ClientSession, op: Op,
                    now: float = 0.0) -> TxnVote:
        """One PREPARE leg: speculative intent install at the master +
        parallel witness records of the leg's keys (the tombstoned intents
        that keep commutativity checks sound during the window).

        The leg is durably prepared on return: 1 RTT when the master was
        fast AND every witness accepted, otherwise via an explicit backup
        sync (2 RTTs for this leg only).  A vote NO (foreign intent lock or
        an existing decision tombstone) installs nothing.
        """
        for _attempt in range(4):
            cfg = self.config.fetch(self.shard_id)
            verdict, result = self.master.handle_update(
                op, cfg.witness_list_version, session.acks(), now
            )
            if verdict != ERROR or result.error != "WRONG_WITNESS_VERSION":
                break
        if verdict == ERROR:
            # TXN_LOCKED carries the blocking spec: the coordinator's
            # wound/wait policy (repro.core.txn) needs the holder's txn_id.
            return TxnVote(
                granted=False, error=result.error,
                blocking=result.value if result.error == "TXN_LOCKED"
                else None,
            )
        statuses = self._record_witnesses(cfg.master_id, op)
        decision, rtts, fast = self._classify(verdict, result, statuses)
        if verdict == SYNCED or decision is Decision.NEED_SYNC:
            # Slow path: the intent reaches the backups before the vote is
            # externalized, so the prepare is durable either way.
            self._drain_syncs()
        session.mark_completed(op.rpc_id)
        if result.value is None:
            # RIFL already acked this leg away (a retry of a transaction
            # that fully completed): the vote stands, the read values were
            # externalized on the original run.
            reads = ()
        else:
            _status, reads = result.value
        return TxnVote(granted=True, fast=fast, rtts=rtts, read_values=reads)

    def txn_decide(self, op: Op,
                   session: Optional[ClientSession] = None) -> str:
        """Apply one COMMIT/ABORT leg.  No witness records and no pre-reply
        sync — the decision re-derives from durable prepare state on crash
        (see repro.core.txn).  ``session=None`` is the recovery-resolution
        path (the coordinator is gone; no acks, no completion marking)."""
        acks = session.acks() if session is not None else ()
        for _attempt in range(4):
            cfg = self.config.fetch(self.shard_id)
            verdict, result = self.master.handle_update(
                op, cfg.witness_list_version, acks, 0.0
            )
            if verdict != ERROR:
                break
        assert verdict != ERROR, f"decide leg failed: {result.error}"
        if session is not None:
            session.mark_completed(op.rpc_id)
        if self.auto_sync and self.master.want_sync:
            self._drain_syncs()
        return result.value

    # ------------------------------------------------------------------ syncs
    def _drain_syncs(self) -> None:
        """Run batched backup syncs + witness gc until quiescent (§4.4, §3.5)."""
        with span("shard.drain"):
            while True:
                req = self.master.begin_sync()
                if req is None:
                    return
                with span("shard.sync_round"):
                    ok = True
                    for b in self.backups:
                        resp = b.handle_sync(req)
                        ok = ok and resp.ok
                    if not ok:
                        self.master.abort_sync()
                        return
                    gc_entries = self.master.complete_sync()
                    live = [w for i, w in enumerate(self.witnesses)
                            if i not in self._dropped_witnesses]
                    for resp in self._gc_witnesses(live, gc_entries):
                        # §4.5: retry suspected uncollected garbage through
                        # RIFL.
                        for op in resp.stale_requests:
                            cfg = self.config.fetch(self.shard_id)
                            self.master.handle_update(
                                op, cfg.witness_list_version, (), 0.0)

    def _gc_witnesses(self, witnesses, gc_entries):
        """One sync round's witness gc: device witnesses sharing a gang
        clear + age in ONE stacked dispatch (lane-expanded entries); any
        remaining witness gc's individually.  Responses in witness order."""
        with span("witness.gc_round"):
            if self.witness_backend == "device" and len(witnesses) > 1:
                from .device_witness import DeviceWitness, gc_many
                from .types import WitnessMode

                gang = self.gang
                stacked = [w for w in witnesses
                           if isinstance(w, DeviceWitness)
                           and w.mode is WitnessMode.NORMAL
                           and w.gang is gang]
                if len(stacked) > 1:
                    resp = dict(zip((id(w) for w in stacked),
                                    gc_many(stacked, gc_entries)))
                    return [resp[id(w)] if id(w) in resp
                            else w.gc(gc_entries) for w in witnesses]
            return [w.gc(gc_entries) for w in witnesses]

    def sync_now(self) -> None:
        self.master.want_sync = True
        self._drain_syncs()

    # --------------------------------------------------------------- recovery
    def crash_master(self) -> RecoveryReport:
        """Kill this shard's master (unsynced state lost) and recover a new
        one from this shard's backups + one of its witnesses (§3.3).  Other
        shards are untouched by construction."""
        old_id = self.master.master_id
        new_master = Master(
            self.alloc_id(),
            sync_batch=self.master.sync_batch,
            hot_key_window=self.master.hot_key_window,
        )
        # Re-apply the cluster's ownership filter BEFORE witness replay:
        # §3.6 — replayed requests for slots migrated away are ignored.
        new_master.owned_partition = self.owned_filter
        live = [i for i in range(self.f) if i not in self._dropped_witnesses]
        assert live, "no witness reachable: recovery must wait (§3.3)"
        recovery_witness = self.witnesses[live[0]]
        with span("recovery.new_witnesses"):
            new_witnesses = [self._new_witness() for _ in range(self.f)]
        new_ids = tuple(self.alloc_id() for _ in range(self.f))
        report = recover_master(
            shard_id=self.shard_id,
            old_master_id=old_id,
            new_master=new_master,
            backups=self.backups,
            recovery_witness=recovery_witness,
            new_witnesses=new_witnesses,
            new_witness_ids=new_ids,
            config=self.config,
        )
        # The black box survives the crash: the replacement master and
        # witnesses inherit the journal AFTER replay (recovery internals are
        # not client-visible protocol steps), and the epoch fence is
        # journaled so the monotonicity monitor sees every bump.
        jr = self.master.journal
        new_master.journal = jr
        new_master.journal_actor = f"m{new_master.master_id}"
        for w_old, w_new in zip(self.witnesses, new_witnesses):
            w_new.journal = getattr(w_old, "journal", None)
            w_new.journal_actor = getattr(w_old, "journal_actor", "w?")
        if jr is not None:
            cfg = self.config.fetch(self.shard_id)
            jr.emit("fence", actor=f"m{new_master.master_id}",
                    shard=self.shard_id, epoch=cfg.epoch,
                    wlv=cfg.witness_list_version, reason="recovery")
        self.master = new_master
        self.witnesses = new_witnesses
        self._witness_ids = new_ids
        self._dropped_witnesses.clear()
        return report

    def replace_witness(self, witness_idx: int) -> None:
        """§3.6 case 2: decommission a witness, install a fresh one, bump the
        WitnessListVersion; master syncs before the new config goes live."""
        dead_id = self._witness_ids[witness_idx]
        new_w = self._new_witness()
        new_id = self.alloc_id()
        self.sync_now()  # master must sync to restore f fault tolerance
        cfg = self.config.replace_witness(self.shard_id, dead_id, new_id)
        self.master.witness_list_version = cfg.witness_list_version
        new_w.start(self.master.master_id)
        self.witnesses[witness_idx] = new_w
        ids = list(self._witness_ids)
        ids[witness_idx] = new_id
        self._witness_ids = tuple(ids)


# ---------------------------------------------------------------------------
# Client sessions: one RIFL identity space per client, shared across shards
# ---------------------------------------------------------------------------
class ShardedClientSession:
    """One logical client talking to N shards through ONE RIFL space.

    (client_id, seq) pairs are allocated from a single per-client sequence,
    so every rpc_id is globally unique across shards.  That is the property
    live migration needs: a completion record can move with its key's slot
    (Master.migrated_rifl) and still dedup a cross-move retry without ever
    being confusable with the new owner's native records.  Acks stay safe to
    apply at any master: completion is tracked globally, so ``seq < N`` in
    an ack means the op completed wherever it ran — a master deleting its
    own records below N deletes only completed ops.
    """

    def __init__(self, client_id: int, router: SlotRouter) -> None:
        self.client_id = client_id
        self.router = router
        self._ids = ClientSession(client_id=client_id)
        self._txn_seq = 0

    def session_for(self, shard_id: int) -> ClientSession:
        """The identity space used when talking to ``shard_id`` — the SAME
        shared space for every shard (see class docstring)."""
        return self._ids

    def acks(self) -> Tuple[Tuple[int, int], ...]:
        return self._ids.acks()

    def mark_completed(self, rpc_id) -> None:
        self._ids.mark_completed(rpc_id)

    def abandon(self, rpc_id) -> None:
        """Release a never-transmitted identity (see ClientSession.abandon):
        callers that created an op and then drew a SlotMoving redirect call
        this before re-issuing fresh, so the ack frontier keeps moving."""
        self._ids.abandon(rpc_id)

    # convenience constructors (the route only decides WHERE the op goes;
    # the identity comes from the shared space)
    def _sub(self, key) -> ClientSession:
        return self.session_for(self.router.shard_of(key))

    def op_set(self, key, value) -> Op:
        return self._sub(key).op_set(key, value)

    def op_get(self, key) -> Op:
        return self._sub(key).op_get(key)

    def op_incr(self, key, delta: int = 1) -> Op:
        return self._sub(key).op_incr(key, delta)

    def op_hmset(self, key, fields) -> Op:
        return self._sub(key).op_hmset(key, fields)

    def op_del(self, key) -> Op:
        return self._sub(key).op_del(key)

    def op_sadd(self, key, member) -> Op:
        return self._sub(key).op_sadd(key, member)

    def op_append(self, key, chunk) -> Op:
        return self._sub(key).op_append(key, chunk)

    def op_max(self, key, n) -> Op:
        return self._sub(key).op_max(key, n)

    def mset_parts(self, kvs,
                   prev: Optional[Dict[int, Op]] = None) -> Dict[int, Op]:
        """Split a multi-key set into per-shard MSET sub-ops, each carrying
        its own rpc_id from the client's (shared, globally-unique) space.

        ``prev`` is the part map of an earlier attempt of the SAME mset: a
        retry after a partial failure must reuse the original sub-ops so
        already-applied legs RIFL-dedup instead of re-executing under fresh
        identities (which would double-apply and double-record).  The retry
        re-routes each ORIGINAL leg to its key set's CURRENT owner — a leg
        whose slots migrated whole between attempts still dedups at the new
        owner (its completion record moved with the slots).  A migration
        that SPLITS a leg's keys across shards (or folds two legs onto one
        shard) makes the original identities unreplayable; that raises a
        descriptive error rather than double-applying.
        """
        kvs = list(kvs)
        if prev is not None:
            want = {k: v for k, v in kvs}
            got = {k: v for sub in prev.values()
                   for k, v in zip(sub.keys, sub.args)}
            assert want == got, "mset retry must carry the same kvs"
            for sub in prev.values():
                owners = {self.router.shard_of(k) for k in sub.keys}
                if len(owners) != 1:
                    raise ValueError(
                        "mset retry invalidated by a live migration: leg "
                        f"{sub.rpc_id} now spans shards {sorted(owners)}; "
                        "use ShardedCluster.txn for atomic retries, or "
                        "re-issue fresh only if no leg ever reached a master"
                    )
            # The keys of the returned map are LEG ids (the shard ids at
            # allocation time) — the executor re-resolves each leg's current
            # owner, so several original legs may legally land on one shard
            # after a migration.
            return dict(prev)
        parts = self.router.split_keys([k for k, _ in kvs])
        return {
            shard_id: self.session_for(shard_id).op_mset(
                [kvs[i] for i in idxs]
            )
            for shard_id, idxs in parts.items()
        }

    def txn_spec(self, writes, reads=()) -> TxnSpec:
        """Build a transaction spec: split read/write sets by the router and
        fix every leg's RIFL identities (prepare_rpc + decide_rpc) up front,
        so any retry of any leg — by this client or by crash resolution —
        is a RIFL-dedup'd replay."""
        writes = list(writes)
        reads = list(reads)
        by_shard: Dict[int, Tuple[List, List]] = {}
        for k, v in writes:
            by_shard.setdefault(self.router.shard_of(k), ([], []))[0].append(
                (k, v)
            )
        for k in reads:
            by_shard.setdefault(self.router.shard_of(k), ([], []))[1].append(k)
        self._txn_seq += 1
        parts = tuple(
            TxnPart(
                shard_id=sid,
                prepare_rpc=self.session_for(sid).next_rpc_id(),
                decide_rpc=self.session_for(sid).next_rpc_id(),
                write_kvs=tuple(w),
                read_keys=tuple(r),
            )
            for sid, (w, r) in sorted(by_shard.items())
        )
        return TxnSpec(txn_id=(self.client_id, self._txn_seq), parts=parts)


@dataclass
class ClusterRecoveryReport:
    """Aggregate of per-shard RecoveryReports (serving-level crash).

    The txn_* counts are CLUSTER-level: the post-recovery resolution sweep
    decides orphaned transactions whose intents may span several shards, so
    they are reported here rather than attributed to any one shard."""
    per_shard: Tuple[RecoveryReport, ...]
    txn_resolved: int = 0
    txn_committed: int = 0
    txn_aborted: int = 0

    @property
    def replayed(self) -> int:
        return sum(r.replayed for r in self.per_shard)

    @property
    def restored_log_entries(self) -> int:
        return sum(r.restored_log_entries for r in self.per_shard)

    @property
    def witness_requests(self) -> int:
        return sum(r.witness_requests for r in self.per_shard)


# ---------------------------------------------------------------------------
# The sharded cluster
# ---------------------------------------------------------------------------
class ShardedCluster:
    """N CURP shards behind a KeyRouter (paper §4, Fig. 3 deployment shape).

    Single-shard ops behave exactly like LocalCluster ops against the owning
    shard.  ``mset`` fans sub-ops out to every touched shard; it completes in
    1 RTT iff every shard's witnesses accepted, otherwise only the rejecting
    shards pay the sync fallback.
    """

    def __init__(
        self,
        n_shards: int = 4,
        f: int = 3,
        sync_batch: int = 50,
        witness_sets: int = 1024,
        witness_ways: int = 4,
        hot_key_window: float = 0.0,
        seed: int = 0,
        auto_sync: bool = True,
        geometry: Optional[WitnessGeometry] = None,
        witness_backend: str = "python",
        n_slots: int = N_SLOTS,
        device: str = "cuda",
    ) -> None:
        from .migration import MigrationManager

        self.n_shards = n_shards
        self.f = f
        self.rng = random.Random(seed)
        self.config = ConfigManager()
        self.router = SlotRouter.uniform(n_shards, n_slots)
        self._record = HistoryRecorder()
        self.history = self._record.history   # linearizability-checkable log
        self._next_node_id = 0
        if geometry is None:
            geometry = WitnessGeometry(witness_sets, witness_ways)
        self.geometry = geometry
        self.witness_backend = witness_backend
        # One device-resident gang for the WHOLE cluster: every shard's
        # witnesses stack into it, so a routed cross-shard batch records at
        # all its target lanes in ONE dispatch (see update_batch).
        self.gang = None
        if witness_backend == "device":
            from .device_witness import WitnessGang

            lanes = 1
            while lanes < n_shards * f:
                lanes <<= 1
            self.gang = WitnessGang(geometry.n_sets, geometry.n_ways, lanes,
                                    device=device)
        # Kept for add_shard: a grown shard is built like the seed shards.
        self._group_kwargs = dict(
            f=f, sync_batch=sync_batch, hot_key_window=hot_key_window,
            auto_sync=auto_sync, device=device,
        )
        self.shards = [
            ShardGroup(
                shard_id=i, config=self.config, alloc_id=self._node_id,
                record=self._record, geometry=geometry,
                witness_backend=witness_backend, gang=self.gang,
                **self._group_kwargs,
            )
            for i in range(n_shards)
        ]
        self.migration = MigrationManager(self)
        self._apply_ownership()
        self._fused = None
        if witness_backend == "device":
            from .fastbatch import FusedBatchDriver

            self._fused = FusedBatchDriver(self)

    def _node_id(self) -> int:
        self._next_node_id += 1
        return self._next_node_id

    def _apply_ownership(self) -> None:
        """Install the router-backed ownership filter on every live master
        (§3.6: a master ignores replayed/incoming ops for slots it no longer
        owns).  The filter closes over the LIVE router, so a slot-map flip
        changes every master's view at once."""
        for g in self.shards:
            if g.retired:
                continue
            flt = (lambda key, sid=g.shard_id:
                   self.router.shard_of(key) == sid)
            g.owned_filter = flt
            g.master.owned_partition = flt

    # ----------------------------------------------------------------- client
    def new_client(self) -> ShardedClientSession:
        return ShardedClientSession(self._node_id(), self.router)

    def shard_of(self, key: Any) -> int:
        return self.router.shard_of(key)

    def slot_of(self, key: Any) -> int:
        return self.router.slot_of(key)

    def _group_for(self, op: Op) -> ShardGroup:
        """Route an op: redirect if any touched slot is mid-handover, feed
        the per-slot load counters, and require a single owning shard."""
        slots = {self.router.slot_of(k) for k in op.keys}
        self.migration.check_slots(slots)
        sids = {self.router.slot_map[s] for s in slots}
        if len(sids) != 1:
            raise ValueError(
                f"op spans shards {sorted(sids)}; use ShardedCluster.mset"
            )
        group = self.shards[sids.pop()]
        for s in slots:
            group.slot_ops[s] = group.slot_ops.get(s, 0) + 1
        return group

    def update(self, session: ShardedClientSession, op: Op, now: float = 0.0):
        group = self._group_for(op)
        return self._with_txn_resolution(
            lambda: group.update(session.session_for(group.shard_id), op, now)
        )

    def read(self, session: ShardedClientSession, op: Op, now: float = 0.0):
        group = self._group_for(op)
        return self._with_txn_resolution(
            lambda: group.read(session.session_for(group.shard_id), op, now)
        )

    def _with_txn_resolution(self, fn):
        """Run a protocol call; whenever it hits keys locked by an undecided
        transaction intent (an orphaned 2PC — its coordinator crashed),
        resolve that transaction from participant state and retry.  Each
        distinct orphan is resolved at most once (an op spanning several
        orphans' locks resolves them all); a repeat of the same txn_id
        re-raises instead of looping."""
        seen: set = set()
        while True:
            try:
                return fn()
            except TxnPending as pend:
                if pend.spec.txn_id in seen:
                    raise
                seen.add(pend.spec.txn_id)
                resolve_txn(self, pend.spec)

    def update_batch(self, session: ShardedClientSession, ops: Sequence[Op],
                     now: float = 0.0) -> List["OpOutcome"]:
        """Batched client path: group ops by owning shard, drive each shard's
        batch through ShardGroup.update_batch (one witness-record invocation
        — one kernel dispatch on the device backend — per witness per shard),
        and return per-op outcomes in the input order.

        On the device backend a routed cross-shard batch of plain updates
        first tries the fused driver (core/fastbatch.py): ONE stacked-gang
        dispatch covers hashing, slot routing, the device-resident master
        window conflict check, and every shard's every witness record.  The
        driver declines (returns None) whenever any op or shard falls off
        its eligibility envelope, and the per-shard path below runs."""
        if self._fused is not None:
            fused = self._fused.try_update_batch(session, ops, now)
            if fused is not None:
                return fused
        groups: Dict[int, List[int]] = {}
        for idx, op in enumerate(ops):
            groups.setdefault(self._group_for(op).shard_id, []).append(idx)
        out: List[Optional["OpOutcome"]] = [None] * len(ops)
        for shard_id, idxs in groups.items():
            sub = session.session_for(shard_id)
            res = self._with_txn_resolution(
                lambda shard_id=shard_id, sub=sub, idxs=idxs:
                self.shards[shard_id].update_batch(
                    sub, [ops[i] for i in idxs], now
                )
            )
            for i, outcome in zip(idxs, res):
                out[i] = outcome
        return out  # type: ignore[return-value]

    def mset(self, session: ShardedClientSession, kvs, now: float = 0.0,
             parts: Optional[Dict[int, Op]] = None):
        """Cross-shard multi-key set: per-shard 1-RTT fast path when every
        shard's sub-op is accepted, per-shard sync fallback otherwise.

        Durability is per shard, atomicity is per KEY only — a client crash
        mid-mset can leave a torn cross-shard write (use ``txn``/
        ``mset_atomic`` for all-or-nothing semantics).  ``parts`` replays an
        earlier attempt's per-shard sub-ops (same rpc_ids), so a retry after
        a partial failure RIFL-dedups instead of double-applying.
        """
        from .local import OpOutcome
        from .migration import SlotMoving

        fresh = parts is None
        parts = session.mset_parts(kvs, prev=parts)
        # Redirect before ANY leg is attempted: a mid-handover slot fails the
        # whole mset client-side (nothing recorded anywhere), so the caller
        # can re-issue fresh once the map settles.  Identities this call
        # just allocated are released (never transmitted) so the ack
        # frontier keeps moving; replayed ``parts`` identities are live and
        # stay reserved.
        try:
            self.migration.check_keys(k for sub in parts.values()
                                      for k in sub.keys)
        except SlotMoving:
            if fresh:
                for sub in parts.values():
                    session.abandon(sub.rpc_id)
            raise
        # A leg blocked by an orphaned transaction intent resolves + retries
        # the whole mset; the fixed per-shard rpc_ids make that idempotent.
        return self._with_txn_resolution(
            lambda: self._mset_once(session, parts, now)
        )

    def _mset_once(self, session: ShardedClientSession,
                   parts: Dict[int, Op], now: float):
        from .local import OpOutcome

        # Resolve each leg's CURRENT owner (a retried leg may have migrated
        # since allocation — its dict key is the historical leg id, not
        # necessarily today's shard; see mset_parts).
        owners: Dict[int, ShardGroup] = {}
        for leg_id, sub_op in parts.items():
            sids = {self.router.shard_of(k) for k in sub_op.keys}
            assert len(sids) == 1, "validated in mset_parts"
            owners[leg_id] = self.shards[sids.pop()]
        # Round 1 (parallel in a real deployment): speculative execute + record
        # at every touched shard.
        attempts: Dict[int, Tuple[str, ExecResult, List[RecordStatus]]] = {}
        decisions: Dict[int, Decision] = {}
        for leg_id, sub_op in parts.items():
            group = owners[leg_id]
            for k in sub_op.keys:
                s = self.router.slot_of(k)
                group.slot_ops[s] = group.slot_ops.get(s, 0) + 1
            attempt = group.attempt_update(sub_op, session.acks(), now)
            attempts[leg_id] = attempt
            decisions[leg_id] = decide(attempt[1], attempt[2])
        # A SYNCED verdict means that master must finish its sync before the
        # reply is externalized; the harness performs the master's sync here.
        for leg_id, (verdict, _res, _sts) in attempts.items():
            if verdict == SYNCED:
                owners[leg_id]._drain_syncs()
        # Client completion rule across shards (§3.2.1, same fold as
        # decide_multi): if not COMPLETE, round 2 sends explicit syncs to the
        # NEED_SYNC shards only.
        overall = combine_decisions(decisions.values())
        if overall is Decision.NEED_SYNC:
            for leg_id, d in decisions.items():
                if d is Decision.NEED_SYNC:
                    owners[leg_id]._drain_syncs()
        # 1 RTT only if every shard was fast AND fully witness-accepted.
        all_fast = all(
            attempts[lid][0] == FAST and d is Decision.COMPLETE
            for lid, d in decisions.items()
        )
        accepts = sum(
            1 for (_v, _r, statuses) in attempts.values()
            for s in statuses if s is RecordStatus.ACCEPTED
        )
        any_synced = any(v == SYNCED for (v, _r, _s) in attempts.values())
        window = self._record.next_window()
        for leg_id, sub_op in parts.items():
            session.mark_completed(sub_op.rpc_id)
            group = owners[leg_id]
            if group.auto_sync and group.master.want_sync:
                group._drain_syncs()
            if attempts[leg_id][0] != DUP:   # dup legs already recorded
                self._record(sub_op, attempts[leg_id][1].value,
                             session.client_id, window=window)
        return OpOutcome(
            value="OK",
            rtts=1 if all_fast else 2,
            fast_path=all_fast,
            synced_path=any_synced,
            witness_accepts=accepts,
        )

    # ----------------------------------------------- transactions (core.txn)
    def txn(
        self,
        session: ShardedClientSession,
        writes,
        reads=(),
        now: float = 0.0,
        on_message=None,
        spec: Optional[TxnSpec] = None,
        wound_wait: bool = True,
    ) -> TxnOutcome:
        """Atomic cross-shard mini-transaction (RIFL-identified 2PC over the
        per-shard fast paths; see repro.core.txn).

        Single-shard transactions short-circuit to one 1-RTT op.  ``spec``
        replays an earlier attempt (same RIFL identities — idempotent);
        ``on_message(stage, shard_id, idx)`` is the crash-injection hook
        (raise CoordinatorCrash to kill the coordinator at that message).
        ``wound_wait`` enables the deterministic intent-conflict policy
        (lower txn_id wins; see TxnCoordinator) — pass False for the
        pre-policy vote-NO-on-any-foreign-intent behavior.
        """
        from .migration import SlotMoving

        fresh_spec = spec is None
        if spec is None:
            spec = session.txn_spec(writes, reads)
        # Redirect before any PREPARE leaves: a leg pinned to a mid-handover
        # slot would land on the wrong owner after the flip.  A spec this
        # call just built is released (its identities never left the
        # client); a replayed spec stays reserved.
        try:
            self.migration.check_keys(
                k for part in spec.parts for k in part.keys
            )
        except SlotMoving:
            if fresh_spec:
                for part in spec.parts:
                    session.abandon(part.prepare_rpc)
                    session.abandon(part.decide_rpc)
            raise
        coord = TxnCoordinator(self, session, wound_wait=wound_wait)
        coord.journal = self.migration.journal
        window = self._record.next_window()
        try:
            out = self._with_txn_resolution(
                lambda: coord.run(spec, now=now, on_message=on_message)
            )
        except CoordinatorCrash:
            # The coordinator died mid-2PC: its effects may or may not land
            # (resolution decides later) — a "maybe" op for the checker.
            self.history.append({
                "op": self._txn_history_op(spec), "value": None,
                "client": session.client_id,
                "invoke": window[0], "complete": window[1], "failed": True,
            })
            raise
        if out.status is TxnStatus.COMMITTED and len(spec.parts) > 1:
            # Multi-shard commits record ONE whole-transaction entry here.
            # The single-shard short-circuit already recorded its (only)
            # entry inside ShardGroup.update — recording again would put
            # two must-linearize points for one atomic op into the history
            # and make the strict checker reject correct executions.
            reads_in_spec_order = tuple(
                out.reads.get(k) for k in spec.read_keys
            ) if out.reads is not None else ()
            self._record(
                self._txn_history_op(spec),
                ("COMMITTED", reads_in_spec_order),
                session.client_id, window=window,
            )
        return out

    @staticmethod
    def _txn_history_op(spec: TxnSpec) -> Op:
        """One history entry for the WHOLE transaction (every shard's leg),
        so the strict linearizability checker treats it atomically."""
        keys = tuple(k for k, _ in spec.write_kvs) + spec.read_keys
        return Op(OpType.TXN, keys, (spec,), spec.txn_id)

    def mset_atomic(self, session: ShardedClientSession, kvs,
                    now: float = 0.0) -> TxnOutcome:
        """All-or-nothing multi-key set: atomic across shards via the
        transaction subsystem (unlike ``mset``, which is only per-shard
        durable).  Single-shard key sets keep the 1-RTT fast path."""
        return self.txn(session, writes=kvs, now=now)

    def resolve_txn(self, spec: TxnSpec) -> TxnStatus:
        """Finish one orphaned transaction (Sinfonia recovery rule)."""
        return resolve_txn(self, spec)

    def resolve_pending_txns(self) -> Dict[str, int]:
        """Sweep and resolve every undecided intent on every shard."""
        return resolve_pending(self)

    # ----------------------------------------- live reconfiguration (§3.6)
    def start_migration(self, slots: Sequence[int], dst_shard: int):
        """Begin moving ``slots`` to ``dst_shard``; returns SlotMigration
        handles (one per donor) to drive stepwise — harnesses interleave
        client traffic between ``step()`` calls.  The slots redirect
        (SlotMoving) from this call until their handover commits."""
        return self.migration.start(slots, dst_shard)

    def migrate_slots(self, slots: Sequence[int], dst_shard: int):
        """Move ``slots`` to ``dst_shard``, running each donor's handover to
        completion.  Returns the MigrationReports."""
        return self.migration.migrate(slots, dst_shard)

    def add_shard(self) -> int:
        """Grow the cluster by one (initially slot-less) shard group; move
        load onto it with ``migrate_slots``/``rebalance``.  Returns the new
        shard id."""
        sid = len(self.shards)
        group = ShardGroup(
            shard_id=sid, config=self.config, alloc_id=self._node_id,
            record=self._record, geometry=self.geometry,
            witness_backend=self.witness_backend, gang=self.gang,
            **self._group_kwargs,
        )
        self.shards.append(group)
        self.n_shards += 1
        if sid >= self.router.n_shards:
            self.router.n_shards = sid + 1
        self._apply_ownership()
        return sid

    def remove_shard(self, shard_id: int) -> List[Any]:
        """Drain a shard: live-migrate every slot it owns round-robin onto
        the remaining shards, then retire the group.  Returns the
        MigrationReports."""
        victim = self.shards[shard_id]
        if victim.retired:
            raise ValueError(f"shard {shard_id} already retired")
        targets = [g.shard_id for g in self.shards
                   if not g.retired and g.shard_id != shard_id]
        if not targets:
            raise ValueError("cannot remove the last shard")
        by_dst: Dict[int, List[int]] = {}
        for i, slot in enumerate(self.router.slots_of_shard(shard_id)):
            by_dst.setdefault(targets[i % len(targets)], []).append(slot)
        reports = []
        for dst, slots in sorted(by_dst.items()):
            reports.extend(self.migrate_slots(slots, dst))
        victim.retired = True
        victim.owned_filter = lambda key: False
        victim.master.owned_partition = victim.owned_filter
        self.n_shards -= 1
        return reports

    def slot_loads(self) -> List[int]:
        """Per-slot op counts summed across shard groups (the rebalance
        policy's input)."""
        loads = [0] * self.router.n_slots
        for g in self.shards:
            for s, c in g.slot_ops.items():
                loads[s] += c
        return loads

    def rebalance(self, max_moves: int = 64,
                  tolerance: float = 1.1) -> Dict[str, Any]:
        """Hot-shard auto-split: plan moves from the per-slot op counters
        (plan_rebalance) and execute them as live handovers.  Counters reset
        afterwards so the next window measures the new placement.  Returns
        {'moves': {dst: [slots]}, 'reports': [MigrationReport...]}."""
        from .migration import plan_rebalance

        live = [g.shard_id for g in self.shards if not g.retired]
        moves = plan_rebalance(
            self.slot_loads(), self.router.slot_map, live,
            max_moves=max_moves, tolerance=tolerance,
        )
        reports = []
        for dst, slots in sorted(moves.items()):
            reports.extend(self.migrate_slots(slots, dst))
        for g in self.shards:
            g.slot_ops.clear()
        return {"moves": moves, "reports": reports}

    # ------------------------------------------------------------------ admin
    def sync_all(self) -> None:
        for g in self.shards:
            if not g.retired:
                g.sync_now()

    def crash_master(self, shard_id: int) -> RecoveryReport:
        """Crash exactly one shard's master; only that shard's witnesses are
        frozen and replayed (per-shard epochs via the ConfigManager).
        Undecided transaction intents the recovered master re-surfaced (from
        its backup log and witness replay) are resolved cluster-wide before
        returning — no intent outlives recovery undecided."""
        report = self.shards[shard_id].crash_master()
        resolved = self.resolve_pending_txns()
        report.txn_resolved = resolved["resolved"]
        report.txn_committed = resolved["committed"]
        report.txn_aborted = resolved["aborted"]
        return report

    def crash_all(self) -> ClusterRecoveryReport:
        reports = tuple(g.crash_master() for g in self.shards
                        if not g.retired)
        resolved = self.resolve_pending_txns()
        return ClusterRecoveryReport(
            per_shard=reports,
            txn_resolved=resolved["resolved"],
            txn_committed=resolved["committed"],
            txn_aborted=resolved["aborted"],
        )

    def epochs(self) -> Dict[int, int]:
        return self.config.epochs()

    def stats(self) -> Dict[str, int]:
        """Aggregate master stats across shards (per-shard in .shards[i])."""
        out: Dict[str, int] = {}
        for g in self.shards:
            if g.retired:
                continue
            for k, v in g.master.stats.items():
                out[k] = out.get(k, 0) + v
        return out
