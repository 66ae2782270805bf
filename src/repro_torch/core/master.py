"""CURP master (§3.2.3, §4.3, §4.4).

The master executes all updates, but — unlike classic primary-backup — replies
*before* replicating to backups ("speculative execution"), as long as the new
operation commutes with every *unsynced* operation.  Backup syncs are batched
(§4.4, batch of up to ``sync_batch`` ops) and run asynchronously.

The master is transport-agnostic: it decides WHAT must happen
(fast-respond / sync-before-respond / duplicate / error) and exposes
``begin_sync``/``complete_sync`` for the harness (simulator or local runner)
that owns actual RPC delivery.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .backup import LogEntry
from .merge import conflicts
from .rifl import RiflTable
from .store import KVStore
from .telemetry import get_registry
from .types import TXN_OPS, BackupSyncReq, ExecResult, Op, OpType, RpcId

# Verdicts for an incoming update.
FAST = "fast"            # executed, reply immediately (1 RTT path)
SYNCED = "synced"        # executed + must sync before replying (conflict path)
DUP = "dup"              # RIFL duplicate, reply with saved result
ERROR = "error"


@dataclass
class PendingSync:
    """An in-flight batched backup sync."""
    through_index: int
    req: BackupSyncReq
    acks: int = 0


class Master:
    def __init__(
        self,
        master_id: int,
        epoch: int = 0,
        sync_batch: int = 50,
        hot_key_sync: bool = True,
        hot_key_window: float = 0.0,
    ) -> None:
        self.master_id = master_id
        self.epoch = epoch
        self.sync_batch = sync_batch
        self.hot_key_sync = hot_key_sync
        # "updated recently" horizon for the §4.4 preemptive-sync heuristic:
        # an update to a key whose previous update is still unsynced hints the
        # key is hot; sync right after responding.
        self.hot_key_window = hot_key_window

        self.store = KVStore()
        self.rifl = RiflTable()
        self.log: List[LogEntry] = []
        self.synced_index = 0                 # log[:synced_index] is on backups
        self.witness_list_version = 0
        # The §3.2.3 unsynced window, merge-lattice aware: keyhash -> the
        # {merge-class: refcount} map of unsynced (hash, class) pairs from
        # Op.hash_classes().  A new op commutes iff none of its pairs
        # CONFLICTS (repro.core.merge) with a held class at the same hash —
        # e.g. INCR rides the fast path over unsynced INCRs of the same key.
        self._unsynced_keyhash: Dict[int, Dict[int, int]] = {}
        self.sync_in_progress: Optional[PendingSync] = None
        self.want_sync: bool = False          # sync requested (batch full / conflict)
        self.owned_partition = None           # optional key filter (migration §3.6)
        # RIFL completion records that arrived WITH migrated data (§3.6 slot
        # handover, RAMCloud-style per-object RIFL): keyed by (rpc_id,
        # key_hashes) so a moved op's retry dedups here while this master's
        # native records stay untouched.  Truncated by client acks like the
        # native table: a piggybacked (client, first_incomplete) frontier
        # proves the client saw results for every seq below it, so those
        # moved completions can never be retried again and are dropped
        # (see _gc_migrated).
        self.migrated_rifl: Dict[Tuple[RpcId, Tuple[int, ...]], Any] = {}
        # Per-client ack frontier already swept over migrated_rifl, so the
        # overlay scan runs only when a client's frontier advances — steady
        # traffic with no new acks pays a dict lookup, not a table walk.
        self._migrated_ack_seen: Dict[int, int] = {}
        self.stats = {
            "fast": 0, "conflict_syncs": 0, "dups": 0, "batch_syncs": 0,
            "reads_fast": 0, "reads_blocked": 0, "hot_key_syncs": 0,
            "txn_prepares": 0, "txn_commits": 0, "txn_aborts": 0,
            "txn_vote_no": 0, "migrated_in_keys": 0, "migrated_out_keys": 0,
            "migrated_rifl_gcd": 0,
        }
        # Optional black-box journal (repro.core.journal.EventJournal): the
        # watchdog attaches one; hooks below are attribute-load + None-check
        # when absent, so they stay in the hot path permanently.
        self.journal = None
        self.journal_actor = f"m{master_id}"
        reg = get_registry()
        self._m_fast = reg.counter("master.fast")
        self._m_conflict_syncs = reg.counter("master.conflict_syncs")
        self._m_dups = reg.counter("master.dups")
        self._m_batch_syncs = reg.counter("master.batch_syncs")
        self._m_hot_key_syncs = reg.counter("master.hot_key_syncs")
        self._h_window = reg.histogram("master.unsynced_window")
        self._h_sync_batch = reg.histogram("master.sync_batch_ops")

    # ------------------------------------------------------------------ utils
    @property
    def unsynced_count(self) -> int:
        return len(self.log) - self.synced_index

    def _commutes(self, op: Op) -> bool:
        for kh, cls in op.hash_classes():
            held = self._unsynced_keyhash.get(kh)
            if not held:
                continue
            for held_cls in held:
                if conflicts(held_cls, cls):
                    return False
        return True

    def _window_add(self, op: Op) -> None:
        for kh, cls in op.hash_classes():
            per_cls = self._unsynced_keyhash.setdefault(kh, {})
            per_cls[cls] = per_cls.get(cls, 0) + 1

    def _window_remove(self, op: Op) -> None:
        for kh, cls in op.hash_classes():
            per_cls = self._unsynced_keyhash.get(kh)
            if per_cls is None:
                continue
            cnt = per_cls.get(cls, 0) - 1
            if cnt <= 0:
                per_cls.pop(cls, None)
                if not per_cls:
                    self._unsynced_keyhash.pop(kh, None)
            else:
                per_cls[cls] = cnt

    def _jexec(self, op: Op, verdict: str, checked: bool,
               txn: Optional[Tuple[int, int]] = None) -> None:
        """Journal one executed-and-logged op (watchdog sensor; see
        repro.core.journal).  ``checked`` marks verdicts subject to the
        fast⇒commutes invariant (MIGRATE_IN and txn decide legs reply FAST
        by design without a window check, so the monitor must not judge
        them); ``index`` is the op's 1-based log position, the unit the
        sync events' ``through`` frontier is expressed in."""
        jr = self.journal
        if jr is None:
            return
        jr.emit(
            "execute", actor=self.journal_actor, rpc=op.rpc_id,
            mid=self.master_id, op=op.op_type.name, verdict=verdict,
            checked=checked, index=len(self.log),
            pairs=op.hash_classes(),
            frontier=self.rifl.acked_frontier(op.rpc_id[0]),
            epoch=self.epoch, txn=txn,
        )

    def owns(self, op: Op) -> bool:
        if op.op_type is OpType.MIGRATE_IN:
            # The handover mechanism itself: absorbs keys the routing table
            # does not map here YET (the map flips only after the transfer
            # is durable), so it must bypass the ownership filter.
            return True
        if self.owned_partition is None:
            return True
        return all(self.owned_partition(k) for k in op.keys)

    # --------------------------------------------------------------- updates
    def handle_update(
        self,
        op: Op,
        witness_list_version: int,
        client_acks: Sequence[Tuple[int, int]] = (),
        now: float = 0.0,
        commutes: Optional[bool] = None,
    ) -> Tuple[str, ExecResult]:
        """Execute an update; classify the reply path.

        Returns (verdict, result).  ``SYNCED`` means the harness must complete
        a backup sync through this op before the reply is released; the result
        carries synced=True so the client completes without witness accepts
        (§3.2.3 "tags its result as synced").

        ``commutes`` optionally overrides the host window lookup with a
        commutativity verdict already computed elsewhere — the fused batch
        driver passes the device ring buffer's conflict bit so the host
        ``_unsynced_keyhash`` dict is never consulted on the hot path.
        """
        if witness_list_version != self.witness_list_version:
            # §3.6: stale witness list — client must refetch and retry, else
            # its witness records would land on decommissioned witnesses.
            return ERROR, ExecResult(None, synced=False, ok=False,
                                     error="WRONG_WITNESS_VERSION")
        if not self.owns(op):
            return ERROR, ExecResult(None, synced=False, ok=False,
                                     error="NOT_OWNER")

        self.rifl.apply_client_acks(client_acks)
        if self.migrated_rifl and client_acks:
            self._gc_migrated(client_acks)
        # §3.6 slot handover: a retry of an op that completed on the DONOR
        # before its slot moved here dedups against the migrated completion
        # records (checked first and key-scoped: this master's own records
        # can never be confused with a moved op's).  Membership test, not a
        # get-vs-None: already-ACKED ops migrate with result None (the
        # ignore-as-duplicate marker) and must still dedup, never re-execute.
        mig_key = (op.rpc_id, op.key_hashes())
        if mig_key in self.migrated_rifl:
            self.stats["dups"] += 1
            self._m_dups.inc()
            return DUP, ExecResult(self.migrated_rifl[mig_key], synced=True)
        dup = self.rifl.check_duplicate(op.rpc_id)
        if dup is not None:
            self.stats["dups"] += 1
            self._m_dups.inc()
            return DUP, ExecResult(dup.result, synced=dup.synced)

        if op.op_type in TXN_OPS:
            return self._handle_txn(op, now)
        if op.op_type is OpType.MIGRATE_IN:
            # Receiver side of a slot handover: absorb the moved snapshot +
            # completion records as ONE ordinary log entry, so backup syncs
            # make the transfer durable and a post-crash restore replays it.
            result = self.store.execute(op, now)
            self._install_migrated(op)
            self._log_txn(op, result)
            self.stats["migrated_in_keys"] += len(op.keys)
            self.want_sync = True
            self._jexec(op, FAST, checked=False)
            return FAST, ExecResult(result, synced=False)
        # Keys under an undecided transaction intent cannot be executed:
        # syncing doesn't resolve the intent, so this is not the §3.2.3
        # conflict path — the caller must resolve the transaction (or wait
        # for its coordinator) and retry.  ExecResult.value carries the
        # blocking TxnSpec for exactly that.
        blocking = self.store.txn_lock_conflict(op.keys)
        if blocking is not None:
            return ERROR, ExecResult(blocking, synced=False, ok=False,
                                     error="TXN_PENDING")

        if commutes is None:
            commutes = self._commutes(op)
        # §4.4 hot-key heuristic: was any touched key updated "recently"
        # (within hot_key_window) before this op?  If so it will likely be
        # updated again soon — sync preemptively after responding.
        hot = False
        if self.hot_key_sync and self.hot_key_window > 0:
            for k in op.keys:
                prev = self.store.last_update_time(k)
                if prev is not None and (now - prev) <= self.hot_key_window:
                    hot = True
                    break

        result = self.store.execute(op, now)
        self.rifl.record_completion(op.rpc_id, result, synced=False)
        self.log.append(LogEntry(op, result))
        self._window_add(op)
        self._h_window.record(self.unsynced_count)
        if op.op_type is OpType.MIGRATE_OUT:
            self.stats["migrated_out_keys"] += len(op.keys)

        if not commutes:
            # §3.2.3: must sync (through this op) before externalizing result.
            self.stats["conflict_syncs"] += 1
            self._m_conflict_syncs.inc()
            self.want_sync = True
            self._jexec(op, SYNCED, checked=True)
            return SYNCED, ExecResult(result, synced=True)

        self.stats["fast"] += 1
        self._m_fast.inc()
        self._jexec(op, FAST, checked=True)
        if self.unsynced_count >= self.sync_batch:
            self.want_sync = True
        if hot:
            # §4.4 heuristic: recently-updated key updated again — sync
            # preemptively (after responding) so future ops don't block.
            self.stats["hot_key_syncs"] += 1
            self._m_hot_key_syncs.inc()
            self.want_sync = True
        return FAST, ExecResult(result, synced=False)

    # ----------------------------------------------- migration (migration.py)
    def _gc_migrated(self, client_acks: Sequence[Tuple[int, int]]) -> None:
        """Ack-driven gc of the migrated-completion overlay: a client ack
        frontier (client_id, first_incomplete) proves every seq below it has
        been seen by the client, so the retry window for those moved ops is
        closed — drop their completion records.  Mirrors the native table's
        apply_client_acks sweep, which cannot see this overlay (its entries
        are keyed (rpc_id, key_hashes), not rpc_id)."""
        for cid, first in client_acks:
            if self._migrated_ack_seen.get(cid, 0) >= first:
                continue
            self._migrated_ack_seen[cid] = first
            dead = [k for k in self.migrated_rifl
                    if k[0][0] == cid and k[0][1] < first]
            for k in dead:
                del self.migrated_rifl[k]
            self.stats["migrated_rifl_gcd"] += len(dead)

    def _install_migrated(self, op: Op) -> None:
        """Install the RIFL completion records riding a MIGRATE_IN op (the
        moved ops' exactly-once identities; see handle_update's dedup)."""
        _kvs, records = op.args
        for rpc_id, key_hashes, result in records:
            if self._migrated_ack_seen.get(rpc_id[0], 0) > rpc_id[1]:
                # Already below this client's acked frontier: the client can
                # never retry it, so don't resurrect the record.
                continue
            self.migrated_rifl[(rpc_id, tuple(key_hashes))] = result

    # --------------------------------------------------- transactions (txn.py)
    def _log_txn(self, op: Op, result) -> None:
        """Shared tail of the txn-op paths: RIFL completion + log entry +
        unsynced-window refcounts (symmetric with complete_sync's walk)."""
        self.rifl.record_completion(op.rpc_id, result, synced=False)
        self.log.append(LogEntry(op, result))
        self._window_add(op)

    def _handle_txn(self, op: Op, now: float) -> Tuple[str, ExecResult]:
        """PREPARE / COMMIT / ABORT legs of the 2PC (repro.core.txn).

        PREPARE follows the regular speculative-update rules (commutativity
        vs the unsynced window decides fast vs synced) plus two vote-NO
        gates: a foreign intent lock on any key, or an existing decision
        tombstone under this leg's decide_rpc (installed by crash
        resolution — refusing the straggler prepare closes the classic 2PC
        prepare/resolve race).  COMMIT/ABORT apply immediately and reply
        FAST without witness records or a pre-reply sync: the decision is a
        deterministic function of durable prepare state, so recovery
        re-derives it instead of needing it pre-logged.
        """
        if op.op_type is OpType.TXN_PREPARE:
            spec, shard_id = op.args
            part = spec.part_on(shard_id)
            dec = self.rifl.check_duplicate(part.decide_rpc)
            if dec is not None:
                self.stats["txn_vote_no"] += 1
                return ERROR, ExecResult(dec.result, synced=False, ok=False,
                                         error="TXN_DECIDED")
            blocking = self.store.txn_lock_conflict(op.keys, spec.txn_id)
            if blocking is not None:
                self.stats["txn_vote_no"] += 1
                return ERROR, ExecResult(blocking, synced=False, ok=False,
                                         error="TXN_LOCKED")
            commutes = self._commutes(op)
            result = self.store.execute(op, now)
            self._log_txn(op, result)
            self.stats["txn_prepares"] += 1
            if not commutes:
                self.stats["conflict_syncs"] += 1
                self.want_sync = True
                self._jexec(op, SYNCED, checked=True, txn=spec.txn_id)
                return SYNCED, ExecResult(result, synced=True)
            self.stats["fast"] += 1
            self._jexec(op, FAST, checked=True, txn=spec.txn_id)
            if self.unsynced_count >= self.sync_batch:
                self.want_sync = True
            return FAST, ExecResult(result, synced=False)

        result = self.store.execute(op, now)
        self._log_txn(op, result)
        if op.op_type is OpType.TXN_COMMIT:
            self.stats["txn_commits"] += 1
        else:
            self.stats["txn_aborts"] += 1
        # Keep decision windows short: the intent's witness records stay
        # live until the prepare syncs, so nudge the batched sync along.
        self.want_sync = True
        self._jexec(op, FAST, checked=False, txn=op.args[0].txn_id)
        return FAST, ExecResult(result, synced=False)

    # ----------------------------------------------------------------- reads
    def handle_read(self, op: Op, now: float = 0.0) -> Tuple[str, ExecResult]:
        """Reads of unsynced values must sync first (§3.2.3 / §A.1)."""
        if not self.owns(op):
            return ERROR, ExecResult(None, synced=False, ok=False,
                                     error="NOT_OWNER")
        blocking = self.store.txn_lock_conflict(op.keys)
        if blocking is not None:
            # An undecided intent covers this key: the read cannot be
            # ordered until the transaction resolves (same rule as updates).
            return ERROR, ExecResult(blocking, synced=False, ok=False,
                                     error="TXN_PENDING")
        value = self.store.execute(op, now)
        if self._commutes(op):
            self.stats["reads_fast"] += 1
            return FAST, ExecResult(value, synced=False)
        self.stats["reads_blocked"] += 1
        self.want_sync = True
        return SYNCED, ExecResult(value, synced=True)

    # ------------------------------------------------------------ sync plumbing
    def begin_sync(self) -> Optional[BackupSyncReq]:
        """Start one batched backup sync if needed (one outstanding at a time,
        like RAMCloud).  Returns the request the harness should fan out to all
        backups, or None."""
        if self.sync_in_progress is not None:
            return None
        if not self.want_sync and self.unsynced_count == 0:
            return None
        through = len(self.log)
        if through == self.synced_index:
            self.want_sync = False
            return None
        req = BackupSyncReq(
            master_id=self.master_id,
            epoch=self.epoch,
            from_index=self.synced_index,
            entries=tuple(
                (e.op, e.result) for e in self.log[self.synced_index:through]
            ),
        )
        self.sync_in_progress = PendingSync(through_index=through, req=req)
        self.want_sync = False
        self._h_sync_batch.record(len(req.entries))
        return req

    def complete_sync(self) -> Tuple[Tuple[int, RpcId], ...]:
        """All backups acked the in-flight sync.  Advances the synced frontier
        and returns the (keyhash, rpc_id) gc entries for the witnesses (§3.5)."""
        assert self.sync_in_progress is not None
        through = self.sync_in_progress.through_index
        gc_entries: List[Tuple[int, RpcId]] = []
        for entry in self.log[self.synced_index:through]:
            # gc entries enumerate the op's (hash, class) pairs — the same
            # identity the witnesses recorded — so e.g. an HMSET's derived
            # per-field FIELD slots are collected, not just the base key's.
            for kh, _cls in entry.op.hash_classes():
                gc_entries.append((kh, entry.op.rpc_id))
            self._window_remove(entry.op)
        self.rifl.mark_synced_through(
            entry.op.rpc_id for entry in self.log[self.synced_index:through]
        )
        count = through - self.synced_index
        self.synced_index = through
        self.sync_in_progress = None
        self.stats["batch_syncs"] += 1
        self._m_batch_syncs.inc()
        jr = self.journal
        if jr is not None:
            jr.emit("sync", actor=self.journal_actor, mid=self.master_id,
                    through=through, count=count)
        return tuple(gc_entries)

    def force_synced_through(self, through: int) -> None:
        """Advance the synced frontier without the single-outstanding-sync
        bookkeeping.  Used by the 'original primary-backup' simulation mode,
        which issues one replication RPC set per op (no batching, multiple
        outstanding) — the pre-CURP RAMCloud behaviour."""
        if through <= self.synced_index:
            return
        assert self.sync_in_progress is None
        for entry in self.log[self.synced_index:through]:
            self._window_remove(entry.op)
        self.rifl.mark_synced_through(
            e.op.rpc_id for e in self.log[self.synced_index:through]
        )
        count = through - self.synced_index
        self.synced_index = through
        self.want_sync = False
        jr = self.journal
        if jr is not None:
            jr.emit("sync", actor=self.journal_actor, mid=self.master_id,
                    through=through, count=count)

    def abort_sync(self) -> None:
        """A backup rejected (e.g. zombie epoch fence): drop the attempt."""
        self.sync_in_progress = None
        self.want_sync = True

    # -------------------------------------------------------------- recovery
    def restore_from_log(self, entries: Sequence[LogEntry]) -> None:
        """New master: rebuild state machine + RIFL from a backup's log."""
        for e in entries:
            self.store.execute(e.op, 0.0)
            if e.op.op_type is OpType.MIGRATE_IN:
                # Moved-in completion records are log-resident (they rode the
                # transfer op): re-surface them so cross-move retries still
                # dedup after this failover.
                self._install_migrated(e.op)
            self.rifl.record_completion(e.op.rpc_id, e.result, synced=True)
        self.log = list(entries)
        self.synced_index = len(self.log)
        self._unsynced_keyhash.clear()

    def replay_from_witness(self, requests: Sequence[Op]) -> int:
        """Replay witness data; RIFL filters ops that already made it to
        backups (§3.3).  Client acks are ignored while replaying (§4.8).

        With the merge lattice, a witness may hold SEVERAL live records of
        one key (concurrent INCRs/SADDs/...), so the replay is a merge-FOLD,
        not a last-writer-wins pick: every surviving request re-executes
        through the state machine, whose merge-op semantics (repro.core.store)
        are order-insensitive within a class.  Requests are additionally
        sorted by rpc_id so two recoveries (or recovery vs a differently-
        ordered witness extraction) produce bit-identical logs — order only
        matters for the log/backup byte stream, never for the merged state.
        Returns number of ops actually re-executed."""
        self.rifl.replay_mode = True
        executed = 0
        for op in sorted(requests, key=lambda o: o.rpc_id):
            if not self.owns(op):
                continue  # §3.6: migrated partition remnants are ignored
            if self.rifl.check_duplicate(op.rpc_id) is not None:
                continue
            result = self.store.execute(op, 0.0)
            self.rifl.record_completion(op.rpc_id, result, synced=False)
            self.log.append(LogEntry(op, result))
            self._window_add(op)
            executed += 1
        self.rifl.replay_mode = False
        self.want_sync = executed > 0 or self.unsynced_count > 0
        return executed
