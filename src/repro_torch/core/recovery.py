"""Master crash recovery (§3.3, §4.6).

Two steps: (1) restore from one backup (standard primary-backup restore —
CURP doesn't change it), then (2) replay from ONE witness: freeze it via
getRecoveryData, replay all held requests in any order (they are mutually
commutative by construction; RIFL filters those already on backups), sync the
result to backups, and hand out fresh witnesses under a bumped epoch +
WitnessListVersion.

Transaction intents (repro.core.txn) ride both steps for free: TXN_PREPARE
ops in the backup log and in witness data re-install their intents when
executed, so the recovered master re-surfaces every prepared-but-undecided
transaction; the enclosing cluster then resolves them (Sinfonia recovery
rule) so no intent outlives recovery undecided.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from .backup import Backup
from .config import ConfigManager
from .master import Master
from .telemetry import span
from .witness import Witness


@dataclass
class RecoveryReport:
    restored_log_entries: int
    witness_requests: int
    replayed: int            # ops actually re-executed (not RIFL-filtered)
    new_epoch: int
    new_witness_list_version: int
    shard_id: int = 0        # which shard failed over (per-shard epochs)
    # Mini-transaction recovery (repro.core.txn): intents the recovered
    # master re-surfaced from its backup log + witness replay, and how the
    # post-recovery cluster-wide resolution sweep decided them.
    txn_intents: int = 0     # undecided intents present right after replay
    txn_resolved: int = 0
    txn_committed: int = 0
    txn_aborted: int = 0


def recover_master(
    *,
    shard_id: int,
    old_master_id: int,
    new_master: Master,
    backups: Sequence[Backup],
    recovery_witness: Witness,
    new_witnesses: Sequence[Witness],
    new_witness_ids: Tuple[int, ...],
    config: ConfigManager,
) -> RecoveryReport:
    """In-process recovery orchestration (the simulator mirrors these steps as
    timed RPCs; the logic and ordering are identical)."""
    # 1. Restore from any backup (they are interchangeable for a fully-synced
    #    prefix; we pick the longest log available).
    with span("recovery.restore"):
        source = max(backups, key=len)
        log = source.get_log()
        new_master.restore_from_log(log)

    # 2. Freeze ONE witness (irreversible recovery mode) and replay.
    with span("recovery.replay"):
        reqs = recovery_witness.get_recovery_data(old_master_id)
        replayed = new_master.replay_from_witness(reqs)

    with span("recovery.sync"):
        # 3. Bump epoch BEFORE syncing so the new master's syncs pass the
        #    fence and any zombie old master is rejected from now on.
        cfg = config.fail_over(shard_id, new_master.master_id,
                               new_witness_ids)
        new_master.epoch = cfg.epoch
        new_master.witness_list_version = cfg.witness_list_version
        for b in backups:
            b.set_epoch(cfg.epoch)

        # 4. Sync replayed ops to backups, then open fresh witnesses.
        req = new_master.begin_sync()
        if req is not None:
            for b in backups:
                resp = b.handle_sync(req)
                assert resp.ok, "fresh-epoch sync must not be fenced"
            new_master.complete_sync()

    with span("recovery.witnesses"):
        for w in new_witnesses:
            w.start(new_master.master_id)

    return RecoveryReport(
        restored_log_entries=len(log),
        witness_requests=len(reqs),
        replayed=replayed,
        new_epoch=cfg.epoch,
        new_witness_list_version=cfg.witness_list_version,
        shard_id=shard_id,
        # Prepared-but-undecided intents survive into the new master (via
        # log restore and witness replay); the enclosing cluster resolves
        # them (repro.core.txn.resolve_pending) right after this returns.
        txn_intents=len(new_master.store.txn_intents()),
    )
