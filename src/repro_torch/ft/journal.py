"""CURP-FT witness journal: durable, unordered records of train-step ops.

The CURP mapping (DESIGN.md §3): a train step is deterministic given
(step_id, data seed, rng) — ~100 bytes.  The driver records that op to f
witnesses in parallel with executing the step (the 1-RTT fast path); full
state syncs to backup replicas only every `sync_every` steps (the paper's
§4.4 batching).  Recovery = restore newest backup + replay journaled steps;
RIFL filtering degenerates to "step_id <= restored step" because the
checkpoint IS the completion record for every folded-in step.

Commutativity: step ops carry distinct keys (step:<n>), so witnesses accept
them unordered; replay order is recovered from the op metadata (exactly like
RIFL rpc_ids order duplicate detection in the paper).

Witness storage is a host-side append-only file per witness — the analogue
of the paper's flash-backed DRAM (DESIGN.md §9.2).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..core.types import Op, OpType, RecordStatus
from ..core.witness import Witness


@dataclass(frozen=True)
class StepOp:
    step: int
    data_seed: int
    rng_seed: int
    driver_id: int = 0

    def to_op(self) -> Op:
        return Op(
            OpType.SET,
            keys=(f"step:{self.step}",),
            args=(json.dumps({
                "step": self.step, "data_seed": self.data_seed,
                "rng_seed": self.rng_seed,
            }),),
            rpc_id=(self.driver_id, self.step),
        )

    @staticmethod
    def from_op(op: Op) -> "StepOp":
        d = json.loads(op.args[0])
        return StepOp(d["step"], d["data_seed"], d["rng_seed"],
                      op.rpc_id[0])


class FileWitness:
    """core.Witness semantics + append-only file durability."""

    def __init__(self, path: Path, master_id: int,
                 n_sets: int = 1024, n_ways: int = 4) -> None:
        self.path = Path(path)
        self.core = Witness(n_sets, n_ways)
        self.core.start(master_id)
        self.master_id = master_id
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists():
            self._replay_file()
        else:
            self.path.touch()

    def _replay_file(self) -> None:
        """Rebuild in-memory table from the durable log (process restart)."""
        live: Dict[int, StepOp] = {}
        for line in self.path.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            if rec["t"] == "record":
                live[rec["step"]] = StepOp(
                    rec["step"], rec["data_seed"], rec["rng_seed"],
                    rec.get("driver", 0),
                )
            elif rec["t"] == "gc":
                for s in rec["steps"]:
                    live.pop(s, None)
        for sop in live.values():
            op = sop.to_op()
            self.core.record(self.master_id, op.key_hashes(), op.rpc_id, op)

    # -- witness API -----------------------------------------------------------
    def record(self, sop: StepOp) -> RecordStatus:
        op = sop.to_op()
        st = self.core.record(self.master_id, op.key_hashes(), op.rpc_id, op)
        if st is RecordStatus.ACCEPTED:
            with self.path.open("a") as f:
                f.write(json.dumps({
                    "t": "record", "step": sop.step,
                    "data_seed": sop.data_seed, "rng_seed": sop.rng_seed,
                    "driver": sop.driver_id,
                }) + "\n")
                f.flush()
                os.fsync(f.fileno())
        return st

    def gc(self, steps: List[int]) -> None:
        entries = []
        for s in steps:
            op = StepOp(s, 0, 0).to_op()
            entries.append((op.key_hashes()[0], (op.rpc_id[0], s)))
        # gc by key hash; rpc client id must match the recorded one — use
        # driver 0 default; core gc matches on (keyhash, rpc_id) so rebuild
        # rpc ids from the live table instead:
        live = {
            op.rpc_id[1]: op for op in self._live_ops()
        }
        entries = [
            (live[s].key_hashes()[0], live[s].rpc_id)
            for s in steps if s in live
        ]
        self.core.gc(tuple(entries))
        with self.path.open("a") as f:
            f.write(json.dumps({"t": "gc", "steps": steps}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _live_ops(self) -> List[Op]:
        out = []
        for ways in self.core._slots:
            for slot in ways:
                if slot.occupied and slot.request is not None:
                    out.append(slot.request)
        return out

    def get_recovery_data(self) -> List[StepOp]:
        ops = self.core.get_recovery_data(self.master_id)
        return sorted(
            (StepOp.from_op(op) for op in ops), key=lambda s: s.step
        )
