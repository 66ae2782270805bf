"""Elastic scaling + straggler mitigation policies (1000+-node posture).

These are the control-plane decisions; the data plane is the dry-run's
sharding (launch/sharding.py) and CURP-FT's journal/backup machinery:

* Pod loss: re-carve the mesh without the lost pod, re-balance the global
  batch over surviving pods, restore from backups + journal replay (the
  journal is pod-independent — StepOps are pure metadata).
* Straggling backup: syncs are ASYNC in CURP, so a slow backup never blocks
  the fast path; if it misses `demote_after` consecutive deadlines it is
  demoted (dropped from the sync set) and a replacement is installed via the
  §3.6 reconfiguration (sync-then-bump-WitnessListVersion ordering).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MeshPlan:
    n_pods: int
    pod_shape: Tuple[int, int]       # (data, model) per pod
    global_batch: int
    per_pod_batch: int
    grad_accum: int                  # keeps tokens/step constant across scale


def plan_elastic_remesh(
    n_live_pods: int, *, pod_data: int = 16, pod_model: int = 16,
    global_batch: int = 256, target_tokens_constant: bool = True,
    baseline_pods: int = 2,
) -> MeshPlan:
    """Re-carve after pod loss/gain.

    Keeps the GLOBAL batch (and thus the optimizer trajectory / journal
    semantics) constant by folding the lost pods' share into gradient
    accumulation: tokens-per-step is invariant, so journal replay remains
    bit-exact across mesh sizes."""
    assert n_live_pods >= 1
    per_pod = global_batch // n_live_pods
    accum = 1
    if target_tokens_constant and n_live_pods < baseline_pods:
        # fold missing pods into accumulation steps
        accum = -(-baseline_pods // n_live_pods)
        per_pod = global_batch // (n_live_pods * accum)
    return MeshPlan(
        n_pods=n_live_pods,
        pod_shape=(pod_data, pod_model),
        global_batch=global_batch,
        per_pod_batch=per_pod,
        grad_accum=accum,
    )


@dataclass
class StragglerPolicy:
    """Deadline-based backup demotion (mirrors §3.6 backup reconfiguration)."""
    deadline_factor: float = 3.0      # x median sync latency
    demote_after: int = 3             # consecutive misses
    _misses: Dict[int, int] = field(default_factory=dict)
    _latencies: List[float] = field(default_factory=list)

    def observe(self, backup_id: int, latency: float) -> Optional[str]:
        """Feed one sync latency; returns 'demote' when policy fires."""
        self._latencies.append(latency)
        med = sorted(self._latencies)[len(self._latencies) // 2]
        if latency > self.deadline_factor * med and len(self._latencies) >= 5:
            self._misses[backup_id] = self._misses.get(backup_id, 0) + 1
            if self._misses[backup_id] >= self.demote_after:
                self._misses[backup_id] = 0
                return "demote"
        else:
            self._misses[backup_id] = 0
        return None
