"""Simulator calibration constants.

This container has no InfiniBand cluster, so the paper's µs-scale evaluation
runs on a discrete-event simulator.  Constants below are calibrated so the
*unreplicated* RAMCloud write latency and throughput match the paper
(Table 1 hardware, §5.1), and every protocol-induced difference (1 vs 2 RTTs,
batched syncs, witness costs) then *emerges from the protocol*, not from
tuning.  Napkin math for the calibration:

  unreplicated median write  = client_send + ow + master_update + ow + client_recv
                             = 0.8 + 2.0 + 1.3 + 2.0 + 0.8            = 6.9 µs  (paper: 6.9)
  sync (original, 3-way)     = above + repl phase
    repl phase               = 3·repl_send + ow + backup_service + ow
                             = 1.2 + 2.0 + 1.6 + 2.0                  = 6.8 µs
                             -> 13.7 µs                                (paper: 13.8)
  CURP f=3                   = unreplicated + 3·client_record_send_cost
                             = 6.9 + 3·0.13                           = 7.3 µs  (paper: 7.3)
    witness reply arrives at ~0.13k + 2.0 + 0.75 + 2.0 + 0.8 ≈ 5.7 µs < master
    reply (7.3), i.e. witnesses are never the critical path (paper §5.1).

  master-throughput model (single dispatch-thread server, §4.4):
    unreplicated cost/op = master_update                        = 1.3  -> 769 k/s
    CURP (batch 50)      = 1.3 + (3·repl_send + 3·repl_ack
                                  + 3·gc_send + 3·gc_resp)/50   = 1.40 -> ~715 k/s (paper: 728 k)
    async  (no witness)  = 1.3 + (3·repl_send + 3·repl_ack)/50  = 1.34 -> ~745 k/s (CURP ≈ 4–8 % below)
    original sync        = 1.3 + 3·repl_send + 3·repl_ack
                           + poll_waste                          = 5.6  -> ~179 k/s (CURP ≈ 4×)

All absolute numbers are *simulated*; the reproduction targets are the paper's
ratios and RTT counts (see DESIGN.md §5).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class SimParams:
    # --- network -------------------------------------------------------------
    one_way_delay_us: float = 2.0        # fixed propagation+switch, per hop
    delay_jitter_sigma: float = 0.03     # lognormal sigma on the one-way delay
    tail_prob: float = 0.003             # rare long-tail events (GC, IRQ, ...)
    tail_extra_us: float = 12.0          # size of a tail excursion
    drop_prob: float = 0.0               # packet loss (tests crank this up)

    # --- client --------------------------------------------------------------
    client_send_cost_us: float = 0.8     # serialize+post the primary RPC
    client_record_send_cost_us: float = 0.13  # each extra witness record RPC
    client_recv_cost_us: float = 0.8
    rpc_timeout_us: float = 1000.0
    config_fetch_us: float = 8.0         # coordinator round trip on retry

    # --- master (single dispatch-thread server) -------------------------------
    master_update_cost_us: float = 1.3   # execute + respond, one update RPC
    # Per-command execution-cost deltas on top of master_update_cost_us,
    # keyed by OpType name (Fig. 10: command types are NOT equally priced —
    # INCR carries no value payload, HMSET pays the hash-field lookup).
    # SET is the calibration anchor (delta 0), so every SET-workload figure
    # keeps the §5.1 napkin math above bit-for-bit.
    op_cost_extra_us: Dict[str, float] = field(default_factory=lambda: {
        "INCR": -0.3,
        "HMSET": 1.0,
    })
    master_read_cost_us: float = 1.0
    repl_send_cost_us: float = 0.4       # issue one backup sync RPC
    repl_ack_cost_us: float = 0.3        # process one backup ack
    gc_send_cost_us: float = 0.45        # issue one witness gc RPC
    gc_resp_cost_us: float = 0.45        # process one witness gc response
    sync_poll_waste_us: float = 2.2      # §4.4: wasted polling in sync mode
    sync_rpc_cost_us: float = 0.6        # handle a client sync RPC

    # --- backup / witness ------------------------------------------------------
    backup_service_us: float = 1.6       # per sync RPC (log append + ack)
    witness_service_us: float = 0.75     # per record RPC (1.27 M/s ≈ 0.79 µs)
    witness_gc_service_us: float = 0.5

    # --- Redis-flavoured backup cost (§5.4): fsync-on-log instead of repl RPC --
    fsync_us: float = 75.0               # NVMe fsync 50–100 µs (paper §5.4)
    redis_op_cost_us: float = 2.5        # syscall-heavy TCP path per RPC

    # --- open-loop client retry (capped exponential backoff + jitter) ---------
    ol_backoff_base_us: float = 200.0    # first retry delay
    ol_backoff_cap_us: float = 8000.0    # exponential backoff ceiling
    ol_backoff_jitter: float = 0.3       # +/- fractional jitter on each delay
    ol_max_attempts: int = 10            # give up (op becomes a "maybe")
    ol_shed_backoff_us: float = 400.0    # extra pause after an explicit shed

    # --- traffic armor (core.overload; see ArmorConfig) ------------------------
    admit_queue_depth: int = 64          # master admission bound
    admit_queue_depth_witness: int = 128
    throttle_rate_ops_per_us: float = 0.0   # per-client token rate (0 = off)
    throttle_burst: float = 8.0
    degrade_hi_frac: float = 0.75        # enter DEFER_SLOW at this fill
    degrade_lo_frac: float = 0.40        # leave it below this fill
    breaker_failures: int = 5            # consecutive failures to trip OPEN
    breaker_reset_us: float = 3000.0     # OPEN -> HALF_OPEN cooldown
    breaker_probes: int = 1              # concurrent HALF_OPEN trials

    # --- heartbeat failure detection (ConfigManager-side, §3.6-fenced) ---------
    heartbeat_interval_us: float = 100.0
    heartbeat_miss_threshold: int = 5    # intervals silent before suspect
    heartbeat_service_us: float = 0.05   # coordinator cost per beat

    # --- failure handling -------------------------------------------------------
    crash_detect_us: float = 500.0
    restore_per_entry_us: float = 0.1    # backup log replay during recovery
    recovery_fixed_us: float = 50.0

    # --- protocol ----------------------------------------------------------------
    sync_batch: int = 50                 # §4.4 (max ops between syncs)
    witness_sets: int = 1024
    witness_ways: int = 4                # §B.1: 4096 slots, 4-way
    # Per-class way budget: max ways of one set a single mergeable
    # (key_hash, class) stack may occupy, so a hot INCR storm cannot
    # monopolize a set and starve conflicting classes (None = no cap,
    # the paper's behavior).
    witness_class_budget: Optional[int] = None
    hot_key_window_us: float = 0.0       # §4.4 heuristic (off by default)


DEFAULT = SimParams()
