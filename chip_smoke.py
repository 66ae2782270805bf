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
   gang_fastpath (K3) also meets the corners of its block-per-shard design
   at B = 1000, as the op pads it and as given: every op in one shard,
   shards with no op, rings filled to count + appends = CAP and wrapping
   past CAP, INCR over INCR beside SET over SET on hot keys; and B = 3000
   all in one shard with rings of 4096 so filled, which the kernel takes in
   chunks (its list of 1024 ops and its staged table of 1024 ring entries).
   gang_gc (K4) also meets the corners of its row-owning design, as the op
   pads them and as given: identical entries (both report 1), one row whose
   4 ways hold one key under 4 rpcs, entries only in lanes that do not
   age, no aging, no entries with aging, and 4096 entries in one aged lane
   and over eight lanes.  gang_record (K2) also meets the corners of its
   row-owning design, as the op pads them and as given: 3072 queries in
   one row (more than the block's list of 2048 holds, so taken in chunks),
   DUP and CONFLICT of one key in both batch orders and beside a key held
   twice under commuting rpcs in either way order, a row driven FULL, 1
   and 64 ways, 2 lanes x 16 sets (fewer rows than blocks), padding only,
   no counters, and K3's record stage of 1024 ops x 3 lanes with a tenth
   padding.  gang_record_groups (K5) also meets the corners of its design,
   as the op pads them and as given: one group of one key, a valid group
   with no valid key, padding groups only, a group of more same-row keys
   than its row has free ways (FULL), keys repeated in a group as DUPs
   under two classes (the later class wins, seen in the coverage),
   dup-all retries, groups of 32 and 64 keys (more than one warp) and
   1024 groups over one lane (a long chain, staged in tiles).
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
   (K8) at B = 4096, U = 1024 and at B = 1000, U = 777, and at the
   corners of its table join (B = 4096, U = 1024 unless named): no
   window, repeated keys under classes that commute and that do not, the
   all-ones key (the table's empty marker), 3072 entries (three
   shared-memory tables), legacy 0/1 validity, classes outside the
   matrix, and B = 1000.  And the three
   transaction and baseline kernels, outputs and all three planes bit for
   bit: txn_probe (K9) as a chain of 2000 probes of 1..16 keys over a
   1024 x 4 table about 90% full (conflicts, FULL rejects that leave the
   table untouched, own-rpc retries, same-set inserters, duplicate keys,
   padding), kernel and plain chains in lockstep, and the chains of K9's
   corners (``parity.txn_corners``: 1024 keys in the distinct sets of
   1024 x 4 then retried with and without own, 64 keys in one set (FULL)
   then an exact fit across warps, every key own, a key repeated with and
   without own and across warps, padding only, 1 and 64 ways, the raw
   all-ones key, ops of 40 to 300 keys on 64 x 8); witness_gc (K10) at
   1024 x 4 and 4096 x 1 with G in {0, 50, 64, 1024} and at the corners
   of its join (``parity.table_gc_corners``: no entries, one, 4096 on
   1024 x 4, one key 300 times, the mixed all-ones key held and stale,
   zero entries against slots left zero, keys outside their set, 4096 x
   1, 64 x 64 and 512 x 3); witness_record_seq
   (K11) at 1024 x 4 with B in {64, 512, 4096}, on an empty table and on
   one K6 filled with mixed classes, and with B = 4096 at 4096 x 4
   (196,608 B, staged in shared memory near the limit), 64 x 64 (staged,
   ways in two chunks) and 4096 x 8 (393,216 B, the global-memory path),
   each on an empty table and on one K6 half filled.  K7 also meets the
   corners of its set-owning design at B = 1000, as padded and as
   given: no window (U = 0), 777 entries with repeated keys of other
   classes at 256 x 1 and 128 x 8, and 3072 entries (three
   shared-memory tables) at 16 x 2; and B = 4000 at 1 x 4 against 1024
   entries and at 4 x 2 against 3072, where each block takes its queries
   in chunks of its list of 1024.  K6 runs
   every case as padded and as given, and meets the corners of its
   set-owning design: 4096 queries in one set of 1024 x 4 (taken in
   chunks), 256 x 1, 128 x 8, 64 x 64 (ways at a stride of 32), 16 x 4
   (fewer sets than blocks) and a batch of padding only.
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
6. Transactions on the device backend, at phase 2's cluster (run after
   phase 5; launches counted from 0 over this phase alone), reproducing
   benchmarks/fig_txn.py's claims 1-3 on the card: the six crash runs of
   ``repro_torch.sim.run_txn_crash_scenario`` (every 2PC stage, with and
   without a participant crash, 64 transactions each) atomic and equal to
   the Python backend; fig_txn's single- and cross-shard streams (1000
   transactions each) with statuses and reads equal to the Python
   backend, paths equal in every shard until its first witness FULL
   reject, single-shard transactions on the 1-RTT path (fast share at
   least 0.95, mean rounds at most 1.05, on the Python backend and on the
   device backend's shards with no FULL reject yet) and cross-shard ones
   at 2 rounds or more; the grouped probe at 1 dispatch on accept and
   reject against 2 for record-then-rollback; DeviceWitness against the
   Python Witness on collision-heavy multi-key ops, and txn_probe on the
   card against its plain version over an evolving 64 x 4 table; the
   sequential record (K11) against the set-parallel one (K6) at 1024 x 4
   (equal accept bits, both timed); and record -> gc -> record at full
   size.
4. Times at phase 2's shapes: each kernel and its plain version (CUDA
   events, state restored between calls; gang_record as the record stage
   the fused batch launches, so gang_fastpath's time includes it), each
   kernel's device time (torch.profiler), the least time the card could
   take for the same work (the bytes and operations this run's data needs),
   the fused batches' wall time, the device's idle share during one more
   fused batch, and the host's self time by source file in another.  K1
   and K6-K8 are timed the same way at phase 5's shapes, K9-K11 at phase
   6's, and beside K11 the least chain of as many serial steps
   (``csrc/chain_probe.cu``, a probe and not a port: one thread, a
   dependent load and a store a step, in global and in shared memory).
   K11 is timed staged at 1024 x 4 (its row) and on its global path at
   4096 x 8, K5 at G = K = 1 (its row) and at G = 64, K = 4, K9 also at
   K = 16 on a 1024 x 4 table at TXN_FILL (one warp) and at K = 1024 in
   the distinct sets of 1024 x 4 (its block path), K10 also at one sync
   batch (G = 50) and at 4096 entries, each K10 shape beside the
   yardstick ``torch.isin`` on the packed 64-bit slot keys and a masked
   fill of occ (more than one launch, so not a library row), and gang_gc
   as the op calls it (its lane checks on the host arrays, no copy back).
   For the kernels redesigned as one launch, the kernels each call
   launches under the profiler (fastpath_record_scan, witness_record,
   gang_gc, conflict_scan, gang_record_groups at both shapes,
   witness_record_seq on both paths, txn_probe on its one-warp and its
   block path (the launch's name says which), witness_gc at its three
   shapes, and gang_record both as K3's record
   stage and as the op: their own kernel only; gang_fastpath: its own
   kernel and gang_record's, and no other) and gang_fastpath's own
   launch's device time apart from that stage.  Device times count each
   kernel per launch the trace caught.

7. Serving (run last; launches counted from 0 over this phase alone):
   ``repro_torch.serving.CurpServeDriver`` on the card at the published
   widths of llama3.2-1b (16 layers, d 2048, 32/8 heads, d_ff 8192, vocab
   128,256, 1.24 B parameters) and hymba-1.5b (32 layers, SWA with three
   global layers, an SSM beside attention in every layer), bf16 weights
   drawn from a seeded ``torch.Generator``, under ``ServeConfig(
   max_batch=8, max_seq=256, f=3, sync_batch=50, n_shards=4,
   witness_backend="device")``: 8 sessions with prompts of 16-48 tokens,
   then 32 generated tokens, every step's commits through the fused gang
   batch (K3 with K2) and its syncs' gc (K4).  For each model: a second
   driver crashes the store after 16 tokens, recovers all 8 sessions and
   generates the same tokens; every acknowledged session reads back equal
   to the driver's tokens; at most one slow commit a session.  For
   llama3.2-1b also the Python witness backend (tokens and fast/slow
   commits identical, a difference in counts only beside a FULL reject,
   which it names), each step as one mini-transaction
   (``atomic_step_commit``, through K5: tokens identical, single-shard
   steps on 1 RTT), and the served weights' f32 twin on the card (TF32
   off) and on the CPU over 8 teacher-forced steps of all 8 rows: logits
   within ``BF16_LOGIT_TOL`` (bf16) and ``F32_LOGIT_TOL`` (f32) of the
   CPU's, greedy tokens equal wherever the CPU's top-2 margin exceeds the
   tolerance.  The store calls of the main run and of the atomic run are
   replayed on the device backend on the CPU (the gang kernels' plain
   versions): commit counts, the six gang planes and the reason counters
   bit for bit.  On the card each driver decodes by replaying one CUDA
   graph a step, captured at its first decode: for each model the crashed
   driver then runs 8 more steps of every row through its graph (no
   commit) against ``decode_step`` run eagerly on a clone of its cache
   (logits' largest difference printed and within ``BF16_LOGIT_TOL``,
   greedy tokens equal wherever the eager top-2 margin exceeds it, one
   replay a step), with both steps' p50 (CUDA events) and, for one step of
   each under the profiler, the device busy ms and the host's CUDA runtime
   calls (launches and copies).  Reports the decode step's p50 and p99
   (CUDA events), tokens/s at batch 8, the host ms of each step's commit,
   the gang kernels' launches per step, the device's idle share over one
   profiled step (and by CUDA events, where the profiler's busy time for
   a replay is not about the eager step's), the host's self time by
   operator over another, and the phase's wall seconds.  The Mamba2 state
   update (``csrc/ssm_update.cu``) runs inside hymba-1.5b's replays, where
   the host counts no launch: its launches in the kernels' line are the
   drivers' ``ssm.fused_updates`` over this phase, the Mamba2 layers each
   replay updated; so are the decode attention's (``csrc/decode_attn.cu``,
   one launch an attention layer): the drivers' ``attn.fused_decodes``.

7b. The Mamba2 state update (after phase 7): ``ssm_state_update_cuda``
   and ``ssm_state_update_plain`` on the same card tensors at hymba-1.5b's
   layer as phase 7 serves it (8 x 50 x 64 x 16) and granite-4.0-h-small's
   as its cell serves it (16 x 128 x 64 x 128), in bf16, every third row
   inactive: the state bit for bit, y within its summation order (|y -
   y_plain| <= 2^-7 |y_plain| + 2^-14 sum_n |new C|, as the gpu test
   states it); both timed (CUDA events, state restored between calls), the
   kernel's device time, and its bound: one read and one write of the
   state at HBM_BYTES_PER_S.  Its kernels' row is hymba's layer.

7c. The decode attention (after 7b): ``decode_attention_cuda`` and
   ``sdpa_decode_plain`` on the same card tensors at each layer of
   ATTN_CASES in bf16: hymba-1.5b's global ring (8 x 16384 x 5 x 64, rep
   5) with rows at the cell's ~1,700 tokens and with every ring full, its
   window ring full (1024), and granite-4.0-h-small's (16 x 8192 x 8 x
   128, rep 4) at the cell's ~600 tokens and full; the slots a row does
   not hold are filled with large values the mask must keep out.  o within
   ``parity.decode_attention_bound`` (the summation order's bound, as the
   gpu test states it) and ``parity.DECODE_ATTENTION_AGREEMENT`` (the
   share of elements bit-equal and the rms gap, which a kernel one slot
   short or rounding p elsewhere fails); both timed (CUDA events), the kernel's device
   time, and its bound: the live K and V rows (and q and o) at
   HBM_BYTES_PER_S.  Its kernels' row is hymba's global ring at ~1,700.

8. Training (run last; launches counted from 0 over this phase alone,
   and it must launch none of the port's kernels: the model is plain
   torch): ``repro_torch.ft.FaultTolerantTrainer`` on the card at the
   published width and depth of smollm-360m (32 layers, d 960, 15/5
   heads, d_ff 2560, vocab 49,152, untied head, 409,007,040 parameters),
   bf16 weights drawn from a seed, remat on, f32 Adam moments, under
   ``DataConfig(seed=1234, batch=2, seq=4096)`` (train_4k's sequence, a
   micro-batch of its 256), ``FTConfig(f=3, sync_every=5)`` and
   ``AdamWConfig(warmup_steps=5, total_steps=1000)``, its witnesses and
   backups in a temporary directory that is removed as each trainer's
   digests are taken.  The reference's recovery schedule at full width:
   trainer A trains 13 steps; trainer B trains 8, crashes, restores the
   step-5 backup (restored 5, replayed 3) and trains to 13; B's weights
   and Adam moments equal A's bit for bit (each step runs under
   deterministic algorithms, cuBLAS with ``CUBLAS_WORKSPACE_CONFIG``, set
   here before torch is imported).  Every witness records every step of
   its epoch and, after each sync, holds none of the synced steps; a byte
   flipped in a backup's state makes its restore raise IOError.  The f32
   twin's one step on the card (TF32 off) against the CPU at 1 x 128:
   loss and grad norm within ``TRAIN_LOSS_RTOL``, the updated weights
   within 2 x lr + ``TRAIN_PARAM_OFF``, all but a ``TRAIN_PARAM_OFF_SHARE``
   of them within ``TRAIN_PARAM_OFF``.  Reports the step's p50 and p99
   (CUDA events), tokens/s, the model FLOPs a step as a share of the dense
   bf16 peak (remat's extra forward beside it), peak CUDA memory, each
   sync's wall time and bytes, the peak bytes on disk, the recovery's
   time and the device's idle share over one profiled step.

9. The sharded step (run last; launches counted from 0 over this phase
   alone, and it must launch none of the port's kernels), on a
   world-size-1 NCCL group and a 1 x 1 ("data", "model") mesh from
   ``repro_torch.launch.mesh.make_mesh_from``: (a) llama3.2-1b at its
   published width, bf16, every parameter, Adam moment and batch tensor a
   DTensor laid out by ``param_specs`` (``launch.sharding``), the "tp"
   rules of train_4k installed (``heads_are_tp``, so the flat-heads
   blockwise attention runs: its calls are counted), batch 2 x 4096: one
   train step held against the same step on plain tensors with no rules
   from the same weights (loss within ``SHARD_LOSS_RTOL``, global grad
   norm within ``SHARD_GNORM_RTOL``), then the step p50 of both (CUDA
   events), peak CUDA memory, and the dry run's bound for the same cell
   at 1 x 1 with the H100's constants (``launch.dryrun`` in a process of
   its own); (b) qwen2-moe-a2.7b at its published width (14.3 B
   parameters in bf16) under "moe_ep": forward and loss at 1 x 4096 under
   no_grad, every MoE through ``moe_mlp_shardmap`` on NCCL's all-to-all
   (calls counted), the first MoE layer's routed output bit-equal to the
   factored local body with identity collectives on the same local
   tensors, the loss finite, the forward's ms and peak memory; (c)
   ``torchrun --standalone --nproc_per_node 1 -m repro_torch.launch.train
   --distributed --smoke`` with a sync and a crash, its digest equal to the
   same run without ``--distributed``.

The last two lines are the kernels' JSON record and ``{"ok": true, ...}``;
the line before them names the card and its power limit.  Details also go
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
# Transactions (phase 6) and K9-K11: a probe chain over a table about 90%
# full, fig_txn's crash stages and streams at the slice's cluster, the gc
# sync batch and fig_fastpath's old-vs-new record.
TXN_PROBES, TXN_FILL = 2000, 2.0
GC_GEOMETRIES, GC_SIZES = ((1024, 4), (4096, 1)), (0, 50, 64, 1024)
SEQ_BATCHES = (64, 512, 4096)
# K11's tables beyond 1024 x 4, at B = TABLE_BATCH: staged in shared memory
# near the limit (196,608 B), staged with ways in two chunks, and on the
# global-memory path (393,216 B); and the shape its global path is timed at.
SEQ_TABLES = ((4096, 4), (64, 64), (4096, 8))
SEQ_GLOBAL = (4096, 8)
CRASH_TXNS, STREAM_TXNS, STREAM_ITEMS = 64, 1000, 100_000
# Serving (phase 7): CurpServeDriver at the published widths, its sessions
# on 4 shards of the device witness gang; prompts of 16-48 tokens, then 32
# generated; a second driver crashes after 16.  Logit tolerances against
# f32 on the CPU (8 teacher-forced steps x 8 rows, logits of scale 1-5):
# bf16 rounds at 2^-9 relative and about 100 roundings reach the residual
# over 16 layers, ~2% rms or ~0.02 on a logit, ~0.1 at the largest of 8.2 M,
# plus the logits' own bf16 ulp (0.03 at 4): 0.25.  f32 sums of 2048-8192
# terms in another order differ by ~1e-5: 1e-3, which TF32's 2^-11
# rounding would break.
SERVE_ARCHS = ("llama3.2-1b", "hymba-1.5b")
SERVE_BATCH, SERVE_MAX_SEQ, SERVE_SHARDS = 8, 256, 4
SERVE_PROMPT, SERVE_TOKENS, SERVE_CRASH_AT = (16, 48), 32, 16
SERVE_NUMERIC_STEPS = 8
# The driver's decode graph against the eager step, on the crashed driver
# after its run: steps of every live row, no commit.
SERVE_GRAPH_STEPS = 8
BF16_LOGIT_TOL, F32_LOGIT_TOL = 0.25, 1e-3
# The Mamba2 state update (phase 7b): each arch's layer at the rows it is
# served with, phase 7's hymba-1.5b first (its kernels' row), then
# granite-4.0-h-small at its cell's 16.
SSM_SHAPES = (("hymba-1.5b", SERVE_BATCH), ("granite-4.0-h-small", 16))
# The decode attention (phase 7c): (case, arch, rows, ring, tokens a row
# holds, None for every ring full), hymba-1.5b's global ring at its cell's
# length first (its kernels' row).
ATTN_CASES = (
    ("hymba global ~1700", "hymba-1.5b", SERVE_BATCH, 16384, 1700),
    ("hymba global full", "hymba-1.5b", SERVE_BATCH, 16384, None),
    ("hymba window full", "hymba-1.5b", SERVE_BATCH, 1024, None),
    ("granite ~600", "granite-4.0-h-small", 16, 8192, 600),
    ("granite full", "granite-4.0-h-small", 16, 8192, None),
)
# Training (phase 8): CURP-FT at smollm-360m's published width and depth
# (bf16 weights, remat, f32 moments), train_4k's sequence of 4096 in a
# micro-batch of 2, f = 3 witnesses and backups, a sync every 5 steps; the
# reference's recovery schedule (13 steps; a second trainer crashes after
# 8, restores the step-5 backup and replays 3).  The f32 twin's one step on
# the card (TF32 off) against the CPU, at batch 1 x 128: the loss and the
# grad norm come out of products of 960-49,152 terms through 32 layers and
# back, summed in other orders (f32 rounds at 2^-24, and phase 7's f32
# logits met the CPU's within 2e-6 relative over 16 layers): 1e-4
# relative.  A first AdamW step moves each weight by lr x g / (|g| + eps
# / scale), +-lr unless |g| is tiny, so a gradient within rounding of 0
# can take the other sign on the two devices and put a weight 2 x lr
# apart; every other weight agrees to its f32 rounding (~1e-8): at most
# 2 x lr + 1e-6 anywhere, and fewer than 1e-3 of the weights more than
# 1e-6 apart.
# (the module's parameters, as the reference's init; the config's analytic
# n_params() leaves out the final norm's 960)
TRAIN_ARCH, TRAIN_PARAMS = "smollm-360m", 409_007_040
TRAIN_BATCH, TRAIN_SEQ, TRAIN_DATA_SEED = 2, 4096, 1234
TRAIN_F, TRAIN_SYNC_EVERY = 3, 5
TRAIN_STEPS, TRAIN_CRASH_AT = 13, 8
TRAIN_NUMERIC_SEQ = 128
TRAIN_LOSS_RTOL, TRAIN_PARAM_OFF, TRAIN_PARAM_OFF_SHARE = 1e-4, 1e-6, 1e-3
BF16_PEAK_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
# The sharded step (phase 9), on a world-size-1 NCCL group and a 1 x 1
# ("data", "model") mesh.  (a) llama3.2-1b at its published width, bf16,
# parameters DTensors by param_specs, the "tp" rules of train_4k (so
# heads_are_tp and the flat-heads attention), batch cut to 2 x 4096: one
# train step held against the same step on plain tensors with no rules.
# The flat and grouped attentions run other einsum shapes (other cuBLAS
# kernels, f32 accumulation both), so bf16 activations may differ by an
# ulp (2^-8) here and there; over 16 layers the mean loss over 8192 tokens
# (about ln 128256 = 11.8) moves by well under 2e-3 relative, and the
# global grad norm, a sum of squares of every gradient, by under 2e-2.
# (b) qwen2-moe-a2.7b at its published width (14.3 B parameters, 28.6 GB
# in bf16), "moe_ep": forward and loss at 1 x 4096 under no_grad (a train
# step's f32 moments alone would take 114 GB).  (c) the train launcher
# under torchrun at one process with --distributed against the same run
# without it.
SHARD_ARCH, SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = "llama3.2-1b", 2, 4096, 4
SHARD_LOSS_RTOL, SHARD_GNORM_RTOL = 2e-3, 2e-2
SHARD_MOE_ARCH, SHARD_MOE_SEQ = "qwen2-moe-a2.7b", 4096
SHARD_LAUNCH_FLAGS = ("--smoke", "--steps", "8", "--sync-every", "3",
                      "--crash-at", "5")


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
    corners = parity.fastpath_corners(rng, 1000, NS, CAP, F, L, 256, 256)
    gc_corners = parity.gc_corners(rng, planes, N_SETS, 256)
    rec_corners = parity.gang_record_corners(rng, BATCH, F)
    grp_corners = parity.gang_groups_corners(rng)
    results = parity.check_kernels(planes, N_SETS, rec, grp, gc, fp, F,
                                   device=device, fp_corners=corners,
                                   gc_corners=gc_corners,
                                   rec_corners=rec_corners,
                                   grp_corners=grp_corners)
    sync()
    say(card, "parity gang_fastpath corners (B = 1000, as padded and as "
              "given): every op in shard 63; 32 shards with no op and the "
              "other rings filled to count + appends = CAP; every ring so "
              "filled, with hot INCR over INCR and SET over SET; B = 3000 "
              "all in shard 63, rings of 4096 so filled (the shard's list "
              "and live span taken in chunks)")
    say(card, "parity gang_gc corners (as padded and as given): "
              + ", ".join(f"{name} (G = {len(g['g_hi'])}, "
                          f"{int(g['aged_lanes'].sum()) if age else 0} aged "
                          f"lanes)"
                          for name, (_p, g, age) in zip(parity.GC_CORNERS,
                                                        gc_corners)))
    say(card, "parity gang_record corners (as padded and as given; rep_f "
              "as K3's stage): "
              + ", ".join(f"{name} ({c['planes'][2].shape[0] // c['n_sets']}"
                          f"x{c['n_sets']}x{c['planes'][2].shape[1]}, "
                          f"{np.asarray(c['rec']['lanes']).size} copies"
                          f"{'' if c['counters'] else ', no counters'})"
                          for name, c in zip(parity.GANG_RECORD_CORNERS,
                                             rec_corners)))
    say(card, "parity gang_record_groups corners (as padded and as given; "
              "4 x 64 x 4 gangs): "
              + ", ".join(f"{name} (G = {c['grp']['key_hi'].shape[0]}, "
                          f"K = {c['grp']['key_hi'].shape[1]})"
                          for name, c in zip(parity.GANG_GROUPS_CORNERS,
                                             grp_corners)))
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
    scan_corners = parity.scan_corners(rng, TABLE_BATCH, WINDOW)
    scans += scan_corners
    fastpaths += parity.table_fastpath_corners(
        np.random.default_rng(SEED + 10), 1000, N_SHARDS, 3 * WINDOW)
    record_corners = parity.table_record_corners(
        np.random.default_rng(SEED + 11), 1024)
    records += record_corners
    results = parity.check_table_kernels(keys, records, fastpaths, scans,
                                         device=device)
    sync()
    say(card, "parity witness_record corners (as padded and as given): "
              + ", ".join(f"{name} ({p[2].shape[0]}x{p[2].shape[1]}, "
                          f"B = {len(q['q_hi'])})"
                          for name, (p, q) in zip(parity.TABLE_RECORD_CORNERS,
                                                  record_corners)))
    say(card, f"parity fastpath_record_scan corners (B = 1000, as padded "
              f"and as given): no window at 1024x4, 777 entries with "
              f"repeated keys at 256x1 and 128x8, {3 * WINDOW} (three "
              f"shared-memory tables) at 16x2; B = 4000 (each block's "
              f"queries taken in chunks) at 1x4 against 1024 entries and "
              f"at 4x2 against {3 * WINDOW}")
    say(card, "parity conflict_scan corners: "
              + ", ".join(f"{name} (B = {len(sc['q_hi'])}, U = "
                          f"{len(sc['w_hi'])})"
                          for name, sc in zip(parity.SCAN_CORNERS,
                                              scan_corners)))
    for r in results:
        say(card, f"parity {r.name}: {r.outputs} integers, "
                  f"max_abs_err {r.max_abs_err}, outcomes by code "
                  f"{r.coverage.tolist()}")
        check(r.outputs > 0 and r.max_abs_err == 0,
              f"{r.name} disagrees with its plain version")
        check(not r.missed, f"{r.name}: the inputs never reach {r.missed}")
    return {r.name: r for r in results}


def phase_txn_parity(np, parity, card, device, sync):
    """K9-K11 against their plain versions at full size: a chain of
    TXN_PROBES probes of 1..16 keys over a 1024 x 4 table about 90% full
    (a key pool of twice the slots, own set on a tenth of the held keys)
    and the chains of ``parity.txn_corners``, gc batches of GC_SIZES at
    1024 x 4 and 4096 x 1 and the cases of ``parity.table_gc_corners``,
    and the sequential
    record at 1024 x 4 over SEQ_BATCHES on an empty table and on one that
    K6 filled with mixed classes, and at SEQ_TABLES with TABLE_BATCH
    queries on an empty table and on one that K6 half filled."""
    from repro_torch.kernels import (
        WitnessTable,
        witness_record,
        witness_table_to_numpy,
    )
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(SEED + 7)
    S, W = TABLE_SETS, TABLE_WAYS
    pool = parity.key_pool(rng, 2 * S * W, S)
    planes = parity.table_planes(rng, pool, S, W, fill=TXN_FILL)
    probes = parity.txn_chain(rng, pool, planes, TXN_PROBES)
    gcs = []
    for gs, gw in GC_GEOMETRIES:
        gp = parity.gc_planes(rng, parity.key_pool(rng, 2 * gs * gw, gs),
                              gs, gw)
        gcs += [(gp, parity.gc_entries(rng, gp, G)) for G in GC_SIZES]
    k6 = WitnessTable.empty(S, W, device=device)
    witness_record(k6, **parity.table_batch(rng, pool, 2 * S * W, W))
    filled = witness_table_to_numpy(k6)
    seqs = []
    for B in SEQ_BATCHES:
        for base in (_empty_planes(np, S, W), filled):
            q = parity.table_batch(rng, pool, B, W)
            seqs.append((base, dict(q_hi=q["q_hi"], q_lo=q["q_lo"])))
    paths = []
    for ts, tw in SEQ_TABLES:
        tpool = parity.key_pool(rng, 2 * ts * tw, ts)
        half = WitnessTable.empty(ts, tw, device=device)
        witness_record(half, **parity.table_batch(rng, tpool, ts * tw // 2,
                                                  tw))
        paths.append(f"{ts} x {tw} "
                     + ("staged" if kops.witness_record_seq_staged(half)
                        else "global")
                     + f", K6-filled {(half.occ > 0).float().mean():.3f}")
        for base in (_empty_planes(np, ts, tw), witness_table_to_numpy(half)):
            q = parity.table_batch(rng, tpool, TABLE_BATCH, tw)
            seqs.append((base, dict(q_hi=q["q_hi"], q_lo=q["q_lo"])))
    probe_corners = parity.txn_corners(rng)
    gc_corners = parity.table_gc_corners(rng)
    results = parity.check_txn_kernels(planes, probes, gcs, seqs,
                                       device=device,
                                       probe_corners=probe_corners,
                                       gc_corners=gc_corners)
    sync()
    say(card, f"parity: K9 chain from a table {(planes[2] > 0).mean():.3f} "
              f"full, K6-filled table {(filled[2] > 0).mean():.3f} full "
              f"for K11; K11 at B = {TABLE_BATCH} on " + "; ".join(paths))
    say(card, f"parity: K9 corners {', '.join(parity.TXN_CORNERS)} "
              f"({sum(len(c['probes']) for c in probe_corners)} probes); "
              f"K10 corners {', '.join(parity.TABLE_GC_CORNERS)}")
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
# Phase 6: transactions on the device backend (fig_txn's claims 1-3) and
# the table ops K9-K11 (fig_fastpath's old-vs-new record, the gc chain)
# ---------------------------------------------------------------------------
def _txn_stream(cluster, cross, sync):
    """STREAM_TXNS transactions of fig_txn's stream through one cluster.
    Returns per transaction (status, reads, fast_path, rtts, shards), the
    first transaction after which each shard's witnesses had a FULL
    reject, and the wall time of the workload and ``cluster.txn`` calls
    alone (the bookkeeping for the checks is left out of it)."""
    from repro_torch.sim import TxnWorkload

    wl = TxnWorkload(n_shards=N_SHARDS, cross_shard_frac=cross,
                     keys_per_txn=2, reads_per_txn=1, n_items=STREAM_ITEMS,
                     seed=9)
    session = cluster.new_client()
    out, first_full, wall = [], {}, 0.0
    for i in range(STREAM_TXNS):
        t0 = time.perf_counter()
        writes, reads = wl.next_txn()
        o = cluster.txn(session, writes, reads)
        wall += time.perf_counter() - t0
        shards = sorted({cluster.shard_of(k) for k, _ in writes}
                        | {cluster.shard_of(k) for k in reads})
        out.append((o.status.value, o.reads, o.fast_path, o.rtts, shards))
        for sid, n in enumerate(_full_by_shard(cluster)):
            if n:
                first_full.setdefault(sid, i)
    t0 = time.perf_counter()
    sync()
    return out, first_full, wall + time.perf_counter() - t0


def _txn_breakdown(torch, card, cluster, n=100):
    """Where a cross-shard transaction's time goes, on the cluster of the
    cross-shard stream: device busy against wall over ``n`` transactions
    under the profiler, then the host's self time by file over ``n`` more
    under cProfile (read the shares: cProfile inflates Python)."""
    import cProfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import TxnWorkload

    wl = TxnWorkload(n_shards=N_SHARDS, cross_shard_frac=1.0,
                     keys_per_txn=2, reads_per_txn=1, n_items=STREAM_ITEMS,
                     seed=10)
    session = cluster.new_client()

    def drive():
        for _ in range(n):
            cluster.txn(session, *wl.next_txn())
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = _device_us(prof)
    prof = cProfile.Profile()
    prof.enable()
    drive()
    prof.disable()
    total, shares = _self_time_by_file(prof)
    idle = None if busy_us is None else 1.0 - busy_us / wall_us
    say(card, f"txn breakdown: {n} cross-shard transactions under the "
              f"profiler: wall {wall_us / 1e3:.1f} ms, device "
              + ("busy not measured" if busy_us is None else
                 f"busy {busy_us / 1e3:.3f} ms, idle share {idle:.4f}"))
    say(card, f"txn breakdown: host self time of {n} more under cProfile, "
              f"{total * 1e3:.1f} ms, by file: "
              + ", ".join(f"{f} {sh:.3f}" for sh, f in shares[:8]))
    return dict(wall_us=wall_us, busy_us=busy_us, idle_share=idle,
                host_ms=total * 1e3, shares={f: sh for sh, f in shares[:20]})


def phase_txn(np, torch, card, device, sync):
    """fig_txn's claims 1-3 on the card at the slice's cluster, the
    single-table K9-K11 path, and their launches (counted from 0 at the
    phase's start and read before the old-vs-new timing loop).  Returns
    (launches, what it measured, the shapes for phase 4)."""
    from repro_torch.core import (
        DeviceWitness,
        ShardedCluster,
        TxnStatus,
        Witness,
        WitnessGeometry,
    )
    from repro_torch.core.types import Op, OpType
    from repro_torch.kernels import (
        WitnessTable,
        dispatch_count,
        ops as kops,
        reset_dispatch_count,
        txn_probe,
        witness_gc,
        witness_record,
        witness_record_seq,
        witness_table_to_numpy,
    )
    from repro_torch.sim import TXN_CRASH_STAGES, run_txn_crash_scenario

    rng = np.random.default_rng(SEED + 8)
    kops.reset_launch_counts()                  # counts start here ...
    info = {}

    # Claim 1: atomicity under coordinator crashes at every 2PC stage,
    # with and without a participant crash, against the Python backend.
    crash = []
    t0 = time.perf_counter()
    for stage in TXN_CRASH_STAGES:
        for participant in (False, True):
            kw = dict(stage=stage, n_shards=N_SHARDS, n_txns=CRASH_TXNS,
                      participant_crash=participant, seed=11 + len(crash))
            r = run_txn_crash_scenario(witness_backend="device",
                                       device=device, **kw)
            p = run_txn_crash_scenario(**kw)
            check(r.intents_after == 0, f"{stage}: {r.intents_after} intents "
                                        f"left after recovery")
            check(r.history_ok, f"{stage}: strict checker violation on "
                                f"{r.offending_key}")
            check(r.crashed_decision in ("COMMITTED", "ABORTED"),
                  f"{stage}: crashed transaction undecided")
            check((r.committed, r.aborted, r.crashed_decision, r.final_reads)
                  == (p.committed, p.aborted, p.crashed_decision,
                      p.final_reads),
                  f"{stage}: the device backend decided differently from "
                  f"the Python backend")
            crash.append(dict(stage=stage, participant_crash=participant,
                              committed=r.committed, aborted=r.aborted,
                              decision=r.crashed_decision))
    info["crash_s"] = time.perf_counter() - t0
    say(card, f"txn crashes: {len(crash)} runs at {N_SHARDS} shards x "
              f"{CRASH_TXNS} transactions on the device backend, each atomic "
              f"(no intent left, strict checker green, crashed transaction "
              f"decided: {[c['decision'] for c in crash]}) and equal to the "
              f"Python backend, in {info['crash_s']:.1f} s")
    info["crash"] = crash

    # Claim 2: single-shard transactions keep 1 RTT, cross-shard ones pay
    # one more round; both backends give the same statuses and reads, and
    # the device backend takes the same path on the card as on the CPU's
    # plain versions.
    streams = {}
    for label, cross in (("single", 0.0), ("cross", 1.0)):
        runs = {}
        for run_name, backend, on in (("device", "device", device),
                                      ("plain", "device", "cpu"),
                                      ("python", "python", "cpu")):
            cluster = ShardedCluster(n_shards=N_SHARDS, f=F,
                                     geometry=WitnessGeometry(N_SETS, N_WAYS),
                                     sync_batch=50, witness_backend=backend,
                                     seed=5, device=on)
            runs[run_name] = _txn_stream(cluster, cross, sync)
            if run_name == "device":
                dev_cluster = cluster
        (dev, dev_full, dev_s), (py, py_full, py_s) = (runs["device"],
                                                       runs["python"])
        plain = runs["plain"][0]
        check([t[:4] for t in dev] == [t[:4] for t in plain],
              f"{label}: a transaction's (status, reads, fast_path, rtts) "
              f"differs between the card and the plain versions on the CPU")
        check([(t[0], t[1]) for t in dev] == [(t[0], t[1]) for t in py],
              f"{label}: statuses or reads differ from the Python backend")
        check(all(t[0] == TxnStatus.COMMITTED.value for t in dev),
              f"{label}: a transaction did not commit")
        # The device witness fills 16 of its 1024 sets at 64 shards (the
        # set placement of phase 2), so witnesses reject records as FULL
        # and those transactions take the sync path.  A transaction's path
        # may differ from the Python backend's only in a shard with a FULL
        # reject by then, and fig_txn's 1-RTT bound is held on the others.
        def after_full(i):
            return any(min(dev_full.get(sid, STREAM_TXNS),
                           py_full.get(sid, STREAM_TXNS)) <= i
                       for sid in dev[i][4])

        diff = [i for i, (a, b) in enumerate(zip(dev, py))
                if (a[2], a[3]) != (b[2], b[3])]
        stray = [i for i in diff if not after_full(i)]
        check(not stray, f"{label}: {len(stray)} transactions (first "
                         f"{stray[:5]}) differ in path from the Python "
                         f"backend in shards with no FULL reject")
        clean = [t for i, t in enumerate(dev) if not after_full(i)]
        n, m = len(dev), len(clean)
        row = dict(fast_frac=sum(t[2] for t in dev) / n,
                   mean_rounds=sum(t[3] for t in dev) / n,
                   clean_txns=m, clean_fast_frac=sum(t[2] for t in clean) / m,
                   clean_mean_rounds=sum(t[3] for t in clean) / m,
                   python_fast_frac=sum(t[2] for t in py) / n,
                   python_mean_rounds=sum(t[3] for t in py) / n,
                   ktxn_per_s=n / dev_s / 1e3,
                   python_ktxn_per_s=n / py_s / 1e3, path_diff=len(diff),
                   full_shards=len(set(dev_full) | set(py_full)))
        streams[label] = row
        say(card, "txn stream {label}: {n} transactions; device backend: "
                  "fast share {fast_frac:.4f}, mean rounds {mean_rounds:.4f}, "
                  "{ktxn_per_s:.3f} ktxn/s; on the {clean_txns} in shards "
                  "with no witness FULL reject yet: fast share "
                  "{clean_fast_frac:.4f}, mean rounds "
                  "{clean_mean_rounds:.4f}; Python backend: fast share "
                  "{python_fast_frac:.4f}, mean rounds "
                  "{python_mean_rounds:.4f}, {python_ktxn_per_s:.3f} "
                  "ktxn/s; statuses and reads equal, path differs on "
                  "{path_diff} (all after a FULL reject, in {full_shards} "
                  "shards); status, reads, fast path and rounds of every "
                  "transaction equal on the card and on the plain versions "
                  "on the CPU".format(label=label, n=n, **row))
    single, cross = streams["single"], streams["cross"]
    for key in ("clean_", "python_"):
        check(single[key + "fast_frac"] >= 0.95
              and single[key + "mean_rounds"] <= 1.05,
              f"single-shard transactions left the 1-RTT path: {single}")
    check(min(cross["mean_rounds"], cross["python_mean_rounds"]) >= 2.0,
          f"cross-shard transactions paid under 2 rounds: {cross}")
    info["streams"] = streams
    info["breakdown"] = _txn_breakdown(torch, card, dev_cluster)

    # Claim 3: the grouped probe is one dispatch on accept and on reject,
    # record-then-rollback two on reject.
    def fresh():
        w = DeviceWitness(N_SETS, N_WAYS, device=device)
        w.start(master_id=1)
        w.record(1, (7,), (999, 1), Op(OpType.SET, ("c",), ("v",), (999, 1)))
        return w

    multi = Op(OpType.MSET, ("a", "b", "c"), (1, 2, 3), (1000, 1))
    counts = {}
    for label, call in (
            ("reject", lambda w: w._record_keys((5, 6, 7), multi.rpc_id,
                                                multi)),
            ("rollback", lambda w: w._record_keys_rollback(
                (5, 6, 7), multi.rpc_id, multi)),
            ("accept", lambda w: w._record_keys((5, 6, 8), (1001, 1),
                                                multi))):
        w = fresh()
        reset_dispatch_count()
        counts[label] = (call(w).value, dispatch_count())
    check(counts["accept"] == ("ACCEPTED", 1)
          and counts["reject"] == ("REJECTED", 1)
          and counts["rollback"] == ("REJECTED", 2),
          f"probe dispatches {counts}")
    say(card, f"txn probe: dispatches and verdicts {counts}")
    info["probe_dispatches"] = counts

    # Probe parity: collision-heavy multi-key ops, DeviceWitness against the
    # Python Witness; then txn_probe on the card against its plain version
    # over an evolving 64 x 4 table (fig_txn's check_probe_parity).
    r = np.random.default_rng(7)
    py, dv = Witness(N_SETS, N_WAYS), DeviceWitness(N_SETS, N_WAYS,
                                                    device=device)
    py.start(1)
    dv.start(1)
    for i in range(60):
        khs = tuple(int(k) for k in r.integers(0, 24, int(r.integers(1, 5))))
        rpc = (50 + i, 1)
        op = Op(OpType.MSET, tuple(f"k{k}" for k in khs),
                tuple(range(len(khs))), rpc)
        st_py, st_dv = py.record(1, khs, rpc, op), dv.record(1, khs, rpc, op)
        check(st_py == st_dv, f"op {i} {khs}: Witness {st_py}, "
                              f"DeviceWitness {st_dv}")
        if st_py.value == "ACCEPTED":
            check(dv.record(1, khs, rpc, op) == py.record(1, khs, rpc, op),
                  f"op {i}: the retry's verdicts differ")
    card_t = WitnessTable.empty(64, 4, device=device)
    plain_t = WitnessTable.empty(64, 4, device="cpu")
    probes = []
    for i in range(60):
        n_keys = int(r.integers(1, 6))
        hi = r.integers(0, 4, n_keys).astype(np.uint32)
        lo = r.integers(0, 4, n_keys).astype(np.uint32)
        a, b = txn_probe(card_t, hi, lo), txn_probe(plain_t, hi, lo)
        check(a.accepted == b.accepted and (a.hit == b.hit).all(),
              f"probe {i}: the card and the plain version disagree")
        for x, y in zip(witness_table_to_numpy(card_t),
                        witness_table_to_numpy(plain_t)):
            check((x == y).all(), f"probe {i}: tables differ")
        probes.append((hi, lo))
    say(card, "txn probe: 60 collision-heavy ops give the Python Witness's "
              "verdicts on DeviceWitness (retries included); 60 txn_probe "
              "calls on the card equal the plain version table for table")

    # fig_fastpath's old vs new record: K11 against K6 at 1024 x 4, one
    # call each per batch here; they are timed after the launches are read.
    old_new = []
    for B in SEQ_BATCHES:
        qh, ql = _random_lanes(np, rng, B)
        t = WitnessTable.empty(TABLE_SETS, TABLE_WAYS, device=device)
        acc_seq = witness_record_seq(t, qh, ql)[0]
        for p in t:
            p.zero_()
        acc_new = witness_record(t, qh, ql)[0]
        check((acc_seq == acc_new).all(),
              f"B={B}: K11 and K6 accept differently on an empty table")
        old_new.append((B, t, qh, ql))

    # The record -> gc -> record chain at full size.
    t = WitnessTable.empty(TABLE_SETS, TABLE_WAYS, device=device)
    qh, ql = _random_lanes(np, rng, TABLE_BATCH)
    acc, t = witness_record(t, qh, ql)
    ok = np.flatnonzero(acc == 1)
    half = ok[: ok.size // 2]
    gc_table = t.clone()
    witness_gc(t, qh[half], ql[half])
    check(int(t.occ.count_nonzero()) == ok.size - half.size,
          "gc left stale occupancy")
    acc2, t = witness_record(t, qh[half], ql[half])
    check((acc2 == 1).all() and int(t.occ.count_nonzero()) == ok.size,
          "re-recorded keys were not all accepted after gc")
    say(card, f"gc chain: {TABLE_BATCH} lanes into {TABLE_SETS}x"
              f"{TABLE_WAYS}, {ok.size} "
              f"accepted, gc of {half.size}, all re-recorded, no stale "
              f"occupancy")

    launches = {k.name: k.launches for k in   # ... and are read here
                kops.GANG_KERNELS[2:] + kops.TXN_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched in phase 6")
    say(card, f"phase 6: kernel launches {launches}")

    seq_rows = []
    for B, bt, bh, bl in old_new:
        def clear():
            for p in bt:
                p.zero_()

        row = dict(batch=B)
        for name, fn in (("seq", witness_record_seq), ("setpar",
                                                       witness_record)):
            us = _event_ms(torch, lambda: fn(bt, bh, bl), clear, 20) * 1e3
            row[f"{name}_us"], row[f"{name}_records_per_s"] = us, B / us * 1e6
        seq_rows.append(row)
        say(card, f"old vs new record, {TABLE_SETS}x{TABLE_WAYS}, batch {B}: "
                  f"witness_record_seq "
                  f"{row['seq_us']:.1f} us ({row['seq_records_per_s']:.0f} "
                  f"records/s), witness_record {row['setpar_us']:.1f} us "
                  f"({row['setpar_records_per_s']:.0f} records/s); accept "
                  f"bits equal")
    info["seq_rows"] = seq_rows
    shapes = dict(probe_table=card_t, probe=probes[-1], gc_table=gc_table,
                  gc_entries=(qh[half], ql[half]))
    return launches, info, shapes


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
    """Device time of one call, from a trace of ``iters`` calls back to
    back (state not restored, so later calls meet their own records).
    A trace taken late in this long run can miss some of its launches, so
    each kernel (or copy) counts its time per launch the trace caught,
    times its launches per call (caught / iters, rounded, at least 1: the
    calls are identical).  ``only`` keeps the kernels whose name holds
    it."""
    from repro_torch.kernels.parity import trace

    total = 0.0
    for e in trace(fn, iters, before).key_averages():
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us and e.count and (only is None or only in e.key):
            total += us / e.count * max(1, round(e.count / iters))
    return total / 1e3 or None


def _one_launch(card, parity, name, fn, *kernels):
    """Check that each call of ``fn`` launches each of ``kernels`` once and
    nothing else, by the kernels a profiler trace of 20 calls caught (a
    share in (0, 1] each: a trace may miss launches, never add one);
    returns the shares."""
    per_call = parity.launches_per_call(fn)
    shares = [[n for k, n in per_call.items() if kernel in k]
              for kernel in kernels]
    check(len(per_call) == len(kernels)
          and all(len(n) == 1 and 0 < n[0] <= 1 for n in shares),
          f"{name} is not one launch each of {kernels}: {per_call}")
    say(card, f"{name} launches per call: "
              + ", ".join(f"{n[0]:g} of {k}" for n, k in zip(shares, kernels))
              + " and no other (the trace caught "
              + ", ".join(f"{n[0] * 20:.0f}" for n in shares)
              + " launches in 20 calls)")
    return per_call


def _bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _join_ops(n, g, same_key_pairs=0):
    """Integer operations of a sort-merge join that looks each of ``n``
    keys up among ``g`` entries: (n + g) * ceil(log2 g) compares of a
    64-bit key at 2 operations each, and 3 for each (key, entry) pair of
    equal keys whose classes a scan checks.  A brute-force scan of every
    pair is the kernels' algorithm, not the work the function needs."""
    steps = max(1, (max(g, 2) - 1).bit_length())
    return 2 * (n + g) * steps + 3 * same_key_pairs


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
    call changed, and one matrix row per class present; operations count
    a join for each key lookup (``_join_ops``), not every pair."""
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
    ring_np = [fp.pop(k) for k in ("ring_hi", "ring_lo", "ring_cls")]
    rings0 = ref.ring_from_numpy(*ring_np, dev)
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

    def timed(kernel, plain, nbytes, nops, only=None):
        t = dict(ms=_event_ms(torch, kernel, restore, 50),
                 plain_ms=_event_ms(torch, plain, restore, 5),
                 bytes=nbytes, bound=_bound_ms(nbytes, nops))
        restore()
        t["device_ms"] = _device_ms(torch, kernel, only=only)
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

    def stage():
        return kops._record_launch(table, N_SETS, t_rows, F, t_qh, t_ql,
                                   r_hi, r_lo, k_cls, counters)

    def stage_plain():
        return ref.record_copies_plain(table, N_SETS, t_rows, F, t_qh, t_ql,
                                       r_hi, r_lo, k_cls, counters)

    nbytes = (BATCH * F * 4 * 2          # rows in, reasons out
              + BATCH * 5 * 4            # q_hi, q_lo, rpc_hi, rpc_lo, class
              + n_cls * 4 + _probe_bytes(np, rows_e, W) + once(stage))
    out["gang_record"] = timed(stage, stage_plain, nbytes,
                               BATCH * F * W * 10)
    restore()
    out["gang_record"]["launches_per_call"] = _one_launch(
        card, parity, "gang_record (K3's record stage)", stage,
        "gang_record_kernel")
    # The standalone op (DeviceWitness.record_batch): hash, rows and record
    # in the same one launch.
    rec = parity.record_batch(np.random.default_rng(SEED + 12), pool, BATCH,
                              L, N_SETS, 256)
    rargs = kops.record_operands(table0, N_SETS, **rec)
    restore()
    out["gang_record"]["op_launches_per_call"] = _one_launch(
        card, parity, "gang_record (the op)",
        lambda: kops.gang_record_cuda(table, N_SETS, *rargs, counters),
        "gang_record_kernel")

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
    # Operations: per shard, a join of its ops against its live span and
    # one of its ops against each other (same key), then the record.
    key = (qh.astype(np.uint64) << np.uint64(32)) | ql.astype(np.uint64)
    nops = BATCH * F * W * 10
    for sid in np.unique(shard):
        mine = key[shard == sid]
        c = (fp["tail_slot"][sid] + np.arange(fp["count"][sid])) % 1024
        span = ((ring_np[0][sid, c].astype(np.uint64) << np.uint64(32))
                | ring_np[1][sid, c].astype(np.uint64))
        sk, n_span = np.unique(span, return_counts=True)
        at = np.minimum(np.searchsorted(sk, mine), max(sk.size - 1, 0))
        ring_pairs = int(n_span[at][sk[at] == mine].sum()) if sk.size else 0
        _, n_op = np.unique(mine, return_counts=True)
        nops += (_join_ops(mine.size, span.size, ring_pairs)
                 + _join_ops(mine.size, mine.size,
                             int((n_op * (n_op - 1) // 2).sum())))
    out["gang_fastpath"] = t = timed(
        lambda: run_fp(kops.gang_fastpath_cuda),
        lambda: run_fp(ref.gang_fastpath_plain), nbytes, nops)
    # Its own launch (hash, route, ring scan, in-batch check, append) apart
    # from K2's record stage.
    restore()
    t["stage_device_ms"] = _device_ms(
        torch, lambda: run_fp(kops.gang_fastpath_cuda),
        only="gang_fastpath_kernel")
    # Launches per call: K3's own kernel and K2's, one each, and no other
    # (no sort, no gather, no fill).
    restore()
    t["launches_per_call"] = _one_launch(
        card, parity, "gang_fastpath", lambda: run_fp(kops.gang_fastpath_cuda),
        "gang_fastpath_kernel", "gang_record_kernel")

    # K4: one sync round's gc_many: entries at a shard's f aged lanes.
    gc = parity.gc_batch(rng, planes, N_SETS, 150, 256)
    aged = [w.lane for w in dev_cluster.shards[1].witnesses]
    gc["aged_lanes"] = np.zeros(L, np.int32)
    gc["aged_lanes"][aged] = 1
    # As gang_gc calls it: the lane checks read the host arrays the
    # operands came from, with no copy back.
    ghost = kops.gc_host_operands(table0, N_SETS, **gc)
    gargs = kops._to_device(dev, *ghost)

    def gc_run():
        return kops.gang_gc_cuda(table, N_SETS, *gargs, True,
                                 g_lane_host=ghost[4], aged_host=ghost[6])

    wrote = once(gc_run)
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
        gc_run, lambda: ref.gang_gc_plain(table, N_SETS, *gargs, True),
        nbytes, G * W * 10 + int(in_aged.sum()) * 3, only="gang_gc_kernel")
    restore()
    out["gang_gc"]["launches_per_call"] = _one_launch(
        card, parity, "gang_gc", gc_run, "gang_gc_kernel")

    # K5: DeviceWitness.record, one single-key op (G = K = 1, the op pads it
    # to 4 x 2; its row in the kernels' line), and phase 1's group batch
    # (G = 64 groups of up to K = 4 keys).  Bytes: each valid key's lanes
    # and class and each group's lane and rpc in, the probed rows, the
    # mixed lanes and reasons out, and what the call wrote.
    for name, (G5, K5) in (("gang_record_groups", (1, 1)),
                           ("gang_record_groups 64x4", (64, 4))):
        grp = parity.group_batch(rng, pool, G5, K5, L, 256)
        rargs = kops.groups_operands(table0, N_SETS, **grp)
        v = grp["key_valid"] == 1
        ql5 = ref.np_keyhash2x32(grp["key_hi"], grp["key_lo"])[1]
        rows = (np.repeat(grp["lanes"][:, None], K5, 1).astype(np.int64)
                * N_SETS + (ql5 & np.uint32(N_SETS - 1)))[v]

        def run(rargs=rargs):
            return kops.gang_groups_cuda(table, N_SETS, *rargs, counters)

        nbytes = (int(v.sum()) * (12 + 8) + G5 * (12 + 4)
                  + _probe_bytes(np, rows, W) + once(run))
        out[name] = timed(
            run, lambda rargs=rargs: ref.gang_groups_plain(
                table, N_SETS, *rargs, counters),
            nbytes, int(v.sum()) * W * 10)
        restore()
        out[name]["launches_per_call"] = _one_launch(
            card, parity, f"{name} (G = {G5}, K = {K5})", run,
            "gang_groups_kernel")
    for name, t in out.items():
        dms = ("not measured" if t["device_ms"] is None
               else f"{t['device_ms']:.4f} ms")
        if "stage_device_ms" in t:
            dms += ("; its own launch not measured"
                    if t["stage_device_ms"] is None else
                    f"; its own launch {t['stage_device_ms']:.4f} ms")
        say(card, f"time {name}: {t['ms']:.4f} ms per call (CUDA events), "
                  f"device time {dms} (profiler), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.6f} ms "
                  f"({t['bound'][1]}, {t['bytes']} B)")
    return out


def phase_table_times(np, torch, card, device, key_lanes):
    """K1 and K6-K8 at phase 5's shapes.  Bounds count what this run's data
    needs: each operand once without padding or valid flags, the three
    planes of each probed set once, each table word the call changed, and
    for a scan the operations of a sort-merge join of the queries against
    the valid window entries (``_join_ops``)."""
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

    def scan_ops(q_hi, q_lo, w_hi, w_lo, w_valid):
        """Operations a scan needs: a join of the queries against the
        valid window entries, with a class check per equal-key pair."""
        live = w_valid > 0
        same = ((q_hi[:, None] == w_hi[live][None])
                & (q_lo[:, None] == w_lo[live][None]))
        return _join_ops(q_hi.size, int(live.sum()), int(same.sum()))

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
    clear()
    out["witness_record"]["launches_per_call"] = _one_launch(
        card, parity, "witness_record",
        lambda: kops.witness_record_cuda(table, *args),
        "witness_record_kernel")

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
    nops = scan_ops(qh, ql, fp["window_hi"], fp["window_lo"],
                    fp["window_valid"])
    nbytes = (TABLE_BATCH * 12 + WINDOW * 12 + fp["slot_map"].size * 4
              + TABLE_BATCH * 20 + sets * TABLE_WAYS * 12
              + changed_bytes(
                  lambda: kops.fastpath_record_scan_cuda(table, *fargs),
                  table, restore))
    out["fastpath_record_scan"] = timed(
        lambda: kops.fastpath_record_scan_cuda(table, *fargs),
        lambda: ref.fastpath_record_scan_plain(table, *fargs), restore,
        nbytes, nops + TABLE_BATCH * (29 + TABLE_WAYS * 6))
    restore()
    out["fastpath_record_scan"]["launches_per_call"] = _one_launch(
        card, parity, "fastpath_record_scan",
        lambda: kops.fastpath_record_scan_cuda(table, *fargs),
        "fastpath_batch_kernel")

    # K8: 4096 queries against a 1024-entry window.
    sc = parity.scan_batch(rng, pool, TABLE_BATCH, WINDOW)
    sargs = kops.scan_operands(dev, **sc)
    nops = scan_ops(sc["q_hi"], sc["q_lo"], sc["w_hi"], sc["w_lo"],
                    sc["w_valid"])
    out["conflict_scan"] = timed(
        lambda: kops.conflict_scan_cuda(*sargs),
        lambda: ref.conflict_scan_plain(*sargs), lambda: None,
        TABLE_BATCH * 16 + WINDOW * 12, nops)
    out["conflict_scan"]["launches_per_call"] = _one_launch(
        card, parity, "conflict_scan",
        lambda: kops.conflict_scan_cuda(*sargs), "conflict_scan_kernel")
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


def _chain_ms(np, torch, rng, dev, B, n_sets, n_ways, shared=True):
    """K11's chain bound, measured: ``chain_probe.cu`` runs B dependent
    steps of the least work a step of K11 does (a load whose address the
    previous load gave, a store into the same row) by one thread, over a
    random cycle of the rows of an n_sets x n_ways plane, once in global
    memory and, with ``shared``, once staged in shared memory (the probe
    stages one plane of up to 48 KB).  Each run's words and the word it
    ended on are checked against the chain walked on the host."""
    from repro_torch.kernels import build, ops as kops

    if n_ways < 2:
        raise ValueError("the chain probe stores into word 1 of a row")
    fn = build.library("chain_probe").chain_probe_launch
    fn.argtypes = [build.I, build.I, build.I, build.P, build.P, build.P]
    fn.restype = build.I
    order = rng.permutation(n_sets)
    nxt = np.empty(n_sets, np.int64)
    nxt[order] = np.roll(order, -1)
    words0 = np.zeros(n_sets * n_ways, np.int32)
    words0[::n_ways] = nxt * n_ways
    want, cur = words0.copy(), 0
    for b in range(B):
        want[cur + 1] = b
        cur = int(want[cur])
    words = torch.from_numpy(words0).to(dev)
    end = torch.empty(1, dtype=torch.int32, device=dev)
    out = {}
    for where, in_shared in (("global", 0), ("shared", 1))[:1 + shared]:
        def run():
            rc = fn(B, words.numel(), in_shared, kops._ptr(words),
                    kops._ptr(end), kops._stream(dev))
            if rc != 0:
                raise RuntimeError(f"chain_probe failed with cudaError {rc}")
        out[f"chain_{where}_ms"] = _event_ms(torch, run, lambda: None, 50)
        if (int(end.item()) != cur
                or not np.array_equal(words.cpu().numpy(), want)):
            raise AssertionError(f"chain probe ({where}) ended on word "
                                 f"{int(end.item())} (want {cur}) or "
                                 f"left other words")
    return out


def phase_txn_times(np, torch, card, device, shapes):
    """K9-K11 at phase 6's shapes: one txn_probe of the probe-parity chain
    on its 64 x 4 table, the gc chain's witness_gc at 1024 x 4, and
    witness_record_seq of TABLE_BATCH lanes into an empty 1024 x 4 table.
    Beside them, K9 at K = 16 on a 1024 x 4 table at TXN_FILL and at K =
    1024 (its block path), K10 at one sync batch (G = 50) and at 4096
    entries, each with the torch.isin yardstick, and each kernel's launches
    per call on each path.  Bounds count what this run's data needs: each
    operand once without padding or valid flags, the three planes of each
    probed set once, each table word the call changed, and for the gc the
    operations of a sort-merge join of the held slots' keys against the
    entries."""
    from repro_torch.kernels import (
        WitnessTable,
        ops as kops,
        parity,
        ref,
        witness_table_to_numpy,
    )

    dev = torch.device(device)
    out = {}

    def timed(kernel, plain, restore, nbytes, nops, only=None):
        """With ``only`` (the kernel's name), the device time restores the
        state before each traced call and counts that kernel alone."""
        t = dict(ms=_event_ms(torch, kernel, restore, 50),
                 plain_ms=_event_ms(torch, plain, restore, 5),
                 bytes=nbytes, ops=nops, bound=_bound_ms(nbytes, nops))
        restore()
        t["device_ms"] = _device_ms(torch, kernel,
                                    before=restore if only else None,
                                    only=only)
        return t

    def restorer(table, table0):
        def restore():
            for p, p0 in zip(table, table0):
                p.copy_(p0)
        return restore

    def changed_bytes(fn, table, restore):
        restore()
        before = [p.clone() for p in table]
        fn()
        torch.cuda.synchronize()
        return 4 * sum(int((a != b).sum()) for a, b in zip(before, table))

    # K9: the last probe of phase 6's chain, on the 64 x 4 table it left
    # (one warp; its row in the kernels' line); 16 fresh keys on a 1024 x 4
    # table at TXN_FILL (one warp); and the first op of K9's first corner,
    # 1024 keys in the 1024 distinct sets of a 1024 x 4 table with a free
    # way in each (a block of 1024, accepts).
    rng = np.random.default_rng(SEED + 8)
    pool = parity.key_pool(rng, 2 * TABLE_SETS * TABLE_WAYS, TABLE_SETS)
    full = parity.table_planes(rng, pool, TABLE_SETS, TABLE_WAYS,
                               fill=TXN_FILL)
    fresh = parity.key_pool(rng, 16, TABLE_SETS)
    wide = parity.txn_corners(rng)[0]
    for name, table0, (hi, lo), path in (
            ("txn_probe", shapes["probe_table"], shapes["probe"], "one warp"),
            ("txn_probe K=16 1024x4", full, (fresh.hi, fresh.lo), "one warp"),
            ("txn_probe K=1024 1024x4", wide["planes"],
             (wide["probes"][0]["key_hi"], wide["probes"][0]["key_lo"]),
             "block")):
        if not isinstance(table0, WitnessTable):
            table0 = ref.witness_table_from_numpy(table0, dev)
        table0 = table0.clone()
        table = table0.clone()
        restore = restorer(table, table0)
        S, W = table0.occ.shape
        K = hi.size
        pargs = kops.txn_probe_operands(table0, hi, lo)
        sets = np.unique(ref.np_keyhash2x32(hi, lo)[1]
                         & np.uint32(S - 1)).size

        def run(table=table, pargs=pargs):
            return kops.txn_probe_cuda(table, *pargs)

        nbytes = (K * 12 + sets * W * 12 + 4 + K * 12
                  + changed_bytes(run, table, restore))
        restore()
        out[name] = t = timed(
            run, lambda table=table, pargs=pargs:
            ref.txn_probe_plain(table, *pargs), restore, nbytes,
            K * (29 + W * 6) + K * (K - 1) // 2 * 3,
            only=None if name == "txn_probe" else "txn_probe_kernel")
        restore()
        t["accepted"] = bool(run()[0].item())
        t["keys"], t["path"] = K, path
        restore()
        t["launches_per_call"] = _one_launch(
            card, parity, f"{name} ({path}, K = {K} padded to "
            f"{pargs[0].numel()}, {S} x {W})", run, "txn_probe_kernel")
        kernel = next(iter(t["launches_per_call"]))
        check(("<false>" in kernel) == (path == "block")
              or "<" not in kernel,
              f"{name} did not take the {path} path: {kernel}")

    # K10: the gc chain's batch on the table it cleared (its row in the
    # kernels' line), one sync batch of it (G = 50), and 4096 entries of
    # gc_entries' mix on the same table; beside each the yardstick,
    # torch.isin on the packed 64-bit slot keys against the entries and
    # the masked fill of occ (more than one call, so not a library row).
    table0 = shapes["gc_table"]
    g_hi, g_lo = shapes["gc_entries"]
    planes0 = witness_table_to_numpy(table0)
    more = parity.gc_entries(rng, planes0, 4096)
    occ = planes0[2].reshape(-1)
    keys = ((table0.keys_hi.to(torch.int64) << 32)
            | (table0.keys_lo.to(torch.int64) & 0xFFFFFFFF))
    for name, (eh, el) in (("witness_gc", (g_hi, g_lo)),
                           ("witness_gc G=50", (g_hi[:50], g_lo[:50])),
                           ("witness_gc G=4096", (more["g_hi"],
                                                  more["g_lo"]))):
        table = table0.clone()
        restore = restorer(table, table0)
        gargs = kops.table_gc_operands(table0, eh, el)

        def run(table=table, gargs=gargs):
            kops.witness_gc_cuda(table, *gargs)

        nbytes = (occ.size * 12 + eh.size * 8
                  + changed_bytes(run, table, restore))
        out[name] = t = timed(
            run, lambda table=table, gargs=gargs:
            ref.witness_gc_plain(table, *gargs), restore, nbytes,
            _join_ops(int((occ > 0).sum()), eh.size),
            only=None if name == "witness_gc" else "witness_gc_kernel")
        t["entries"] = int(eh.size)
        ents = ((gargs[0].to(torch.int64) << 32)
                | (gargs[1].to(torch.int64) & 0xFFFFFFFF))

        def yardstick(table=table, ents=ents):
            table.occ.masked_fill_(torch.isin(keys, ents) & (table.occ > 0),
                                   0)

        restore()
        run()
        want = table.occ.clone()
        restore()
        yardstick()
        check(torch.equal(table.occ, want),
              f"{name}: the isin yardstick and K10 clear different slots")
        t["yardstick_ms"] = _event_ms(torch, yardstick, restore, 50)
        restore()
        t["yardstick_device_ms"] = _device_ms(torch, yardstick)
        restore()
        t["yardstick_kernels"] = parity.launches_per_call(yardstick)
        restore()
        t["launches_per_call"] = _one_launch(
            card, parity, f"{name} (G = {eh.size}, {table.occ.shape[0]} x "
            f"{table.occ.shape[1]})", run, "witness_gc_kernel")

    # K11: fig_fastpath's sequential baseline at its largest batch, staged
    # in shared memory at the paper's 1024 x 4 (its row in the kernels'
    # line) and walking global memory at SEQ_GLOBAL; the chain probe beside
    # each (in shared memory only where a plane fits the probe's 48 KB).
    rng = np.random.default_rng(SEED + 9)
    for name, (ts, tw), staged in (
            ("witness_record_seq", (TABLE_SETS, TABLE_WAYS), True),
            (f"witness_record_seq {SEQ_GLOBAL[0]}x{SEQ_GLOBAL[1]}",
             SEQ_GLOBAL, False)):
        table = WitnessTable.empty(ts, tw, device=dev)
        check(kops.witness_record_seq_staged(table) == staged,
              f"K11 at {ts} x {tw} does not take the "
              f"{'staged' if staged else 'global'} path")

        def clear(table=table):
            for p in table:
                p.zero_()

        qh, ql = _random_lanes(np, rng, TABLE_BATCH)
        sargs = kops.seq_operands(table, qh, ql)
        sets = np.unique(ql & np.uint32(ts - 1)).size

        def run(table=table, sargs=sargs):
            return kops.witness_record_seq_cuda(table, *sargs)

        nbytes = (TABLE_BATCH * 12 + sets * tw * 12
                  + changed_bytes(run, table, clear))
        out[name] = t = timed(
            run, lambda table=table, sargs=sargs:
            ref.witness_record_seq_plain(table, *sargs), clear, nbytes,
            TABLE_BATCH * tw * 4)
        t["path"] = "staged" if staged else "global"
        t["chain"] = TABLE_BATCH
        t.update(_chain_ms(np, torch, rng, dev, TABLE_BATCH, ts, tw,
                           shared=ts * tw * 4 <= 48 * 1024))
        clear()
        t["launches_per_call"] = _one_launch(
            card, parity, f"witness_record_seq ({t['path']}, {ts} x {tw})",
            run, "witness_seq_kernel")
    for name, t in out.items():
        dms = ("not measured" if t["device_ms"] is None
               else f"{t['device_ms']:.4f} ms")
        chain = ("" if "chain" not in t else
                 f"; {t['path']} path, a chain of {t['chain']} dependent "
                 f"steps, "
                 + ("" if t["device_ms"] is None else
                    f"{t['device_ms'] / t['chain'] * 1e6:.1f} ns a step of "
                    f"device time; ")
                 + f"the least chain of as many steps (chain_probe.cu, "
                 f"CUDA events) {t['chain_global_ms']:.4f} ms in global "
                 f"memory, " + ("not measured" if "chain_shared_ms" not in t
                                else f"{t['chain_shared_ms']:.4f} ms")
                 + " in shared memory")
        yard = ("" if "yardstick_ms" not in t else
                f"; yardstick torch.isin + masked_fill_ "
                f"({len(t['yardstick_kernels'])} kernels a call) "
                f"{t['yardstick_ms']:.4f} ms (CUDA events), device "
                + ("not measured" if t["yardstick_device_ms"] is None
                   else f"{t['yardstick_device_ms']:.4f} ms"))
        verdict = ("" if "accepted" not in t else
                   f"; {t['path']} path, "
                   + ("accepts" if t["accepted"] else "rejects"))
        say(card, f"time {name}: {t['ms']:.4f} ms per call (CUDA events), "
                  f"device time {dms} (profiler), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound'][0]:.3e} ms "
                  f"({t['bound'][1]}, {t['bytes']} B, {t['ops']} ops)"
                  f"{chain}{yard}{verdict}; "
                  f"library none (no single PyTorch call computes it)")
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

    s = dev_cluster.new_client()
    ops = [s.op_set(f"user{k}", "host")
           for k in rng.choice(N_KEYS, size=BATCH, p=p / p.sum())]
    prof = cProfile.Profile()
    prof.enable()
    dev_cluster.update_batch(s, ops)
    torch.cuda.synchronize()
    prof.disable()
    total, shares = _self_time_by_file(prof)
    say(card, f"host: self time of one fused batch under cProfile, "
              f"{total * 1e3:.1f} ms, by file: "
              + ", ".join(f"{f} {sh:.3f}" for sh, f in shares[:8]))
    return dict(total_ms=total * 1e3,
                shares={f: sh for sh, f in shares})


def _self_time_by_file(prof):
    """A cProfile run's self time summed by source file (the port's files
    by path, C functions by name, packages by name).  Returns (total s,
    [(share, file)] largest first)."""
    import pstats

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
    return total, sorted(((t / total, f) for f, t in by_file.items()),
                         reverse=True)


# ---------------------------------------------------------------------------
# Phase 7: serving (CurpServeDriver on the model zoo, full width)
# ---------------------------------------------------------------------------
def serve_arch(name):
    """The configuration phase 7 serves, at its published width."""
    from repro_torch.configs import ARCHS

    return ARCHS[name]


def _serve_config(device, **kw):
    from repro_torch.serving import ServeConfig

    base = dict(max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ, f=F,
                sync_batch=50, n_shards=SERVE_SHARDS,
                witness_backend="device", device=device)
    base.update(kw)
    return ServeConfig(**base)


def _prompts(np, vocab):
    rng = np.random.default_rng(SEED + 7)
    lo, hi = SERVE_PROMPT
    return {f"sess{i}": rng.integers(
        0, vocab, int(rng.integers(lo, hi + 1))).tolist()
        for i in range(SERVE_BATCH)}


class _ServeClock:
    """While armed: CUDA events around each decode step of one driver, the
    host clock around each commit (``commit_batch`` or ``txn``), and each
    transaction's outcome.  Always: the store calls, as (call, [(session,
    tokens, done)]), so that they can be replayed."""

    def __init__(self, torch, driver):
        self.torch, self.armed = torch, False
        self.decode, self.commit_s, self.txns, self.log = [], [], [], []
        decode, store = driver._decode, driver.store

        def timed_decode(host):
            if not self.armed:
                return decode(host)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = decode(host)
            b.record()
            self.decode.append((a, b))
            return out

        def timed(fn, outcomes):
            def call(states):
                self.log.append((fn.__name__, [(x.session_id, list(x.tokens),
                                                x.done) for x in states]))
                if not self.armed:
                    return fn(states)
                t = time.perf_counter()
                out = fn(states)
                self.commit_s.append(time.perf_counter() - t)
                if outcomes:
                    self.txns.append(out)
                return out
            return call

        driver._decode = timed_decode
        store.commit_batch = timed(store.commit_batch, False)
        store.txn = timed(store.txn, True)

    def decode_ms(self):
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.decode]


def _serve_run(torch, cfg, model, prompts, crash_at=None, **kw):
    """One driver over the prompts: submit every session (its prompt fed
    through decode), then SERVE_TOKENS steps, crashing the whole store and
    recovering after ``crash_at`` steps if given.  Returns the driver, its
    clock (armed over the steps), the launches of each kernel over the
    steps, the steps' wall s and the recovery report."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import CurpServeDriver

    d = CurpServeDriver(cfg, _serve_config(model.device, **kw),
                        params=model)
    clock = _ServeClock(torch, d)
    for sid, prompt in prompts.items():
        d.submit(sid, prompt)
    torch.cuda.synchronize()
    before = kops.launch_counts()
    clock.armed = True
    t0 = time.perf_counter()
    rep = None
    if crash_at is None:
        d.generate(SERVE_TOKENS)
    else:
        d.generate(crash_at)
        rep = d.crash_and_recover()
        d.generate(SERVE_TOKENS - crash_at)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clock.armed = False
    after = kops.launch_counts()
    return d, clock, {k: after[k] - before[k] for k in after}, wall, rep


def _tokens(d):
    return {sid: list(s.tokens) for sid, s in d.sessions.items()}


def _check_store(card, name, d, paths=True):
    """Durability: every session the store acknowledged reads back equal
    to the driver's tokens; with ``paths``, at most one slow commit a
    session and every other one fast."""
    for sid, s in d.sessions.items():
        st = d.store.load(sid)
        check(st is not None and st.tokens == s.tokens,
              f"{name}: session {sid} reads back "
              f"{None if st is None else len(st.tokens)} tokens, the driver "
              f"holds {len(s.tokens)}")
    n = SERVE_BATCH * (1 + SERVE_TOKENS)
    fast, slow = d.store.fast_commits, d.store.slow_commits
    check(fast + slow == n and (slow <= SERVE_BATCH or not paths),
          f"{name}: {fast} fast and {slow} slow commits of {n} "
          f"(at most {SERVE_BATCH} slow)")


def _check_plain(card, name, d, log):
    """The store's calls of a run replayed on the device backend on the
    CPU, i.e. the gang kernels' plain versions: commit counts, per-shard
    commits, the six gang planes and the reason counters must equal the
    card's bit for bit (the kernels at the serving path's own shapes)."""
    from repro_torch.serving import CurpSessionStore, SessionState

    sc = d.serve
    cpu = CurpSessionStore(f=sc.f, sync_batch=sc.sync_batch,
                           n_shards=sc.n_shards, geometry=sc.witness_geometry,
                           witness_backend="device", n_slots=sc.n_slots,
                           device="cpu")
    for call, states in log:
        getattr(cpu, call)([SessionState(*x) for x in states])
    for attr in ("fast_commits", "slow_commits"):
        check(getattr(cpu, attr) == getattr(d.store, attr),
              f"{name}: {attr} on the card {getattr(d.store, attr)}, on the "
              f"plain versions {getattr(cpu, attr)}")
    check(cpu.per_shard_commits() == d.store.per_shard_commits(),
          f"{name}: per-shard commits differ from the plain versions'")
    card_gang, cpu_gang = d.store.cluster.gang, cpu.cluster.gang
    for plane, a, b in zip(card_gang.table._fields, card_gang.table,
                           cpu_gang.table):
        check(a.shape == b.shape and bool((a.cpu() == b).all()),
              f"{name}: gang plane {plane} differs from the plain versions'")
    check((card_gang.drain_counters() == cpu_gang.drain_counters()).all(),
          f"{name}: reason counters differ from the plain versions'")
    say(card, f"serving {name}: {len(log)} store calls replayed on the gang "
              f"kernels' plain versions: commits, the six gang planes "
              f"({tuple(card_gang.table.occ.shape)}) and the reason counters "
              f"identical")


def _pcts(np, xs):
    return (float(np.percentile(xs, 50)), float(np.percentile(xs, 99)))


def _serve_idle(np, torch, d, clock):
    """One more decode step (and its commit) under the profiler: device
    busy time against the step's wall time, and the decode's own time by
    CUDA events (the graph's replay with its copies)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n = len(clock.decode)
    clock.armed = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    clock.armed = False
    decode_ms = clock.decode_ms()[n]
    us = _device_us(prof)
    busy = None if us is None else us / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy, decode_event_ms=decode_ms,
                idle_share=None if busy is None else 1.0 - busy / wall_ms,
                idle_share_events=1.0 - decode_ms / wall_ms)


def _clone_cache(cache):
    return {"pos": cache["pos"].clone(), "segments": [
        {k: ({n: t.clone() for n, t in v.items()} if k == "ssm"
             else v.clone()) for k, v in e.items()}
        for e in cache["segments"]]}


def _profiled(torch, fn):
    """``fn`` under the profiler twice: the device busy ms (CUDA activity
    alone), then the host's CUDA runtime calls by name (kernel and graph
    launches, copies, fills; the CPU's activity beside)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = _device_us(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.key_averages():
        k = e.key
        if k.startswith("cu") and any(w in k for w in (
                "Launch", "Memcpy", "Memset")):
            calls[k] = calls.get(k, 0) + e.count
    return (None if us is None else us / 1e3), calls


def _launches(calls):
    return sum(n for k, n in calls.items() if "Launch" in k)


def _serve_graph_check(np, torch, card, name, d):
    """SERVE_GRAPH_STEPS decode steps of every live row through the
    driver's graph (``_decode``; no commit) against the same step run
    eagerly by ``decode_step`` on a clone of the cache taken just before
    it: logits and caches compared, greedy tokens equal wherever the eager
    top-2 margin exceeds BF16_LOGIT_TOL; each graph step one replay; both
    timed by CUDA events; then one step of each under the profiler: device
    busy ms and the host's runtime calls."""
    from repro_torch.models import cache_tensors, decode_step

    live = torch.tensor([sid is not None for sid in d.slots])
    host = np.zeros((2, SERVE_BATCH), np.int32)
    for i, sid in enumerate(d.slots):
        if sid:
            host[:, i] = (d.sessions[sid].tokens[-1], 1)
    err = cache_err = 0.0
    equal = judged = 0
    graph_ms, eager_ms = [], []
    replays = d.graph_replays
    for _ in range(SERVE_GRAPH_STEPS):
        twin = _clone_cache(d.cache)
        dev = torch.from_numpy(host).to(d.device)
        batch = {"tokens": dev[0][:, None], "active": dev[1]}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        want, _ = decode_step(d.cfg, d.params, batch, twin)
        ev[1].record()
        ev[2].record()
        got = d._decode(host)
        ev[3].record()
        torch.cuda.synchronize()
        eager_ms.append(ev[0].elapsed_time(ev[1]))
        graph_ms.append(ev[2].elapsed_time(ev[3]))
        got, want = got.cpu()[live], want.cpu()[live]
        err = max(err, float((got - want).abs().max()))
        for a, b in zip(cache_tensors(d.cache), cache_tensors(twin)):
            cache_err = max(cache_err, float((a.float() - b.float()).abs()
                                             .max()))
        top2 = torch.topk(want, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > BF16_LOGIT_TOL
        judged += int(sure.sum())
        check(torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]),
              f"{name}: the decode graph's greedy tokens differ from the "
              f"eager step's where its top-2 margin exceeds "
              f"{BF16_LOGIT_TOL}")
        equal += int((got.argmax(-1) == want.argmax(-1)).sum())
        host[0, live.numpy()] = got.argmax(-1).numpy()
    rows = SERVE_GRAPH_STEPS * int(live.sum())
    check(d.graph_replays - replays == SERVE_GRAPH_STEPS,
          f"{name}: {d.graph_replays - replays} graph replays for "
          f"{SERVE_GRAPH_STEPS} decode steps")
    check(err <= BF16_LOGIT_TOL, f"{name}: the decode graph's logits differ "
                                 f"from the eager step's by {err:.6g} > "
                                 f"{BF16_LOGIT_TOL}")
    twin = _clone_cache(d.cache)
    dev = torch.from_numpy(host).to(d.device)
    eager_busy, eager_calls = _profiled(torch, lambda: decode_step(
        d.cfg, d.params, {"tokens": dev[0][:, None], "active": dev[1]},
        twin))
    graph_busy, graph_calls = _profiled(torch, lambda: d._decode(host))
    g50, e50 = _pcts(np, graph_ms)[0], _pcts(np, eager_ms)[0]
    say(card, f"serving {name}: decode graph against the eager step, "
              f"{SERVE_GRAPH_STEPS} steps x {int(live.sum())} rows: logits "
              f"max abs diff {err:.6g} (tol {BF16_LOGIT_TOL}), caches "
              f"{cache_err:.6g}, greedy tokens equal on {equal} of {rows} "
              f"rows ({judged} past the margin); one replay a step; decode "
              f"p50 graph {g50:.3f} ms, eager {e50:.3f} ms (CUDA events); "
              f"one step under the profiler: device busy graph "
              + ("not measured" if graph_busy is None else
                 f"{graph_busy:.3f}")
              + " ms, eager "
              + ("not measured" if eager_busy is None else
                 f"{eager_busy:.3f}")
              + f" ms; host runtime calls graph {graph_calls}, eager "
                f"{eager_calls}")
    return dict(max_abs_err=err, cache_max_abs_err=cache_err,
                tokens_equal=equal, rows=rows, judged=judged,
                graph_ms=graph_ms, eager_ms=eager_ms, graph_p50=g50,
                eager_p50=e50, graph_busy_ms=graph_busy,
                eager_busy_ms=eager_busy, graph_calls=graph_calls,
                eager_calls=eager_calls,
                graph_launches=_launches(graph_calls),
                eager_launches=_launches(eager_calls))


def _serve_host_ops(torch, d, top=8):
    """One more step under the profiler's CPU activity: the host's self
    time by operator, the largest first (the profiler inflates each op's
    cost alike, so read the shares)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d.step()
        torch.cuda.synchronize()
    ops = sorted(((e.self_cpu_time_total, e.count, e.key)
                  for e in prof.key_averages()), reverse=True)
    total = sum(t for t, _, _ in ops) or 1.0
    return dict(total_ms=total / 1e3,
                top=[(k, n, t / total) for t, n, k in ops[:top]])


def _serve_numerics(np, torch, card, cfg, model):
    """The served bf16 weights against their f32 twin on the card (TF32
    off) and on the CPU: SERVE_NUMERIC_STEPS teacher-forced decode steps
    of all SERVE_BATCH rows."""
    from dataclasses import replace

    from repro_torch.models import Transformer, decode_step, init_decode_cache

    cfg32 = replace(cfg, dtype="float32")
    m32 = Transformer(cfg32, device=model.device, seed=SEED)
    check(all(torch.equal(a.to(torch.bfloat16), b) for a, b in
              zip(m32.parameters(), model.parameters())),
          "the bf16 model is not its f32 twin rounded")
    t0 = time.perf_counter()
    cpu = Transformer.from_state_dict(cfg32, m32.state_dict(), device="cpu")
    rng = np.random.default_rng(SEED + 8)
    toks = rng.integers(0, cfg.vocab, (SERVE_NUMERIC_STEPS, SERVE_BATCH, 1))
    runs = {"bf16": (cfg, model), "f32": (cfg32, m32), "cpu": (cfg32, cpu)}
    caches = {k: init_decode_cache(c, SERVE_BATCH, SERVE_MAX_SEQ,
                                   device=m.device)
              for k, (c, m) in runs.items()}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err = {"bf16": 0.0, "f32": 0.0}
    tol = {"bf16": BF16_LOGIT_TOL, "f32": F32_LOGIT_TOL}
    judged = {"bf16": 0, "f32": 0}
    scale = 0.0
    try:
        for t in range(SERVE_NUMERIC_STEPS):
            logits = {}
            for k, (c, m) in runs.items():
                tok = torch.from_numpy(toks[t]).int().to(m.device)
                logits[k], caches[k] = decode_step(c, m, {"tokens": tok},
                                                   caches[k])
            want = logits["cpu"]
            scale = max(scale, float(want.abs().max()))
            top2 = torch.topk(want, 2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            for k in err:
                got = logits[k].cpu()
                err[k] = max(err[k], float((got - want).abs().max()))
                sure = margin > tol[k]
                judged[k] += int(sure.sum())
                check(torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]),
                      f"{k} greedy tokens differ from the CPU's where its "
                      f"top-2 margin exceeds {tol[k]}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    for k in err:
        check(err[k] <= tol[k], f"{k} logits on the card differ from the "
                                f"CPU's f32 by {err[k]:.6g} > {tol[k]}")
    n = SERVE_NUMERIC_STEPS * SERVE_BATCH
    say(card, f"serving {cfg.name} numerics: {SERVE_NUMERIC_STEPS} "
              f"teacher-forced steps x {SERVE_BATCH} rows against f32 on the "
              f"CPU (logits up to {scale:.4f}): bf16 max abs err "
              f"{err['bf16']:.6g} (tol {BF16_LOGIT_TOL}), f32 with TF32 off "
              f"{err['f32']:.6g} (tol {F32_LOGIT_TOL}); greedy tokens equal "
              f"on {judged['bf16']} and {judged['f32']} of {n} rows whose "
              f"CPU top-2 margin exceeds the tolerance "
              f"({time.perf_counter() - t0:.1f} s)")
    return dict(max_abs_err=err, judged_rows=judged, rows=n,
                max_abs_logit=scale)


def phase_serving(np, torch, card, device):
    """CurpServeDriver on the card at full width (launches counted from 0
    over this phase alone); returns the phase's launches and numbers."""
    from repro_torch.core.telemetry import get_registry
    from repro_torch.kernels import ops as kops
    from repro_torch.models import Transformer

    kops.reset_launch_counts()
    fused = get_registry().counter("ssm.fused_updates")
    fused.reset()
    attended = get_registry().counter("attn.fused_decodes")
    attended.reset()
    info = {}
    t_phase = time.perf_counter()
    for name in SERVE_ARCHS:
        cfg = serve_arch(name)
        fused_before, attended_before = fused.value, attended.value
        t0 = time.perf_counter()
        model = Transformer(cfg, device=device, seed=SEED)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        say(card, f"serving {name}: {cfg.n_layers} layers, d {cfg.d_model}, "
                  f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, "
                  f"vocab {cfg.vocab:,}, {n_params:,} parameters in "
                  f"{cfg.dtype} ({torch.cuda.memory_allocated() / 2**30:.2f} "
                  f"GiB on the card), built in "
                  f"{time.perf_counter() - t0:.1f} s")
        prompts = _prompts(np, cfg.vocab)
        a, clock, steps_launched, wall, _ = _serve_run(torch, cfg, model,
                                                       prompts)
        want = _tokens(a)
        check(all(len(want[sid]) == len(p) + SERVE_TOKENS
                  for sid, p in prompts.items()),
              f"{name}: a session did not get {SERVE_TOKENS} tokens")
        _check_store(card, name, a)
        _check_plain(card, name, a, clock.log)
        b, _, _, _, rep = _serve_run(torch, cfg, model, prompts,
                                     crash_at=SERVE_CRASH_AT)
        check(rep["recovered_sessions"] == SERVE_BATCH,
              f"{name}: {rep['recovered_sessions']} sessions recovered of "
              f"{SERVE_BATCH}")
        check(_tokens(b) == want, f"{name}: the driver crashed after "
                                  f"{SERVE_CRASH_AT} steps generated other "
                                  f"tokens")
        _check_store(card, f"{name} (crashed)", b, paths=False)
        graph = _serve_graph_check(np, torch, card, name, b)
        dec = clock.decode_ms()
        p50, p99 = _pcts(np, dec)
        commit_ms = [s * 1e3 for s in clock.commit_s]
        c50, c99 = _pcts(np, commit_ms)
        per_step = {k: steps_launched[k] / SERVE_TOKENS
                    for k in ("gang_record", "gang_fastpath", "gang_gc",
                              "gang_record_groups")}
        row = dict(n_params=n_params, decode_ms=dec, decode_p50=p50,
                   decode_p99=p99, commit_ms=commit_ms, commit_p50=c50,
                   commit_p99=c99, tokens_per_s=SERVE_BATCH * SERVE_TOKENS
                   / wall, launches_per_step=per_step,
                   fast_slow=(a.store.fast_commits, a.store.slow_commits),
                   crash=rep, graph=graph,
                   graph_replays=(a.graph_replays, b.graph_replays))
        say(card, f"serving {name}: {SERVE_BATCH} sessions (prompts "
                  f"{min(map(len, prompts.values()))}-"
                  f"{max(map(len, prompts.values()))} tokens) x "
                  f"{SERVE_TOKENS} tokens on 4 shards of the device witness "
                  f"gang: decode step (one graph replay) p50 {p50:.3f} "
                  f"ms, p99 {p99:.3f} ms (CUDA events); "
                  f"{a.graph_replays} replays in driver A"
                  f"; {row['tokens_per_s']:.1f} tokens/s at "
                  f"batch {SERVE_BATCH}; commit host ms per step p50 "
                  f"{c50:.3f}, p99 {c99:.3f}; launches per step "
                  + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
                  + f"; commits fast {row['fast_slow'][0]}, slow "
                    f"{row['fast_slow'][1]}; crash after {SERVE_CRASH_AT} "
                    f"steps: {rep['recovered_sessions']} recovered, "
                    f"{rep['replayed_ops']} replayed, tokens identical; "
                    f"every session read back")
        del b
        if name == SERVE_ARCHS[0]:
            row.update(_serve_other_paths(np, torch, card, cfg, model,
                                          prompts, a, want))
            row["numerics"] = _serve_numerics(np, torch, card, cfg, model)
        row["idle"] = _serve_idle(np, torch, a, clock)
        idle = row["idle"]
        # The profiler's idle share stands only if it sees the graph's
        # kernels: a replayed decode busy about as long as the eager one.
        seen = (graph["graph_busy_ms"] is not None
                and graph["eager_busy_ms"] is not None
                and 0.8 <= graph["graph_busy_ms"] / graph["eager_busy_ms"]
                <= 1.25)
        idle["profiler_sees_graph"] = seen
        # The profiler slows the step it traces: its busy time against the
        # mean step of the untraced run (wall over steps, commits included).
        idle["step_ms"] = wall / SERVE_TOKENS * 1e3
        idle["idle_share_untraced"] = (
            None if idle["busy_ms"] is None
            else 1.0 - idle["busy_ms"] / idle["step_ms"])
        say(card, f"serving {name}: one step under the profiler: wall "
                  f"{idle['wall_ms']:.3f} ms, device busy "
                  + ("not measured" if idle["busy_ms"] is None else
                     f"{idle['busy_ms']:.3f} ms, idle share "
                     f"{idle['idle_share']:.4f}")
                  + f"; the decode's replay {idle['decode_event_ms']:.3f} ms "
                    f"by CUDA events, idle share by events at most "
                    f"{idle['idle_share_events']:.4f}; the profiler "
                  + ("sees" if seen else "does not see")
                  + " the graph's kernels (replayed busy against eager busy"
                    " within 0.8-1.25x); against the untraced run's mean "
                    f"step of {idle['step_ms']:.3f} ms the busy time leaves "
                  + ("an idle share not measured"
                     if idle["idle_share_untraced"] is None else
                     f"an idle share of {idle['idle_share_untraced']:.4f}"))
        row["host_ops"] = _serve_host_ops(torch, a)
        say(card, f"serving {name}: host self time of one step under the "
                  f"profiler {row['host_ops']['total_ms']:.1f} ms, by op: "
                  + ", ".join(f"{k} x{n} {sh:.3f}"
                              for k, n, sh in row["host_ops"]["top"]))
        row["ssm_fused_updates"] = fused.value - fused_before
        check((row["ssm_fused_updates"] > 0) == bool(cfg.ssm),
              f"{name}: {row['ssm_fused_updates']} Mamba2 state updates "
              f"in its replays")
        row["attn_fused_decodes"] = attended.value - attended_before
        check(row["attn_fused_decodes"] > 0
              and row["attn_fused_decodes"] % cfg.n_layers == 0,
              f"{name}: {row['attn_fused_decodes']} decode attentions in "
              f"its replays, not one for each of its {cfg.n_layers} layers")
        info[name] = row
        del a, model
        torch.cuda.empty_cache()
    launched = kops.launch_counts()
    path = ("gang_record", "gang_fastpath", "gang_gc", "gang_record_groups")
    check(all(launched[k] > 0 for k in path),
          f"serving did not launch every gang kernel: {launched}")
    # The host counts ssm_update.cu and decode_attn.cu once a capture;
    # their launches are the replays' state updates and attentions.
    launched[kops.SSM_UPDATE.name] = fused.value
    launched[kops.DECODE_ATTN.name] = attended.value
    say(card, "serving launches (phase 7 alone): "
              + ", ".join(f"{k} {launched[k]}"
                          for k in path + (kops.SSM_UPDATE.name,
                                           kops.DECODE_ATTN.name))
              + f"; phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return launched, info


def _serve_other_paths(np, torch, card, cfg, model, prompts, a, want):
    """The same run on the Python witness backend (tokens and commit counts
    identical, unless a FULL reject explains a difference in counts) and
    with each step one mini-transaction (tokens identical; every
    single-shard step fast, every cross-shard one committed in 2 rounds or
    more)."""
    py, _, _, _, _ = _serve_run(torch, cfg, model, prompts,
                                witness_backend="python")
    check(_tokens(py) == want, "the Python witness backend generated "
                               "other tokens")
    counts = [(d.store.fast_commits, d.store.slow_commits) for d in (a, py)]
    full = {sid: n for sid, n in enumerate(_full_by_shard(a.store.cluster))
            if n}
    if counts[0] != counts[1]:
        check(full, f"fast/slow commits differ from the Python backend "
                    f"({counts[0]} against {counts[1]}) with no FULL reject")
        say(card, f"serving: fast/slow commits {counts[0]} against the "
                  f"Python backend's {counts[1]}; FULL rejects by shard "
                  f"{full}")
    at, clock, launched, _, _ = _serve_run(torch, cfg, model, prompts,
                                           atomic_step_commit=True)
    check(_tokens(at) == want, "atomic step commits generated other tokens")
    _check_plain(card, f"{cfg.name} (atomic step commits)", at, clock.log)
    single = [o for o in clock.txns if o.n_shards == 1]
    cross = [o for o in clock.txns if o.n_shards > 1]
    check(all(o.status.name == "COMMITTED" for o in clock.txns)
          and all(o.fast_path and o.rtts == 1 for o in single)
          and all(o.rtts >= 2 for o in cross),
          f"atomic step commits: "
          f"{[(o.status.name, o.n_shards, o.rtts) for o in clock.txns]}")
    say(card, f"serving {cfg.name}: Python witness backend tokens and "
              f"fast/slow commits {counts[1]} identical"
              + (f" (FULL rejects by shard {full})" if full else "")
              + f"; atomic step commits: tokens identical, "
                f"{len(single)} single-shard steps on 1 RTT, {len(cross)} "
                f"cross-shard committed in "
                f"{sorted({o.rtts for o in cross})} rounds; launches "
              + ", ".join(f"{k} {launched[k]}" for k in (
                  "gang_record", "gang_fastpath", "gang_gc",
                  "gang_record_groups")))
    return dict(python_fast_slow=counts[1], full_by_shard=full,
                atomic=dict(single=len(single), cross=len(cross),
                            launches=launched))


# ---------------------------------------------------------------------------
# Phase 7b: the Mamba2 state update against its plain version
# ---------------------------------------------------------------------------
def _ssm_operands(torch, cfg, B, device):
    """A bf16 state and one step's operands at ``cfg``'s Mamba2 layer for B
    rows, every third row inactive.  B and C are views of one wider row
    laid out batch-fastest and xdt is permuted, as ``ssm_decode`` finds
    them after its conv's einsum."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    gen = torch.Generator(device=device).manual_seed(SEED + 29)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    row = draw(2 * G * N + 8, B).t()
    Bm = row[:, 8:8 + G * N].reshape(B, G, N)
    Cm = row[:, 8 + G * N:].reshape(B, G, N)
    xdt = (draw(P, H, B) * 0.5).permute(2, 1, 0)
    dA = (0.5 + 0.5 * torch.rand((B, H), generator=gen, device=device)).to(
        torch.bfloat16)
    active = torch.ones(B, dtype=torch.int32, device=device)
    active[1::3] = 0
    return draw(B, H, P, N), dA, xdt, Bm, Cm, active


def phase_ssm_update(np, torch, card, device):
    """``ssm_update.cu`` against ``ssm_state_update_plain`` on the same
    card tensors at each of SSM_SHAPES: the state bit for bit, y within its
    summation order; both timed, the kernel's device time and its bound.
    Returns its numbers by arch."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops as kops
    from repro_torch.models.ssm import ssm_state_update_plain

    out = {}
    for arch, B in SSM_SHAPES:
        cfg = ARCHS[arch]
        state0, dA, xdt, Bm, Cm, active = _ssm_operands(torch, cfg, B,
                                                        device)
        shape = tuple(state0.shape)
        want, y_want = ssm_state_update_plain(state0, dA, xdt, Bm, Cm,
                                              active)
        new_all, _ = ssm_state_update_plain(state0, dA, xdt, Bm, Cm, None)
        state = state0.clone()
        y = kops.ssm_state_update_cuda(state, dA, xdt, Bm, Cm, active)
        torch.cuda.synchronize()
        check(torch.equal(state.view(torch.int16), want.view(torch.int16)),
              f"ssm_state_update at {shape}: the state differs from the "
              f"plain version's")
        # Each side rounds its f32 sum of N terms once to bf16 (2^-8 of |y|
        # each); two f32 sums in other orders part by at most 2 N 2^-24 of
        # the terms' absolute sum, N <= 128.
        rep = cfg.ssm_heads // cfg.ssm_groups
        terms = (new_all.float() * Cm.repeat_interleave(rep, dim=1).float()
                 [:, :, None, :]).abs().sum(-1)
        tol = 2**-7 * y_want.float().abs() + 2**-14 * terms
        gap = (y.float() - y_want.float()).abs()
        check(bool((gap <= tol).all()),
              f"ssm_state_update at {shape}: y differs from the plain "
              f"version's by {float(gap.max()):.6g}, past its summation "
              f"order")

        def restore():
            state.copy_(state0)

        def kernel():
            kops.ssm_state_update_cuda(state, dA, xdt, Bm, Cm, active)

        def plain():
            ssm_state_update_plain(state, dA, xdt, Bm, Cm, active)

        nbytes = 2 * state.numel() * state.element_size()
        t = dict(shape=shape, max_abs_err=float(gap.max()),
                 tol_share=float((gap / tol.clamp_min(1e-30)).max()),
                 ms=_event_ms(torch, kernel, restore, 50),
                 plain_ms=_event_ms(torch, plain, restore, 5),
                 bytes=nbytes, bound=_bound_ms(nbytes, 0))
        restore()
        t["device_ms"] = _device_ms(torch, kernel, only="ssm_update")
        out[arch] = t
        say(card, f"ssm_state_update at {arch}'s layer {shape} bf16, rows "
                  f"{int((active == 0).sum())} of {B} inactive: state bit "
                  f"for bit with the plain version, y max abs diff "
                  f"{t['max_abs_err']:.6g} ({t['tol_share']:.3f} of its "
                  f"bound); {t['ms']:.4f} ms (CUDA events; plain "
                  f"{t['plain_ms']:.4f}), device "
                  + ("not measured" if t["device_ms"] is None else
                     f"{t['device_ms']:.4f} ms")
                  + f", bound {t['bound'][0]:.6f} ms ({nbytes:,} B "
                    f"read and written)")
    return out


# ---------------------------------------------------------------------------
# Phase 7c: the decode attention against its plain version
# ---------------------------------------------------------------------------
def phase_decode_attention(np, torch, card, device):
    """``decode_attn.cu`` against ``sdpa_decode_plain`` on the same card
    tensors at each of ATTN_CASES: o within its summation order's bound;
    both timed, the kernel's device time and its bound.  Returns its
    numbers by case."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops as kops, parity
    from repro_torch.models.layers import attn_scale, sdpa_decode_plain

    out = {}
    for case, arch, B, C, tokens in ATTN_CASES:
        cfg = ARCHS[arch]
        Hkv, dh = cfg.n_kv_heads, cfg.d_head
        rep = cfg.n_heads // Hkv
        scale = attn_scale(cfg, dh)
        rows = np.arange(B)
        # a row holds tokens + 1 slots after this one's write; rows part
        # by a few tokens, as sessions with other prompts do
        pos = (C + 5 * rows) if tokens is None else (tokens - 7 * rows)
        q, k, v, cur_pos = parity.decode_attention_case(
            B, C, Hkv, rep, dh, torch.bfloat16, device, pos.tolist(), scale,
            seed=SEED + 31)
        got = kops.decode_attention_cuda(q, k, v, cur_pos, scale)
        want = sdpa_decode_plain(cfg, q, k, v, cur_pos)
        torch.cuda.synchronize()
        tol = parity.decode_attention_bound(q, k, v, cur_pos, scale, want)
        gap = (got.float() - want.float()).abs()
        check(bool((gap <= tol).all()),
              f"decode_attention at {case}: o differs from the plain "
              f"version's by {float(gap.max()):.6g}, past its summation "
              f"order's bound ({float((gap / tol).max()):.3f} of it)")
        equal, rms = parity.decode_attention_agreement(got, want)
        least, most = parity.DECODE_ATTENTION_AGREEMENT[torch.bfloat16]
        check(equal >= least and rms <= most,
              f"decode_attention at {case}: {equal:.4f} of o's elements "
              f"equal to the plain version's (at least {least}), rms gap "
              f"{rms:.3f} u (at most {most})")
        live = int(parity.live_slots(cur_pos, C).sum())
        nbytes = (2 * live * Hkv * dh + 2 * q.numel()) * k.element_size()

        def kernel():
            kops.decode_attention_cuda(q, k, v, cur_pos, scale)

        def plain():
            sdpa_decode_plain(cfg, q, k, v, cur_pos)

        t = dict(shape=(B, C, Hkv, dh), rep=rep, live_slots=live,
                 max_abs_err=float(gap.max()),
                 tol_share=float((gap / tol).max()),
                 equal_share=equal, rms_gap_u=rms,
                 ms=_event_ms(torch, kernel, lambda: None, 50),
                 plain_ms=_event_ms(torch, plain, lambda: None, 5),
                 bytes=nbytes, bound=_bound_ms(nbytes, 0),
                 device_ms=_device_ms(torch, kernel, only="decode_attn"))
        out[case] = t
        del q, k, v, got, want, tol, gap
        torch.cuda.empty_cache()
        say(card, f"decode_attention at {case} ({B} x {C} x {Hkv} x {dh} "
                  f"bf16, rep {rep}, {live:,} live slots): o max abs diff "
                  f"{t['max_abs_err']:.6g} ({t['tol_share']:.3f} of its "
                  f"bound, {equal:.4f} of elements equal, rms gap "
                  f"{rms:.3f} u); "
                  f"{t['ms']:.4f} ms (CUDA events; plain "
                  f"{t['plain_ms']:.4f}), device "
                  + ("not measured" if t["device_ms"] is None else
                     f"{t['device_ms']:.4f} ms")
                  + f", bound {t['bound'][0]:.6f} ms ({nbytes:,} B of live "
                    f"K, V, q and o)")
    return out


# ---------------------------------------------------------------------------
# Phase 8: training (FaultTolerantTrainer, full width)
# ---------------------------------------------------------------------------
def train_arch():
    """The configuration phase 8 trains, at its published width."""
    from repro_torch.configs import ARCHS

    return ARCHS[TRAIN_ARCH]


class _DiskPeak:
    """While entered, a thread sums the sizes of the files under ``root``
    every 20 ms (a backup's temp directory included) and keeps the
    largest total."""

    def __init__(self, root):
        self.root, self.peak = root, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def size(self):
        n = 0
        for d, _, files in os.walk(self.root):
            for name in files:
                try:
                    n += os.stat(os.path.join(d, name)).st_size
                except FileNotFoundError:        # removed while walked
                    pass
        return n

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.size())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.size())


def _clock_steps(torch, trainer):
    """CUDA events around each train step the trainer runs."""
    events, step = [], trainer._train_step

    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step(*args)
        b.record()
        events.append((a, b))
        return out

    trainer._train_step = timed
    return events


def _clock_journal(trainer):
    """Host seconds each step spends recording its StepOp at the f
    witnesses (each record opens its file, appends a line, fsyncs and
    closes), by step: [the records, the fsyncs inside them]."""
    spent = {}
    for w in trainer.witnesses:
        record = w.record

        def timed(sop, record=record):
            fsync, took = os.fsync, spent.setdefault(sop.step, [0.0, 0.0])

            def timed_fsync(fd):
                t = time.perf_counter()
                fsync(fd)
                took[1] += time.perf_counter() - t

            os.fsync = timed_fsync
            t = time.perf_counter()
            try:
                return record(sop)
            finally:
                took[0] += time.perf_counter() - t
                os.fsync = fsync

        w.record = timed
    return spent


def _journal(path):
    """A witness's durable log: the steps it recorded, in order, and those
    still live (recorded and not gc'd).  Read from its file, since asking
    the witness itself for its recovery data would freeze it."""
    recorded, live = [], set()
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if rec["t"] == "record":
            recorded.append(rec["step"])
            live.add(rec["step"])
        else:
            live.difference_update(rec["steps"])
    return recorded, sorted(live)


def _watch_syncs(trainer):
    """After each backup sync, no witness may hold a step the sync folded
    in (every live step is at or past the synced step)."""
    sync = trainer._sync_backups

    def checked():
        sync()
        for i in range(len(trainer.witnesses)):
            _, live = _journal(trainer.root / f"witness{i}.jsonl")
            check(all(s >= trainer.step for s in live),
                  f"witness {i} still holds {live} after the sync at step "
                  f"{trainer.step}")

    trainer._sync_backups = checked


def _check_journal(trainer, name):
    """Every witness recorded (accepted: a rejected record is not logged)
    each step of its epoch once, in order, and holds exactly the steps
    since the last sync."""
    since = trainer.sync_log[-1]["step"]
    for i in range(len(trainer.witnesses)):
        steps, live = _journal(trainer.root / f"witness{i}.jsonl")
        check(steps and steps == list(range(steps[0], trainer.step)),
              f"trainer {name}: witness {i} recorded steps {steps}")
        check(live == list(range(since, trainer.step)),
              f"trainer {name}: witness {i} holds {live} after the sync at "
              f"{since}")
    return len(steps)


def _train_flops(cfg, n_params, batch, seq):
    """Model FLOPs of one step: 6 x the parameters that enter a product
    (all but the embedding table) x tokens, plus attention's QK^T and PV
    over the full S x S square (what the blockwise attention computes),
    forward and backward; and what remat adds, one more forward."""
    tokens = batch * seq
    n_mm = n_params - (0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
    attn_fwd = 4 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * tokens
    return 6 * n_mm * tokens + 3 * attn_fwd, 2 * n_mm * tokens + attn_fwd


def _train_idle(torch, trainer):
    """One more train step (off the journal, after the digests) under the
    profiler: device busy time against its wall time."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.pipeline.batch_for(trainer.step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._run_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us = _device_us(prof)
    busy = None if us is None else us / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy,
                idle_share=None if busy is None else 1.0 - busy / wall_ms)


def _corrupt_backup(trainer):
    """Flip one byte of the newest state of the last backup replica: its
    restore must raise IOError."""
    rep = trainer.backups[-1]
    step = rep.newest_step()
    path = rep.root / f"step{step}" / "state.bin"
    with path.open("r+b") as f:
        f.seek(100)
        byte = f.read(1)[0]
        f.seek(100)
        f.write(bytes([byte ^ 0xFF]))
    t0 = time.perf_counter()
    raised = False
    try:
        rep.restore(step)
    except IOError:
        raised = True
    check(raised, f"a corrupted backup (replica {rep.replica_id}, step "
                  f"{step}) restored without an IOError")
    return step, time.perf_counter() - t0


def _train_numerics(np, torch, card, cfg, device):
    """One train step of the model's f32 twin on the card (TF32 off) and on
    the CPU, batch 1 x TRAIN_NUMERIC_SEQ, from the same weights (drawn on
    the CPU) and zero moments: loss, grad norm and the updated weights."""
    from dataclasses import replace

    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import make_train_step
    from repro_torch.models import Transformer
    from repro_torch.optim import AdamWConfig, init_opt_state

    t0 = time.perf_counter()
    cfg32 = replace(cfg, dtype="float32")
    opt = AdamWConfig(warmup_steps=5, total_steps=1000)
    step = make_train_step(cfg32, opt)
    data = DataConfig(seed=TRAIN_DATA_SEED, batch=1, seq=TRAIN_NUMERIC_SEQ)
    cpu = Transformer(cfg32, device="cpu", seed=SEED)
    models = {"card": Transformer.from_state_dict(cfg32, cpu.state_dict(),
                                                  device),
              "cpu": cpu}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    metrics = {}
    try:
        for name, m in models.items():
            batch = SyntheticPipeline(cfg32, data, m.device).batch_for(0)
            _, _, got = step(m, init_opt_state(m, opt, m.device), batch)
            metrics[name] = {k: float(v) for k, v in got.items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    got, want = metrics["card"], metrics["cpu"]
    rel = {k: abs(got[k] - want[k]) / abs(want[k])
           for k in ("loss", "grad_norm")}
    for k, r in rel.items():
        check(r <= TRAIN_LOSS_RTOL, f"training numerics: the f32 {k} on the "
                                    f"card is {got[k]!r} against the CPU's "
                                    f"{want[k]!r} ({r:.3g} relative > "
                                    f"{TRAIN_LOSS_RTOL})")
    lr = want["lr"]
    worst, off, n = 0.0, 0, 0
    card_params = dict(models["card"].named_parameters())
    for k, p in cpu.named_parameters():
        d = (card_params[k].detach().cpu() - p.detach()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > TRAIN_PARAM_OFF).sum())
        n += d.numel()
    check(worst <= 2 * lr + TRAIN_PARAM_OFF,
          f"training numerics: a weight on the card is {worst:.3g} from the "
          f"CPU's after one step, more than 2 x lr ({lr:.3g}) + "
          f"{TRAIN_PARAM_OFF}")
    check(off / n < TRAIN_PARAM_OFF_SHARE,
          f"training numerics: {off} of {n} weights differ by more than "
          f"{TRAIN_PARAM_OFF}")
    say(card, f"training {cfg.name} numerics: one step of the f32 twin at "
              f"1 x {TRAIN_NUMERIC_SEQ} on the card (TF32 off) against the "
              f"CPU: loss {got['loss']:.6f} vs {want['loss']:.6f} "
              f"({rel['loss']:.3g} relative, tol {TRAIN_LOSS_RTOL}), grad "
              f"norm {got['grad_norm']:.6f} vs {want['grad_norm']:.6f} "
              f"({rel['grad_norm']:.3g}); updated weights at most "
              f"{worst:.3g} apart (2 x lr = {2 * lr:.3g}), {off} of {n:,} "
              f"more than {TRAIN_PARAM_OFF} ({time.perf_counter() - t0:.1f} "
              f"s)")
    return dict(card=got, cpu=want, rel=rel, max_abs_param=worst,
                params_off=off, n_params=n)


def _train_report(np, card, cfg, info):
    """Phase 8's step, sync and recovery numbers from ``info`` (the runs'
    raw measurements), printed and added to it."""
    step_ms, sync_log = info["step_ms"], info["sync_log"]
    p50, p99 = _pcts(np, step_ms[1:])
    model_flops, remat_flops = _train_flops(cfg, info["n_params"],
                                            TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    info.update(
        step_p50=p50, step_p99=p99, tokens_per_s=tokens / (p50 / 1e3),
        tokens_per_s_with_syncs=TRAIN_STEPS * tokens / info["a_wall"],
        model_tflop=model_flops / 1e12, remat_tflop=remat_flops / 1e12,
        peak_share=model_flops / (p50 / 1e3) / BF16_PEAK_FLOPS,
        sync_p50_s=float(np.percentile([x["seconds"] for x in sync_log],
                                       50)))
    losses, rep = info["losses"], info["recovery"]
    say(card, f"training {cfg.name}: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab:,}, {info['n_params']:,} "
              f"parameters in {cfg.dtype}, remat, f32 moments; batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}; f = {TRAIN_F}, a sync every "
              f"{TRAIN_SYNC_EVERY} steps (built in {info['built_s']:.1f} s)")
    say(card, f"training: step p50 {p50:.1f} ms, p99 {p99:.1f} ms over "
              f"steps 1-{TRAIN_STEPS - 1} (CUDA events; step 0 "
              f"{step_ms[0]:.1f} ms); {info['tokens_per_s']:.0f} tokens/s "
              f"at p50, {info['tokens_per_s_with_syncs']:.0f} with the "
              f"syncs; model {info['model_tflop']:.2f} TFLOP a step "
              f"(remat adds {info['remat_tflop']:.2f}), "
              f"{info['peak_share']:.4f} of the dense bf16 peak at p50; peak "
              f"CUDA memory {info['peak_cuda_bytes'] / 2**30:.2f} GiB; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    journal = info["journal_ms"]
    after = [journal[s] for s in range(TRAIN_SYNC_EVERY, TRAIN_STEPS,
                                       TRAIN_SYNC_EVERY)]
    a_syncs = sum(x["seconds"] for x in sync_log[1:TRAIN_STEPS
                                                  // TRAIN_SYNC_EVERY + 1])
    say(card, f"training: trainer A's {TRAIN_STEPS} steps took "
              f"{info['a_wall']:.1f} s: steps {sum(step_ms) / 1e3:.1f} "
              f"(CUDA events), syncs {a_syncs:.1f}, journal "
              f"{sum(journal) / 1e3:.1f} ({TRAIN_F} fsync'd records a step: "
              f"p50 {float(np.percentile(journal, 50)):.1f} ms, of which "
              f"fsync p50 {float(np.percentile(info['fsync_ms'], 50)):.1f} "
              f"ms; the first step after each sync "
              + ", ".join(f"{x:.1f}" for x in after) + " ms)")
    say(card, f"training: {len(sync_log)} syncs of "
              f"{sync_log[0]['bytes'] / TRAIN_F / 1e9:.3f} GB to {TRAIN_F} "
              f"backups ({sync_log[0]['bytes'] / 1e9:.3f} GB written a "
              f"sync), wall s p50 {info['sync_p50_s']:.2f} (each: "
              + ", ".join(f"{x['seconds']:.2f}" for x in sync_log)
              + f"); peak on disk {info['peak_disk_bytes'] / 1e9:.3f} GB")
    say(card, f"training: crash after {TRAIN_CRASH_AT} steps: restored "
              f"step {rep['restored_step']}, replayed {rep['replayed']} "
              f"journaled steps in {info['recover_s']:.1f} s (restore, "
              f"replay and the sync after), trained to {TRAIN_STEPS}: "
              f"weights and Adam moments equal the uninterrupted run's bit "
              f"for bit; every witness accepted every step "
              f"({info['records_per_witness']} records each after recovery) "
              f"and held none of a synced step; a byte flipped in backup "
              f"{TRAIN_F - 1}'s step-{info['corrupt']['step']} state raised "
              f"IOError on restore ({info['corrupt']['restore_s']:.1f} s)")
    return info


def phase_training(np, torch, card, device):
    """FaultTolerantTrainer on the card at full width (launches counted from
    0 over this phase alone: it must launch none of the port's kernels);
    returns the phase's numbers."""
    from repro_torch.data import DataConfig
    from repro_torch.ft import FTConfig, FaultTolerantTrainer
    from repro_torch.ft.runner import state_digest
    from repro_torch.kernels import ops as kops
    from repro_torch.optim import AdamWConfig

    kops.reset_launch_counts()
    cfg = train_arch()
    check(cfg.remat and cfg.dtype == "bfloat16",
          f"{cfg.name}: remat {cfg.remat}, dtype {cfg.dtype}")
    data = DataConfig(seed=TRAIN_DATA_SEED, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    opt = AdamWConfig(warmup_steps=5, total_steps=1000)
    work = Path(tempfile.mkdtemp(prefix="curp_ft_"))

    def trainer(name):
        t = FaultTolerantTrainer(cfg, data, FTConfig(
            f=TRAIN_F, sync_every=TRAIN_SYNC_EVERY,
            workdir=str(work / name), device=device), opt)
        _watch_syncs(t)
        return t

    try:
        with _DiskPeak(work) as disk:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            a = trainer("a")
            built_s = time.perf_counter() - t0
            n_params = sum(p.numel() for p in a.params.parameters())
            check(n_params == TRAIN_PARAMS,
                  f"{cfg.name}: {n_params:,} parameters")
            events = _clock_steps(torch, a)
            journal_s = _clock_journal(a)
            t0 = time.perf_counter()
            a.train(TRAIN_STEPS)
            torch.cuda.synchronize()
            a_wall = time.perf_counter() - t0
            peak_mem = torch.cuda.max_memory_allocated()
            step_ms = [x.elapsed_time(y) for x, y in events]
            losses = [m["loss"] for m in a.metrics_log]
            check(all(np.isfinite(losses)), f"training losses {losses}")
            _check_journal(a, "A")
            want = (a.params_digest(), state_digest(a.opt_state))
            sync_log = list(a.sync_log)
            shutil.rmtree(a.root)
            del a, events
            torch.cuda.empty_cache()

            b = trainer("b")
            b.train(TRAIN_CRASH_AT)
            b.crash()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            rep = b.recover()
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t0
            check(rep["restored_step"] == TRAIN_SYNC_EVERY
                  and rep["replayed"] == TRAIN_CRASH_AT - TRAIN_SYNC_EVERY,
                  f"recovery after a crash at step {TRAIN_CRASH_AT}: {rep}")
            b.train(TRAIN_STEPS - b.step)
            check(b.params_digest() == want[0],
                  "the recovered trainer's weights differ from the "
                  "uninterrupted run's")
            check(state_digest(b.opt_state) == want[1],
                  "the recovered trainer's Adam moments differ from the "
                  "uninterrupted run's")
            records = _check_journal(b, "B")
            corrupt_step, corrupt_s = _corrupt_backup(b)
            sync_log += b.sync_log
            shutil.rmtree(b.root)
        info = _train_report(np, card, cfg, dict(
            n_params=n_params, built_s=built_s, step_ms=step_ms,
            a_wall=a_wall, journal_ms=[journal_s[i][0] * 1e3 for i in
                                       range(TRAIN_STEPS)],
            fsync_ms=[journal_s[i][1] * 1e3 for i in range(TRAIN_STEPS)],
            losses=losses, peak_cuda_bytes=peak_mem,
            sync_log=sync_log, peak_disk_bytes=disk.peak,
            recover_s=recover_s, recovery=rep, records_per_witness=records,
            corrupt=dict(step=corrupt_step, restore_s=corrupt_s)))
        idle = info["idle"] = _train_idle(torch, b)
        del b
        torch.cuda.empty_cache()
        info["numerics"] = _train_numerics(np, torch, card, cfg, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launched = kops.launch_counts()
    check(not any(launched.values()),
          f"training launched the port's kernels: {launched}")
    say(card, f"training: one step under the profiler: wall "
              f"{idle['wall_ms']:.1f} ms, device busy "
              + ("not measured" if idle["busy_ms"] is None else
                 f"{idle['busy_ms']:.1f} ms, idle share "
                 f"{idle['idle_share']:.4f}")
              + "; none of the port's kernels launched")
    return info


# ---------------------------------------------------------------------------
# Phase 9: the sharded step (DTensor on a 1 x 1 mesh over NCCL)
# ---------------------------------------------------------------------------
def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _whole(t):
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _timed_steps(torch, run):
    """CUDA events around each of SHARD_STEPS calls of ``run``: ms each."""
    times = []
    for _ in range(SHARD_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in times]


def _counting(module, name, counts):
    """Wrap ``module.name`` so that each call adds one to ``counts[name]``;
    returns a function that puts the original back."""
    fn = getattr(module, name)

    def counted(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)

    setattr(module, name, counted)
    return lambda: setattr(module, name, fn)


def shard_arch(name):
    """A configuration phase 9 runs, at its published width."""
    from repro_torch.configs import ARCHS

    return ARCHS[name]


def _sharded_train(np, torch, card, mesh, device):
    """(a): one train step of llama3.2-1b at full width on plain tensors
    (no rules), then the same step from the same weights with every
    parameter, moment and batch tensor a DTensor under the "tp" rules;
    then SHARD_STEPS more sharded steps, timed."""
    from repro_torch.configs import SHAPES, ShapeSpec, concrete_batch
    from repro_torch.launch import dryrun, make_train_step
    from repro_torch.launch import sharding as sh
    from repro_torch.models import Transformer
    from repro_torch.models import layers as mlayers
    from repro_torch.models.shardctx import activation_sharding, heads_are_tp
    from repro_torch.optim import AdamWConfig, init_opt_state

    cfg = shard_arch(SHARD_ARCH)
    opt = AdamWConfig(warmup_steps=5, total_steps=1000)
    step = make_train_step(cfg, opt)
    batch = concrete_batch(cfg, "train", SHARD_BATCH, SHARD_SEQ, seed=SEED,
                           device=device)
    t0 = time.perf_counter()
    model = Transformer(cfg, device=device, seed=SEED)
    ostate = init_opt_state(model, opt, device)
    _, _, plain = step(model, ostate, batch)
    plain = {k: float(v) for k, v in plain.items()}
    plain_ms = _timed_steps(torch, lambda: step(model, ostate, batch))
    del model, ostate
    torch.cuda.empty_cache()

    shape = SHAPES["train_4k"]
    sizes = sh.axis_sizes(mesh)
    model = Transformer(cfg, device=device, seed=SEED)
    named = dict(model.named_parameters())
    pspec = sh.sanitize_specs(sh.state_specs(cfg, sh.param_specs(
        cfg, tp=sizes["model"])), named, sizes)
    ostate = init_opt_state(model, opt, device)
    sh.distribute_model(model, mesh, pspec)
    ostate = sh.distribute_tree(mesh, ostate, sh.opt_specs(pspec))
    bspec = sh.sanitize_specs(sh.batch_pspecs(
        cfg, shape, multi_pod=False, with_labels=True, n_dev=mesh.size()),
        batch, sizes)
    dbatch = sh.distribute_tree(mesh, batch, bspec)
    rules = sh.activation_rules(cfg, shape, mesh, multi_pod=False,
                                strategy="tp")
    counts = {}
    restore = _counting(mlayers, "_sdpa_blockwise_flat", counts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    try:
        with activation_sharding(rules):
            check(heads_are_tp(), "the tp rules leave heads_are_tp false")
            _, _, got = step(model, ostate, dbatch)
            got = {k: float(_whole(v)) for k, v in got.items()}
            first_calls = counts.get("_sdpa_blockwise_flat", 0)
            step_ms = _timed_steps(
                torch, lambda: metrics.append(step(model, ostate, dbatch)[2]))
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated()
    loss_final = float(_whole(metrics[-1]["loss"]))
    check(np.isfinite(loss_final), f"sharded {cfg.name}: loss {loss_final}")
    check(first_calls >= cfg.n_layers,
          f"sharded {cfg.name}: the flat-heads attention ran "
          f"{first_calls} times in a step of {cfg.n_layers} layers")
    rel = {k: abs(got[k] - plain[k]) / abs(plain[k])
           for k in ("loss", "grad_norm")}
    check(rel["loss"] <= SHARD_LOSS_RTOL,
          f"sharded {cfg.name}: loss {got['loss']!r} against the plain "
          f"step's {plain['loss']!r} ({rel['loss']:.3g} > "
          f"{SHARD_LOSS_RTOL})")
    check(rel["grad_norm"] <= SHARD_GNORM_RTOL,
          f"sharded {cfg.name}: grad norm {got['grad_norm']!r} against the "
          f"plain step's {plain['grad_norm']!r} ({rel['grad_norm']:.3g} > "
          f"{SHARD_GNORM_RTOL})")
    del model, ostate, dbatch, batch
    torch.cuda.empty_cache()
    cut = ShapeSpec("train_4k", "train", SHARD_SEQ, SHARD_BATCH)
    rec = dryrun.run_cell_isolated(SHARD_ARCH, cut, (1, 1), "1x1",
                                   strategy="tp")
    check(rec.get("status") == "ok", f"dry run of {cfg.name}: {rec}")
    p50 = float(np.percentile(step_ms, 50))
    plain_p50 = float(np.percentile(plain_ms, 50))
    built = time.perf_counter() - t0
    terms = rec["terms"]
    say(card, f"sharded {cfg.name} (a): {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, bf16, "
              f"batch {SHARD_BATCH} x {SHARD_SEQ}, every parameter, moment "
              f"and batch tensor a DTensor on the 1 x 1 mesh, the tp rules "
              f"of train_4k: heads_are_tp, the flat-heads attention "
              f"{first_calls} calls a step; loss {got['loss']:.6f} vs the "
              f"plain step's {plain['loss']:.6f} ({rel['loss']:.3g} "
              f"relative, tol {SHARD_LOSS_RTOL}), grad norm "
              f"{got['grad_norm']:.6f} vs {plain['grad_norm']:.6f} "
              f"({rel['grad_norm']:.3g}, tol {SHARD_GNORM_RTOL})")
    say(card, f"sharded {cfg.name} (a): step p50 {p50:.1f} ms over "
              f"{SHARD_STEPS} steps (CUDA events; each: "
              + ", ".join(f"{x:.1f}" for x in step_ms)
              + f"); the plain step's p50 {plain_p50:.1f} ms (each: "
              + ", ".join(f"{x:.1f}" for x in plain_ms)
              + f"); peak CUDA memory {peak / 2**30:.2f} GiB; the dry run's "
              f"bound for this cell at 1 x 1 (H100 constants): "
              f"{terms['bound_step_s'] * 1e3:.1f} ms ({terms['dominant']}: "
              f"compute {terms['compute_s'] * 1e3:.1f}, memory "
              f"{terms['memory_s'] * 1e3:.1f}, collective "
              f"{terms['collective_s'] * 1e3:.1f} ms; "
              f"{rec['flops_per_device'] / 1e12:.2f} TFLOP counted), "
              f"measured / bound {p50 / (terms['bound_step_s'] * 1e3):.1f}x "
              f"({built:.1f} s)")
    return dict(plain=plain, sharded=got, rel=rel, flat_calls=first_calls,
                step_ms=step_ms, step_p50=p50, plain_step_ms=plain_ms,
                plain_step_p50=plain_p50, peak_cuda_bytes=peak, dryrun=rec)


def _sharded_moe(np, torch, card, mesh, device):
    """(b): qwen2-moe-a2.7b at full width under "moe_ep": forward and loss
    at 1 x SHARD_MOE_SEQ under no_grad, every MoE through the shard_map
    dispatch on NCCL's all-to-all; the first MoE layer's routed output
    against the factored local body with identity collectives, on the
    same local tensors, bit for bit (deterministic algorithms on)."""
    from repro_torch.configs import SHAPES, concrete_batch
    from repro_torch.launch import sharding as sh
    from repro_torch.models import Transformer, loss_fn
    from repro_torch.models import moe as pmoe
    from repro_torch.models.shardctx import activation_sharding

    cfg = shard_arch(SHARD_MOE_ARCH)
    check(cfg.moe_dispatch == "capacity" and cfg.n_experts % mesh.size()
          == 0, f"{cfg.name}: dispatch {cfg.moe_dispatch}")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    sizes = sh.axis_sizes(mesh)
    shape = SHAPES["train_4k"]
    sh.distribute_model(model, mesh, sh.sanitize_specs(sh.state_specs(
        cfg, sh.param_specs(cfg, tp=sizes["model"])),
        dict(model.named_parameters()), sizes))
    batch = concrete_batch(cfg, "train", 1, SHARD_MOE_SEQ, seed=SEED,
                           device=device)
    dbatch = sh.distribute_tree(mesh, batch, sh.sanitize_specs(
        sh.batch_pspecs(cfg, shape, multi_pod=False, with_labels=True,
                        n_dev=mesh.size()), batch, sizes))
    rules = sh.activation_rules(cfg, shape, mesh, multi_pod=False,
                                strategy="moe_ep")
    counts, first = {}, []
    local = pmoe.moe_ep_local

    def recording(*args):
        out = local(*args)
        if not first:
            first.append((args, out))
        return out

    restores = [_counting(pmoe, "moe_mlp_shardmap", counts),
                _counting(pmoe.MeshComm, "_a2a", counts)]
    pmoe.moe_ep_local = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad(), activation_sharding(rules):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            loss, aux = loss_fn(cfg, model, dbatch)
            b.record()
            torch.cuda.synchronize()
            args, (out, aux_l) = first[0]
            want, want_aux = local(*args[:-1], pmoe.IdentityComm())
    finally:
        torch.use_deterministic_algorithms(det)
        pmoe.moe_ep_local = local
        for r in restores:
            r()
    fwd_ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated()
    loss = float(_whole(loss))
    check(np.isfinite(loss), f"{cfg.name} under moe_ep: loss {loss}")
    check(counts.get("moe_mlp_shardmap") == cfg.n_layers,
          f"{cfg.name}: the shard_map dispatch ran "
          f"{counts.get('moe_mlp_shardmap')} times for {cfg.n_layers} "
          f"layers")
    check(counts.get("_a2a") == 2 * cfg.n_layers,
          f"{cfg.name}: {counts.get('_a2a')} all-to-alls for "
          f"{cfg.n_layers} layers")
    check(torch.equal(out, want) and torch.equal(aux_l, want_aux),
          f"{cfg.name}: the first MoE layer's shard_map output differs from "
          f"its local body with identity collectives (max "
          f"{float((out.float() - want.float()).abs().max())})")
    say(card, f"sharded {cfg.name} (b): {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} of "
              f"d_ff {cfg.moe_d_ff}, {cfg.n_shared_experts} shared; "
              f"{n_params:,} parameters in bf16 as DTensors, the moe_ep "
              f"rules: forward and loss at 1 x {SHARD_MOE_SEQ} in "
              f"{fwd_ms:.1f} ms (CUDA events, no_grad), peak CUDA memory "
              f"{peak / 2**30:.2f} GiB; the shard_map dispatch ran "
              f"{counts['moe_mlp_shardmap']} times on NCCL's all-to-all "
              f"({counts['_a2a']} calls), its first layer bit-equal to the "
              f"local body with identity collectives; loss {loss:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    del model, dbatch, batch, first, args
    torch.cuda.empty_cache()
    return dict(n_params=n_params, forward_ms=fwd_ms, peak_cuda_bytes=peak,
                loss=loss, shardmap_calls=counts["moe_mlp_shardmap"],
                all_to_all_calls=counts["_a2a"])


def _sharded_launch(card, device):
    """(c): the train launcher under torchrun at one process with
    --distributed, against the same run without it: equal digests."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    work = Path(tempfile.mkdtemp(prefix="curp_launch_"))
    out = {}
    t0 = time.perf_counter()
    runs = {
        "distributed": [sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node", "1", "-m",
                        "repro_torch.launch.train", "--distributed"],
        "one process": [sys.executable, "-m", "repro_torch.launch.train"]}
    procs = {}
    try:
        # both at once: each is one small trainer, deterministic alone; each
        # in a session of its own, so that torchrun's worker dies with it
        for name, pre in runs.items():
            procs[name] = subprocess.Popen(
                pre + ["--workdir", str(work / name.replace(" ", "_")),
                       "--device", device] + list(SHARD_LAUNCH_FLAGS),
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            check(proc.returncode == 0,
                  f"train launcher ({name}) exited {proc.returncode}: "
                  f"{stderr[-1500:]}")
            digests = [ln.split("digest ")[1] for ln in stdout.splitlines()
                       if "digest " in ln]
            check(len(digests) == 1, f"train launcher ({name}): "
                                     f"{stdout[-1500:]}")
            out[name] = digests[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    check(out["distributed"] == out["one process"],
          f"train launcher: digest {out['distributed']} under torchrun "
          f"--distributed, {out['one process']} without")
    say(card, f"sharded (c): torchrun --standalone --nproc_per_node 1 -m "
              f"repro_torch.launch.train --distributed "
              f"{' '.join(SHARD_LAUNCH_FLAGS)}: digest {out['distributed']}, "
              f"equal to the run without --distributed "
              f"({time.perf_counter() - t0:.1f} s, both at once)")
    return out


def phase_sharded(np, torch, card, device):
    """Phase 9 (launches counted from 0 over this phase alone; it must
    launch none of the port's kernels): NCCL on the card, gloo on the
    CPU (a rehearsal)."""
    import torch.distributed as dist

    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh_from

    kops.reset_launch_counts()
    if device == "cuda":
        torch.cuda.set_device(0)    # the device NCCL and the mesh use
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh_from((1, 1), ("data", "model"), device_type=device)
        info = dict(train=_sharded_train(np, torch, card, mesh, device),
                    moe=_sharded_moe(np, torch, card, mesh, device))
    finally:
        dist.destroy_process_group()
    info["launch"] = _sharded_launch(card, device)
    launched = kops.launch_counts()
    check(not any(launched.values()),
          f"the sharded step launched the port's kernels: {launched}")
    say(card, "sharded: none of the port's kernels launched")
    return info


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a checkout of the "
              "repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # Deterministic cuBLAS for phase 8's bit-exact replay: read when the
    # first cuBLAS handle is made, so set before torch is imported.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    wall = {"build": time.perf_counter() - t0}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        wall[name] = wall.get(name, 0.0) + time.perf_counter() - t
        return out

    key_lanes = run("parity", ycsb_key_lanes, np)
    par = run("parity", phase_parity, np, parity, card, "cuda", sync)
    par.update(run("parity", phase_table_parity, np, parity, card, "cuda",
                   sync, key_lanes))
    par.update(run("parity K9-K11", phase_txn_parity, np, parity, card,
                   "cuda", sync))
    dev_cluster, launches, slice_info = run("slice", phase_slice, np, card,
                                            "cuda", sync)
    table_launches, table_info = run("table path", phase_table_path, np,
                                     torch, card, "cuda", key_lanes)
    launches.update(table_launches)
    txn_launches, txn_info, txn_shapes = run("transactions", phase_txn, np,
                                             torch, card, "cuda", sync)
    launches.update({k: n for k, n in txn_launches.items()
                     if k not in launches})
    times = run("times", phase_times, np, torch, dev_cluster, card, "cuda")
    times.update(run("times", phase_table_times, np, torch, card, "cuda",
                     key_lanes))
    times.update(run("times K9-K11", phase_txn_times, np, torch, card,
                     "cuda", txn_shapes))
    idle = run("idle", phase_idle, np, torch, dev_cluster, card)
    serve_launches, serve_info = run("serving", phase_serving, np, torch,
                                     card, "cuda")
    ssm_info = run("ssm update", phase_ssm_update, np, torch, card, "cuda")
    attn_info = run("decode attention", phase_decode_attention, np, torch,
                    card, "cuda")
    train_info = run("training", phase_training, np, torch, card, "cuda")
    shard_info = run("sharded", phase_sharded, np, torch, card, "cuda")
    say(card, "wall s by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in wall.items())
        + f"; total {time.perf_counter() - t0:.1f}")
    errs = {k: p.max_abs_err for k, p in par.items()}
    # The Mamba2 state update: phase 7's launches, phase 7b's numbers at the
    # layer phase 7 serves (hymba-1.5b's).
    ssm = kops.SSM_UPDATE.name
    launches[ssm] = serve_launches[ssm]
    times[ssm] = ssm_info[SSM_SHAPES[0][0]]
    errs[ssm] = max(t["max_abs_err"] for t in ssm_info.values())
    # The decode attention: phase 7's launches, phase 7c's numbers at
    # hymba-1.5b's global ring at its cell's length.
    attn = kops.DECODE_ATTN.name
    launches[attn] = serve_launches[attn]
    times[attn] = attn_info[ATTN_CASES[0][0]]
    errs[attn] = max(t["max_abs_err"] for t in attn_info.values())
    kernels = []
    for k in kops.KERNELS:
        t = times[k.name]
        kernels.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[k.name], max_abs_err=errs[k.name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=None))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, slice=slice_info, table_path=table_info,
        txn=txn_info, txn_launches=txn_launches, times=times, idle=idle,
        serving=serve_info, serving_launches=serve_launches,
        ssm_update=ssm_info, decode_attention=attn_info,
        training=train_info, sharded=shard_info,
        wall_s=wall,
        ptxas=build.ptxas_reports()), indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
