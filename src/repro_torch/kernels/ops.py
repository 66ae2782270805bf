"""Public wrappers of the kernels: one dispatch per call.

Counterpart of ``src/repro/kernels/ops.py``.  The gang ops:
``gang_record`` (K2), ``gang_record_groups`` (K5), ``gang_gc`` (K4) and
``gang_fastpath_batch`` (K3, with K2 as its record stage).  The single-table
ops: ``keyhash2x32`` and ``shard_route`` (K1), ``witness_record`` (K6),
``fastpath_batch`` (K7) and ``conflict_scan`` (K8), and the transaction
and baseline ops of one table: ``txn_probe`` (K9, on K1's mix),
``witness_gc`` (K10) and ``witness_record_seq`` (K11).  Beside them, two
kernels of the decode step that the JAX package leaves to XLA: the Mamba2
state update (``ssm_state_update_cuda``) and one layer's decode attention
(``decode_attention_cuda``).  Signatures, result
tuples and reason codes are the JAX package's, without its TPU-only options
(``interpret``, ``tile_sets``, ``block*``).

Each op pads its host (numpy) inputs to a power-of-two bucket as the JAX
version does (``_bucket``/``_pad_valid``), moves them to the table's device
in one copy, runs, and brings every host-side output back in one copy.  On
CUDA tensors it launches the hand-written kernels of ``csrc/``; on CPU
tensors it runs their plain versions in ``ref.py``; any other device
raises.  There is no fallback from one to the other.

Table ops take their device from the table; ``keyhash2x32``,
``shard_route`` and ``conflict_scan`` from a torch tensor among their
inputs, else from ``device`` (default ``"cuda"``, which raises without a
card).

The table planes, the rings and the ``[L, 5]`` counter plane are updated
IN PLACE (the JAX version donated their buffers instead); the results hand
back the same tensors, so callers rebind exactly as before.

``dispatch_count()`` counts public op calls on the port's telemetry
registry, as the JAX package counts jitted-program launches.  Each
:class:`CudaKernel` below also counts its own launches (``launches``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core.telemetry import span
from . import ref
from .build import CudaKernel, I, L, P
from .ref import GangTable, N_REASON_CODES, WitnessTable

# ---------------------------------------------------------------------------
# Host-side dispatch accounting (on the port's own telemetry registry)
# ---------------------------------------------------------------------------
_DISPATCH_COUNTER = "kernels.dispatches"


def _count_dispatch(n: int = 1) -> None:
    from ..core.telemetry import registry

    registry().counter(_DISPATCH_COUNTER).inc(n)


def dispatch_count() -> int:
    """Public op calls since the last reset (one per call, whatever
    the device)."""
    from ..core.telemetry import registry

    return registry().counter(_DISPATCH_COUNTER).value


def reset_dispatch_count() -> None:
    from ..core.telemetry import registry

    registry().counter(_DISPATCH_COUNTER).reset()


# ---------------------------------------------------------------------------
# The kernels of this slice
# ---------------------------------------------------------------------------
_CSRC = "src/repro_torch/kernels/csrc/"

GANG_RECORD = CudaKernel(
    "gang_record", _CSRC + "gang_record.cu",
    "src/repro/kernels/witness_record.py:681",
    {"gang_record_launch": [I, I] + [P] * 11 + [I] * 4 + [P] * 9})
GANG_FASTPATH = CudaKernel(
    "gang_fastpath", _CSRC + "gang_fastpath.cu",
    "src/repro/kernels/ops.py:787",
    {"gang_fastpath_launch": [I] + [P] * 6 + [I, P, I, I, I, P, I] + [P] * 3
     + [I, I] + [P] * 9})
GANG_GC = CudaKernel(
    "gang_gc", _CSRC + "gang_gc.cu",
    "src/repro/kernels/witness_record.py:943",
    {"gang_gc_launch": [I] + [P] * 6 + [I, P, I, I, I] + [P] * 9})
GANG_GROUPS = CudaKernel(
    "gang_record_groups", _CSRC + "gang_groups.cu",
    "src/repro/kernels/witness_record.py:846",
    {"gang_groups_launch": [I, I] + [P] * 9 + [I] * 3 + [P] * 11})

KEYHASH = CudaKernel(
    "keyhash", _CSRC + "keyhash.cu", "src/repro/kernels/keyhash.py:48",
    {"keyhash_launch": [I, P, P, P, P, P, I, P, P]})
WITNESS_RECORD = CudaKernel(
    "witness_record", _CSRC + "witness_table.cu",
    "src/repro/kernels/witness_record.py:258",
    {"witness_record_launch": [I] + [P] * 5 + [I] * 3 + [P] * 5})
FASTPATH_RECORD_SCAN = CudaKernel(
    "fastpath_record_scan", _CSRC + "fastpath_batch.cu",
    "src/repro/kernels/witness_record.py:307",
    {"fastpath_batch_launch": [I] + [P] * 5 + [I, P, I] + [P] * 3
     + [I, I, I] + [P] * 9})
CONFLICT_SCAN = CudaKernel(
    "conflict_scan", _CSRC + "conflict_scan.cu",
    "src/repro/kernels/conflict_scan.py:71",
    {"conflict_scan_launch": [I, P, P, P, P, I, P, P, P, I, P, P]})

TXN_PROBE = CudaKernel(
    "txn_probe", _CSRC + "witness_txn.cu",
    "src/repro/kernels/witness_record.py:496",
    {"txn_probe_launch": [I, P, P, P, P, I, I] + [P] * 8})
WITNESS_GC = CudaKernel(
    "witness_gc", _CSRC + "witness_gc.cu",
    "src/repro/kernels/witness_record.py:980",
    {"witness_gc_launch": [I, I] + [P] * 6})
WITNESS_RECORD_SEQ = CudaKernel(
    "witness_record_seq", _CSRC + "witness_seq.cu",
    "src/repro/kernels/witness_record.py:385",
    {"witness_seq_launch": [I, P, P, I, I] + [P] * 5,
     "witness_seq_path": [I, I, ctypes.POINTER(ctypes.c_int)]})

SSM_UPDATE = CudaKernel(
    "ssm_state_update", _CSRC + "ssm_update.cu",
    "none: src/repro/models/ssm.py ssm_decode is plain jnp",
    {"ssm_update_launch": [I] * 6 + [P] * 2 + [L] * 2 + [P] + [L] * 3
     + [P] + [L] * 3 + [P] + [L] * 3 + [P, L, P, P]})

DECODE_ATTN = CudaKernel(
    "decode_attention", _CSRC + "decode_attn.cu",
    "none: src/repro/models/layers.py attention_decode is plain jnp",
    {"decode_attn_launch": [I] * 6 + [ctypes.c_float] + [P] * 6})

GANG_KERNELS = (GANG_RECORD, GANG_FASTPATH, GANG_GC, GANG_GROUPS)
TABLE_KERNELS = (KEYHASH, WITNESS_RECORD, FASTPATH_RECORD_SCAN, CONFLICT_SCAN)
TXN_KERNELS = (TXN_PROBE, WITNESS_GC, WITNESS_RECORD_SEQ)
KERNELS = (GANG_KERNELS + TABLE_KERNELS + TXN_KERNELS
           + (SSM_UPDATE, DECODE_ATTN))


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# Launchers: same signatures as the plain versions in ref.py
# ---------------------------------------------------------------------------
_MATRIX: Dict[torch.device, torch.Tensor] = {}

# K3, K6 and K7 keep an item's batch position below bit 29 of a word whose
# upper bits are flags (smem_join.cuh); K2 holds its copies to the same.
_MAX_BATCH = 1 << 29


def _matrix(device: torch.device) -> torch.Tensor:
    m = _MATRIX.get(device)
    if m is None:
        m = _MATRIX[device] = torch.as_tensor(ref.conflict_matrix_np(),
                                              device=device)
    return m


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(device: torch.device, *tensors) -> None:
    """What the kernels take: contiguous int32 tensors on one CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"CUDA launcher called on {device}")
    for t in tensors:
        if t is None:
            continue
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"kernel operand must be a contiguous int32 tensor on "
                f"{device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def _record_launch(table: GangTable, n_sets: int, rows, rep: int, qh, ql,
                   r_hi, r_lo, cls, counters, *, k_hi=None, k_lo=None,
                   lanes=None, valid=None) -> torch.Tensor:
    """K2's one launch.  Given ``rows`` (K3's record stage), copy e of op
    e // rep goes to gang row ``rows[e]`` (a row outside [0, L * S) is
    padding, reason 0), as ``ref.record_copies_plain`` sets out; with
    ``rows`` None, op b hashes ``k_hi``/``k_lo`` into ``qh``/``ql`` and
    goes to its row at ``lanes[b]`` unless ``valid[b]`` != 1, one copy an
    op.  Returns reasons per copy."""
    dev = table.occ.device
    N = (k_hi if rows is None else rows).shape[0]
    if N >= _MAX_BATCH:
        raise ValueError(f"gang_record takes fewer than {_MAX_BATCH} "
                         f"copies, got {N}")
    R, W = table.occ.shape
    reasons = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return reasons
    m = _matrix(dev)
    GANG_RECORD.call(
        "gang_record_launch", N, rep, _ptr(k_hi), _ptr(k_lo), _ptr(lanes),
        _ptr(valid), _ptr(rows), _ptr(qh), _ptr(ql), _ptr(r_hi), _ptr(r_lo),
        _ptr(cls), _ptr(m), m.numel(), R, n_sets, W,
        *(_ptr(p) for p in table), _ptr(reasons), _ptr(counters),
        _stream(dev))
    GANG_RECORD.launches += 1
    return reasons


def gang_record_cuda(table: GangTable, n_sets: int, k_hi, k_lo, k_cls,
                     k_valid, lanes, r_hi, r_lo, counters=None):
    """K2 on the card, one launch (no prep, no sort); see
    ``ref.gang_record_plain`` for the contract."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, k_cls, k_valid, lanes, r_hi, r_lo,
                counters)
    qh = torch.empty_like(k_hi)
    ql = torch.empty_like(k_hi)
    rsn = _record_launch(table, n_sets, None, 1, qh, ql, r_hi, r_lo, k_cls,
                         counters, k_hi=k_hi, k_lo=k_lo, lanes=lanes,
                         valid=k_valid)
    return rsn, qh, ql


def gang_groups_cuda(table: GangTable, n_sets: int, k_hi, k_lo, k_valid,
                     k_cls, lanes, r_hi, r_lo, g_valid, counters=None):
    """K5 on the card; see ``ref.gang_groups_plain`` for the contract."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, k_valid, k_cls, lanes, r_hi, r_lo,
                g_valid, counters)
    G, K = k_hi.shape
    if K > 1024:
        raise ValueError(f"gang_record_groups takes at most 1024 keys per "
                         f"group, got {K}")
    reasons = torch.empty(G, dtype=torch.int32, device=dev)
    qh = torch.empty_like(k_hi)
    ql = torch.empty_like(k_hi)
    if G == 0:
        return reasons, qh, ql
    m = _matrix(dev)
    GANG_GROUPS.call(
        "gang_groups_launch", G, K, _ptr(k_hi), _ptr(k_lo), _ptr(k_valid),
        _ptr(k_cls), _ptr(lanes), _ptr(r_hi), _ptr(r_lo), _ptr(g_valid),
        _ptr(m), m.numel(), n_sets, table.occ.shape[1],
        *(_ptr(p) for p in table), _ptr(reasons), _ptr(qh), _ptr(ql),
        _ptr(counters), _stream(dev))
    GANG_GROUPS.launches += 1
    return reasons, qh, ql


def gang_gc_cuda(table: GangTable, n_sets: int, g_hi, g_lo, g_rh, g_rl,
                 g_lane, g_valid, aged_idx, do_age: bool, *,
                 g_lane_host: Optional[np.ndarray] = None,
                 aged_host: Optional[np.ndarray] = None):
    """K4 on the card, one launch; see ``ref.gang_gc_plain`` for the
    contract.  ``g_lane`` must lie in [0, L) and ``aged_idx`` must hold
    distinct lanes in [0, L), both checked here on the host: from
    ``g_lane_host`` and ``aged_host``, the host arrays the device tensors
    were copied from, where the caller has them (``gang_gc`` does), else
    from one copy back of each."""
    L = _n_lanes(table, n_sets)
    # An entry's lane indexes the entry blocks' shared bitmap of aged
    # lanes, and each tile of an aged lane has one owning block: a lane out
    # of range would read or write past the bitmap, a repeated aged lane
    # give a tile two owners.
    _check_range("g_lane", g_lane.cpu().numpy() if g_lane_host is None
                 else np.asarray(g_lane_host), L)
    n_aged = aged_idx.shape[0] if do_age else 0
    if n_aged:
        aged = (aged_idx.cpu().numpy() if aged_host is None
                else np.asarray(aged_host))
        _check_range("aged_idx", aged, L)
        if np.unique(aged).size != n_aged:
            raise ValueError(f"aged_idx repeats a lane: {aged.tolist()}")
    dev = g_hi.device
    _check_cuda(dev, *table, g_hi, g_lo, g_rh, g_rl, g_lane, g_valid,
                aged_idx)
    W = table.occ.shape[1]
    if W > 32:
        raise ValueError(f"gang_gc takes at most 32 ways, got {W}")
    G = g_hi.shape[0]
    cleared = torch.empty(G, dtype=torch.int32, device=dev)
    way_mask = torch.empty(G, dtype=torch.int32, device=dev)
    if G == 0 and n_aged == 0:
        return cleared
    GANG_GC.call(
        "gang_gc_launch", G, _ptr(g_hi), _ptr(g_lo), _ptr(g_rh), _ptr(g_rl),
        _ptr(g_lane), _ptr(g_valid), n_aged, _ptr(aged_idx), L, n_sets, W,
        *(_ptr(p) for p in table),
        _ptr(cleared), _ptr(way_mask), _stream(dev))
    GANG_GC.launches += 1
    return cleared


def gang_fastpath_cuda(table: GangTable, n_sets: int, f: int,
                       k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, exec_pred,
                       slot_map, lane_map, ring_hi, ring_lo, ring_cls,
                       tail, count, counters=None):
    """K3 on the card: its own launch, then K2's (the record stage), and
    no other; see ``ref.gang_fastpath_plain`` for the contract.  The slot
    map's shards must lie in [0, NS) and count + appends fit CAP, as
    ``gang_fastpath_batch`` checks on the host."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, k_cls, k_valid, r_hi, r_lo,
                exec_pred, slot_map, lane_map, ring_hi, ring_lo, ring_cls,
                tail, count, counters)
    B = k_hi.shape[0]
    R = table.occ.shape[0]
    NS, CAP = ring_hi.shape
    if NS < 1 or B >= _MAX_BATCH:
        raise ValueError(f"gang_fastpath takes at least one ring and fewer "
                         f"than {_MAX_BATCH} ops, got {NS} rings and {B} "
                         f"ops")
    qh = torch.empty_like(k_hi)
    ql = torch.empty_like(k_hi)
    shard = torch.empty_like(k_hi)
    rows_e = torch.empty(B * f, dtype=torch.int32, device=dev)
    conflicts = torch.empty_like(k_hi)
    new_count = torch.empty_like(count)
    m = _matrix(dev)
    GANG_FASTPATH.call(
        "gang_fastpath_launch", B, _ptr(k_hi), _ptr(k_lo), _ptr(k_cls),
        _ptr(k_valid), _ptr(exec_pred), _ptr(slot_map), slot_map.shape[0],
        _ptr(lane_map), f, n_sets, R, _ptr(m), m.numel(), _ptr(ring_hi),
        _ptr(ring_lo), _ptr(ring_cls), NS, CAP, _ptr(tail), _ptr(count),
        _ptr(qh), _ptr(ql), _ptr(shard), _ptr(rows_e), _ptr(conflicts),
        _ptr(new_count), _stream(dev))
    GANG_FASTPATH.launches += 1
    rsn = _record_launch(table, n_sets, rows_e, f, qh, ql, r_hi, r_lo, k_cls,
                         counters)
    return rsn, conflicts, shard, qh, ql, new_count


def keyhash_cuda(hi, lo, slot_map=None):
    """K1 on the card; see ``ref.keyhash_plain`` for the contract."""
    dev = hi.device
    _check_cuda(dev, hi, lo, slot_map)
    qh = torch.empty_like(hi)
    ql = torch.empty_like(hi)
    shard = None if slot_map is None else torch.empty_like(hi)
    n_slots = 0 if slot_map is None else slot_map.shape[0]
    KEYHASH.call("keyhash_launch", hi.shape[0], _ptr(hi), _ptr(lo), _ptr(qh),
                 _ptr(ql), _ptr(slot_map), n_slots, _ptr(shard), _stream(dev))
    KEYHASH.launches += 1
    return qh, ql, shard


def witness_record_cuda(table: WitnessTable, q_hi, q_lo, q_cls, q_valid):
    """K6 on the card, one launch (no sort); see
    ``ref.witness_record_plain`` for the contract.  Returns accept bits in
    batch order."""
    dev = q_hi.device
    _check_cuda(dev, *table, q_hi, q_lo, q_cls, q_valid)
    S, W = table.occ.shape
    B = q_hi.shape[0]
    if B >= _MAX_BATCH:
        raise ValueError(f"witness_record takes fewer than {_MAX_BATCH} "
                         f"queries, got {B}")
    accepted = torch.empty_like(q_hi)
    if B == 0:
        return accepted
    m = _matrix(dev)
    WITNESS_RECORD.call("witness_record_launch", B, _ptr(q_hi), _ptr(q_lo),
                        _ptr(q_cls), _ptr(q_valid), _ptr(m), m.numel(), S, W,
                        *(_ptr(p) for p in table), _ptr(accepted),
                        _stream(dev))
    WITNESS_RECORD.launches += 1
    return accepted


def fastpath_record_scan_cuda(table: WitnessTable, k_hi, k_lo, k_cls,
                              k_valid, slot_map, w_hi, w_lo, w_valid):
    """K7 on the card, one launch (no sort); see
    ``ref.fastpath_record_scan_plain`` for the contract."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, k_cls, k_valid, slot_map, w_hi,
                w_lo, w_valid)
    S, W = table.occ.shape
    if k_hi.shape[0] >= _MAX_BATCH:
        raise ValueError(f"fastpath_record_scan takes fewer than "
                         f"{_MAX_BATCH} queries, got {k_hi.shape[0]}")
    qh, ql, shard, accepted, conflicts = (torch.empty_like(k_hi)
                                          for _ in range(5))
    m = _matrix(dev)
    FASTPATH_RECORD_SCAN.call(
        "fastpath_batch_launch", k_hi.shape[0], _ptr(k_hi), _ptr(k_lo),
        _ptr(k_cls), _ptr(k_valid), _ptr(slot_map), slot_map.shape[0],
        _ptr(m), m.numel(), _ptr(w_hi), _ptr(w_lo), _ptr(w_valid),
        w_hi.shape[0], S, W, *(_ptr(p) for p in table), _ptr(qh), _ptr(ql),
        _ptr(shard), _ptr(accepted), _ptr(conflicts), _stream(dev))
    FASTPATH_RECORD_SCAN.launches += 1
    return accepted, conflicts, shard, qh, ql


def conflict_scan_cuda(w_hi, w_lo, w_valid, q_hi, q_lo, q_cls):
    """K8 on the card, one launch; see ``ref.conflict_scan_plain`` for the
    contract.  No queries, no launch."""
    dev = q_hi.device
    _check_cuda(dev, w_hi, w_lo, w_valid, q_hi, q_lo, q_cls)
    conflicts = torch.empty_like(q_hi)
    if q_hi.shape[0] == 0:
        return conflicts
    m = _matrix(dev)
    CONFLICT_SCAN.call("conflict_scan_launch", q_hi.shape[0], _ptr(q_hi),
                       _ptr(q_lo), _ptr(q_cls), _ptr(m), m.numel(),
                       _ptr(w_hi), _ptr(w_lo), _ptr(w_valid), w_hi.shape[0],
                       _ptr(conflicts), _stream(dev))
    CONFLICT_SCAN.launches += 1
    return conflicts


def txn_probe_cuda(table: WitnessTable, k_hi, k_lo, own, valid):
    """K9 on the card, one launch (also for K = 0, which accepts); see
    ``ref.txn_probe_plain`` for the contract."""
    dev = k_hi.device
    _check_cuda(dev, *table, k_hi, k_lo, own, valid)
    K = k_hi.shape[0]
    if K > 1024:
        raise ValueError(f"txn_probe takes at most 1024 keys, got {K}")
    S, W = table.occ.shape
    if W > 256:
        raise ValueError(f"txn_probe takes at most 256 ways, got {W}")
    acc = torch.empty(1, dtype=torch.int32, device=dev)
    hit, qh, ql = (torch.empty_like(k_hi) for _ in range(3))
    TXN_PROBE.call("txn_probe_launch", K, _ptr(k_hi), _ptr(k_lo), _ptr(own),
                   _ptr(valid), S, W, *(_ptr(p) for p in table), _ptr(acc),
                   _ptr(hit), _ptr(qh), _ptr(ql), _stream(dev))
    TXN_PROBE.launches += 1
    return acc, hit, qh, ql


def witness_gc_cuda(table: WitnessTable, g_hi, g_lo) -> None:
    """K10 on the card; see ``ref.witness_gc_plain`` for the contract.  No
    entries, no launch."""
    dev = g_hi.device
    _check_cuda(dev, *table, g_hi, g_lo)
    if g_hi.shape[0] == 0:
        return
    WITNESS_GC.call("witness_gc_launch", table.occ.numel(), g_hi.shape[0],
                    _ptr(g_hi), _ptr(g_lo), *(_ptr(p) for p in table),
                    _stream(dev))
    WITNESS_GC.launches += 1


def witness_record_seq_staged(table: WitnessTable) -> bool:
    """Whether K11 walks ``table`` staged in shared memory (its three
    planes fit the shared memory a block may opt into on the table's
    device) rather than in global memory."""
    _check_cuda(table.occ.device, *table)
    S, W = table.occ.shape
    staged = ctypes.c_int(0)
    WITNESS_RECORD_SEQ.call("witness_seq_path", S, W, ctypes.byref(staged))
    return bool(staged.value)


def witness_record_seq_cuda(table: WitnessTable, q_hi, q_lo) -> torch.Tensor:
    """K11 on the card, one launch (staged in shared memory or walking
    global memory, as :func:`witness_record_seq_staged` says); see
    ``ref.witness_record_seq_plain`` for the contract.  No queries, no
    launch."""
    dev = q_hi.device
    _check_cuda(dev, *table, q_hi, q_lo)
    S, W = table.occ.shape
    if W > 256:
        raise ValueError(f"witness_record_seq takes at most 256 ways, got "
                         f"{W}")
    accepted = torch.empty_like(q_hi)
    if q_hi.shape[0] == 0:
        return accepted
    WITNESS_RECORD_SEQ.call("witness_seq_launch", q_hi.shape[0], _ptr(q_hi),
                            _ptr(q_lo), S, W, *(_ptr(p) for p in table),
                            _ptr(accepted), _stream(dev))
    WITNESS_RECORD_SEQ.launches += 1
    return accepted


# The state sizes ssm_update.cu is instantiated for, and the float types of
# both model kernels (ssm_update.cu, decode_attn.cu).
SSM_STATE_SIZES = (16, 128)
_FLOAT_TYPES = (torch.bfloat16, torch.float32)


def ssm_state_update_cuda(state: torch.Tensor, dA: torch.Tensor,
                          xdt: torch.Tensor, Bm: torch.Tensor,
                          Cm: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """One Mamba2 layer's single-token state update on the card, one launch
    of ``ssm_update.cu``: ``state`` [B, H, P, N] is written IN PLACE where
    ``active`` [B] (int32) is > 0, and y [B, H, P] is returned for every
    row; see ``models.ssm.ssm_state_update_plain`` for the contract.
    The state is contiguous; ``dA`` [B, H], ``xdt`` [B, H, P], ``Bm`` and
    ``Cm`` [B, G, N] and ``active`` may be views with any strides, and
    every float operand has the state's type (bf16 or f32).  Anything
    else, or a tensor off the card, raises."""
    if state.dim() != 4:
        raise ValueError(f"ssm_state_update takes a [B, H, P, N] state, got "
                         f"{tuple(state.shape)}")
    B, H, P, N = state.shape
    G = Bm.shape[1] if Bm.dim() == 3 else 0
    if N not in SSM_STATE_SIZES:
        raise ValueError(f"ssm_state_update is built for state sizes "
                         f"{SSM_STATE_SIZES}, got N = {N}")
    if state.dtype not in _FLOAT_TYPES or any(
            t.dtype != state.dtype for t in (dA, xdt, Bm, Cm)) \
            or active.dtype != torch.int32:
        raise ValueError(
            f"ssm_state_update takes one float type of {_FLOAT_TYPES} and an "
            f"int32 active mask, got state {state.dtype}, dA {dA.dtype}, "
            f"xdt {xdt.dtype}, B {Bm.dtype}, C {Cm.dtype}, active "
            f"{active.dtype}")
    if G == 0 or H % G:
        raise ValueError(f"ssm_state_update: B is {tuple(Bm.shape)}, wanted "
                         f"[B, G, N] with G dividing H = {H}")
    for name, t, want in (("dA", dA, (B, H)), ("xdt", xdt, (B, H, P)),
                          ("B", Bm, (B, G, N)), ("C", Cm, (B, G, N)),
                          ("active", active, (B,))):
        if tuple(t.shape) != want:
            raise ValueError(f"ssm_state_update: {name} is "
                             f"{tuple(t.shape)}, wanted {want}")
    if not state.is_contiguous() or state.data_ptr() % 16:
        raise ValueError("ssm_state_update takes a contiguous state on a "
                         "16-byte boundary")
    dev = state.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (dA, xdt, Bm, Cm, active)):
        raise ValueError(f"ssm_state_update runs on one CUDA device, got "
                         f"the state on {dev}")
    y = torch.empty((B, H, P), dtype=state.dtype, device=dev)
    if state.numel() == 0:
        return y
    SSM_UPDATE.call("ssm_update_launch", int(state.dtype == torch.bfloat16),
                    N, B, H, P, G, _ptr(state),
                    *(a for t in (dA, xdt, Bm, Cm, active)
                      for a in (_ptr(t), *t.stride())),
                    _ptr(y), _stream(dev))
    SSM_UPDATE.launches += 1
    return y


# The head sizes decode_attn.cu is instantiated for (64 and 128 served, 16
# the reduced configs), and the most query heads one KV head may serve
# (nemotron-4-340b, dh 192 at 12 a KV head, is outside both).
DECODE_HEAD_DIMS = (16, 64, 128)
DECODE_MAX_REP = 8


def decode_attention_cuda(q: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor, cur_pos: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """One layer's single-token attention on the card, one launch of
    ``decode_attn.cu``: ``q`` [B, 1, Hq, dh] against each row's live slots
    of the ring ``kc``/``vc`` [B, C, Hkv, dh] (the first ``cur_pos[b] + 1``,
    or all C once ``cur_pos[b] >= C``), read in place; returns o [B, 1, Hq,
    dh].  See ``models.layers.sdpa_decode_plain`` for the contract.  The
    cache is contiguous, q and the cache share one float type (bf16 or
    f32), ``cur_pos`` is int32, Hkv divides Hq at most ``DECODE_MAX_REP``
    times and dh is one of ``DECODE_HEAD_DIMS``.  Anything else, or a
    tensor off the card, raises."""
    if q.dim() != 4 or kc.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention takes q [B, 1, Hq, dh] and a "
                         f"[B, C, Hkv, dh] cache, got {tuple(q.shape)} and "
                         f"{tuple(kc.shape)}")
    B, C, Hkv, dh = kc.shape
    Hq = q.shape[2]
    if (tuple(vc.shape) != tuple(kc.shape) or q.shape[0] != B
            or q.shape[3] != dh or tuple(cur_pos.shape) != (B,)
            or C == 0 or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(kc.shape)}, v {tuple(vc.shape)}, cur_pos "
                         f"{tuple(cur_pos.shape)} do not fit one layer")
    rep = Hq // Hkv
    if dh not in DECODE_HEAD_DIMS:
        raise ValueError(f"decode_attention is built for head sizes "
                         f"{DECODE_HEAD_DIMS}, got dh = {dh}")
    if not 1 <= rep <= DECODE_MAX_REP:
        raise ValueError(f"decode_attention serves 1 to {DECODE_MAX_REP} "
                         f"query heads a KV head, got {Hq} over {Hkv}")
    if kc.dtype not in _FLOAT_TYPES or q.dtype != kc.dtype \
            or vc.dtype != kc.dtype or cur_pos.dtype != torch.int32:
        raise ValueError(
            f"decode_attention takes one float type of {_FLOAT_TYPES} and "
            f"int32 positions, got q {q.dtype}, k {kc.dtype}, v {vc.dtype}, "
            f"cur_pos {cur_pos.dtype}")
    if not (kc.is_contiguous() and vc.is_contiguous()) \
            or kc.data_ptr() % 16 or vc.data_ptr() % 16:
        raise ValueError("decode_attention takes a contiguous cache on "
                         "16-byte boundaries")
    dev = kc.device
    if dev.type != "cuda" or any(t.device != dev for t in (q, vc, cur_pos)):
        raise ValueError(f"decode_attention runs on one CUDA device, got "
                         f"the cache on {dev}, q on {q.device}")
    o = torch.empty((B, 1, Hq, dh), dtype=q.dtype, device=dev)
    if B == 0:
        return o
    q, cur_pos = q.contiguous(), cur_pos.contiguous()
    DECODE_ATTN.call("decode_attn_launch", int(kc.dtype == torch.bfloat16),
                     dh, B, C, Hkv, rep, scale, _ptr(q), _ptr(kc), _ptr(vc),
                     _ptr(cur_pos), _ptr(o), _stream(dev))
    DECODE_ATTN.launches += 1
    return o


# The decode step's kernels by the serving counter that counts them.  A
# CUDA graph's replays launch them without the host, so the driver counts
# what the captured step launched, at every replay.
STEP_KERNELS = {"ssm.fused_updates": SSM_UPDATE,
                "attn.fused_decodes": DECODE_ATTN}


@contextlib.contextmanager
def step_launches():
    """Counts the launches of ``STEP_KERNELS`` made inside the block:
    yields a dict that holds them by counter name once the block ends."""
    before = {name: k.launches for name, k in STEP_KERNELS.items()}
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        made.update((name, STEP_KERNELS[name].launches - n)
                    for name, n in before.items())


# ---------------------------------------------------------------------------
# Host-side prep shared by the public ops
# ---------------------------------------------------------------------------
def _bucket(n: int, lo: int = 16) -> int:
    """Next power of two >= n (>= lo), as the JAX package pads."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _pad_valid(B: int, *arrays):
    """Pad 1-D arrays to the bucket size; returns (padded..., valid)."""
    pad = _bucket(B) - B
    valid = np.ones((B + pad,), np.int32)
    valid[B:] = 0
    out = tuple(
        np.concatenate([np.asarray(a), np.zeros((pad,), np.asarray(a).dtype)])
        if pad else np.asarray(a)
        for a in arrays
    )
    return out + (valid,)


def _to_device(device: torch.device, *arrays):
    """Move 4-byte numpy arrays to ``device`` in ONE copy; returns int32
    tensors (same bits, same shapes), each a contiguous view of the one
    buffer."""
    flat = [np.ascontiguousarray(a).view(np.int32).reshape(-1) for a in arrays]
    buf = torch.from_numpy(np.concatenate(flat)).to(device)
    out, off = [], 0
    for a, fl in zip(arrays, flat):
        out.append(buf[off:off + fl.size].view(np.asarray(a).shape))
        off += fl.size
    return out


def _to_host(*tensors):
    """Bring int32 tensors to numpy in ONE copy: the blocking wait for the
    device that every op ends in (one ``kernels.host_wait`` span a call)."""
    with span("kernels.host_wait"):
        flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(tuple(t.shape)))
        off += n
    return out


def _pick(device: torch.device, cuda_fn, plain_fn):
    if device.type == "cuda":
        return cuda_fn
    if device.type == "cpu":
        return plain_fn
    raise ValueError(f"gang ops run on CUDA or CPU tensors, not {device}")


def _n_lanes(table: GangTable, n_sets: int) -> int:
    return table.occ.shape[0] // n_sets


def _check_range(name: str, values: np.ndarray, hi: int) -> None:
    if values.size and (values.min() < 0 or values.max() >= hi):
        raise ValueError(f"{name} out of range [0, {hi}): "
                         f"{values.min()}..{values.max()}")


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------
class GangRecordResult(NamedTuple):
    """Result of one grouped gang record (all caller order)."""
    reasons: np.ndarray      # [G] reason code per group
    q_hi: np.ndarray         # [G, K] mixed lanes of every key (padding = 0)
    q_lo: np.ndarray         # [G, K]
    table: GangTable         # the gang table (updated in place)
    counters: Optional[torch.Tensor] = None  # [L, 5] reason counters, if fed


class GangFastPathResult(NamedTuple):
    """Result of one fused cluster-batch dispatch (all caller order)."""
    reasons: np.ndarray      # [B, f] reason code per op per witness copy
    conflicts: np.ndarray    # [B] device master-window conflict bit
    shard_ids: np.ndarray    # [B] slot-table placement
    q_hi: np.ndarray         # [B] mixed keyhash lanes
    q_lo: np.ndarray         # [B]
    table: GangTable         # the gang table (updated in place)
    ring_hi: torch.Tensor    # [NS, CAP] unsynced-window rings (in place)
    ring_lo: torch.Tensor    # [NS, CAP]
    counts: np.ndarray       # [NS] post-append live-entry count per ring
    ring_cls: torch.Tensor   # [NS, CAP] merge-lattice class per ring entry
    counters: Optional[torch.Tensor] = None  # [L, 5] reason counters, if fed


def record_operands(table: GangTable, n_sets: int, key_hi, key_lo, lanes,
                    rpc_hi, rpc_lo, key_cls=None):
    """Host inputs of ``gang_record`` -> the padded device operands that
    ``gang_record_cuda`` and ``ref.gang_record_plain`` take after
    (table, n_sets): k_hi, k_lo, k_cls, k_valid, lanes, r_hi, r_lo."""
    key_hi = np.asarray(key_hi, np.uint32)
    (B,) = key_hi.shape
    key_cls = (np.zeros((B,), np.int32) if key_cls is None
               else np.asarray(key_cls, np.int32))
    lanes = np.asarray(lanes, np.int32)
    _check_range("lanes", lanes, _n_lanes(table, n_sets))
    key_hi, key_lo, key_cls, lanes, rpc_hi, rpc_lo, valid = _pad_valid(
        B, key_hi, np.asarray(key_lo, np.uint32), key_cls, lanes,
        np.asarray(rpc_hi, np.uint32), np.asarray(rpc_lo, np.uint32),
    )
    return _to_device(table.occ.device, key_hi, key_lo, key_cls, valid,
                      lanes, rpc_hi, rpc_lo)


def gang_record(table: GangTable, n_sets: int, key_hi, key_lo, lanes,
                rpc_hi, rpc_lo, key_cls=None, *, counters=None):
    """Set-parallel single-key record over the gang: ONE dispatch for a
    batch of [B] single-key ops (each with its own lane and rpc identity).
    ``key_cls`` is the optional [B] merge-lattice class (default SET).

    Returns (reasons [B], q_hi [B], q_lo [B], table) as numpy outputs in
    caller order; with the optional ``counters`` plane ([L, 5] int32, one
    count per op at its lane, added in the same launch) the tuple grows a
    fifth element, the plane itself."""
    _count_dispatch()
    B = np.asarray(key_hi).shape[0]
    operands = record_operands(table, n_sets, key_hi, key_lo, lanes, rpc_hi,
                               rpc_lo, key_cls)
    fn = _pick(table.occ.device, gang_record_cuda, ref.gang_record_plain)
    rsn, qh, ql = _to_host(*fn(table, n_sets, *operands, counters))
    out = (rsn[:B], qh.view(np.uint32)[:B], ql.view(np.uint32)[:B], table)
    return out + (counters,) if counters is not None else out


def groups_operands(table: GangTable, n_sets: int, key_hi, key_lo,
                    key_valid, lanes, rpc_hi, rpc_lo, key_cls=None):
    """Host inputs of ``gang_record_groups`` -> the padded device operands
    of ``gang_groups_cuda`` / ``ref.gang_groups_plain``: k_hi, k_lo,
    k_valid, k_cls ([Gp, Kp]), lanes, r_hi, r_lo, g_valid ([Gp])."""
    key_hi = np.asarray(key_hi, np.uint32)
    G, K = key_hi.shape
    key_cls = (np.zeros((G, K), np.int32) if key_cls is None
               else np.asarray(key_cls, np.int32))
    lanes = np.asarray(lanes, np.int32)
    _check_range("lanes", lanes, _n_lanes(table, n_sets))
    Gp, Kp = _bucket(G, lo=4), _bucket(K, lo=2)
    pad2 = ((0, Gp - G), (0, Kp - K))
    g_valid = np.zeros((Gp,), np.int32)
    g_valid[:G] = 1
    return _to_device(
        table.occ.device, np.pad(key_hi, pad2),
        np.pad(np.asarray(key_lo, np.uint32), pad2),
        np.pad(np.asarray(key_valid, np.int32), pad2), np.pad(key_cls, pad2),
        np.pad(lanes, (0, Gp - G)),
        np.pad(np.asarray(rpc_hi, np.uint32), (0, Gp - G)),
        np.pad(np.asarray(rpc_lo, np.uint32), (0, Gp - G)), g_valid)


def gang_record_groups(table: GangTable, n_sets: int, key_hi, key_lo,
                       key_valid, lanes, rpc_hi, rpc_lo, key_cls=None,
                       *, counters=None) -> GangRecordResult:
    """Batched per-group all-or-nothing record: ONE dispatch for a whole
    batch of (possibly multi-key) ops.

    ``key_hi``/``key_lo``/``key_valid`` are [G, K] RAW keyhash lanes padded
    to a common key count; ``key_cls`` is the optional [G, K] class per key
    (default SET); ``lanes``/``rpc_hi``/``rpc_lo`` are [G].  Groups resolve
    in index order with the Python witness's placement semantics.  With
    ``counters``, one count per group is added at its lane in the same
    launch."""
    _count_dispatch()
    G, K = np.asarray(key_hi).shape
    operands = groups_operands(table, n_sets, key_hi, key_lo, key_valid,
                               lanes, rpc_hi, rpc_lo, key_cls)
    fn = _pick(table.occ.device, gang_groups_cuda, ref.gang_groups_plain)
    rsn, qh, ql = _to_host(*fn(table, n_sets, *operands, counters))
    return GangRecordResult(rsn[:G], qh.view(np.uint32)[:G, :K],
                            ql.view(np.uint32)[:G, :K], table, counters)


def gc_host_operands(table: GangTable, n_sets: int, g_hi, g_lo, g_rpc_hi,
                     g_rpc_lo, g_lane, aged_lanes):
    """Host inputs of ``gang_gc`` -> the padded host arrays of the operands
    of ``gang_gc_cuda`` / ``ref.gang_gc_plain``: g_hi, g_lo, g_rh, g_rl,
    g_lane, g_valid, aged_idx (the ids of the lanes to age); ``g_lane``
    checked in range, ``aged_idx`` distinct and in range by
    construction."""
    g_hi = np.asarray(g_hi, np.uint32)
    (G,) = g_hi.shape
    L = _n_lanes(table, n_sets)
    g_lane = np.asarray(g_lane, np.int32)
    _check_range("g_lane", g_lane, L)
    aged = np.asarray(aged_lanes, np.int32)
    if aged.shape != (L,):
        raise ValueError(f"aged_lanes must be an [{L}] mask, got {aged.shape}")
    g_hi, g_lo, g_rh, g_rl, g_lane, valid = _pad_valid(
        G, g_hi, np.asarray(g_lo, np.uint32),
        np.asarray(g_rpc_hi, np.uint32), np.asarray(g_rpc_lo, np.uint32),
        g_lane,
    )
    return (g_hi, g_lo, g_rh, g_rl, g_lane, valid,
            np.flatnonzero(aged == 1).astype(np.int32))


def gc_operands(table: GangTable, n_sets: int, g_hi, g_lo, g_rpc_hi,
                g_rpc_lo, g_lane, aged_lanes):
    """Host inputs of ``gang_gc`` -> the padded device operands of
    ``gang_gc_cuda`` / ``ref.gang_gc_plain`` (:func:`gc_host_operands`,
    in one copy)."""
    return _to_device(table.occ.device, *gc_host_operands(
        table, n_sets, g_hi, g_lo, g_rpc_hi, g_rpc_lo, g_lane, aged_lanes))


def gang_gc(table: GangTable, n_sets: int, g_hi, g_lo, g_rpc_hi, g_rpc_lo,
            g_lane, aged_lanes, *, do_age: bool = True):
    """Gang gc, ONE dispatch: rpc-matched clears plus in-kernel aging.

    Entry lanes are MIXED key lanes (as the record ops return them) plus
    the recording rpc identity and target lane; a slot clears only on a
    full (key, rpc, lane) match, so a stale entry never drops a newer
    same-key record.  ``aged_lanes`` is an [L] 0/1 mask of lanes whose
    survivors age this round; ``do_age=False`` is the rollback variant.
    Returns (cleared [G] numpy bit per entry, table)."""
    _count_dispatch()
    G = np.asarray(g_hi).shape[0]
    host = gc_host_operands(table, n_sets, g_hi, g_lo, g_rpc_hi, g_rpc_lo,
                            g_lane, aged_lanes)
    operands = _to_device(table.occ.device, *host)
    fn = _pick(table.occ.device,
               functools.partial(gang_gc_cuda, g_lane_host=host[4],
                                 aged_host=host[6]),
               ref.gang_gc_plain)
    (clr,) = _to_host(fn(table, n_sets, *operands, do_age))
    return clr[:G], table


def fastpath_operands(table: GangTable, n_sets: int, key_hi, key_lo,
                      rpc_hi, rpc_lo, exec_pred, slot_map, lane_map,
                      tail_slot, count, key_cls=None):
    """Host inputs of ``gang_fastpath_batch`` -> the padded device operands
    of ``gang_fastpath_cuda`` / ``ref.gang_fastpath_plain`` that come from
    the host: k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, exec_pred, slot_map,
    lane_map, tail, count (the rings are already on the device)."""
    slot_map = np.asarray(slot_map, np.int32)
    lane_map = np.asarray(lane_map, np.int32)
    NS, _f = lane_map.shape
    key_hi = np.asarray(key_hi, np.uint32)
    (B,) = key_hi.shape
    _check_range("slot_map", slot_map, NS)
    _check_range("lane_map", lane_map, _n_lanes(table, n_sets))
    key_cls = (np.zeros((B,), np.int32) if key_cls is None
               else np.asarray(key_cls, np.int32))
    key_hi, key_lo, key_cls, rpc_hi, rpc_lo, exec_pred, valid = _pad_valid(
        B, key_hi, np.asarray(key_lo, np.uint32), key_cls,
        np.asarray(rpc_hi, np.uint32), np.asarray(rpc_lo, np.uint32),
        np.asarray(exec_pred, np.int32),
    )
    return _to_device(table.occ.device, key_hi, key_lo, key_cls, valid,
                      rpc_hi, rpc_lo, exec_pred, slot_map, lane_map,
                      np.asarray(tail_slot, np.int32),
                      np.asarray(count, np.int32))


def gang_fastpath_batch(table: GangTable, n_sets: int, key_hi, key_lo,
                        rpc_hi, rpc_lo, exec_pred, slot_map, lane_map,
                        ring_hi, ring_lo, tail_slot, count,
                        *, key_cls=None, ring_cls=None,
                        counters=None) -> GangFastPathResult:
    """The whole cluster-batch hot loop in ONE dispatch:

        hash -> slot route -> ring conflict scan (device-resident master
        window, incl. in-batch growth) -> ring append -> record at every
        target shard's f witness lanes (rpc and age held in the table)

    ``lane_map`` is [NS, f] (gang lane of witness j of shard s);
    ``ring_hi``/``ring_lo`` are the [NS, CAP] per-shard unsynced-keyhash
    rings with ``tail_slot``/``count`` the live span (count + appends must
    fit CAP: callers drain first, and a batch that overflows raises).
    ``exec_pred[b] = 1`` marks ops that will execute at their master.
    ``key_cls`` ([B]) and ``ring_cls`` ([NS, CAP]) carry the merge-lattice
    classes (default SET).  Reasons and conflicts come back per op as
    numpy; rings and table stay on the device, updated in place."""
    NS, f = np.asarray(lane_map).shape
    _count_dispatch()
    B = np.asarray(key_hi).shape[0]
    if ring_hi.shape[0] != NS:
        raise ValueError(f"{ring_hi.shape[0]} rings for {NS} shards")
    dev = table.occ.device
    if ring_cls is None:
        ring_cls = torch.zeros(ring_hi.shape, dtype=torch.int32, device=dev)
    (k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, t_exec, t_slots, t_lanes,
     t_tail, t_count) = fastpath_operands(
        table, n_sets, key_hi, key_lo, rpc_hi, rpc_lo, exec_pred, slot_map,
        lane_map, tail_slot, count, key_cls)
    # Before the launch: the kernel appends in place beyond each live span,
    # which is safe only while count + appends fits CAP.
    slot_map = np.asarray(slot_map, np.int32)
    lo = ref.np_keyhash2x32(key_hi, key_lo)[1]
    shards = slot_map[lo % np.uint32(slot_map.shape[0])]
    appends = np.bincount(shards[np.asarray(exec_pred) == 1], minlength=NS)
    if (np.asarray(count, np.int64) + appends).max(initial=0) \
            > ring_hi.shape[1]:
        raise ValueError("ring overflow: count + appends exceeds CAP "
                         "(the caller must drain first)")
    fn = _pick(dev, gang_fastpath_cuda, ref.gang_fastpath_plain)
    rsn, con, shard, qh, ql, new_count = _to_host(*fn(
        table, n_sets, f, k_hi, k_lo, k_cls, k_valid, r_hi, r_lo, t_exec,
        t_slots, t_lanes, ring_hi, ring_lo, ring_cls, t_tail, t_count,
        counters))
    return GangFastPathResult(
        rsn.reshape(-1, f)[:B], con[:B], shard[:B],
        qh.view(np.uint32)[:B], ql.view(np.uint32)[:B], table,
        ring_hi, ring_lo, new_count, ring_cls, counters,
    )


# ---------------------------------------------------------------------------
# Single-table ops: the fast-path pipeline on one witness table
# ---------------------------------------------------------------------------
# Keys hash to one of DEFAULT_N_SLOTS slots (mixed low lane mod n_slots) and
# a slot -> shard table names the owner; it must match
# repro_torch.core.shard.N_SLOTS (the host SlotRouter).
DEFAULT_N_SLOTS = 256


def default_slot_map(n_shards: int,
                     n_slots: int = DEFAULT_N_SLOTS) -> np.ndarray:
    """Round-robin slot -> shard table: slot i is owned by shard i % N."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return (np.arange(n_slots, dtype=np.int32) % n_shards).astype(np.int32)


def _np(x, dtype) -> np.ndarray:
    """A host array of ``x`` (numpy, list or torch tensor) as ``dtype``;
    uint32 lanes given as int32 bit patterns keep their bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype, copy=False)


def _op_device(device, *inputs) -> torch.device:
    """The device of the first torch tensor among ``inputs``, else
    ``device``; a CUDA device that is absent raises."""
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return ref.resolve_device(x.device)
    return ref.resolve_device(device)


def _slot_map(n_shards, slot_map, n_slots) -> np.ndarray:
    if slot_map is None:
        slot_map = default_slot_map(n_shards, n_slots)
    slot_map = _np(slot_map, np.int32).reshape(-1)
    if slot_map.size == 0:
        raise ValueError("the slot map is empty")
    return slot_map


def _check_table(table: WitnessTable) -> None:
    """What the table kernels index by: three [S, W] planes, S a power of
    two."""
    shapes = {tuple(p.shape) for p in table}
    if len(shapes) != 1 or len(table.occ.shape) != 2:
        raise ValueError(f"table planes must share one [S, W] shape, got "
                         f"{sorted(shapes)}")
    S = table.occ.shape[0]
    if S & (S - 1):
        raise ValueError(f"n_sets must be a power of two, got {S}")


def _same_length(what: str, *arrays: np.ndarray) -> int:
    """The common length of 1-D host arrays that a kernel reads side by
    side (a shorter one would be read past its end)."""
    shapes = {a.shape for a in arrays}
    if len(shapes) != 1 or len(arrays[0].shape) != 1:
        raise ValueError(f"{what} must be 1-D of one length, got "
                         f"{sorted(shapes)}")
    return arrays[0].shape[0]


def keyhash2x32(hi, lo, *, device="cuda"):
    """Batched 64-bit-equivalent key hash (K1): raw (hi, lo) lanes -> the
    mixed (hi, lo) uint32 lanes, [N] numpy each, in caller order."""
    dev = _op_device(device, hi, lo)
    _count_dispatch()
    hi, lo = _np(hi, np.uint32), _np(lo, np.uint32)
    _same_length("hi and lo", hi, lo)
    t_hi, t_lo = _to_device(dev, hi, lo)
    fn = _pick(dev, keyhash_cuda, ref.keyhash_plain)
    qh, ql = _to_host(*fn(t_hi, t_lo)[:2])
    return qh.view(np.uint32), ql.view(np.uint32)


def shard_route(hi, lo, n_shards: Optional[int] = None, *, slot_map=None,
                n_slots: int = DEFAULT_N_SLOTS, device="cuda") -> np.ndarray:
    """Batched key -> shard placement by slot-table gather (K1 with the
    route): the keyhash2x32 mix, the mixed low lane mod ``n_slots`` picks a
    slot, ``slot_map[slot]`` names the shard.  Agrees with
    ``repro_torch.core.shard.SlotRouter`` on every map.  With only
    ``n_shards`` the round-robin ``default_slot_map`` is used.  Returns [N]
    int32 shard ids (numpy)."""
    if slot_map is None and n_shards is None:
        raise ValueError("shard_route needs n_shards or slot_map")
    dev = _op_device(device, hi, lo, slot_map)
    slot_map = _slot_map(n_shards, slot_map, n_slots)
    _count_dispatch()
    hi, lo = _np(hi, np.uint32), _np(lo, np.uint32)
    _same_length("hi and lo", hi, lo)
    t_hi, t_lo, t_map = _to_device(dev, hi, lo, slot_map)
    fn = _pick(dev, keyhash_cuda, ref.keyhash_plain)
    (shard,) = _to_host(fn(t_hi, t_lo, t_map)[2])
    return shard


def table_record_operands(table: WitnessTable, q_hi, q_lo, q_cls=None):
    """Host inputs of ``witness_record`` -> the padded device operands of
    ``witness_record_cuda`` / ``ref.witness_record_plain`` after the table:
    q_hi, q_lo, q_cls, q_valid."""
    _check_table(table)
    q_hi, q_lo = _np(q_hi, np.uint32), _np(q_lo, np.uint32)
    q_cls = (np.zeros(q_hi.shape, np.int32) if q_cls is None
             else _np(q_cls, np.int32))
    B = _same_length("q_hi, q_lo and q_cls", q_hi, q_lo, q_cls)
    return _to_device(table.occ.device, *_pad_valid(B, q_hi, q_lo, q_cls))


def witness_record(table: WitnessTable, q_hi, q_lo, q_cls=None):
    """Batched record of MIXED keyhash lanes into one witness table (K6):
    queries to one set resolve in batch order, sets in parallel.  The set
    is ``q_lo & (S-1)`` of the lanes given (no hashing).  ``q_cls`` is the
    optional per-query merge-lattice class (default SET).  Returns
    (accepted [B] int32 numpy, table); the table is updated in place."""
    _count_dispatch()
    B = len(q_hi)
    args = table_record_operands(table, q_hi, q_lo, q_cls)
    fn = _pick(table.occ.device, witness_record_cuda, ref.witness_record_plain)
    (acc,) = _to_host(fn(table, *args))
    return acc[:B], table


def scan_operands(device, w_hi, w_lo, w_valid, q_hi, q_lo, q_cls=None):
    """Host inputs of ``conflict_scan`` -> the device operands of
    ``conflict_scan_cuda`` / ``ref.conflict_scan_plain``: w_hi, w_lo,
    w_valid, q_hi, q_lo, q_cls (no padding: the kernel masks its edges)."""
    w_hi, w_lo = _np(w_hi, np.uint32), _np(w_lo, np.uint32)
    w_valid = _np(w_valid, np.int32)
    q_hi, q_lo = _np(q_hi, np.uint32), _np(q_lo, np.uint32)
    q_cls = (np.zeros(q_hi.shape, np.int32) if q_cls is None
             else _np(q_cls, np.int32))
    _same_length("w_hi, w_lo and w_valid", w_hi, w_lo, w_valid)
    _same_length("q_hi, q_lo and q_cls", q_hi, q_lo, q_cls)
    return _to_device(device, w_hi, w_lo, w_valid, q_hi, q_lo, q_cls)


def conflict_scan(w_hi, w_lo, w_valid, q_hi, q_lo, q_cls=None, *,
                  device="cuda") -> np.ndarray:
    """Commutativity check of B queries against a U-entry unsynced window
    (K8).  ``w_valid`` packs each entry's merge-lattice class (0 invalid,
    else 1 + class; legacy 0/1 callers get class SET); ``q_cls`` is the
    optional per-query class.  Returns [B] int32 conflict bits (numpy)."""
    dev = _op_device(device, w_hi, w_lo, w_valid, q_hi, q_lo, q_cls)
    _count_dispatch()
    args = scan_operands(dev, w_hi, w_lo, w_valid, q_hi, q_lo, q_cls)
    fn = _pick(dev, conflict_scan_cuda, ref.conflict_scan_plain)
    (con,) = _to_host(fn(*args))
    return con


class FastPathResult(NamedTuple):
    """Result of one fused fast-path batch (all [B], caller order)."""
    accepted: np.ndarray     # witness accept bit per op
    conflicts: np.ndarray    # master-window conflict bit per op
    shard_ids: np.ndarray    # slot-table placement (int32)
    q_hi: np.ndarray         # mixed keyhash lanes: callers extend their
    q_lo: np.ndarray         # unsynced window with these on accept
    table: WitnessTable      # the witness table (updated in place)


def table_fastpath_operands(table: WitnessTable, key_hi, key_lo,
                            key_cls=None, window_hi=None, window_lo=None,
                            window_valid=None, slot_map=None):
    """Host inputs of ``fastpath_batch`` -> the padded device operands of
    ``fastpath_record_scan_cuda`` / ``ref.fastpath_record_scan_plain`` after
    the table: k_hi, k_lo, k_cls, k_valid, slot_map, w_hi, w_lo, w_valid.
    The batch and the window are padded to power-of-two buckets; an empty
    window becomes one invalid entry."""
    _check_table(table)
    if window_hi is None or len(window_hi) == 0:
        if window_lo is not None and len(window_lo) > 0:
            raise ValueError("window_lo given without window_hi")
        w_hi = np.zeros((1,), np.uint32)
        w_lo = np.zeros((1,), np.uint32)
        w_val = np.zeros((1,), np.int32)
    else:
        if window_lo is None:
            raise ValueError("window_hi given without window_lo")
        w_hi = _np(window_hi, np.uint32)
        w_lo = _np(window_lo, np.uint32)
        w_val = (np.ones(w_hi.shape, np.int32) if window_valid is None
                 else _np(window_valid, np.int32))
    key_hi, key_lo = _np(key_hi, np.uint32), _np(key_lo, np.uint32)
    key_cls = (np.zeros(key_hi.shape, np.int32) if key_cls is None
               else _np(key_cls, np.int32))
    B = _same_length("key_hi, key_lo and key_cls", key_hi, key_lo, key_cls)
    U = _same_length("window_hi, window_lo and window_valid", w_hi, w_lo,
                     w_val)
    k_hi, k_lo, k_cls, k_valid = _pad_valid(B, key_hi, key_lo, key_cls)
    w_hi, w_lo, w_val, _ = _pad_valid(U, w_hi, w_lo, w_val)
    return _to_device(table.occ.device, k_hi, k_lo, k_cls, k_valid,
                      _slot_map(1, slot_map, DEFAULT_N_SLOTS), w_hi, w_lo,
                      w_val)


def fastpath_batch(table: WitnessTable, key_hi, key_lo, key_cls=None, *,
                   window_hi=None, window_lo=None, window_valid=None,
                   n_shards: int = 1, slot_map=None,
                   n_slots: int = DEFAULT_N_SLOTS) -> FastPathResult:
    """One fused dispatch for a whole update batch (K7):

        hash -> slot route -> witness record -> window conflict scan

    ``key_hi``/``key_lo`` are the RAW 64-bit keyhash lanes; the op mixes
    them, routes by ``slot_map`` (or the round-robin map of ``n_shards``),
    records the mixed lanes in the table and scans them against the
    master's unsynced window.  ``key_cls`` is the optional per-op class
    (default SET); the window arguments are MIXED lanes with
    ``window_valid`` packing 0 (invalid) or 1 + class (plain 0/1 means
    SET); omit them for an empty window.  Outputs are numpy; the table is
    updated in place."""
    slot_map = _slot_map(n_shards, slot_map, n_slots)
    _count_dispatch()
    B = len(key_hi)
    args = table_fastpath_operands(table, key_hi, key_lo, key_cls, window_hi,
                                   window_lo, window_valid, slot_map)
    fn = _pick(table.occ.device, fastpath_record_scan_cuda,
               ref.fastpath_record_scan_plain)
    acc, con, shard, qh, ql = _to_host(*fn(table, *args))
    return FastPathResult(acc[:B], con[:B], shard[:B], qh.view(np.uint32)[:B],
                          ql.view(np.uint32)[:B], table)


# ---------------------------------------------------------------------------
# Transaction and baseline ops of one table
# ---------------------------------------------------------------------------
class TxnProbeResult(NamedTuple):
    """Result of one all-or-nothing multi-key record (ONE dispatch)."""
    accepted: bool           # the whole op accepted (all keys placed/hit)
    hit: np.ndarray          # [K] same-key table hit per key (caller order)
    q_hi: np.ndarray         # mixed keyhash lanes of the op's keys: callers
    q_lo: np.ndarray         # gc with these, extend windows on accept
    table: WitnessTable      # updated iff accepted; bit-identical otherwise


def txn_probe_operands(table: WitnessTable, key_hi, key_lo, own=None):
    """Host inputs of ``txn_probe`` -> the padded device operands of
    ``txn_probe_cuda`` / ``ref.txn_probe_plain`` after the table: k_hi,
    k_lo, own, valid (K padded to a power-of-two bucket of at least 16)."""
    _check_table(table)
    key_hi, key_lo = _np(key_hi, np.uint32), _np(key_lo, np.uint32)
    own = (np.zeros(key_hi.shape, np.int32) if own is None
           else _np(own, np.int32))
    K = _same_length("key_hi, key_lo and own", key_hi, key_lo, own)
    return _to_device(table.occ.device, *_pad_valid(K, key_hi, key_lo, own))


def txn_probe(table: WitnessTable, key_hi, key_lo,
              own=None) -> TxnProbeResult:
    """All-or-nothing record of ONE multi-key op (K9, on K1's mix): a
    single dispatch on both the accept and the reject path.

    ``key_hi``/``key_lo`` are the RAW 64-bit keyhash lanes of the op's
    (deduplicated) keys; ``own[k] = 1`` marks keys the caller knows are
    already held under this op's rpc_id (idempotent retry).  The table is
    updated in place on accept and left bit-identical on reject, so callers
    can rebind ``result.table`` unconditionally."""
    _count_dispatch()
    K = len(key_hi)
    args = txn_probe_operands(table, key_hi, key_lo, own)
    fn = _pick(table.occ.device, txn_probe_cuda, ref.txn_probe_plain)
    acc, hit, qh, ql = _to_host(*fn(table, *args))
    return TxnProbeResult(bool(acc[0]), hit[:K], qh.view(np.uint32)[:K],
                          ql.view(np.uint32)[:K], table)


def table_gc_operands(table: WitnessTable, g_hi, g_lo):
    """Host inputs of ``witness_gc`` -> the device operands of
    ``witness_gc_cuda`` / ``ref.witness_gc_plain`` after the table: g_hi,
    g_lo (no padding; G may be 0)."""
    _check_table(table)
    g_hi, g_lo = _np(g_hi, np.uint32), _np(g_lo, np.uint32)
    _same_length("g_hi and g_lo", g_hi, g_lo)
    return _to_device(table.occ.device, g_hi, g_lo)


def witness_gc(table: WitnessTable, g_hi, g_lo) -> WitnessTable:
    """Clear synced entries (K10): ``occ <- 0`` in every occupied slot whose
    MIXED key lanes equal a gc entry's; key planes untouched.  ONE dispatch,
    also for an empty gc batch (which changes nothing).  Returns the table,
    updated in place."""
    _count_dispatch()
    args = table_gc_operands(table, g_hi, g_lo)
    _pick(table.occ.device, witness_gc_cuda, ref.witness_gc_plain)(table,
                                                                   *args)
    return table


def seq_operands(table: WitnessTable, q_hi, q_lo):
    """Host inputs of ``witness_record_seq`` -> the device operands of
    ``witness_record_seq_cuda`` / ``ref.witness_record_seq_plain`` after
    the table: q_hi, q_lo (no padding)."""
    _check_table(table)
    q_hi, q_lo = _np(q_hi, np.uint32), _np(q_lo, np.uint32)
    _same_length("q_hi and q_lo", q_hi, q_lo)
    return _to_device(table.occ.device, q_hi, q_lo)


def witness_record_seq(table: WitnessTable, q_hi, q_lo):
    """The pre-refactor sequential record (K11): MIXED lanes, the whole
    batch one ordered loop, classless (conflict on ``occ == 1`` exactly).
    Kept for old-vs-new measurement against ``witness_record`` (K6) and
    for differential tests.  Returns (accepted [B] int32 numpy, table); the
    table is updated in place."""
    _count_dispatch()
    args = seq_operands(table, q_hi, q_lo)
    fn = _pick(table.occ.device, witness_record_seq_cuda,
               ref.witness_record_seq_plain)
    (acc,) = _to_host(fn(table, *args))
    return acc, table


__all__ = [
    "GangTable", "GangRecordResult", "GangFastPathResult", "N_REASON_CODES",
    "gang_record", "gang_record_groups", "gang_gc", "gang_fastpath_batch",
    "WitnessTable", "FastPathResult", "DEFAULT_N_SLOTS", "default_slot_map",
    "keyhash2x32", "shard_route", "witness_record", "conflict_scan",
    "fastpath_batch", "TxnProbeResult", "txn_probe", "witness_gc",
    "witness_record_seq", "dispatch_count", "reset_dispatch_count",
    "launch_counts", "reset_launch_counts", "KERNELS", "GANG_KERNELS",
    "TABLE_KERNELS", "TXN_KERNELS", "CudaKernel",
    "SSM_STATE_SIZES", "ssm_state_update_cuda", "DECODE_HEAD_DIMS",
    "DECODE_MAX_REP", "decode_attention_cuda", "STEP_KERNELS",
    "step_launches",
]
