"""The benchmark's own yardstick: peaks of the card, and the bytes and
operations a call needs for its inputs.

The byte counts follow ``chip_smoke.py`` phase 4 (copied here so that a
change to the program cannot move them): each operand once, each probed
gang row's five planes once (occ, keys_hi, keys_lo, rpc_hi, rpc_lo of each
way), each table word the call must change and each reason counter it
bumps.  Where phase 4 diffs the table, these count only the words that
must change on an accepted record (its ``occ`` word), so the bound stays a
lower one and a share of it can never pass 100%.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 rate,
# at the card's full 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
N_PLANES_PROBED = 5          # occ, keys_hi, keys_lo, rpc_hi, rpc_lo


def probe_bytes(rows: np.ndarray, n_ways: int) -> int:
    return int(np.unique(rows).size) * n_ways * N_PLANES_PROBED * 4


def counter_bytes(lanes: np.ndarray, reasons: np.ndarray) -> int:
    """Each (lane, reason) counter bumped: read and written once."""
    keep = reasons > 0
    pairs = np.unique(lanes[keep].astype(np.int64) * 8 + reasons[keep])
    return int(pairs.size) * 8


def fastpath_bytes(*, n_ops: int, f: int, n_shards: int, n_slots: int,
                   n_classes: int, live_ring: int, appends: int,
                   rows: np.ndarray, row_lanes: np.ndarray,
                   reasons: np.ndarray, n_ways: int) -> int:
    """One fused batch, K3 with its K2 record stage (``gang_fastpath``).

    ``live_ring``: live ring entries of the touched shards before the
    batch; ``appends``: ops the ring appends; ``rows``/``row_lanes``/
    ``reasons``: the gang row, lane and reason of each of the n_ops x f
    witness copies."""
    return (n_ops * 6 * 4                 # keys, class, rpc, exec_pred
            + n_slots * 4                 # slot map
            + n_shards * (f + 2) * 4      # lane map, tail, count
            + n_classes * 4               # conflict-matrix rows
            + live_ring * 12              # live ring spans read
            + appends * 12 + n_shards * 4  # ring appends, new counts
            + n_ops * (f + 4) * 4         # reasons, conflicts, shard, q_hi/lo
            + probe_bytes(rows, n_ways)
            + int((reasons == 1).sum()) * 4   # occ of each inserted record
            + counter_bytes(row_lanes, reasons))


def groups_bytes(*, key_valid: np.ndarray, rows: np.ndarray,
                 lanes: np.ndarray, reasons: np.ndarray, n_ways: int) -> int:
    """One grouped record (``gang_groups``): each valid key's raw lanes,
    class and mixed lanes out, each group's lane, rpc and reason, the
    probed rows, the occ word of each inserted key and the counters."""
    n_keys = int(key_valid.sum())
    accepted = reasons == 1
    inserted = int((key_valid.reshape(len(reasons), -1)[accepted]).sum())
    return (n_keys * (12 + 8) + len(reasons) * (12 + 4)
            + probe_bytes(rows, n_ways) + inserted * 4
            + counter_bytes(lanes, reasons))


# ---------------------------------------------------------------------------
# the served model's decode step
# ---------------------------------------------------------------------------
def _layer_weights(m: dict) -> int:
    d, dh = m["d_model"], m["d_head"]
    n = d * m["n_heads"] * dh + 2 * d * m["n_kv_heads"] * dh \
        + m["n_heads"] * dh * d                       # wq, wk, wv, wo
    n += 3 * d * m["d_ff"]                            # swiglu MLP
    di = m["ssm_expand"] * d
    h = di // m["ssm_head_dim"]
    N = m["ssm_state"]
    conv_dim = di + 2 * N
    n += d * (2 * di + 2 * N + h) + conv_dim * m["ssm_conv"] + conv_dim \
        + 3 * h + di + di * d                         # the SSM mixer
    return n + 2 * d                                  # two norms


def matmul_params(m: dict) -> int:
    """Parameters every token reads whole: all layers and the LM head (the
    embedding is a gather of the token's row)."""
    return m["n_layers"] * _layer_weights(m) + m["d_model"] * m["vocab"]


def decode_bytes(m: dict, contexts) -> int:
    """Least bytes one decode step reads and writes (bf16 = 2 bytes): every
    weight once (the embedding's live rows only), each live row's attended
    K and V at its real context (a window layer at most ``swa_window``),
    its SSM and conv state read and written, its new K and V written, and
    the f32 logits."""
    d, dh, hkv = m["d_model"], m["d_head"], m["n_kv_heads"]
    di = m["ssm_expand"] * d
    h = di // m["ssm_head_dim"]
    conv_dim = di + 2 * m["ssm_state"]
    n_global = len(m["global_attn_layers"])
    n_window = m["n_layers"] - n_global
    total = 2 * matmul_params(m) + 2 * d * len(contexts)
    for ctx in contexts:
        kv = hkv * dh * 2 * 2                          # K and V, bf16
        total += (n_global * (ctx - 1)                 # cached K and V read
                  + n_window * (min(ctx, m["swa_window"]) - 1)) * kv
        total += m["n_layers"] * kv                    # the new K and V
        state = h * m["ssm_head_dim"] * m["ssm_state"] \
            + (m["ssm_conv"] - 1) * conv_dim
        total += m["n_layers"] * state * 2 * 2         # read and written
        total += m["vocab"] * 4                        # f32 logits
    return int(total)


def decode_flops(m: dict, contexts) -> int:
    """Model FLOPs of one decode step: 2 a multiplied parameter a live row,
    attention's two products at each row's real context, and the SSM's
    state update and read-out."""
    d, dh, hq = m["d_model"], m["d_head"], m["n_heads"]
    di = m["ssm_expand"] * d
    n_global = len(m["global_attn_layers"])
    n_window = m["n_layers"] - n_global
    total = 0
    for ctx in contexts:
        total += 2 * matmul_params(m)
        total += 4 * hq * dh * (n_global * ctx
                                + n_window * min(ctx, m["swa_window"]))
        total += m["n_layers"] * 6 * di * m["ssm_state"]
    return int(total)
