"""Roofline terms of a dry-run cell.

A copy of ``repro.launch.hlo_analysis`` (it imports only ``re`` and
``typing``).  All numbers are PER-DEVICE, so the three roofline terms are
per-device times, equivalent to the total/(devices x rate) form.

``collective_bytes`` parses XLA's compiled HLO text, as the reference's dry
run feeds it: it sums the RESULT buffer sizes of every all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute instruction
(including -start forms), bucketed by collective type.  The port's dry run
has no HLO: ``launch.dryrun`` counts its collectives by the same rule (the
result sizes of the functional collectives each device runs) as it traces
the step, and uses ``analytic_hbm_bytes`` and ``roofline_terms`` from here.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"\b(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * b


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum per-device result-buffer bytes by collective type (of XLA's HLO
    text; the port's dry run has no HLO and counts its collectives by the
    same rule in ``launch.dryrun``)."""
    out: Dict[str, int] = {
        "all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0,
    }
    counts: Dict[str, int] = {k: 0 for k in out}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue  # -start carries the buffers; -done would double count
        kind = m.group(1)
        lhs = line.split(" = ", 1)
        if len(lhs) != 2:
            continue
        # Everything before the op name is the result type (tuple-aware).
        result_type = lhs[1][: lhs[1].find(m.group(0))]
        total = 0
        for dt, dims in _SHAPE_RE.findall(result_type):
            total += _shape_bytes(dt, dims)
        out[kind] += total
        counts[kind] += 1
    out_counts = {f"n_{k}": v for k, v in counts.items()}
    return {**out, **out_counts}


def analytic_hbm_bytes(cfg, shape, n_dev: int, tp: int, dp: int) -> float:
    """Per-device-per-step HBM traffic estimate (lower-bound napkin model).

    A count of 'bytes accessed' (XLA's, or the port's dry run's) takes
    EVERY op's operands with no fusion model, far above what a device's
    memory moves, so the memory roofline term uses this analytic model (the
    counted number is still recorded as memory_hlo_s).  Terms:

      weights  : dense params are ZeRO-gathered => read in full per pass
                 (train: fwd+bwd+remat = 3 passes); MoE expert params are
                 expert-stationary => /tp.
      optimizer: local param shard f32 m/v read+write + grad + param (train).
      acts     : residual-stream saves/restores + block boundary I/O,
                 ~6 x tokens x D x L (train), 2 x (prefill/decode).
      kv       : attention K/V gathered per layer (seq-sharded scheme);
                 decode reads the cache shard (C/tp per model rank).
      logits   : [tokens, V] write + re-read(s).
    """
    act = 2.0  # bf16
    S = shape.seq_len
    B = shape.global_batch
    kind = shape.kind
    L = cfg.n_layers
    d = cfg.d_model
    V = cfg.vocab
    b_dev = max(B // dp, 1)
    tokens_dev = b_dev * (1 if kind == "decode" else S) / (
        tp if kind != "decode" and S % tp == 0 else 1
    )
    P_tot = cfg.n_params()
    expert_params = (
        L * cfg.n_experts * 3 * d * cfg.moe_d_ff if cfg.has_moe else 0
    )
    dense_params = P_tot - expert_params
    passes = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[kind]
    if kind == "decode":
        # weight-stationary decode (param_specs_decode): each device reads only
        # its weight shard per token step.
        shard = tp if cfg.n_params() * act / tp < 8e9 else n_dev
        w = (dense_params + expert_params) * act / shard
    else:
        w = passes * (dense_params + expert_params / tp) * act
    o = (P_tot / n_dev) * 16.0 if kind == "train" else 0.0
    a_mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[kind]
    a = a_mult * tokens_dev * d * L * act
    kv = 0.0
    if cfg.has_attn:
        hkv = cfg.n_kv_heads * cfg.d_head
        if kind == "decode":
            # global-attn layers read C/tp of cache; swa layers read window
            n_glob = (
                L if cfg.attn == "full" else len(cfg.global_attn_layers)
            )
            n_swa = L - n_glob if cfg.attn == "swa" else 0
            kv = b_dev * 2 * act * hkv * (
                n_glob * (S / tp) + n_swa * min(cfg.swa_window, S)
            )
        else:
            # K/V gathered per layer per device (fwd; bwd re-gathers)
            kv = passes * L * b_dev * S * hkv * 2 * act
    ssm_t = 0.0
    if cfg.ssm:
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        if kind == "decode":
            ssm_t = b_dev * L * state * 2 * act
        else:
            n_chunks = max(S // cfg.ssm_chunk, 1)
            ssm_t = tokens_dev / S * n_chunks * L * state * 2 * act if S else 0
    lg_mult = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[kind]
    lg = lg_mult * tokens_dev * V * act if kind != "prefill" else (
        b_dev * V * act  # prefill emits last-token logits only
    )
    return w + o + a + kv + ssm_t + lg


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    *,
    peak_flops: float,
    hbm_bw: float,
    ici_bw: float,
    analytic_bytes_per_device: float | None = None,
) -> Dict[str, float]:
    compute_s = flops_per_device / peak_flops
    memory_hlo_s = bytes_per_device / hbm_bw
    memory_s = (
        analytic_bytes_per_device / hbm_bw
        if analytic_bytes_per_device is not None else memory_hlo_s
    )
    coll_s = coll_bytes_per_device / ici_bw
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
        key=lambda kv: kv[1],
    )[0]
    total = max(compute_s, memory_s, coll_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "memory_hlo_s": memory_hlo_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "bound_step_s": total,
    }
