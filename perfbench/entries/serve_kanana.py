"""The kanana cell: kanana-2-30b-a3b served through ``CurpServeDriver`` in
``entries/serve_granite.py``'s serving window.

Traffic parameters as ``entries/serve.py`` takes them (``sessions``,
``prompt_min``/``prompt_max``, ``warm_steps``, ``trace_steps``,
``check_sessions``, ``gap_limit``).  The model config is built before any
weight is drawn, so a program that lacks one of its fields (multi-head
latent attention, the leading dense layer, the sigmoid router) fails at
once.  The weights, the benchmark's input, are drawn on the card from the
seed in one bf16 ``randn`` (30.67e9 values, 61.34 GB) and adopted by
``Transformer.from_state_dict`` without a copy.  After the window the
driver and its caches are freed and the f32 reference
(``reference/kanana.py``, attention in the expanded form) reads those same
bf16 tensors, one weight at a time, over the sampled sessions.

``served_logit_gap`` is read as ``entries/serve_granite.py`` reads it: at
each served position the gap by which the served token's reference logit
lies below the reference's best, in units of that position's reference
logit spread, averaged over the session's served positions; the widest
sampled session's mean is compared with ``gap_limit``.  The limit and the
readings it rests on are in PERF.md.

Besides granite's window this entry reads the program's MLA counters at
the window's edges (``mla.slots_read``, ``mla.slots_live``: the driver's
host counts a step) for ``mla.live_share``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

from perfbench import counts_kanana, harness
from perfbench.reference import kanana as ref

# This entry's own instance of serve_granite.py (loaded by path, shared
# with no other cell), with kanana's layout and reference bound in below:
# its make_weights draws kanana's weights and its check_gaps reads the
# served gaps against kanana's reference, as the granite cell does.
_granite = harness.load_module(Path(__file__).with_name("serve_granite.py"))
MLA_COUNTERS = ("mla.slots_read", "mla.slots_live")
# config.json keys the program builds at one value only, and so does not
# take as fields: no q-LoRA, interleaved RoPE, renormalised picks, one
# expert group.
BUILT = {"q_lora_rank": None, "rope_interleave": True,
         "norm_topk_prob": True, "n_group": 1, "topk_group": 1}


def check_built(config: dict) -> None:
    """Raise where the configuration's top-level keys ask for a form the
    program does not build (``BUILT``)."""
    other = {k: config[k] for k, v in BUILT.items()
             if k in config and config[k] != v}
    if other:
        raise ValueError(f"the program builds {BUILT}, not {other}")


def layout(m: dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """(name, shape, init) of every parameter, in the program's names: init
    is a standard deviation (drawn) or ("value", what) for the fixed
    ones."""
    d, H, V = m["d_model"], m["n_heads"], m["vocab"]
    r, dv = m["kv_lora_rank"], m["v_head_dim"]
    dn, dr = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    E, ff, sff, dff = m["n_experts"], m["moe_d_ff"], m["shared_d_ff"], \
        m["d_ff"]
    # Each product keeps its input's scale (std 1/sqrt(fan-in)), and the
    # untied embedding is drawn at 1, a block output's scale, but for the
    # routed experts' down-projection, at 0.2/sqrt(fan-in).  The sigmoid
    # router weighs its six picks near equally (~2.448/6 each), and the
    # 6th and 7th of 128 scores lie ~0.01 apart, so bf16 rounding alone
    # flips picks, each moving ~0.4 of a layer's expert output: at
    # 1/sqrt(fan-in) the random model's logits decorrelate from the f32
    # reference's and the check could not tell bf16 from the fp8 control
    # (PERF.md section 4).  The correction bias at 0.02: near that gap,
    # so it moves some picks and not most.
    out = [("embed", (V, d), 1.0)]
    for i in range(m["n_layers"]):
        p = f"blocks.{i}."
        out += [
            (p + "norm1", (d,), ("value", "ones")),
            (p + "attn.wq", (d, H * (dn + dr)), d ** -0.5),
            (p + "attn.wkv_a", (d, r + dr), d ** -0.5),
            (p + "attn.kv_norm", (r,), ("value", "ones")),
            (p + "attn.wkv_b", (r, H * (dn + dv)), r ** -0.5),
            (p + "attn.wo", (H * dv, d), (H * dv) ** -0.5),
            (p + "norm2", (d,), ("value", "ones")),
        ]
        if i < m["first_k_dense"]:
            out += [
                (p + "mlp.w_gate", (d, dff), d ** -0.5),
                (p + "mlp.w_up", (d, dff), d ** -0.5),
                (p + "mlp.w_down", (dff, d), dff ** -0.5),
            ]
        else:
            out += [
                (p + "moe.router", (d, E), d ** -0.5),
                (p + "moe.correction_bias", (E,), 0.02),
                (p + "moe.w_gate", (E, d, ff), d ** -0.5),
                (p + "moe.w_up", (E, d, ff), d ** -0.5),
                (p + "moe.w_down", (E, ff, d), 0.2 * ff ** -0.5),
                (p + "moe.shared.w_gate", (d, sff), d ** -0.5),
                (p + "moe.shared.w_up", (d, sff), d ** -0.5),
                (p + "moe.shared.w_down", (sff, d), sff ** -0.5),
            ]
    return out + [("final_norm", (d,), ("value", "ones")),
                  ("lm_head", (d, V), d ** -0.5)]


_granite.layout, _granite.ref = layout, ref


def _mla_counts() -> Dict[str, int]:
    from repro_torch.core.telemetry import registry

    snap = registry().snapshot("mla.")
    return {n: snap[n]["value"] for n in MLA_COUNTERS if n in snap}


def run(run) -> None:
    """granite's serving window over kanana; the MLA counters are read as
    the window opens (``setup_done``, which the window's first step
    follows) and once the serve returns (no step runs after the window)."""
    check_built(run.config)
    at_open: Dict[str, int] = {}
    setup_done = run.setup_done

    def window_opens():
        setup_done()
        at_open.update(_mla_counts())

    run.setup_done = window_opens
    _granite.serve(run, make_weights=_granite.make_weights,
                   check_gaps=_granite.check_gaps,
                   step_bytes=counts_kanana.decode_bytes,
                   step_flops=counts_kanana.decode_flops)
    for name, v in _mla_counts().items():
        if name in at_open:
            run.counts[name] = v - at_open[name]
