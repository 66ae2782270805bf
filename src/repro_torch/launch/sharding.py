"""Sharding rules: 2-D FSDP("data") x TP("model"), pod-DP on batch.

The torch port of ``repro.launch.sharding``, line for line over the port's
own spec type :class:`P`.  Parameters shard (data, model) jointly — ZeRO-3
over "data" (the gather happens at use) and tensor-parallel over "model"
(heads / d_ff / experts).  Head dims that don't divide the model axis stay
replicated on that axis (smollm 15H, hymba 25H, deepseek 56H, qwen2-vl
12H); their FSDP sharding still applies.  Optimizer moments reuse the
param specs.

The spec functions return trees shaped as the reference's: nested dicts
with every layer's parameters stacked on a leading ``L`` axis, so the two
packages' specs compare entry by entry.  :func:`state_specs` maps such a
tree onto the port's state-dict names (``blocks.{i}.attn.wq``), dropping
the ``L`` entry, by the walk that carries the reference's weights across
(``models.convert``).  :func:`to_placements` turns a spec into DTensor
placements on a ``DeviceMesh``, :func:`distribute_model` makes every
parameter of a module a DTensor, and :func:`activation_rules` gives the
rules that ``models.shardctx.constrain`` applies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping

from ..configs.shapes import ShapeSpec
from ..models.config import ModelConfig, layer_has_attn, layer_has_ssm
from ..models.convert import unstack_layers
from ..models.shardctx import to_placements
from ..models.transformer import segments


def _canonical(entry):
    """An entry as ``PartitionSpec`` keeps it: a tuple of one name is the
    name, an empty tuple is ``None``."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) <= 1:
            return entry[0] if entry else None
    return entry


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dim sharded
    over several mesh axes, major first).  Equal by value, as
    ``PartitionSpec`` is, with its entries kept as it keeps them."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class Rule:
    """An installed activation rule: the spec on a mesh (the reference's
    ``NamedSharding``, read as ``.mesh`` and ``.spec``).  A spec that names
    an axis the mesh lacks, or one axis twice, raises, as a
    ``NamedSharding`` does."""
    mesh: Any
    spec: P

    def __post_init__(self) -> None:
        to_placements(self.mesh, self.spec)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the :class:`P` leaves of nested dicts and lists, with
    the congruent leaves of ``rest`` (a missing key or a length mismatch
    raises, as ``jax.tree_util.tree_map`` does)."""
    if _is_spec(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        for r in rest:
            if set(r) != set(tree):
                raise ValueError(f"tree keys {sorted(tree)} != "
                                 f"{sorted(r)}")
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if len(r) != len(tree):
                raise ValueError(f"tree lengths {len(tree)} != {len(r)}")
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree leaf: {tree!r}")


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def _div(n: int, by: int) -> bool:
    return n % by == 0


def param_specs(cfg: ModelConfig, *, tp: int = 16) -> Dict[str, Any]:
    """Spec tree congruent with the reference's ``init_params(cfg)``."""
    d, dh = cfg.d_model, cfg.d_head
    heads_tp = "model" if _div(cfg.n_heads * dh, tp) else None
    kv_tp = "model" if _div(cfg.n_kv_heads * dh, tp) else None

    attn = {
        "wq": P(None, "data", heads_tp),
        "wk": P(None, "data", kv_tp),
        "wv": P(None, "data", kv_tp),
        "wo": P(None, heads_tp, "data"),
    }
    if cfg.qk_norm:
        attn["q_norm"] = P(None, None)
        attn["k_norm"] = P(None, None)

    layers: Dict[str, Any] = {"norm1": P(None, None)}
    if cfg.has_attn:
        layers["attn"] = attn
    if cfg.ssm:
        di_tp = "model" if _div(cfg.ssm_d_inner, tp) else None
        layers["ssm"] = {
            "in_proj": P(None, "data", None),
            "conv_w": P(None, None, None),
            "conv_b": P(None, None),
            "A_log": P(None, None),
            "D": P(None, None),
            "dt_bias": P(None, None),
            "ssm_norm": P(None, None),
            "out_proj": P(None, di_tp, "data"),
        }
    if cfg.has_moe:
        layers["norm2"] = P(None, None)
        if _div(cfg.n_experts, tp):
            # expert parallelism over "model"
            moe = {
                "router": P(None, "data", None),
                "w_gate": P(None, "model", "data", None),
                "w_up": P(None, "model", "data", None),
                "w_down": P(None, "model", None, "data"),
            }
        else:
            # uneven expert count (e.g. 60): TP inside each expert's FFN
            moe = {
                "router": P(None, "data", None),
                "w_gate": P(None, None, "data", "model"),
                "w_up": P(None, None, "data", "model"),
                "w_down": P(None, None, "model", "data"),
            }
        if cfg.n_shared_experts:
            sff_tp = "model" if _div(cfg.shared_d_ff, tp) else None
            moe["shared"] = {
                "w_gate": P(None, "data", sff_tp),
                "w_up": P(None, "data", sff_tp),
                "w_down": P(None, sff_tp, "data"),
            }
        layers["moe"] = moe
    elif cfg.has_dense_mlp:
        ff_tp = "model" if _div(cfg.d_ff, tp) else None
        layers["norm2"] = P(None, None)
        mlp = {
            "w_up": P(None, "data", ff_tp),
            "w_down": P(None, ff_tp, "data"),
        }
        if cfg.act == "swiglu":
            mlp["w_gate"] = P(None, "data", ff_tp)
        layers["mlp"] = mlp

    out: Dict[str, Any] = {
        "embed": P("model", "data"),
        "layers": layers,
        "final_norm": P(None),
    }
    if cfg.frontend != "token":
        out["frontend_proj"] = P(None, "data")
    if not cfg.tie_embeddings:
        out["lm_head"] = P("data", "model")
    return out


def param_specs_decode(cfg: ModelConfig, *, tp: int = 16) -> Dict[str, Any]:
    """Weight-stationary 2-D TP for serve_step: every weight matrix shards
    (in -> "data", out -> "model"), so each device computes its [D/dp x
    F/tp] tile per product (x is gathered — tiny at S=1 — and partial sums
    reduce over "data") and no weight moves per token."""
    base = param_specs(cfg, tp=tp)

    # Models whose bf16 weights fit 16-way sharded (<8 GB a device) drop
    # the "data"-axis FSDP entirely at decode: zero weight collectives per
    # token.  The giants (nemotron) keep 2-D tiles ([D/dp x F/tp]).
    small = cfg.n_params() * 2 / tp < 8e9
    in_axis = None if small else "data"

    def fix(s: P) -> P:
        if len(s) == 3:          # stacked [L, in, out]
            return P(None, in_axis, "model")
        # 4-dim (MoE experts) are already expert-stationary: keep.
        return s

    out = tree_map(fix, base)
    out["embed"] = P("model", "data")
    if not cfg.tie_embeddings:
        out["lm_head"] = P("data", "model")
    return out


def batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, *, multi_pod: bool,
                 with_labels: bool, n_dev: int = 256) -> Dict[str, P]:
    dp = dp_axes(multi_pod)
    specs: Dict[str, P] = {}
    # long_500k has global_batch=1: can't shard batch; leave it unsharded.
    bshard = dp if shape.global_batch >= 16 else None
    if (cfg.ssm and shape.kind != "decode"
            and shape.global_batch % n_dev == 0):
        bshard = dp + ("model",)   # match activation_rules' SSM strategy
    if cfg.frontend == "token":
        specs["tokens"] = P(bshard, None)
    else:
        specs["embeds"] = P(bshard, None, None)
    if cfg.pos == "mrope":
        specs["positions"] = P(None, bshard, None)
    if with_labels:
        specs["labels"] = P(bshard, None)
    return specs


def cache_pspecs(cfg: ModelConfig, shape: ShapeSpec, *, multi_pod: bool):
    """Decode-cache spec tree, congruent with ``init_decode_cache``.

    KV caches [n, B, C, Hkv, dh]: batch over the DP axes when it's large
    enough; the cache length C shards over "model" (each model shard holds
    a sequence chunk; softmax and the contraction over C become partial
    reductions and an all-reduce)."""
    dp = dp_axes(multi_pod)
    bshard = dp if shape.global_batch >= 16 else None
    segs = []
    for _kind, s, _e in segments(cfg):
        entry: Dict[str, Any] = {}
        if layer_has_attn(cfg, s):
            entry["k"] = P(None, bshard, "model", None, None)
            entry["v"] = P(None, bshard, "model", None, None)
        if layer_has_ssm(cfg, s):
            entry["ssm"] = {
                "state": P(None, bshard, None, None, None),
                "conv": P(None, bshard, None, None),
            }
        segs.append(entry)
    return {"pos": P(), "segments": segs}


def activation_rules(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                     multi_pod: bool, strategy: str = "seq") -> Dict[str, Rule]:
    """Rules for ``models.shardctx.constrain`` kinds.

    Strategy: "2-D token parallelism" — batch shards over the DP axes,
    SEQUENCE shards over "model".  Every per-token op (projections, MLPs,
    norms, logits, loss) then splits over every device regardless of head
    counts.  Attention q-blocks are sequence-sharded too; K/V are gathered
    per layer.  MoE expert buffers shard over "model" (EP); decode steps
    (S=1) shard batch only and lean on the C-sharded KV cache.
    """
    sizes = axis_sizes(mesh)
    tp = sizes.get("model", 1)
    n_dev = 1
    for v in sizes.values():
        n_dev *= v
    dp = dp_axes(multi_pod)
    b = dp if shape.global_batch >= 16 else None
    S = 1 if shape.kind == "decode" else shape.seq_len
    sp = "model" if (S % tp == 0 and S // tp >= 128) else None
    # SSM recurrences are sequential over chunks: sequence sharding would
    # put per-step broadcasts on the critical path.  When the global batch
    # covers the whole mesh, shard batch over BOTH axes instead.
    if cfg.ssm and shape.kind != "decode" and shape.global_batch % n_dev == 0:
        b = dp + ("model",)
        sp = None
    # Decode: per-token activations are tiny ([B,1,D]); REPLICATE them so
    # the weight-stationary decode specs never force a weight gather.  The
    # KV cache keeps its (batch x cache-len) sharding (cache_pspecs).
    if shape.kind == "decode":
        b = None
    # "tp" strategy (archs whose heads AND d_ff divide the model axis):
    # weights stay model-sharded at use (Megatron TP) — the ZeRO gather
    # only spans "data"; activations pay [B,S,D] reductions.
    if strategy == "tp" and shape.kind != "decode":
        heads_tp = "model" if _div(cfg.n_heads, tp) else None
        ff = cfg.d_ff if cfg.has_dense_mlp else 0
        rules = {
            "residual": P(b, None, None),
            "heads": P(b, None, heads_tp, None),
            "kv_heads": P(b, None,
                          "model" if _div(cfg.n_kv_heads, tp) else None, None),
            "ffn": P(b, None, "model" if ff and _div(ff, tp) else None),
            "moe": P(b, None, None, None),
            "moe_buf": P("model" if _div(cfg.n_experts or 1, tp) else None,
                         None, None),
            "moe_hidden": P("model" if _div(cfg.n_experts or 1, tp) else None,
                            None, None),
            "logits": P(b, None, "model" if _div(cfg.vocab, tp) else None),
            "ssm_states": P(None, b, None, None, None),
            "scores5": None,
        }
        return {k: Rule(mesh, v) for k, v in rules.items() if v is not None}
    # expert buffers [E, C, D]: EP over experts when divisible, else shard
    # the capacity dim (C is rounded to a multiple of 64 in moe.py).
    if cfg.has_moe and _div(cfg.n_experts, tp):
        moe_buf = P("model", None, None)
    else:
        moe_buf = P(None, "model", None)
    rules = {
        "residual": P(b, sp, None),
        "heads": P(b, sp, None, None),
        "kv_heads": P(b, None, None, None),   # gathered for attention
        "ffn": P(b, sp, None),
        "moe": P(b, sp, None, None),          # dense-dispatch hidden
        "moe_buf": moe_buf,                   # [E, C, D]
        "moe_hidden": moe_buf,                # [E, C, F]
        "logits": P(b, sp, "model" if sp is None and b == dp
                    and _div(cfg.vocab, tp) else None),
        # decode attention scores [B, G, rep, 1, C]: keep the cache-length
        # axis sharded (partial softmax + reduction, no cache all-gather).
        "scores5": (P(None, None, None, None, "model")
                    if shape.kind == "decode" else None),
        # inter-chunk SSD states [c, B, H, P, N]: replicate over "model" so
        # the sequential recurrence runs locally.
        "ssm_states": P(None, b if isinstance(b, tuple) or b is None else b,
                        None, None, None),
    }
    if strategy == "moe_ep" and cfg.has_moe and shape.kind != "decode":
        # marker: moe_forward switches to the explicit all-to-all dispatch
        # (models/moe.py) when this rule is installed.
        rules["moe_ep"] = P()
    if (strategy == "hp" and shape.kind != "decode"
            and _div(cfg.n_heads, tp) and _div(cfg.n_kv_heads, tp)):
        # head-parallel attention for full-MHA archs (KV heads divide the
        # mesh): q/k/v reshard seq->heads entering attention and back.
        rules["heads"] = P(b, None, "model", None)
        rules["kv_heads"] = P(b, None, "model", None)
    return {k: Rule(mesh, v) for k, v in rules.items() if v is not None}


def opt_specs(pspecs) -> Dict[str, Any]:
    return {
        "m": pspecs,
        "v": pspecs,
        "step": P(),
    }


def sanitize_specs(spec_tree, shape_tree, axis_sizes: Dict[str, int]):
    """Drop mesh axes from any spec dim that doesn't divide evenly (the
    reference's pjit rejects uneven shardings; the port keeps its specs).
    E.g. vocab 50280 can't shard 16-way; 60 experts can't either — those
    dims fall back to replicated and another dim carries the parallelism.
    ``shape_tree`` leaves are anything with ``.shape``."""

    def fix(spec: P, leaf) -> P:
        shape = leaf.shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, ent in zip(shape, entries):
            if ent is None:
                out.append(None)
                continue
            axes = ent if isinstance(ent, tuple) else (ent,)
            size = 1
            for a in axes:
                size *= axis_sizes.get(a, 1)
            out.append(ent if dim % size == 0 else None)
        return P(*out)

    return tree_map(fix, spec_tree, shape_tree)


def state_specs(cfg: ModelConfig, spec_tree) -> Dict[str, P]:
    """A parameter spec tree (the reference's nesting, layers stacked) as a
    spec per name of the port's state dict: ``layers/attn/wq`` becomes
    ``blocks.{i}.attn.wq`` for each layer ``i``, without its leading
    ``L`` entry."""
    return unstack_layers(cfg, spec_tree, lambda s: s,
                          lambda s, i: P(*s[1:]))


def distribute(mesh, t, spec: P):
    """``t`` (a whole tensor) as a DTensor laid out by ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, to_placements(mesh, spec))


def distribute_tree(mesh, tree, specs):
    """Each tensor of a nested dict / list (a batch, a decode cache, an
    optimizer state) as a DTensor laid out by the congruent spec."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(mesh, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(mesh, v, s) for v, s in zip(tree, specs)]
    return distribute(mesh, tree, specs)


def distribute_model(model, mesh, specs: Mapping[str, P]):
    """Replace every parameter of ``model`` by a DTensor laid out by
    ``specs`` (a spec per state-dict name, as :func:`state_specs` gives);
    a parameter without a spec raises."""
    from torch import nn

    names = {n for n, _ in model.named_parameters()}
    if names != set(specs):
        raise ValueError(f"specs for {sorted(set(specs) - names)} name no "
                         f"parameter; parameters without a spec: "
                         f"{sorted(names - set(specs))}")
    for name in sorted(names):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner)
        p = getattr(mod, attr)
        setattr(mod, attr, nn.Parameter(distribute(mesh, p.detach(),
                                                   specs[name]),
                                        requires_grad=p.requires_grad))
    return model


def to_shardings(mesh, spec_tree):
    """Each spec of ``spec_tree`` as a :class:`Rule` on ``mesh`` (the
    reference's ``NamedSharding`` tree)."""
    return tree_map(lambda s: Rule(mesh, s), spec_tree)
