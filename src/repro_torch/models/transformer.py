"""Unified model: one code path drives all 10 assigned architectures.

The torch port of ``repro.models.transformer``.  A :class:`Transformer`
module holds the parameters (an ``nn.ModuleList`` of blocks, one per layer,
where the reference stacks them for ``lax.scan``); ``forward``,
``loss_fn``, ``init_decode_cache``, ``decode_step`` and ``prefill`` are
plain functions over it, run eagerly layer by layer.  The decode cache
keeps the reference's layout, per segment of ``segments(cfg)``:

    [single 0] [scan 1..14] [single 15] [scan 16..30] [single 31]

(Hymba), each segment's tensors stacked over its layers, with window-sized
KV for SWA layers and ``max_seq`` KV for global ones.  Where
``cfg.layer_types`` gives each layer one mixer (Granite 4.0-H), each
attention layer is a "single" segment holding only its K/V and each run of
Mamba2 layers a "scan" segment holding only SSM state.  Multi-head
latent attention (``attn="mla"``) caches one latent row a token a layer
(``latent``: kv_lora_rank + qk_rope_head_dim values), never per-head K/V.
Layers before ``first_k_dense`` hold the dense MLP, the rest the MoE.
``decode_step``
writes the cache in place, its positions too.  Every entry point places
its tensors on ``device`` ("cuda" unless the caller asks for another) and
raises when it names a CUDA device and none is present: nothing falls back
to the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig, layer_has_attn, layer_has_moe, layer_has_ssm
from .layers import (
    MLA,
    MLP,
    Attention,
    Init,
    attention_decode,
    attention_train,
    mla_decode,
    mla_train,
    mlp,
    rmsnorm,
)
from .moe import MoE, RoutingTally, moe_forward
from .shardctx import constrain, follow, take_last
from .ssm import SSM, init_ssm_cache, ssm_decode, ssm_train


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (there is no
    fallback to the CPU: the caller asks for it by name)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the model zoo runs on a CUDA device and none is available; "
            "pass device='cpu' to run it on the CPU")
    return device


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32", ...) as a torch
    dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ----------------------------------------------------------------------------
# segmentation
# ----------------------------------------------------------------------------
def segments(cfg: ModelConfig) -> List[Tuple[str, int, int]]:
    """[("scan"|"single", start, end)] covering 0..n_layers in order."""
    if cfg.layer_types:
        segs: List[Tuple[str, int, int]] = []
        for i, kind in enumerate(cfg.layer_types):
            if kind == "attention":
                segs.append(("single", i, i + 1))
            elif segs and segs[-1][0] == "scan":
                segs[-1] = ("scan", segs[-1][1], i + 1)
            else:
                segs.append(("scan", i, i + 1))
        return segs
    if cfg.attn != "swa" or not cfg.global_attn_layers:
        return [("scan", 0, cfg.n_layers)]
    segs: List[Tuple[str, int, int]] = []
    cur = 0
    for g in sorted(cfg.global_attn_layers):
        if g > cur:
            segs.append(("scan", cur, g))
        segs.append(("single", g, g + 1))
        cur = g + 1
    if cur < cfg.n_layers:
        segs.append(("scan", cur, cfg.n_layers))
    return segs


# ----------------------------------------------------------------------------
# the module
# ----------------------------------------------------------------------------
class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init, i: int) -> None:
        super().__init__()
        self.norm1 = init.full((cfg.d_model,), 1.0)
        if layer_has_attn(cfg, i):
            self.attn = (MLA if cfg.attn == "mla" else Attention)(cfg, init)
        if layer_has_ssm(cfg, i):
            self.ssm = SSM(cfg, init)
        if layer_has_moe(cfg, i):
            self.norm2 = init.full((cfg.d_model,), 1.0)
            self.moe = MoE(cfg, init)
        elif cfg.has_dense_mlp:
            self.norm2 = init.full((cfg.d_model,), 1.0)
            self.mlp = MLP(cfg, init)


class Transformer(nn.Module):
    """The parameters of one architecture on one device, drawn from
    ``seed`` by a ``torch.Generator`` at the reference's scales (the
    reference's own weights come in through ``convert.params_from_jax``
    and :meth:`from_state_dict`)."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0) -> None:
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        init = Init(self.device, torch_dtype(cfg.dtype), seed)
        d = cfg.d_model
        self.embed = init.normal((cfg.vocab, d), d ** -0.5)
        if cfg.frontend != "token":
            fd = cfg.frontend_dim or d
            self.frontend_proj = init.normal((fd, d), fd ** -0.5)
        self.blocks = nn.ModuleList(Block(cfg, init, i)
                                    for i in range(cfg.n_layers))
        self.final_norm = init.full((d,), 1.0)
        if not cfg.tie_embeddings:
            self.lm_head = init.normal((d, cfg.vocab), d ** -0.5)

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig,
                        state: Mapping[str, torch.Tensor],
                        device="cuda") -> "Transformer":
        """The module on ``device`` holding exactly ``state`` (every key),
        with no random draw.  A tensor already of the parameter's shape,
        the config's dtype and ``device`` becomes the parameter itself (no
        copy: a state as large as the card's free memory still loads);
        any other is copied, cast to the config's dtype."""
        device = resolve_device(device)
        model = cls(cfg, device="meta")
        names = dict(model.named_parameters())
        here = torch.empty(0, device=device).device     # "cuda" -> "cuda:0"
        if set(state) != set(names):
            raise KeyError(
                f"state does not match the parameters: missing "
                f"{sorted(set(names) - set(state))}, unexpected "
                f"{sorted(set(state) - set(names))}")
        for name, meta in names.items():
            t = state[name]
            if tuple(t.shape) != tuple(meta.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, the "
                                 f"parameter is {tuple(meta.shape)}")
            if t.dtype != meta.dtype or t.device != here:
                t = t.to(device=device, dtype=meta.dtype, copy=True)
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr,
                    nn.Parameter(t.detach(), requires_grad=meta.requires_grad))
        model.device = device
        return model

    def to_empty(self, *, device, recurse: bool = True) -> "Transformer":
        """``nn.Module.to_empty`` that also moves ``device``."""
        device = resolve_device(device)
        super().to_empty(device=device, recurse=recurse)
        self.device = device
        return self

    def head(self) -> torch.Tensor:
        """[D, V]: the LM head, or ``embed.T`` when embeddings are tied."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Transformer:
    """The reference's ``init_params(cfg, key)``: fresh random weights,
    here a :class:`Transformer` drawn from ``seed`` on ``device``."""
    return Transformer(cfg, device=device, seed=seed)


# ----------------------------------------------------------------------------
# forward (train / encode / prefill-logits)
# ----------------------------------------------------------------------------
def _residual(cfg: ModelConfig, x, out):
    """``x + out``, the block's output scaled by ``residual_multiplier``
    (multiplied only where it is not 1)."""
    if cfg.residual_multiplier != 1.0:
        out = out * cfg.residual_multiplier
    return x + out


def _block_train(cfg: ModelConfig, p: Block, x, positions, is_global: bool):
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    parts = []
    if isinstance(getattr(p, "attn", None), MLA):
        parts.append(mla_train(cfg, p.attn, h, positions))
    elif hasattr(p, "attn"):
        parts.append(attention_train(cfg, p.attn, h, positions, is_global))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(p, "ssm"):
        parts.append(ssm_train(cfg, p.ssm, h))
    mix = parts[0] if len(parts) == 1 else (parts[0] + parts[1]) * 0.5
    x = _residual(cfg, x, mix)
    if hasattr(p, "moe"):
        h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
        out, aux = moe_forward(cfg, p.moe, h2)
        x = _residual(cfg, x, out)
    elif cfg.has_dense_mlp:
        h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
        x = _residual(cfg, x, mlp(cfg, p.mlp, h2))
    return constrain(x, "residual"), aux


def embed_inputs(cfg: ModelConfig, params: Transformer,
                 batch: Dict) -> torch.Tensor:
    if cfg.frontend == "token":
        x = params.embed[batch["tokens"]]
    else:
        # audio / vision stubs: precomputed frame/patch embeddings (spec).
        x = batch["embeds"] @ params.frontend_proj
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return constrain(x, "residual")


def forward(
    cfg: ModelConfig, params: Transformer, batch: Dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits [B,S,V], aux_loss)."""
    x = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # Activation checkpointing where the reference wraps _block_train in
    # jax.checkpoint: every layer of a scan segment (a "single" segment's
    # layer runs plain there too).  Backward recomputes the block's forward,
    # op for op, so the gradients are those of the plain run, bit for bit.
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, s, e in segments(cfg):
        for i in range(s, e):
            args = (cfg, params.blocks[i], x, positions,
                    cfg.layer_is_global(i))
            if remat and kind == "scan":
                # the block draws no random numbers: no RNG state to keep
                x, a = checkpoint(_block_train, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _block_train(*args)
            aux_total = aux_total + a
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = constrain(_scaled(cfg, x @ params.head()), "logits")
    return logits, aux_total


def _scaled(cfg: ModelConfig, logits):
    """The head's output divided by ``logits_scaling`` (only where it is
    not 1)."""
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def loss_fn(
    cfg: ModelConfig, params: Transformer, batch: Dict,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = forward(cfg, params, batch)
    labels = follow(batch["labels"].long(), logits)
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    ll = take_last(logits32, labels[..., None])[..., 0]
    nll = lse - ll
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp_min(torch.sum(mask), 1.0)
    else:
        denom = torch.tensor(float(nll.numel()), device=nll.device)
    ce = torch.sum(nll) / denom
    total = ce + cfg.router_aux_coef * aux
    return total, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------------------
# decode path (serve_step)
# ----------------------------------------------------------------------------
def init_decode_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda",
) -> Dict:
    """Cache: per segment, stacked over the segment's layers."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    segs = []
    for kind, s, e in segments(cfg):
        n = e - s
        entry: Dict[str, Any] = {}
        if layer_has_attn(cfg, s) and cfg.attn == "mla":
            entry["latent"] = torch.zeros(
                (n, batch, max_seq, cfg.latent_width), dtype=dtype,
                device=device)
        elif layer_has_attn(cfg, s):
            is_global = cfg.layer_is_global(s) if kind == "single" else (
                cfg.attn == "full"
            )
            C = max_seq if is_global else min(cfg.swa_window, max_seq)
            shape = (n, batch, C, cfg.n_kv_heads, cfg.d_head)
            entry["k"] = torch.zeros(shape, dtype=dtype, device=device)
            entry["v"] = torch.zeros(shape, dtype=dtype, device=device)
        if layer_has_ssm(cfg, s):
            one = init_ssm_cache(cfg, batch, dtype, device)
            entry["ssm"] = {name: torch.zeros((n,) + a.shape, dtype=a.dtype,
                                              device=device)
                            for name, a in one.items()}
        segs.append(entry)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "segments": segs}


def latent_slots(cache: Dict) -> Tuple[int, int, int]:
    """(MLA layers, rows, slots a row) of a decode cache's latent entries:
    what each step's MLA attention reads.  (0, 0, 0) without MLA."""
    shapes = [e["latent"].shape for e in cache["segments"] if "latent" in e]
    if not shapes:
        return 0, 0, 0
    return sum(s[0] for s in shapes), shapes[0][1], shapes[0][2]


def cache_tensors(cache: Dict) -> List[torch.Tensor]:
    """Every tensor of a decode cache, "pos" first, in a fixed order."""
    out = [cache["pos"]]
    for entry in cache["segments"]:
        for name, t in entry.items():
            out.extend(t.values() if name == "ssm" else [t])
    return out


def _block_decode(cfg: ModelConfig, p: Block, x, entry, j: int, cur_pos,
                  positions, is_global: bool, active, tally=None):
    """Layer ``j`` of a segment's cache ``entry``, written in place."""
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    parts = []
    if "latent" in entry:
        parts.append(mla_decode(cfg, p.attn, h, entry["latent"][j], cur_pos,
                                positions, active))
    if "k" in entry:
        o, _ = attention_decode(
            cfg, p.attn, h, (entry["k"][j], entry["v"][j]), cur_pos,
            positions, is_global, active,
        )
        parts.append(o)
    if "ssm" in entry:
        cache = {name: t[j] for name, t in entry["ssm"].items()}
        o, new = ssm_decode(cfg, p.ssm, h, cache, active)
        for name, t in new.items():
            if t is not cache[name]:       # not written in place already
                cache[name].copy_(t)
        parts.append(o)
    mix = parts[0] if len(parts) == 1 else (parts[0] + parts[1]) * 0.5
    x = _residual(cfg, x, mix)
    if hasattr(p, "moe"):
        h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
        out, _ = moe_forward(cfg, p.moe, h2, tally)
        x = _residual(cfg, x, out)
    elif cfg.has_dense_mlp:
        h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
        x = _residual(cfg, x, mlp(cfg, p.mlp, h2))
    return x


@torch.no_grad()
def decode_step(
    cfg: ModelConfig, params: Transformer, batch: Dict, cache: Dict,
    tally: Optional[RoutingTally] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  batch: {"tokens": [B,1]} (or {"embeds": [B,1,fd]});
    optional "positions" ([B,1] or [3,B,1]) and "active" ([B] int32: rows
    with 0 neither write caches nor advance).  Returns (logits [B,V] f32,
    cache): every tensor of the cache is written in place, "pos" too
    (``pos += active``, after every layer has read it), so a step captured
    as a CUDA graph reads and writes the same tensors at each replay.
    ``tally`` (an MoE config; ``moe.RoutingTally`` over the step's active
    mask) takes each MoE layer's dispatch rows and, on the device with no
    host sync, the experts its live rows pick."""
    x = embed_inputs(cfg, params, batch)
    B = x.shape[0]
    cur_pos = cache["pos"]                       # [B]
    active = batch.get("active")
    if active is None:
        active = torch.ones((B,), dtype=torch.int32, device=x.device)
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = cur_pos.to(torch.int32)[:, None]
    for (_, s, e), entry in zip(segments(cfg), cache["segments"]):
        for i in range(s, e):
            x = _block_decode(cfg, params.blocks[i], x, entry, i - s,
                              cur_pos, positions, cfg.layer_is_global(i),
                              active, tally)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = _scaled(cfg, (x[:, 0, :] @ params.head()).float())
    if tally is not None:
        tally.record()
    cur_pos.add_(active)
    return logits, cache


def prefill(
    cfg: ModelConfig, params: Transformer, batch: Dict,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward: returns (last-position logits, all logits).
    (Serving builds its caches by decode, as the reference does.)"""
    logits, _ = forward(cfg, params, batch)
    return logits[:, -1, :], logits
