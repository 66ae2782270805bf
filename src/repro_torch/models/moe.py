"""Mixture-of-Experts layer: top-k softmax routing, or DeepSeek-V3's sigmoid
routing with a correction bias, optional shared experts (Qwen-MoE style),
dense one-hot dispatch or capacity-bounded dispatch.

The torch port of ``repro.models.moe``.  Load-balancing aux loss follows
Switch Transformer (fraction-of-tokens x mean-router-prob per expert).
``moe_forward`` dispatches as the reference does: the expert-parallel
``moe_mlp_shardmap`` (explicit all-to-all over the "model" mesh axis) when
the ``moe_ep`` marker rule is installed, else the capacity or the dense
dispatch.  At decode a :class:`RoutingTally` counts the rows each
dispatch multiplies and, on the device, the experts the live rows pick
(the registry's ``moe.experts_touched``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.telemetry import get_registry
from .config import ModelConfig
from .layers import MLP, Init
from .shardctx import constrain, get_rule, to_placements


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init) -> None:
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = init.normal((d, e), d ** -0.5)
        if cfg.router_score == "sigmoid":
            self.correction_bias = init.full((e,), 0.0)
        self.w_gate = init.normal((e, d, ff), d ** -0.5)
        self.w_up = init.normal((e, d, ff), d ** -0.5)
        self.w_down = init.normal((e, ff, d), ff ** -0.5)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, init, d_ff=cfg.shared_d_ff)


class RoutingTally:
    """One decode step's routing, counted as the step is built.

    Each MoE layer's dispatch calls ``add`` with its rows' picks and the
    rows its buffers hold.  The host keeps what the shapes fix: ``rows``,
    the rows the step's dispatch multiplies, and ``picks_a_row``, the
    expert picks of one live row over the step's layers.  The device keeps
    what the routing decides: the experts with a live pick in each layer,
    which ``record``, at the step's end, adds to the registry's device
    counter ``moe.experts_touched``.  No host sync: a captured step adds
    to it at each replay, and it is copied to the host only when read."""

    def __init__(self, active: torch.Tensor) -> None:
        self.live = (active > 0).reshape(-1, 1)
        self.rows = 0
        self.picks_a_row = 0
        self.touched = []

    def add(self, tok_onehot: torch.Tensor, rows: int, top_k: int) -> None:
        """``tok_onehot`` [N, E]: each row's picks (N = the step's rows);
        ``rows``: the rows the layer's dispatch multiplies."""
        self.rows += rows
        self.picks_a_row += top_k
        self.touched.append(((tok_onehot * self.live).sum(dim=0) > 0).sum())

    def record(self) -> None:
        if self.touched:
            get_registry().device_counter("moe.experts_touched").add(
                torch.stack(self.touched).sum())


def _capacity(cfg: ModelConfig, n: int) -> int:
    """The capacity dispatch's rows an expert for ``n`` tokens: K * n * cf
    / E rounded, at least 1, then up to a multiple of 64, as the reference
    keeps it."""
    C = int(max(1, round(cfg.top_k * n * cfg.moe_capacity_factor
                         / cfg.n_experts)))
    return -(-C // 64) * 64


def _route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor,
           bias=None):
    """(probabilities [..., E], the picks' weights and the picks [..., K]).
    ``bias``: the sigmoid router's correction bias, if it has one."""
    if cfg.router_score == "sigmoid":
        return route_sigmoid(cfg, router, bias, x)
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, _weigh(cfg, top_p), top_i


def route_sigmoid(cfg: ModelConfig, router, bias, x):
    """DeepSeek-V3's noaux_tc routing (one expert group): logits in f32,
    scores their sigmoids; picks the top-k of scores + ``bias``, weighs
    them by their unbiased scores."""
    scores = torch.sigmoid(x.float() @ router.float())
    choice = scores if bias is None else scores + bias.float()
    top_i = torch.topk(choice, cfg.top_k, dim=-1).indices
    return scores, _weigh(cfg, torch.gather(scores, -1, top_i)), top_i


def _weigh(cfg: ModelConfig, top_p: torch.Tensor) -> torch.Tensor:
    """The picks' weights: renormalised to sum to 1, then times
    ``routed_scaling`` (where it is not 1).  DeepSeek-V3 adds 1e-20 to the
    sum, which leaves any f32 sum above ~1e-12 unchanged: a sum of
    sigmoids or softmax probabilities never comes near it."""
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    if cfg.routed_scaling != 1.0:
        top_p = top_p * cfg.routed_scaling
    return top_p


def _bias(p: MoE):
    return getattr(p, "correction_bias", None)


def _shared(cfg: ModelConfig, p: MoE, x: torch.Tensor, out: torch.Tensor):
    if cfg.n_shared_experts:
        sp = p.shared
        sg = F.silu(x @ sp.w_gate) * (x @ sp.w_up)
        out = out + sg @ sp.w_down
    return out


def moe_mlp(
    cfg: ModelConfig, p: MoE, x: torch.Tensor, tally=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense dispatch.  x: [B, S, D] -> (out [B, S, D], aux_loss scalar)."""
    E = cfg.n_experts
    probs, top_p, top_i = _route(cfg, p.router, x, _bias(p))  # [B,S,K]
    if tally is not None:                 # every expert over every row
        picks = F.one_hot(top_i, E).sum(dim=2).reshape(-1, E)
        tally.add(picks, E * picks.shape[0], cfg.top_k)

    # combine [B,S,E] = sum_k onehot(top_i_k) * top_p_k
    onehot = F.one_hot(top_i, E).to(x.dtype)                  # [B,S,K,E]
    combine = torch.einsum("bske,bsk->bse", onehot, top_p.to(x.dtype))

    # Expert computation on the full token set (dense einsum over E).
    g = torch.einsum("bsd,edf->bsef", x, p.w_gate)
    u = torch.einsum("bsd,edf->bsef", x, p.w_up)
    h = constrain(F.silu(g) * u, "moe")
    y = torch.einsum("bsef,efd->bsed", h, p.w_down)
    out = _shared(cfg, p, x, torch.einsum("bsed,bse->bsd", y, combine))

    # Switch-style load-balance loss.
    frac_tokens = torch.mean(
        torch.sum(F.one_hot(top_i, E).float(), dim=2), dim=(0, 1))  # [E]
    frac_probs = torch.mean(probs, dim=(0, 1))                # [E]
    aux = torch.sum(frac_tokens * frac_probs) * E
    return out, aux


def moe_mlp_capacity(
    cfg: ModelConfig, p: MoE, x: torch.Tensor, tally=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded gather/scatter dispatch (GShard-style).

    Tokens scatter into per-expert buffers of capacity
    C = ceil(K * N * cf / E), rounded up to 64 (overflow drops); experts run
    batched GEMMs over their buffers; results gather back weighted by router
    probs.  Top-k experts per token are distinct, so a token's slot in
    expert e is the exclusive-over-tokens running count of e."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, D)
    probs, top_p, top_i = _route(cfg, p.router, xf, _bias(p))  # [N, K]

    C = _capacity(cfg, N)
    tok_onehot = F.one_hot(top_i, E).sum(dim=1)               # [N,E]
    if tally is not None:
        tally.add(tok_onehot, E * C, K)
    base = torch.cumsum(tok_onehot, dim=0) - tok_onehot       # exclusive
    slot = torch.gather(base, 1, top_i)                       # [N, K]
    keep = slot < C

    flat_e = torch.where(keep, top_i, 0).reshape(-1)          # [N*K]
    flat_s = torch.where(keep, slot, 0).reshape(-1)
    flat_w = torch.where(keep, top_p, 0.0).reshape(-1)
    src = xf.repeat_interleave(K, dim=0)                      # [N*K, D]
    src = torch.where(keep.reshape(-1)[:, None], src, 0)

    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_e, flat_s), src.to(x.dtype), accumulate=True)
    buf = constrain(buf, "moe_buf")
    g = torch.einsum("ecd,edf->ecf", buf, p.w_gate)
    u = torch.einsum("ecd,edf->ecf", buf, p.w_up)
    h = constrain(F.silu(g) * u, "moe_hidden")
    y = torch.einsum("ecf,efd->ecd", h, p.w_down)
    gathered = y[flat_e, flat_s]                              # [N*K, D]
    outf = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    tok_idx = torch.arange(N, device=x.device).repeat_interleave(K)
    outf = outf.index_add(0, tok_idx, gathered.float() * flat_w[:, None])
    out = _shared(cfg, p, x, outf.reshape(B, S, D).to(x.dtype))

    frac_tokens = torch.mean(tok_onehot.float(), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = torch.sum(frac_tokens * frac_probs) * E
    return out, aux


def _capacity_local(cfg: ModelConfig, n: int) -> int:
    """The per-shard capacity of the expert-parallel dispatch: ceil to 8 of
    K * n * cf / E (truncated first), at least 8, as the reference's
    shard_map body has it; the capacity path rounds up to 64 instead, so
    the two drop different tokens when a buffer overflows."""
    c = int(cfg.top_k * n * cfg.moe_capacity_factor / cfg.n_experts)
    return int(max(8, -(-c // 8) * 8))


class IdentityComm:
    """The collectives of :func:`moe_ep_local` on one device (tp = 1): the
    gather, both all-to-alls and the mean are the identity."""

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return t

    def to_experts(self, buf: torch.Tensor) -> torch.Tensor:
        return buf

    def from_experts(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def mean(self, aux: torch.Tensor) -> torch.Tensor:
        return aux


class _MeshMean(torch.autograd.Function):
    """The mean of a local scalar over every rank of ``groups`` (one group
    per mesh axis; JAX's ``pmean`` over all of them).  Its transpose is the
    same mean of the cotangents."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _mesh_mean(t, groups)

    @staticmethod
    def backward(ctx, g):
        return _mesh_mean(g, ctx.groups), None


def _mesh_mean(t: torch.Tensor, groups) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    n = 1
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
        n *= g.size()
    return t / n


class MeshComm:
    """The collectives of :func:`moe_ep_local` on ``mesh``: weights
    gathered over "data", expert buffers exchanged by all-to-all over
    "model", the aux loss averaged over every axis.  All are functional
    collectives with autograd."""

    def __init__(self, mesh) -> None:
        self.tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
        self.model = mesh.get_group("model")
        self.data = mesh.get_group("data")
        self.groups = [mesh.get_group(a) for a in mesh.mesh_dim_names]

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol

        single = getattr(funcol, "all_gather_single_autograd", None)
        if single is None:       # older torch: the tensor form gathers any dim
            return funcol.all_gather_tensor_autograd(t, dim, self.data)
        return single(t.movedim(dim, 0).contiguous(), 0,
                      self.data).movedim(0, dim)

    def _a2a(self, t: torch.Tensor) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol

        return funcol.all_to_all_single_autograd(t, None, None, self.model)

    def to_experts(self, buf: torch.Tensor) -> torch.Tensor:
        """[E, C, D] -> [E/tp, tp*C, D]: each expert shard receives every
        source shard's buffers for its experts, source i at i*C."""
        E, C, D = buf.shape
        tp = self.tp
        recv = self._a2a(buf.contiguous())          # [tp * E/tp, C, D]
        return recv.reshape(tp, E // tp, C, D).transpose(0, 1).reshape(
            E // tp, tp * C, D)

    def from_experts(self, y: torch.Tensor) -> torch.Tensor:
        """[E/tp, tp*C, D] -> [E, C, D]: the results go back to the shard
        whose tokens they are."""
        e, tc, D = y.shape
        tp = self.tp
        send = y.reshape(e, tp, tc // tp, D).transpose(0, 1).reshape(
            tp * e, tc // tp, D)
        return self._a2a(send.contiguous())

    def mean(self, aux: torch.Tensor) -> torch.Tensor:
        return _MeshMean.apply(aux, self.groups)


def moe_ep_local(cfg: ModelConfig, xl: torch.Tensor, router: torch.Tensor,
                 wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, comm
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shard_map body of the reference's ``moe_mlp_shardmap`` on one
    device's shards: ``xl`` [bl, sl, D] its tokens, ``router`` [D/dp, E],
    ``wg``/``wu`` [E/tp, D/dp, F] and ``wd`` [E/tp, F, D/dp] its weight
    shards.  ``comm`` carries the collectives (:class:`MeshComm`, or
    :class:`IdentityComm` on one device).  Routing is per shard, with the
    local capacity of :func:`_capacity_local`."""
    E, K = cfg.n_experts, cfg.top_k
    # Gather the FSDP'd D-dim of this device's experts (ZeRO-at-use).
    wg = comm.gather(wg, 1)
    wu = comm.gather(wu, 1)
    wd = comm.gather(wd, 2)
    router = comm.gather(router, 0)
    bl, sl, d = xl.shape
    n = bl * sl
    xf = xl.reshape(n, d)
    probs, top_p, top_i = _route(cfg, router, xf)
    C = _capacity_local(cfg, n)
    tok_onehot = F.one_hot(top_i, E).sum(dim=1)               # [n, E]
    base = torch.cumsum(tok_onehot, dim=0) - tok_onehot
    slot = torch.gather(base, 1, top_i)
    keep = slot < C
    flat_e = torch.where(keep, top_i, 0).reshape(-1)
    flat_s = torch.where(keep, slot, 0).reshape(-1)
    flat_w = torch.where(keep, top_p, 0.0).reshape(-1)
    src = xf.repeat_interleave(K, dim=0)
    src = torch.where(keep.reshape(-1)[:, None], src, 0)
    buf = torch.zeros((E, C, d), dtype=xl.dtype, device=xl.device)
    buf = buf.index_put((flat_e, flat_s), src.to(xl.dtype), accumulate=True)
    recv = comm.to_experts(buf)                               # [E/tp, tp*C, D]
    g = torch.einsum("ecd,edf->ecf", recv, wg)
    u = torch.einsum("ecd,edf->ecf", recv, wu)
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd)
    back = comm.from_experts(y)                               # [E, C, D]
    gathered = back[flat_e, flat_s]
    outf = torch.zeros((n, d), dtype=torch.float32, device=xl.device)
    tok_idx = torch.arange(n, device=xl.device).repeat_interleave(K)
    outf = outf.index_add(0, tok_idx, gathered.float() * flat_w[:, None])
    out = outf.reshape(bl, sl, d).to(xl.dtype)
    frac_tokens = torch.mean(tok_onehot.float(), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = comm.mean(torch.sum(frac_tokens * frac_probs) * E)
    return out, aux


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose gradient is scaled by ``s``."""

    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _shard_in(mesh, t, spec) -> torch.Tensor:
    """Enter a shard_map: ``t`` laid out by ``spec``, as this rank's local
    tensor; its cotangent sums over the mesh dims ``spec`` leaves out (a
    replicated input's gradient is the sum of its replicas')."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    placements = to_placements(mesh, spec)
    if not isinstance(t, DTensor):     # a plain tensor counts as replicated
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
    t = t.redistribute(mesh, placements)
    grads = [Partial() if isinstance(p, Replicate) else p for p in placements]
    return t.to_local(grad_placements=grads)


def _shard_out(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """Leave a shard_map: this rank's ``t`` as the shard of a DTensor laid
    out by ``spec``; its cotangent is divided over the mesh dims ``spec``
    leaves out, as the reference's transpose divides it."""
    from torch.distributed.tensor import DTensor, Replicate

    placements = to_placements(mesh, spec)
    n = 1
    for i, pl in enumerate(placements):
        if isinstance(pl, Replicate):
            n *= mesh.shape[i]
    if n > 1:
        t = _ScaleGrad.apply(t, 1.0 / n)
    return DTensor.from_local(t, mesh, placements)


def moe_mlp_shardmap(cfg: ModelConfig, p: MoE, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with an EXPLICIT all-to-all (the reference's
    shard_map, here on DTensor local shards).

    The routing is done per shard in plain torch, and the only
    cross-device traffic is the all-to-all of the [E, C_l, D] capacity
    buffers over the "model" axis, plus the ZeRO weight gather over
    "data" (functional collectives with autograd, so it is differentiable
    end to end).  Requires the ``moe_ep`` marker rule (for the mesh) and
    the ``residual`` rule (the activations' layout)."""
    mesh = get_rule("moe_ep").mesh
    x_spec = get_rule("residual").spec
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    if cfg.n_experts % tp:
        raise ValueError(f"expert parallelism needs the {cfg.n_experts} "
                         f"experts to divide the model axis ({tp})")
    w_spec3 = ("model", "data", None)    # [E, D, F] as stored (EP x FSDP)
    wd_spec = ("model", None, "data")
    out, aux = moe_ep_local(
        cfg, _shard_in(mesh, x, x_spec),
        _shard_in(mesh, p.router, ("data", None)),
        _shard_in(mesh, p.w_gate, w_spec3), _shard_in(mesh, p.w_up, w_spec3),
        _shard_in(mesh, p.w_down, wd_spec), MeshComm(mesh))
    out = _shard_out(mesh, out, x_spec)
    aux = _shard_out(mesh, aux, ())
    return _shared(cfg, p, x, out), aux


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor, tally=None):
    """The layer's output and aux loss; ``tally`` (a decode step's
    :class:`RoutingTally`) takes the live rows' picks."""
    if (cfg.moe_dispatch == "capacity" and get_rule("moe_ep") is not None
            and cfg.n_experts and get_rule("residual") is not None):
        if cfg.router_score == "sigmoid":
            raise NotImplementedError(
                "the expert-parallel dispatch does not carry the sigmoid "
                "router's correction bias")
        mesh = get_rule("moe_ep").mesh
        tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 0)
        if tp and cfg.n_experts % tp == 0:
            return moe_mlp_shardmap(cfg, p, x)
    if cfg.moe_dispatch == "capacity":
        return moe_mlp_capacity(cfg, p, x, tally)
    return moe_mlp(cfg, p, x, tally)
