"""Activation-sharding context.

Model code stays mesh-agnostic: layers call ``constrain(x, kind)`` at the
boundaries that matter (residual stream, attention heads, FFN hidden, MoE
expert dim, logits), as the JAX package's layers do.  Launchers and the
dry run install a rule per kind (``launch.sharding.activation_rules``:
objects with ``.mesh``, a ``DeviceMesh``, and ``.spec``); ``constrain``
then redistributes a DTensor to the rule's placements.  With no rule for
the kind, on a plain tensor, or where the tensor's rank differs from the
spec's, it returns ``x`` unchanged, as the reference does, so every
single-device path keeps its results bit for bit.

Installing rules (a non-empty ``activation_sharding``) also enters
DTensor's ``implicit_replication``: the plain tensors the model makes for
itself (positions, masks, accumulators) then count as replicated on the
mesh beside the DTensor parameters and activations.

Kinds:
  residual    [B, S, D]
  heads       [B, S, H, dh]
  ffn         [B, S, F]
  moe         [B, S, E, F]
  logits      [B, S, V]
"""
from __future__ import annotations

from contextlib import ExitStack, contextmanager
from typing import Dict

import torch

_RULES: Dict[str, object] = {}


@contextmanager
def activation_sharding(rules: Dict[str, object]):
    global _RULES
    old = _RULES
    _RULES = dict(rules)
    try:
        with ExitStack() as stack:
            if _RULES:
                from torch.distributed.tensor.experimental import (
                    implicit_replication,
                )

                stack.enter_context(implicit_replication())
            yield
    finally:
        _RULES = old


def constrain(x, kind: str):
    r = _RULES.get(kind)
    if r is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or x.ndim != len(r.spec):
        return x
    return x.redistribute(r.mesh, to_placements(r.mesh, r.spec))


def to_placements(mesh, spec):
    """One DTensor placement per mesh dim: ``Shard(d)`` when tensor dim
    ``d``'s entry names that mesh axis, else ``Replicate()``.  A tuple
    entry shards one tensor dim over several mesh dims, in mesh order.  An
    axis of one device holds the whole dim, so it is ``Replicate()`` there
    too (DTensor's view rules refuse to merge a dim sharded over it, as
    ``x @ w`` does with a batch of one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for dim, ent in enumerate(spec):
        if ent is None:
            continue
        axes = ent if isinstance(ent, tuple) else (ent,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {tuple(names)}")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: a dim sharded over {axes} must "
                             f"name them in the mesh's order {tuple(names)}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def split_dim(x, dim: int, sizes):
    """``x`` with dim ``dim`` split into ``sizes`` (heads out of a
    projection, or KV groups out of heads).  A DTensor sharded on that dim
    over more devices than ``sizes[0]`` divides by is first replicated on
    it: DTensor cannot view such a split (GSPMD reshards so too)."""
    dim = dim % x.ndim
    placements = getattr(x, "placements", None)
    if placements:
        n = 1
        for i, pl in enumerate(placements):
            if pl.is_shard(dim):
                n *= x.device_mesh.size(i)
        if sizes[0] % n:
            from torch.distributed.tensor import Replicate

            x = x.redistribute(x.device_mesh, [
                Replicate() if pl.is_shard(dim) else pl
                for pl in placements])
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


class _MergeDims(torch.autograd.Function):
    """Merge dims ``dim`` and ``dim + 1``; the gradient splits back by
    :func:`split_dim`."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None


def merge_dims(x, dim: int):
    """``x`` with dims ``dim`` and ``dim + 1`` merged (heads back into a
    projection's input).  Its gradient splits as :func:`split_dim` does,
    so a gradient sharded over more devices than the heads divide by
    reshards first; on a plain tensor it is ``reshape``."""
    dim = dim % x.ndim
    if getattr(x, "placements", None):
        return _MergeDims.apply(x, dim)
    return x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])


def follow(t, ref):
    """``t`` laid out as ``ref`` on the dims they share (``t``'s dims are
    ``ref``'s leading ones): each mesh dim that shards one of them shards
    it in ``t`` too, any other leaves ``t`` replicated.  Labels follow the
    logits so that the loss's gather stays local.  A plain tensor beside a
    plain ``ref`` comes back as it is."""
    placements = getattr(ref, "placements", None)
    if not placements:
        return t
    from torch.distributed.tensor import DTensor, Replicate

    want = [pl if pl.is_shard() and pl.dim < t.ndim else Replicate()
            for pl in placements]
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, ref.device_mesh,
                               [Replicate()] * len(placements))
    return t.redistribute(ref.device_mesh, want)


class _TakeLast(torch.autograd.Function):
    """``torch.gather`` on the last dim whose gradient is scattered into
    zeros laid out as the input (the built-in backward makes its zeros at
    the global shape, replicated, on every rank)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(x, idx)
        return torch.gather(x, -1, idx)

    @staticmethod
    def backward(ctx, g):
        x, idx = ctx.saved_tensors
        return torch.zeros_like(x).scatter_add(-1, idx, g), None


def take_last(x, idx):
    """``torch.gather(x, -1, idx)`` (the loss's label logits).  On a
    DTensor the gather runs on each rank's shard (``idx`` laid out as
    ``x``, see :func:`follow`), its gradient is built on zeros laid out as
    ``x``, and a gather from a vocab-sharded ``x`` (a masked partial sum,
    which DTensor cannot index before it is reduced) is reduced at once."""
    placements = getattr(x, "placements", None)
    if not placements:
        return torch.gather(x, -1, idx)
    out = _TakeLast.apply(x, idx)
    if not any(pl.is_partial() for pl in out.placements):
        return out
    from torch.distributed.tensor import Replicate

    return out.redistribute(out.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in out.placements])


def _whole(t):
    """A DTensor's whole value on this rank (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def gathered(x):
    """A DTensor replicated on every mesh dim (a plain tensor as it is)."""
    placements = getattr(x, "placements", None)
    if not placements:
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * len(placements))


def write_rows_(cache, slot, rows, keep):
    """``cache[b, slot[b]] = rows[b]`` in place for each batch row ``b``
    where ``keep[b]`` (a ring write of one token per row); a row that does
    not keep writes back what its slot holds, so no row's write depends on
    another's.  ``cache`` is [B, C, ...].  On a DTensor cache (batch and
    cache length sharded) each rank writes the rows of its batch range
    whose slot falls in its cache range, into its local shard."""
    placements = getattr(cache, "placements", None)
    if not placements:
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, slot] = torch.where(keep, rows, cache[bidx, slot])
        return cache
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    local = cache.to_local()
    b0, c0 = offset[0], offset[1]
    nb, nc = shape[0], shape[1]
    rows, slot, keep = (_whole(t)[b0:b0 + nb] for t in (rows, slot, keep))
    ls = slot - c0
    mine = keep & ((ls >= 0) & (ls < nc)).reshape(
        (nb,) + (1,) * (keep.ndim - 1))
    ls = ls.clamp(0, nc - 1)
    bidx = torch.arange(nb, device=local.device)
    local[bidx, ls] = torch.where(mine, rows, local[bidx, ls])
    return cache


def get_rule(kind: str):
    """Inspect the installed rule (layers pick TP vs sequence-parallel
    attention layouts from it)."""
    return _RULES.get(kind)


def heads_are_tp() -> bool:
    """True iff the 'heads' rule shards the head dim (dim 2 of [B,S,H,dh])."""
    r = _RULES.get("heads")
    if r is None:
        return False
    try:
        spec = r.spec
        return len(spec) >= 3 and spec[2] is not None
    except AttributeError:
        return False
