"""Activation-sharding context (the port's hook, inert on one card).

Model code stays mesh-agnostic: layers call ``constrain(x, kind)`` at the
boundaries that matter (residual stream, attention heads, FFN hidden, MoE
expert dim, logits), as the JAX package's layers do.  There a launcher
installs a NamedSharding per kind before tracing.  The port runs on one
card and has no mapping of these rules to ``torch.distributed`` DTensor
placements yet (the launch slice adds it), so ``constrain`` is the
identity whatever is installed, and ``heads_are_tp`` is always false: the
flat-heads blockwise attention and the shard_map MoE that it selects need
a mesh and come with launch.

Kinds:
  residual    [B, S, D]
  heads       [B, S, H, dh]
  ffn         [B, S, F]
  moe         [B, S, E, F]
  logits      [B, S, V]
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

_RULES: Dict[str, object] = {}


@contextmanager
def activation_sharding(rules: Dict[str, object]):
    global _RULES
    old = _RULES
    _RULES = dict(rules)
    try:
        yield
    finally:
        _RULES = old


def constrain(x, kind: str):
    """The identity: no rule is mapped to a placement on one card."""
    return x


def get_rule(kind: str):
    """Inspect the installed rule (layers pick TP vs sequence-parallel
    attention layouts from it)."""
    return _RULES.get(kind)


def heads_are_tp() -> bool:
    """Whether attention heads are tensor-parallel: never, until launch
    maps the rules to DTensor placements."""
    return False
