"""The assigned input-shape set (LM-family): every (arch x shape) cell of the
dry-run matrix is defined here.

  train_4k     seq 4096   global_batch 256   -> train_step
  prefill_32k  seq 32768  global_batch 32    -> prefill (forward) step
  decode_32k   seq 32768  global_batch 128   -> serve_step (1 new token,
                                                KV cache of seq_len)
  long_500k    seq 524288 global_batch 1     -> serve_step; sub-quadratic
                                                archs only (SSM / hybrid-SWA)

Encoder-only archs (hubert) have no decode; pure full-attention archs skip
long_500k (DESIGN.md §6).  Skips are explicit rows in the roofline table.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg, shape: ShapeSpec) -> Tuple[bool, Optional[str]]:
    """(runs?, skip_reason)."""
    if shape.kind == "decode" and not cfg.can_decode:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention: long_500k designated sub-quadratic-only"
    return True, None
