"""Deterministic synthetic data pipeline.

CURP-FT replays train steps from witness journals, so a batch must be
reconstructible from its metadata alone: batch_for(step) is a pure function
of (seed, step).  This is exactly the property the paper needs from RIFL'd
requests — the *operation* (not the result) is what gets journaled.

The torch port of ``repro.data.pipeline``: the numpy generation is the
reference's, draw for draw, so both packages build the same batch; only
the result lands as torch tensors on ``device`` ("cuda" unless the caller
asks for another; it raises without a card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import resolve_device, torch_dtype


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    batch: int = 8
    seq: int = 128


class SyntheticPipeline:
    """Markov-ish token stream: next-token structure so loss can decrease."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 device="cuda") -> None:
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        rng = np.random.default_rng(data.seed)
        # A fixed random transition table gives learnable structure.
        self._trans = rng.integers(
            0, cfg.vocab, size=(min(cfg.vocab, 4096), 4), dtype=np.int64
        )

    def batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step): the CURP-FT replay contract."""
        d = self.data
        rng = np.random.default_rng((self.data.seed, step))
        toks = np.empty((d.batch, d.seq + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.cfg.vocab, d.batch)
        pick = rng.integers(0, 4, size=(d.batch, d.seq))
        noise = rng.random((d.batch, d.seq)) < 0.1
        rand = rng.integers(0, self.cfg.vocab, (d.batch, d.seq))
        for t in range(d.seq):
            nxt = self._trans[toks[:, t] % self._trans.shape[0], pick[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        host = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        embeds = None
        if self.cfg.frontend != "token":
            fd = self.cfg.frontend_dim or self.cfg.d_model
            embeds = np.asarray(
                np.random.default_rng((self.data.seed, step, 7)).normal(
                    0, 1, (d.batch, d.seq, fd)
                ),
                np.float32,
            )
            del host["tokens"]
        if self.cfg.pos == "mrope":
            host["positions"] = np.ascontiguousarray(np.broadcast_to(
                np.arange(d.seq, dtype=np.int32), (3, d.batch, d.seq)))
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in host.items()}
        if embeds is not None:
            batch["embeds"] = torch.from_numpy(embeds).to(
                device=self.device, dtype=torch_dtype(self.cfg.dtype))
        return batch
