"""Shared fixtures of the benchmark's own tests (``python -m pytest
perfbench/tests`` from the root of the checkout; the repo's tier-1 run,
which collects ``tests/`` only, does not reach them)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def card():
    """Skips the test without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)


def small_kv(c: dict, n_shards: int = 4, records: int = 2000) -> dict:
    c = json.loads(json.dumps(c))
    c["cluster"].update(n_shards=n_shards, witness_sets=64)
    c["records"] = records
    return c


def small_hymba(c: dict, dtype: str = "float32") -> dict:
    c = json.loads(json.dumps(c))
    c["model"].update(n_layers=3, d_model=64, vocab=256, n_heads=4,
                      n_kv_heads=2, d_head=16, d_ff=128, swa_window=8,
                      global_attn_layers=[0], ssm_head_dim=16, ssm_chunk=16,
                      dtype=dtype)
    c["serve"]["max_seq"] = 512
    return c
