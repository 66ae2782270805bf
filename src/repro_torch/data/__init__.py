"""repro_torch.data — the deterministic synthetic pipeline on torch (the
port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
