"""The reference's model configs as the port's ``ModelConfig``, for the
parity tests: the port's functions read the port's own fields (Granite's
``layer_types`` and scalars, at their defaults here), and the reference's
functions read the port's config as their own."""
import dataclasses

from repro.models.config import reduced as _ref_reduced
from repro_torch.models import ModelConfig


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def reduced(cfg, **overrides) -> ModelConfig:
    """The reference's ``reduced``, as the port's config."""
    return port_cfg(_ref_reduced(cfg, **overrides))
