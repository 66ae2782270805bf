"""repro_torch.configs — assigned architectures x input shapes."""
from .archs import ARCHS, get_arch
from .inputs import batch_specs, cache_specs, concrete_batch
from .shapes import SHAPES, ShapeSpec, applicable

__all__ = [
    "ARCHS", "get_arch", "batch_specs", "cache_specs", "concrete_batch",
    "SHAPES", "ShapeSpec", "applicable",
]
