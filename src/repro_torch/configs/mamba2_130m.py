"""--arch mamba2_130m: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import MAMBA2_130M as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
