"""--arch smollm_360m: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import SMOLLM_360M as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
