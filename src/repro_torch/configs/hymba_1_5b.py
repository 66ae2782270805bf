"""--arch hymba_1_5b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import HYMBA_1_5B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
