"""--arch kanana_2_30b_a3b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import KANANA_2_30B_A3B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
