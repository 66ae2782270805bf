"""--arch qwen3_moe_30b_a3b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import QWEN3_MOE_30B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
