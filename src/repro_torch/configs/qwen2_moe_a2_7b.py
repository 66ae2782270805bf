"""--arch qwen2_moe_a2_7b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import QWEN2_MOE_A27B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
