"""--arch qwen2_vl_2b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import QWEN2_VL_2B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
