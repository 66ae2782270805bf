"""--arch deepseek_coder_33b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import DEEPSEEK_CODER_33B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
