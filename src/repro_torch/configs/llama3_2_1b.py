"""--arch llama3_2_1b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import LLAMA32_1B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
