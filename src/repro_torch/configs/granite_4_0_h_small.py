"""--arch granite_4_0_h_small: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import GRANITE_4_0_H_SMALL as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
