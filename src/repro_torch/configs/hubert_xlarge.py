"""--arch hubert_xlarge: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import HUBERT_XLARGE as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
