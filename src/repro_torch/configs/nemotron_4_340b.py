"""--arch nemotron_4_340b: exact assigned config (see archs.py for source tags)."""
from ..models.config import reduced

from .archs import NEMOTRON_4_340B as CONFIG

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]
