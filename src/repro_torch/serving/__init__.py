"""repro_torch.serving — CURP-durable sessions (``kvstore``) and the decode
driver on the torch model zoo (``server``)."""
from .kvstore import CurpSessionStore, SessionState
from .server import CurpServeDriver, ServeConfig

__all__ = ["CurpSessionStore", "SessionState", "CurpServeDriver",
           "ServeConfig"]
