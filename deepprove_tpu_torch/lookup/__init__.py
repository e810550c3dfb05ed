from . import logup

__all__ = ["logup"]
