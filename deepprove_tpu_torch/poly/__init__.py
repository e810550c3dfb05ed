from . import mle

__all__ = ["mle"]
