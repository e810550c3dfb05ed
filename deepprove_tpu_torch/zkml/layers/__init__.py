from . import activation, dense, requant

__all__ = ["activation", "dense", "requant"]
