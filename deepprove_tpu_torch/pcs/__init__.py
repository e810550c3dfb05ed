from . import basefold, merkle, ntt

__all__ = ["basefold", "merkle", "ntt"]
