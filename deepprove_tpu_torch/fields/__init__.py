from . import gf, host
from .gf import GF2, EXT_W, P

__all__ = ["gf", "host", "GF2", "P", "EXT_W"]
