from . import activation, convolution, dense, pooling, requant, shape_ops

__all__ = ["activation", "convolution", "dense", "pooling", "requant", "shape_ops"]
