from . import activation, add, convolution, dense, embeddings, layernorm, matmul, pad, pooling, requant, shape_ops

__all__ = ["activation", "add", "convolution", "dense", "embeddings", "layernorm", "matmul", "pad", "pooling",
           "requant", "shape_ops"]
