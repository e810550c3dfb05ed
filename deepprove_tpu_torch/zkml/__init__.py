from . import model, quantization, tensor

__all__ = ["model", "quantization", "tensor"]
