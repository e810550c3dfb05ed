from . import lookup_context, model, quantization, tensor

__all__ = ["lookup_context", "model", "quantization", "tensor"]
