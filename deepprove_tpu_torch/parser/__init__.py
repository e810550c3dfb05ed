"""Model-file parsers (ONNX)."""
