"""One-call API, as in the JAX package's `api.py`: ONNX -> FloatModel ->
`quantize` -> `Context.generate` -> `Prover.prove` -> `verify`.

    from deepprove_tpu_torch.api import prove_onnx, verify_proof

    result = prove_onnx("model.onnx", [x0, x1], strategy="inference")
    verify_proof(result)  # raises on any failure

Everything runs on the card unless `device="cpu"` is passed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as device_mod
from .parser.onnx import load_onnx
from .transcript import default_transcript
from .zkml.float_model import quantize
from .zkml.iop import IO, Context, Prover, verify
from .zkml.tensor import Tensor


@dataclasses.dataclass
class ProofResult:
    ctx: Context
    proof: object
    io: IO
    outputs_dequantized: list


def prove_model(model, quantized_inputs: list[Tensor], device="cuda", **pcs_kw) -> ProofResult:
    """Prove inference of an already-quantized Model on the given inputs."""
    dev = device_mod.resolve(device)
    trace = model.run(quantized_inputs, device=dev)
    ctx = Context.generate(model, device=dev, **pcs_kw)
    proof = Prover(ctx, default_transcript(), device=dev).prove(trace)
    io = IO(inputs=trace.inputs, outputs=trace.outputs)
    return ProofResult(ctx=ctx, proof=proof, io=io, outputs_dequantized=[])


def prove_onnx(path: str, inputs: list, strategy: str = "absolute_max",
               calibration_inputs: list | None = None, device="cuda", **pcs_kw) -> ProofResult:
    """Load and quantize an ONNX model and prove inference on its FIRST input
    (the others only calibrate the "inference" strategy)."""
    dev = device_mod.resolve(device)
    fm = load_onnx(path)
    calib = calibration_inputs or (inputs if strategy == "inference" else None)
    model, s_in, s_out = quantize(fm, strategy=strategy, calibration_inputs=calib, device=dev)
    xq = Tensor(torch.from_numpy(s_in.quantize(np.asarray(inputs[0], dtype=np.float64))).to(dev))
    result = prove_model(model, [xq], device=dev, **pcs_kw)
    result.outputs_dequantized = [s_out.dequantize(t.data.cpu().numpy()) for t in result.io.outputs]
    return result


def verify_proof(result: ProofResult) -> None:
    """Verify with a fresh transcript on the context's device; raises on failure."""
    verify(result.ctx, result.proof, result.io, default_transcript(), device=result.ctx.device)
