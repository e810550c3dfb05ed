from .prover import SumcheckProof, VirtualPolynomial, prove, prove_device
from .verifier import interpolate_uni_poly, verify

__all__ = [
    "SumcheckProof", "VirtualPolynomial", "prove", "prove_device", "verify",
    "interpolate_uni_poly",
]
