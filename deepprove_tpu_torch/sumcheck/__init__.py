from .fused import prove_device
from .fused import prove_fused as prove
from .prover import SumcheckProof, VirtualPolynomial
from .verifier import interpolate_uni_poly, verify

__all__ = [
    "SumcheckProof", "VirtualPolynomial", "prove", "prove_device", "verify",
    "interpolate_uni_poly",
]
