from .context import Context
from .prover import Prover
from .verifier import IO, verify

__all__ = ["Context", "IO", "Prover", "verify"]
