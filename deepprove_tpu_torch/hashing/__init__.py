from . import constants, poseidon2, poseidon2_cuda

__all__ = ["constants", "poseidon2", "poseidon2_cuda"]
