// The port's one kernel library: every CUDA source of this directory in one
// translation unit, so that one nvcc call builds it (deepprove_tpu_torch/
// kernels.py) and the kernels share one copy of the Poseidon2 constants.
//
//   poseidon2_compress.cu  the Merkle level (hashing/poseidon2_cuda.py)
//   transcript.cu          the Fiat-Shamir sponge (transcript/device.py)
//   sumcheck.cu            the sumcheck rounds (sumcheck/fused.py)
//
// Each source keeps its own names in one anonymous namespace and exports
// plain C entry points only (no PyTorch headers), so the build takes seconds.

#include "poseidon2_compress.cu"
#include "sumcheck.cu"
#include "transcript.cu"

// The message of a CUDA error code that an entry point returned.
extern "C" const char* dp_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
