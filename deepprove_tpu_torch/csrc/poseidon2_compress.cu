// One Merkle level of Poseidon2 two_to_one compression over Goldilocks.
//
// Replaces the TPU kernel `_compress_kernel` in
// deepprove_tpu/hashing/poseidon2_pallas.py (launched by `_compress_chunk`
// through pl.pallas_call). Same function: for each pair i of a plane-major
// (4, 2M) digest level, state = [left, 0, 0, 0, 0] -> permute -> rate lanes
// overwritten with right -> permute -> parent = [s3, s2, s1, s0], written to
// the (4, M) output. Width 8, 4 + 22 + 4 rounds, x^7 S-box.
//
// What bounds it on Hopper: integer multiplies. A pair costs 2 permutations
// of 8*8*4 + 22*(4 + 8) = 520 Goldilocks multiplies each (1040 per pair),
// every one a 64x64->128 product built from 32-bit IMADs, against 96 bytes
// of device memory traffic (64 read, 32 written). The design follows from
// that: one thread per pair with the 8-lane state in registers for all 60
// rounds, one read of the children and one write of the parent; the round
// constants sit in __constant__ memory, where every lane of a warp reads
// the same word (a broadcast). The TPU's fixed chunk sizes were a tiling
// choice; here any M >= 1 runs, the ragged last block masked.

#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define P2_CONST __constant__
#include "poseidon2_constants.h"

namespace {

__device__ __forceinline__ u64 sbox(u64 x) {
    u64 x2 = gl::mul(x, x);
    u64 x4 = gl::mul(x2, x2);
    u64 x6 = gl::mul(x4, x2);
    return gl::mul(x6, x);
}

// M4 = circ(2, 3, 1, 1) on s[0..4) in place (plonky3 MDSMat4).
__device__ __forceinline__ void m4(u64* s) {
    u64 t01 = gl::add(s[0], s[1]);
    u64 t23 = gl::add(s[2], s[3]);
    u64 t0123 = gl::add(t01, t23);
    u64 t01123 = gl::add(t0123, s[1]);
    u64 t01233 = gl::add(t0123, s[3]);
    u64 n3 = gl::add(t01233, gl::add(s[0], s[0]));
    u64 n1 = gl::add(t01123, gl::add(s[2], s[2]));
    u64 n0 = gl::add(t01123, t01);
    u64 n2 = gl::add(t01233, t23);
    s[0] = n0;
    s[1] = n1;
    s[2] = n2;
    s[3] = n3;
}

__device__ __forceinline__ void external_linear(u64* st) {
    m4(st);
    m4(st + 4);
#pragma unroll
    for (int k = 0; k < 4; k++) {
        u64 sum = gl::add(st[k], st[4 + k]);
        st[k] = gl::add(st[k], sum);
        st[4 + k] = gl::add(st[4 + k], sum);
    }
}

__device__ __forceinline__ void permute(u64* st) {
    external_linear(st);
#pragma unroll
    for (int r = 0; r < 4; r++) {
#pragma unroll
        for (int i = 0; i < 8; i++) st[i] = sbox(gl::add(st[i], INIT_RC[r][i]));
        external_linear(st);
    }
#pragma unroll
    for (int r = 0; r < 22; r++) {
        st[0] = sbox(gl::add(st[0], INT_RC[r]));
        u64 sum = st[0];
#pragma unroll
        for (int i = 1; i < 8; i++) sum = gl::add(sum, st[i]);
#pragma unroll
        for (int i = 0; i < 8; i++) st[i] = gl::add(gl::mul(st[i], DIAG[i]), sum);
    }
#pragma unroll
    for (int r = 0; r < 4; r++) {
#pragma unroll
        for (int i = 0; i < 8; i++) st[i] = sbox(gl::add(st[i], TERM_RC[r][i]));
        external_linear(st);
    }
}

// in: (4, 2m) row-major; out: (4, m) row-major. Thread i owns pair i.
__global__ void compress_level_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                                      long long m) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const long long w = 2 * m;
    u64 st[8];
    u64 right[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
        st[k] = in[k * w + 2 * i];
        right[k] = in[k * w + 2 * i + 1];
        st[4 + k] = 0;
    }
    permute(st);
#pragma unroll
    for (int k = 0; k < 4; k++) st[k] = right[k];
    permute(st);
#pragma unroll
    for (int k = 0; k < 4; k++) out[k * m + i] = st[3 - k];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = success).
extern "C" int dp_poseidon2_compress_level(const void* in, void* out, long long m,
                                           void* stream) {
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    compress_level_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, m);
    return (int)cudaGetLastError();
}

extern "C" const char* dp_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
