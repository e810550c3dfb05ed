// One Merkle level of Poseidon2 two_to_one compression over Goldilocks.
//
// Replaces the TPU kernel `_compress_kernel` in
// deepprove_tpu/hashing/poseidon2_pallas.py (launched by `_compress_chunk`
// through pl.pallas_call). Same function: for each pair i of a plane-major
// (4, 2M) digest level, state = [left, 0, 0, 0, 0] -> permute -> rate lanes
// overwritten with right -> permute -> parent = [s3, s2, s1, s0], written to
// the (4, M) output. Width 8, 4 + 22 + 4 rounds, x^7 S-box.
//
// What bounds it on Hopper: the integer pipes, the IMAD pipe first (its wide
// and high 32-bit multiplies issue at about 24 and 31 an SM a clock, the low
// one at 64: scripts/int_mul_rates.cu, PERF.md). A pair is 2 permutations of
// 8*8*4 + 22*(4 + 8) = 520 Goldilocks multiplies each (1040 a pair), every
// one a 64x64 -> 128-bit product of 32-bit multiplies plus a reduction,
// against 96 bytes of device memory (64 read, 32 written). So one thread
// owns one pair, its 8-lane state in registers for all 60 rounds, and
// every instruction saved in the field arithmetic is time saved:
//   - the round loops are rolled and both permutations run through one loop
//     body (`#pragma unroll 1`), so the kernel is a few thousand
//     instructions and stays in the instruction cache; the constants are
//     read by round index from __constant__ memory, one word for the whole
//     warp (a broadcast);
//   - the 8 lanes of a round stay unrolled: in an external round they are
//     8 independent S-box chains for the scheduler to interleave;
//   - the product is one carry chain of 32-bit multiply-adds, the reduction
//     branch-free on the carry flags (goldilocks.cuh);
//   - values stay lazy (any u64 congruent mod p) and are brought below p
//     once, on the 4 output lanes; the linear layers sum unreduced into
//     64 + 32 bits and fold each lane once; the internal layer computes
//     st[i] * DIAG[i] + sum as one 128-bit multiply-add and one reduction;
//   - __launch_bounds__ caps the registers so that several blocks share an
//     SM with no spills.
// The TPU's fixed chunk sizes were a tiling choice; here any M >= 1 runs,
// the ragged last block masked.

#include <cuda_runtime.h>

#include "goldilocks.cuh"

#define P2_CONST __constant__
#include "poseidon2_constants.h"

namespace {

constexpr int THREADS = 256;   // a block
constexpr int MIN_BLOCKS = 4;  // resident an SM: 32 warps, at most 64 registers a thread

__device__ __forceinline__ u64 sbox(u64 x) {
    u64 x2 = gl::mul(x, x);
    u64 x3 = gl::mul(x2, x);
    u64 x4 = gl::mul(x2, x2);
    return gl::mul(x3, x4);  // x^7, three multiplies deep
}

// M4 = circ(2, 3, 1, 1) on s[0..4) (plonky3 MDSMat4), unreduced: each
// output sums 7 inputs.
__device__ __forceinline__ void m4(const u64* s, gl::wide* n) {
    gl::wide t01 = gl::wadd(s[0], s[1]);
    gl::wide t23 = gl::wadd(s[2], s[3]);
    gl::wide t0123 = gl::wadd(t01, t23);
    gl::wide t01123 = gl::wadd(t0123, s[1]);
    gl::wide t01233 = gl::wadd(t0123, s[3]);
    n[0] = gl::wadd(t01123, t01);
    n[1] = gl::wadd(t01123, gl::wadd(s[2], s[2]));
    n[2] = gl::wadd(t01233, t23);
    n[3] = gl::wadd(t01233, gl::wadd(s[0], s[0]));
}

// Both M4s, then each lane plus the sum of its two halves: every output
// sums 3 * 7 = 21 inputs, folded once.
__device__ __forceinline__ void external_linear(u64* st) {
    gl::wide a[4], b[4];
    m4(st, a);
    m4(st + 4, b);
#pragma unroll
    for (int k = 0; k < 4; k++) {
        gl::wide sum = gl::wadd(a[k], b[k]);
        st[k] = gl::fold(gl::wadd(a[k], sum));
        st[4 + k] = gl::fold(gl::wadd(b[k], sum));
    }
}

__device__ __forceinline__ void external_round(u64* st, const u64* rc) {
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = sbox(gl::add_const(st[i], rc[i]));
    external_linear(st);
}

__device__ __forceinline__ void internal_round(u64* st, u64 rc) {
    st[0] = sbox(gl::add_const(st[0], rc));
    gl::wide w = gl::wadd(st[0], st[1]);
#pragma unroll
    for (int i = 2; i < 8; i++) w = gl::wadd(w, st[i]);
    u64 sum = gl::fold(w);
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = gl::mul_add(st[i], DIAG[i], sum);
}

__device__ __forceinline__ void permute(u64* st) {
    external_linear(st);
#pragma unroll 1
    for (int r = 0; r < 4; r++) external_round(st, INIT_RC[r]);
#pragma unroll 1
    for (int r = 0; r < 22; r++) internal_round(st, INT_RC[r]);
#pragma unroll 1
    for (int r = 0; r < 4; r++) external_round(st, TERM_RC[r]);
}

// in: (4, 2m) row-major; out: (4, m) row-major. Thread i owns pair i.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
compress_level_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long m) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const long long w = 2 * m;
    u64 st[8];
#pragma unroll
    for (int k = 0; k < 4; k++) {
        st[k] = in[k * w + 2 * i];
        st[4 + k] = 0;
    }
    // one permutation body for both absorptions: left, then right
#pragma unroll 1
    for (int half = 0; half < 2; half++) {
        if (half) {
#pragma unroll
            for (int k = 0; k < 4; k++) st[k] = in[k * w + 2 * i + 1];
        }
        permute(st);
    }
#pragma unroll
    for (int k = 0; k < 4; k++) out[k * m + i] = gl::canonical(st[3 - k]);
}

// Row r of out (4, n) = op r of goldilocks.cuh on the lazy operands a, b, c:
// mul(a, b), mul_add(a, b, c), add_const(a, c mod p), and the 21-term sum
// 7a + 7b + 7c folded once (the external layer's widest), made canonical.
__global__ void goldilocks_probe_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                                        const u64* __restrict__ c, u64* __restrict__ out,
                                        long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u64 x = a[i], y = b[i], z = c[i];
    gl::wide w = gl::wadd(gl::wadd(x, y), z);
    for (int k = 1; k < 7; k++) w = gl::wadd(gl::wadd(gl::wadd(w, x), y), z);
    out[i] = gl::canonical(gl::mul(x, y));
    out[n + i] = gl::canonical(gl::mul_add(x, y, z));
    out[2 * n + i] = gl::canonical(gl::add_const(x, gl::canonical(z)));
    out[3 * n + i] = gl::canonical(gl::fold(w));
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = success).
extern "C" int dp_poseidon2_compress_level(const void* in, void* out, long long m,
                                           void* stream) {
    const long long blocks = (m + THREADS - 1) / THREADS;
    compress_level_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, m);
    return (int)cudaGetLastError();
}

// Block size and resident blocks an SM of the compression kernel.
extern "C" int dp_poseidon2_launch_config(int* threads, int* blocks_per_sm) {
    *threads = THREADS;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                              compress_level_kernel, THREADS, 0);
}

extern "C" int dp_goldilocks_probe(const void* a, const void* b, const void* c, void* out,
                                   long long n, void* stream) {
    const int threads = 256;
    goldilocks_probe_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                              (cudaStream_t)stream>>>((const u64*)a, (const u64*)b,
                                                      (const u64*)c, (u64*)out, n);
    return (int)cudaGetLastError();
}

extern "C" const char* dp_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
