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

#include "poseidon2.cuh"

namespace {

constexpr int THREADS = 256;   // a block
constexpr int MIN_BLOCKS = 4;  // resident an SM: 32 warps, at most 64 registers a thread

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
        p2::permute(st);
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
