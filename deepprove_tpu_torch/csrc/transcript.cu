// The Fiat-Shamir sponge kernel: one launch applies one call of the
// transcript session (transcript/session.py) to the state in device memory.
//
// Replaces the JAX package's jitted sponge dispatches: transcript/device.py
// (observe, sample, observe_ext, sample_ext) as driven by
// transcript/session.py `_absorb_constants`, `_absorb_base_arr`,
// `_absorb_ext_arr`, `_sample_ext_vec`, `_challenge_vec`, `_challenge_multi`
// (:43-146). In eager torch one width-8 permutation would be thousands of
// launches; here a whole call is one.
//
// One call, in this order:
//   1. absorb `n_pre` constants given by value (labels, num_vars, degrees);
//   2. absorb a device array of n elements: base (a1 == nullptr) or
//      extension, a0[i] then a1[i] for each element;
//   3. squeeze k extension challenges (a0 sampled first), absorbing label
//      chunks before each one: none (n_labels == 0), label 0 before every
//      challenge (n_labels == 1), or label q before challenge q; the
//      challenges go to out (2, k): the a0 row, then the a1 row.
//
// What bounds it: latency. Every permutation depends on the one before:
// a permutation is 8 external rounds of 3 dependent multiplies (the S-box)
// and 22 internal rounds of 4, 112 dependent Goldilocks multiplies, each
// 32-bit partial products, their carries and a reduction. So one warp runs the call
// with the state in registers, a word a lane (transcript.cuh), which leaves
// each round the latency of its multiply chain and a few shuffles; the
// absorbed array is read 32 words at a time, the next 32 in flight while
// the current ones are absorbed, so no permutation waits on a load.

#include <cuda_runtime.h>

#include "transcript.cuh"

namespace {

constexpr int MAX_PRE = 16;
constexpr int MAX_LABELS = 4;
constexpr int MAX_LABEL_CHUNKS = 16;
constexpr int WARP = 32;

struct Script {
    u64 pre[MAX_PRE];
    u64 label_chunks[MAX_LABEL_CHUNKS];
    int label_off[MAX_LABELS + 1];
    int n_pre;
    int n_labels;
};

// Word w of the absorbed array in absorb order (a0[e], then a1[e] when the
// array is an extension one), 0 past its end.
__device__ __forceinline__ u64 array_word(const u64* a0, const u64* a1, long long words, long long w) {
    if (w >= words) return 0;
    if (!a1) return a0[w];
    return (w & 1) ? a1[w >> 1] : a0[w >> 1];
}

__global__ void __launch_bounds__(WARP) sponge_kernel(u64* state, Script sc, const u64* a0,
                                                       const u64* a1, long long n, long long k,
                                                       u64* out) {
    const int lane = threadIdx.x;
    sponge::State st;
    sponge::load(st, state);
    const long long words = a1 ? 2 * n : n;
    u64 cur = array_word(a0, a1, words, lane);  // in flight during the constants
    for (int i = 0; i < sc.n_pre; i++) sponge::observe(st, sc.pre[i]);
    for (long long b = 0; b < words; b += WARP) {
        const u64 next = array_word(a0, a1, words, b + WARP + lane);
        const int count = words - b < WARP ? (int)(words - b) : WARP;
        for (int w = 0; w < count; w++) sponge::observe(st, sponge::shfl(cur, w));
        cur = next;
    }
    for (long long q = 0; q < k; q++) {
        if (sc.n_labels) {
            const int l = sc.n_labels == 1 ? 0 : (int)q;
            for (int c = sc.label_off[l]; c < sc.label_off[l + 1]; c++)
                sponge::observe(st, sc.label_chunks[c]);
        }
        u64 x0, x1;
        sponge::sample_ext(st, x0, x1);
        if (lane == 0) {
            out[q] = x0;
            out[k + q] = x1;
        }
    }
    sponge::store(st, state);
}

// x[0] <- a chain of `iters` dependent products on x[0] in one thread: its
// time over `iters` is the latency of one dependent product. ORDER 0:
// gl::mul by x[1], the latency of one Goldilocks multiply. ORDER 1: the
// sponge's products (transcript.cuh) on a permutation's chain in their
// order, 112 a permutation (8 external S-boxes: a square, then two
// multiplies; 22 internal rounds: an S-box, then a multiply-add), the unit
// of the sponge-running kernels' bounds; `iters` a multiple of 112. The
// round loops stay rolled: unrolled, the chain's code outgrows the
// instruction cache and the time is that of fetching it.
template <int ORDER>
__global__ void __launch_bounds__(1) mul_chain_kernel(u64* x, long long iters) {
    u64 v = x[0];
    const u64 w = x[1];
    if (ORDER == 0) {
        for (long long i = 0; i < iters; i++) v = gl::mul(v, w);
    } else {
        for (long long i = 0; i < iters; i += 112) {
#pragma unroll 1
            for (int r = 0; r < 4; r++) v = sponge::mul(sponge::mul(sponge::sqr(v), w), w);
#pragma unroll 1
            for (int r = 0; r < 22; r++) v = sponge::mul_add(sponge::mul(sponge::mul(sponge::sqr(v), w), w), w, w);
#pragma unroll 1
            for (int r = 0; r < 4; r++) v = sponge::mul(sponge::mul(sponge::sqr(v), w), w);
        }
    }
    x[0] = gl::canonical(v);
}

}  // namespace

extern "C" int dp_mul_chain(void* x, long long iters, int order, void* stream) {
    if (order == 0) mul_chain_kernel<0><<<1, 1, 0, (cudaStream_t)stream>>>((u64*)x, iters);
    else if (order == 1 && iters % 112 == 0) mul_chain_kernel<1><<<1, 1, 0, (cudaStream_t)stream>>>((u64*)x, iters);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// Limits of one call, for the wrapper's checks.
extern "C" void dp_sponge_limits(int* max_pre, int* max_labels, int* max_label_chunks) {
    *max_pre = MAX_PRE;
    *max_labels = MAX_LABELS;
    *max_label_chunks = MAX_LABEL_CHUNKS;
}

// pre: n_pre constants; label_chunks / label_off: n_labels labels (label l
// = chunks [label_off[l], label_off[l + 1])). Launches on `stream`; returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int dp_sponge(void* state, const unsigned long long* pre, int n_pre,
                         const unsigned long long* label_chunks, const int* label_off,
                         int n_labels, const void* a0, const void* a1, long long n,
                         long long k, void* out, void* stream) {
    Script sc = {};
    if (n_pre > MAX_PRE || n_labels > MAX_LABELS || n_pre < 0 || n_labels < 0)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_pre; i++) sc.pre[i] = pre[i];
    if (n_labels) {
        if (label_off[n_labels] > MAX_LABEL_CHUNKS) return (int)cudaErrorInvalidValue;
        for (int l = 0; l <= n_labels; l++) sc.label_off[l] = label_off[l];
        for (int c = 0; c < label_off[n_labels]; c++) sc.label_chunks[c] = label_chunks[c];
    }
    sc.n_pre = n_pre;
    sc.n_labels = n_labels;
    sponge_kernel<<<1, WARP, 0, (cudaStream_t)stream>>>((u64*)state, sc, (const u64*)a0,
                                                     (const u64*)a1, n, k, (u64*)out);
    return (int)cudaGetLastError();
}
