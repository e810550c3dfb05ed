// The sumcheck rounds on the device, with the Fiat-Shamir sponge in the same
// launches: no round reads the host.
//
// Replaces the JAX package's jitted round loop, sumcheck/fused.py
// `_round_step_kernel` (:164) and `_fused_kernel` (:64). It proves
//   sum_{x in {0,1}^n} sum_p c_p prod_f rows[idx[p][f]](x)
// over a stacked (m, 2^n) extension array held as two int64 planes (the a0
// plane, then the a1 plane, row-major). Each round: fold the previous
// round's challenge into every row (the lowest variable), form the round
// message (the sum at t = 0..D of the lowest variable), absorb it with the
// label b"Internal round" and squeeze the next challenge. A factor index of
// -1 is the constant 1 (it pads a product of lower degree).
//
// Three kernels, D (the degree, 1..5) a template parameter:
//   round_kernel  one grid-wide pass: folds the rows by the challenge read
//                 from device memory (none in round 0) into a second buffer
//                 (ping-pong: a fold in place would race), reads its own
//                 folded pairs back, and writes the block's partial message
//                 to scratch;
//   finish_kernel one block: sums the partials, writes the message, runs the
//                 sponge (transcript.cuh) and writes the challenge where the
//                 next round_kernel reads it;
//   tail_kernel   one block: every remaining round once the rows are short,
//                 fold, message, sponge, with __syncthreads between steps,
//                 then the last fold into the final evaluations.
// So a sumcheck of n variables is 2 launches a round above the tail and one
// for the tail (sumcheck/fused.py picks the split).
//
// What bounds them: round_kernel reads the m rows (16 bytes an element) and
// writes their halves once, and does 3 multiplies a fold and about D (D + 1)
// extension multiplies a product a pair: at the main path's degrees (2 and
// 3) the device memory, at degree 5 with few rows the multiplies. The
// finish and tail kernels are latency: the sponge is one thread running
// dependent permutations (transcript.cuh), and a tail round is a block's pass
// over at most 2^(TAIL_LOG + 1) entries a row. The design keeps every round's
// data and challenge on the device, so that no launch waits on the host.
//
// Arithmetic is canonical (every value below p), so messages, challenges and
// evaluations equal the plain torch version bit for bit.

#include <cuda_runtime.h>

#include "transcript.cuh"

namespace {

constexpr int MAX_DEGREE = 5;
constexpr int ROUND_THREADS = 256;  // round_kernel and finish_kernel blocks
constexpr int TAIL_THREADS = 512;  // the tail's one block: at most 128 registers a thread
constexpr u64 P = gl::P;

struct ext {
    u64 a0, a1;
};

__device__ __forceinline__ u64 fadd(u64 a, u64 b) {
    u64 s = a + b;
    return (s < a || s >= P) ? s - P : s;  // a carry dropped 2^64: s - p wraps back
}

__device__ __forceinline__ u64 fsub(u64 a, u64 b) {
    u64 d = a - b;
    return a < b ? d + P : d;
}

__device__ __forceinline__ u64 fmul(u64 a, u64 b) { return gl::canonical(gl::mul(a, b)); }

__device__ __forceinline__ ext eadd(ext a, ext b) { return {fadd(a.a0, b.a0), fadd(a.a1, b.a1)}; }

__device__ __forceinline__ ext esub(ext a, ext b) { return {fsub(a.a0, b.a0), fsub(a.a1, b.a1)}; }

// Karatsuba over X^2 = 7, as fields/gf.py `ext_mul`.
__device__ __forceinline__ ext emul(ext a, ext b) {
    u64 t0 = fmul(a.a0, b.a0);
    u64 t1 = fmul(a.a1, b.a1);
    u64 t2 = fmul(fadd(a.a0, a.a1), fadd(b.a0, b.a1));
    return {gl::canonical(gl::mul_add(t1, 7, t0)), fsub(fsub(t2, t0), t1)};
}

__device__ __forceinline__ ext load(const u64* p0, const u64* p1, long long i) {
    return {p0[i], p1[i]};
}

// One pair j of one round, added into sums[0..D]. Rows of the source are
// L long. With `fold`, entries 4j..4j+3 of each row fold by r into entries
// 2j, 2j+1 of the destination (rows L / 2 long), and the pair is read back
// from there; else the pair is entries 2j, 2j+1 of the source.
template <int D>
__device__ __forceinline__ void round_pass(long long j, bool fold, const u64* s0, const u64* s1,
                                           u64* d0, u64* d1, int m, long long L, ext r,
                                           const int* fidx, int np, const u64* c0,
                                           const u64* c1, ext* sums) {
    const u64 *v0 = s0, *v1 = s1;
    long long ld = L;
    if (fold) {
        const long long half = L >> 1;
        for (int i = 0; i < m; i++) {
            const long long s = (long long)i * L + 4 * j;
            ext x0 = load(s0, s1, s), x1 = load(s0, s1, s + 1);
            ext x2 = load(s0, s1, s + 2), x3 = load(s0, s1, s + 3);
            ext lo = eadd(x0, emul(r, esub(x1, x0)));
            ext hi = eadd(x2, emul(r, esub(x3, x2)));
            const long long d = (long long)i * half + 2 * j;
            d0[d] = lo.a0;
            d1[d] = lo.a1;
            d0[d + 1] = hi.a0;
            d1[d + 1] = hi.a1;
        }
        v0 = d0;
        v1 = d1;
        ld = half;
    }
    for (int p = 0; p < np; p++) {
        ext acc[D + 1];
        bool any = false;
#pragma unroll
        for (int f = 0; f < D; f++) {
            const int row = fidx[p * D + f];
            if (row < 0) continue;  // the constant 1
            const long long o = (long long)row * ld + 2 * j;
            ext lo = load(v0, v1, o), hi = load(v0, v1, o + 1);
            ext diff = esub(hi, lo);
            ext v = lo;
#pragma unroll
            for (int t = 0; t <= D; t++) {
                if (t == 1) v = hi;
                else if (t >= 2) v = eadd(v, diff);
                if (any) acc[t] = emul(acc[t], v);
                else acc[t] = v;
            }
            any = true;
        }
        if (!any) {
#pragma unroll
            for (int t = 0; t <= D; t++) acc[t] = {1, 0};
        }
        const ext c = load(c0, c1, p);
#pragma unroll
        for (int t = 0; t <= D; t++) sums[t] = eadd(sums[t], emul(c, acc[t]));
    }
}

// The block's sums into total[0..2(D + 1)) (t-major, a0 then a1); every
// thread of the block takes part. red holds (blockDim / 32) * 2(D + 1) words.
template <int D>
__device__ __forceinline__ void block_sum(const ext* sums, u64* red, u64* total) {
    constexpr int V = 2 * (D + 1);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
    for (int t = 0; t <= D; t++) {
        u64 a = sums[t].a0, b = sums[t].a1;
#pragma unroll
        for (int off = 16; off; off >>= 1) {
            a = fadd(a, (u64)__shfl_down_sync(0xffffffffu, (unsigned long long)a, off));
            b = fadd(b, (u64)__shfl_down_sync(0xffffffffu, (unsigned long long)b, off));
        }
        if (lane == 0) {
            red[warp * V + 2 * t] = a;
            red[warp * V + 2 * t + 1] = b;
        }
    }
    __syncthreads();
    if (threadIdx.x < V) {
        u64 s = 0;
        for (int w = 0; w < nwarps; w++) s = fadd(s, red[w * V + threadIdx.x]);
        total[threadIdx.x] = s;
    }
    __syncthreads();
}

// One thread: write message `rnd` (total, t-major) into msgs (2, n, D + 1),
// absorb it and the round label, squeeze the challenge into chals (2, n).
template <int D>
__device__ ext absorb_and_squeeze(const u64* total, int rnd, int n, u64* msgs, u64* chals,
                                  u64* state) {
    sponge::State st;
    sponge::load(st, state);
    const long long plane = (long long)n * (D + 1);
    for (int t = 0; t <= D; t++) {
        const u64 a0 = total[2 * t], a1 = total[2 * t + 1];
        msgs[rnd * (D + 1) + t] = a0;
        msgs[plane + rnd * (D + 1) + t] = a1;
        sponge::observe(st, a0);
        sponge::observe(st, a1);
    }
    sponge::observe(st, sponge::ROUND_LABEL_0);
    sponge::observe(st, sponge::ROUND_LABEL_1);
    const u64 a0 = sponge::sample(st);
    const u64 a1 = sponge::sample(st);
    chals[rnd] = a0;
    chals[n + rnd] = a1;
    sponge::store(st, state);
    return {a0, a1};
}

template <int D>
__global__ void __launch_bounds__(ROUND_THREADS)
round_kernel(const u64* __restrict__ s0, const u64* __restrict__ s1, u64* d0, u64* d1, int m,
             long long L, const u64* r0, const u64* r1, const int* __restrict__ fidx, int np,
             const u64* __restrict__ c0, const u64* __restrict__ c1, u64* __restrict__ partials) {
    constexpr int V = 2 * (D + 1);
    __shared__ u64 red[(ROUND_THREADS / 32) * V];
    __shared__ u64 total[V];
    const bool fold = r0 != nullptr;
    const long long count = fold ? L / 4 : L / 2;
    const long long j = (long long)blockIdx.x * ROUND_THREADS + threadIdx.x;
    ext sums[D + 1];
#pragma unroll
    for (int t = 0; t <= D; t++) sums[t] = {0, 0};
    if (j < count) {
        const ext r = fold ? ext{*r0, *r1} : ext{0, 0};
        round_pass<D>(j, fold, s0, s1, d0, d1, m, L, r, fidx, np, c0, c1, sums);
    }
    block_sum<D>(sums, red, total);
    if (threadIdx.x < V) partials[(long long)blockIdx.x * V + threadIdx.x] = total[threadIdx.x];
}

template <int D>
__global__ void __launch_bounds__(ROUND_THREADS)
finish_kernel(const u64* __restrict__ partials, long long nblocks, int rnd, int n, u64* msgs,
              u64* chals, u64* state) {
    constexpr int V = 2 * (D + 1);
    __shared__ u64 red[(ROUND_THREADS / 32) * V];
    __shared__ u64 total[V];
    ext sums[D + 1];
#pragma unroll
    for (int t = 0; t <= D; t++) sums[t] = {0, 0};
    for (long long b = threadIdx.x; b < nblocks; b += ROUND_THREADS) {
#pragma unroll
        for (int t = 0; t <= D; t++)
            sums[t] = eadd(sums[t], load(partials + 2 * t, partials + 2 * t + 1, b * V));
    }
    block_sum<D>(sums, red, total);
    if (threadIdx.x == 0) absorb_and_squeeze<D>(total, rnd, n, msgs, chals, state);
}

// Rounds rnd0..n-1 on rows of length L in buffer x (folding first by
// challenge rnd0 - 1 when rnd0 > 0), ping-ponging with buffer y (rows of at
// least L / 2); then the last fold into finals (2, m). No pointer is
// restrict or read through the read-only path: both buffers are written
// and read again inside the launch.
template <int D>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_kernel(u64* x0, u64* x1, u64* y0, u64* y1, int m, long long L, int rnd0, int n,
            const int* fidx, int np, const u64* c0, const u64* c1, u64* msgs, u64* chals,
            u64* state, u64* finals) {
    constexpr int V = 2 * (D + 1);
    __shared__ u64 red[(TAIL_THREADS / 32) * V];
    __shared__ u64 total[V];
    __shared__ u64 rs[2];
    bool fold = rnd0 > 0;
    if (threadIdx.x == 0 && fold) {
        rs[0] = chals[rnd0 - 1];
        rs[1] = chals[n + rnd0 - 1];
    }
    __syncthreads();
    long long len = L;
    for (int rnd = rnd0; rnd < n; rnd++) {
        const ext r = {rs[0], rs[1]};
        const long long count = fold ? len / 4 : len / 2;
        ext sums[D + 1];
#pragma unroll
        for (int t = 0; t <= D; t++) sums[t] = {0, 0};
        for (long long j = threadIdx.x; j < count; j += TAIL_THREADS)
            round_pass<D>(j, fold, x0, x1, y0, y1, m, len, r, fidx, np, c0, c1, sums);
        block_sum<D>(sums, red, total);
        if (threadIdx.x == 0) {
            const ext nr = absorb_and_squeeze<D>(total, rnd, n, msgs, chals, state);
            rs[0] = nr.a0;
            rs[1] = nr.a1;
        }
        if (fold) {
            u64* t0 = x0;
            u64* t1 = x1;
            x0 = y0;
            x1 = y1;
            y0 = t0;
            y1 = t1;
            len >>= 1;
        }
        fold = true;
        __syncthreads();
    }
    // len == 2: fold the last challenge in
    const ext r = {rs[0], rs[1]};
    for (int i = threadIdx.x; i < m; i += TAIL_THREADS) {
        const ext lo = load(x0, x1, (long long)i * len), hi = load(x0, x1, (long long)i * len + 1);
        const ext f = eadd(lo, emul(r, esub(hi, lo)));
        finals[i] = f.a0;
        finals[m + i] = f.a1;
    }
}

}  // namespace

#define DP_DISPATCH(degree, LAUNCH) \
    switch (degree) {               \
        case 1: LAUNCH(1); break;   \
        case 2: LAUNCH(2); break;   \
        case 3: LAUNCH(3); break;   \
        case 4: LAUNCH(4); break;   \
        case 5: LAUNCH(5); break;   \
        default: return (int)cudaErrorInvalidValue; \
    }

extern "C" int dp_sumcheck_limits(int* max_degree, int* threads) {
    *max_degree = MAX_DEGREE;
    *threads = ROUND_THREADS;
    return 0;
}

// One round above the tail. r0/r1 point at the previous challenge (both
// null in round 0: no fold, d0/d1 unused); partials gets one 2(D + 1)-word
// row per block of ROUND_THREADS pairs. Returns cudaGetLastError() of the launch.
extern "C" int dp_sumcheck_round(int degree, const void* s0, const void* s1, void* d0, void* d1,
                                 int m, long long L, const void* r0, const void* r1,
                                 const void* fidx, int np, const void* c0, const void* c1,
                                 void* partials, void* stream) {
    const long long count = r0 ? L / 4 : L / 2;
    const unsigned blocks = (unsigned)((count + ROUND_THREADS - 1) / ROUND_THREADS);
#define DP_ROUND(D)                                                                          \
    round_kernel<D><<<blocks, ROUND_THREADS, 0, (cudaStream_t)stream>>>(                            \
        (const u64*)s0, (const u64*)s1, (u64*)d0, (u64*)d1, m, L, (const u64*)r0,             \
        (const u64*)r1, (const int*)fidx, np, (const u64*)c0, (const u64*)c1, (u64*)partials)
    DP_DISPATCH(degree, DP_ROUND)
#undef DP_ROUND
    return (int)cudaGetLastError();
}

extern "C" int dp_sumcheck_finish(int degree, const void* partials, long long nblocks, int rnd,
                                  int n, void* msgs, void* chals, void* state, void* stream) {
#define DP_FINISH(D)                                                                   \
    finish_kernel<D><<<1, ROUND_THREADS, 0, (cudaStream_t)stream>>>(                          \
        (const u64*)partials, nblocks, rnd, n, (u64*)msgs, (u64*)chals, (u64*)state)
    DP_DISPATCH(degree, DP_FINISH)
#undef DP_FINISH
    return (int)cudaGetLastError();
}

extern "C" int dp_sumcheck_tail(int degree, void* x0, void* x1, void* y0, void* y1, int m,
                                long long L, int rnd0, int n, const void* fidx, int np,
                                const void* c0, const void* c1, void* msgs, void* chals,
                                void* state, void* finals, void* stream) {
#define DP_TAIL(D)                                                                          \
    tail_kernel<D><<<1, TAIL_THREADS, 0, (cudaStream_t)stream>>>(                                 \
        (u64*)x0, (u64*)x1, (u64*)y0, (u64*)y1, m, L, rnd0, n, (const int*)fidx, np,        \
        (const u64*)c0, (const u64*)c1, (u64*)msgs, (u64*)chals, (u64*)state, (u64*)finals)
    DP_DISPATCH(degree, DP_TAIL)
#undef DP_TAIL
    return (int)cudaGetLastError();
}
