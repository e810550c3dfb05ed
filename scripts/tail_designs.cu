// Measurements behind the sponge's and the sumcheck kernels' designs, for
// `scripts/tail_designs.py` to time on the card. Built as one shared library
// with the port's kernel library in the same translation unit, so that
// every kernel here runs the library's own device functions and adds only
// a loop around them, or a copy that undoes a choice:
//   - the permutation: a chain of permutations by one warp with a state
//     word a lane (transcript.cuh `sponge::permute`, as the sponge runs
//     it), by one thread holding all 8 words (poseidon2.cuh `p2::permute`,
//     as the Merkle kernel runs it), by the design before the finish
//     kernel's redesign (namespace `before`, with and without its internal
//     rounds' broadcast shuffle), and by the library's with its external
//     layer gathered in one level of shuffles (namespace `gather`);
//   - the finish kernel's parts: its partial sum alone and its sponge call
//     alone, for the library's design and for the design before it
//     (namespace `before`: copies of the earlier device functions, kept
//     here only to be timed beside the library's), and an empty kernel;
//   - the tail's sponge calls alone: `rounds` calls of absorb_and_squeeze
//     by one warp, the state parked in shared memory between calls as the
//     tail parks it;
//   - the barriers alone: `rounds` x 3 cluster barriers, or grid barriers,
//     in one launch (the tail's 3 a round).

#include "kernels.cu"

namespace {

constexpr int BARRIER_THREADS = 512;  // a block of the barrier kernels, as the tail's

// The finish kernel's design before its redesign, as the library had it:
// lane 0 alone keeps the internal rounds' S-box and broadcasts it by a
// shuffle, the products are goldilocks.cuh's (one carry chain of 32-bit
// multiply-adds), the sponge call takes a step a word, and the finish
// kernel's threads walk the partials a row at a time. `BROADCAST` false
// leaves that shuffle out (lane 0's S-box is not shared, so the values are
// wrong): the shuffle's cost on the chain.
namespace before {

using sponge::Consts;
using sponge::FULL;
using sponge::RATE;
using sponge::shfl8;
using sponge::shfl8_xor;
using sponge::State;  // and sponge::load: the state and constants as the library loads them
// (the calls below name before:: where the library has a function of the same name)

__device__ __forceinline__ u64 external_linear(u64 x, int i) {
    const int g = i & 4, k = i & 3;
    const u64 a = shfl8(x, g | ((k + 1) & 3));
    const u64 b = shfl8(x, g | ((k + 2) & 3));
    const u64 c = shfl8(x, g | ((k + 3) & 3));
    const gl::wide xa = gl::wadd(x, a);
    const gl::wide n = gl::wadd(gl::wadd(xa, xa), gl::wadd(gl::wadd(b, c), a));
    return gl::fold(gl::wadd(gl::wadd(n, n), shfl8_xor(n, 4)));
}

template <bool BROADCAST>
__device__ __forceinline__ u64 internal_rounds(u64 x, int i, u64 diag) {
    u64 rc = INT_RC[0];
#pragma unroll 1
    for (int r = 0; r < 22; r++) {
        const u64 next = INT_RC[r < 21 ? r + 1 : r];
        gl::wide w = {i == 0 ? 0 : x, 0};
        w = gl::wadd(w, shfl8_xor(w, 1));
        w = gl::wadd(w, shfl8_xor(w, 2));
        w = gl::wadd(w, shfl8_xor(w, 4));
        const u64 s0 = p2::sbox(gl::add_const(x, rc));
        const u64 sum = gl::fold(gl::wadd(w, BROADCAST ? shfl8(s0, 0) : s0));
        x = gl::mul_add(i == 0 ? s0 : x, diag, sum);
        rc = next;
    }
    return x;
}

__device__ __forceinline__ u64 pick(const u64* a, int r) {
    return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

template <bool BROADCAST = true>
__device__ __forceinline__ u64 permute(u64 x, int i, const Consts& c) {
    x = external_linear(x, i);
#pragma unroll 1
    for (int r = 0; r < 4; r++) x = external_linear(p2::sbox(gl::add_const(x, pick(c.init_rc, r))), i);
    x = internal_rounds<BROADCAST>(x, i, c.diag);
#pragma unroll 1
    for (int r = 0; r < 4; r++) x = external_linear(p2::sbox(gl::add_const(x, pick(c.term_rc, r))), i);
    return x;
}

__device__ __forceinline__ void duplex(State& st) {
    const int i = sponge::word();
    if (i < st.ilen) st.s = st.ibuf;
    st.ibuf = 0;
    st.s = gl::canonical(before::permute<true>(st.s, i, st.c));
    st.obuf = st.s;
    st.ilen = 0;
    st.olen = RATE;
}

__device__ __forceinline__ u64 step(State& st, u64 v, bool squeeze) {
    if (squeeze ? (st.ilen > 0 || st.olen == 0) : st.ilen == RATE) before::duplex(st);
    if (squeeze) {
        st.olen--;
        return shfl8(st.obuf, st.olen);
    }
    if (sponge::word() == st.ilen) st.ibuf = v;
    st.ilen++;
    st.olen = 0;
    return 0;
}

__device__ __forceinline__ void store(State& st, u64* g) {
    if (st.ilen == RATE) before::duplex(st);
    const int i = sponge::word();
    if ((threadIdx.x & 31) >= 8) return;
    g[i] = st.s;
    if (i < RATE) {
        g[8 + i] = st.ibuf;
        g[13 + i] = st.obuf;
    }
    if (i == 0) {
        g[12] = (u64)st.ilen;
        g[17] = (u64)st.olen;
    }
}

template <int D>
__device__ __forceinline__ ext absorb_and_squeeze(State& st, u64 word, int rnd, int n, u64* msgs, u64* chals) {
    constexpr int V = 2 * (D + 1);
    const int lane = threadIdx.x & 31;
    if (lane < V) msgs[(long long)(lane & 1) * n * (D + 1) + rnd * (D + 1) + (lane >> 1)] = word;
    const u64 mine = lane < V ? word : lane == V ? sponge::ROUND_LABEL_0 : sponge::ROUND_LABEL_1;
    ext c;
#pragma unroll 1
    for (int w = 0; w < V + 4; w++) {
        const u64 out = before::step(st, sponge::shfl(mine, w < V + 2 ? w : 0), w >= V + 2);
        if (w == V + 2) c.a0 = out;
        if (w == V + 3) c.a1 = out;
    }
    if (lane == 0) {
        chals[rnd] = c.a0;
        chals[n + rnd] = c.a1;
    }
    return c;
}

// the partial sum: a row of V words at a time, then the shuffle-first block sum
template <int D>
__device__ __forceinline__ void partial_sum(const u64* partials, long long nblocks, u64* red, u64* total) {
    constexpr int V = 2 * (D + 1);
    ext sums[D + 1];
#pragma unroll
    for (int t = 0; t <= D; t++) sums[t] = {0, 0};
    for (long long b = threadIdx.x; b < nblocks; b += ROUND_THREADS) {
#pragma unroll
        for (int t = 0; t <= D; t++)
            sums[t] = eadd(sums[t], ::load(partials + 2 * t, partials + 2 * t + 1, b * V));
    }
    block_sum<D>(sums, red, total);
}

}  // namespace before

// The library's permutation with its external layer gathered in one level
// of shuffles: every lane gathers the other seven words and forms its
// output alone (against the library's three shuffles within a half, then
// one across the halves).
namespace gather {

__device__ __forceinline__ gl::wide m4_row(const u64* v) {  // 2 v0 + 3 v1 + v2 + v3
    const gl::wide v01 = gl::wadd(v[0], v[1]);
    return gl::wadd(gl::wadd(v01, v01), gl::wadd(gl::wadd(v[1], v[2]), v[3]));
}

__device__ __forceinline__ u64 external_linear(u64 x, int i, u64 c) {
    const int g = i & 4, k = i & 3;
    u64 a[4], b[4];  // the own half and the other half from word k on
    a[0] = x;
#pragma unroll
    for (int j = 1; j < 4; j++) a[j] = sponge::shfl8(x, g | ((k + j) & 3));
#pragma unroll
    for (int j = 0; j < 4; j++) b[j] = sponge::shfl8(x, (g ^ 4) | ((k + j) & 3));
    const gl::wide ma = m4_row(a);
    return gl::fold(gl::wadd(gl::wadd(gl::wadd(ma, ma), c), m4_row(b)));
}

__device__ __forceinline__ u64 external_rounds(u64 x, int i, u64 c1, u64 c2, u64 c3, u64 c4) {
#pragma unroll 1
    for (int r = 0; r < 4; r++) {
        x = external_linear(sponge::sbox(x), i, c1);
        c1 = c2;
        c2 = c3;
        c3 = c4;
    }
    return x;
}

__device__ __forceinline__ u64 permute(u64 x, int i, const sponge::Consts& c) {
    x = external_linear(x, i, c.init_rc[0]);
    x = external_rounds(x, i, c.init_rc[1], c.init_rc[2], c.init_rc[3], i == 0 ? INT_RC[0] : 0);
    x = sponge::internal_rounds(x, i, c.diag, c.term_rc[0]);
    return external_rounds(x, i, c.term_rc[1], c.term_rc[2], c.term_rc[3], 0);
}

}  // namespace gather

// The finish kernel before its redesign, whole and in its two parts.
template <int D>
__global__ void __launch_bounds__(ROUND_THREADS)
before_finish_kernel(const u64* partials, long long nblocks, int rnd, int n, u64* msgs, u64* chals, u64* state) {
    constexpr int V = 2 * (D + 1);
    __shared__ u64 red[(ROUND_THREADS / 32) * V];
    __shared__ u64 total[V];
    sponge::State st;
    if (threadIdx.x < 32) sponge::load(st, state);
    before::partial_sum<D>(partials, nblocks, red, total);
    if (threadIdx.x < 32) {
        before::absorb_and_squeeze<D>(st, threadIdx.x < V ? total[threadIdx.x] : 0, rnd, n, msgs, chals);
        before::store(st, state);
    }
}

template <int D>
__global__ void __launch_bounds__(ROUND_THREADS)
before_sum_kernel(const u64* partials, long long nblocks, u64* out) {
    constexpr int V = 2 * (D + 1);
    __shared__ u64 red[(ROUND_THREADS / 32) * V];
    __shared__ u64 total[V];
    before::partial_sum<D>(partials, nblocks, red, total);
    if (threadIdx.x < V) out[threadIdx.x] = total[threadIdx.x];
}

template <int D>
__global__ void __launch_bounds__(ROUND_THREADS, 1) finish_sum_kernel(const u64* partials, long long nblocks, u64* out) {
    const u64 word = finish_sum<D>(partials, nblocks);
    if (threadIdx.x < 2 * (D + 1)) out[threadIdx.x] = word;
}

// one finish kernel's sponge call alone (the message words given)
template <int D>
__global__ void __launch_bounds__(32) before_sponge_call_kernel(u64* state, const u64* words, u64* msgs, u64* chals) {
    constexpr int V = 2 * (D + 1);
    sponge::State st;
    sponge::load(st, state);
    before::absorb_and_squeeze<D>(st, threadIdx.x < V ? words[threadIdx.x] : 0, 0, 1, msgs, chals);
    before::store(st, state);
}

template <int D>
__global__ void __launch_bounds__(32) sponge_call_kernel(u64* state, const u64* words, u64* msgs, u64* chals) {
    constexpr int V = 2 * (D + 1);
    sponge::State st;
    sponge::load(st, state);
    absorb_and_squeeze<D>(st, threadIdx.x < V ? words[threadIdx.x] : 0, 0, 1, msgs, chals);
    sponge::store(st, state);
}

// One block that does nothing: the device time every launch pays.
__global__ void __launch_bounds__(ROUND_THREADS) empty_kernel() {}

// s: a sponge state (18 words); its 8 sponge words are permuted `perms`
// times in turn, brought below p after each permutation as the duplex does.
// LAYOUT 0: the library's sponge::permute; 2: the design before it; 3: the
// same without the internal rounds' broadcast shuffle; 4: gather::permute.
template <int LAYOUT>
__global__ void __launch_bounds__(32) warp_permute_kernel(u64* s, int perms) {
    const int i = sponge::word();
    sponge::State st;
    sponge::load(st, s);
    u64 x = st.s;
#pragma unroll 1
    for (int p = 0; p < perms; p++) {
        if (LAYOUT == 0) x = gl::canonical(sponge::permute(x, i, st.c));
        if (LAYOUT == 2) x = gl::canonical(before::permute<true>(x, i, st.c));
        if (LAYOUT == 3) x = gl::canonical(before::permute<false>(x, i, st.c));
        if (LAYOUT == 4) x = gl::canonical(gather::permute(x, i, st.c));
    }
    if (threadIdx.x < 8) s[i] = x;
}

__global__ void __launch_bounds__(1) thread_permute_kernel(u64* s, int perms) {
    u64 x[8];
#pragma unroll
    for (int i = 0; i < 8; i++) x[i] = s[i];
#pragma unroll 1
    for (int p = 0; p < perms; p++) {
        p2::permute(x);
#pragma unroll
        for (int i = 0; i < 8; i++) x[i] = gl::canonical(x[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) s[i] = x[i];
}

// The tail's sponge calls alone: `rounds` calls of absorb_and_squeeze<D> by
// one warp, the state parked in shared memory between calls as the tail
// parks it.
template <int D>
__global__ void __launch_bounds__(32) sponge_chain_kernel(u64* state, int rounds, u64* msgs, u64* chals) {
    __shared__ u64 home[sponge::STATE_WORDS];
    const u64* from = state;
    for (int rnd = 0; rnd < rounds; rnd++) {
        sponge::State st;
        sponge::load(st, from);
        absorb_and_squeeze<D>(st, (u64)rnd * 32 + threadIdx.x, rnd, rounds, msgs, chals);
        sponge::store(st, home);
        from = home;
        __syncwarp();
    }
    if (threadIdx.x < sponge::STATE_WORDS) state[threadIdx.x] = home[threadIdx.x];
}

__global__ void __launch_bounds__(BARRIER_THREADS, 1) cluster_barrier_kernel(int rounds) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int i = 0; i < 3 * rounds; i++) cluster.sync();
}

__global__ void __launch_bounds__(BARRIER_THREADS, 1) grid_barrier_kernel(int rounds) {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < 3 * rounds; i++) grid.sync();
}

}  // namespace

// layout 0: one warp, a word a lane; 1: one thread; 2: one warp as before
// the finish kernel's redesign; 3: that without its broadcast shuffle; 4:
// the library's with the external layer gathered in one level.
extern "C" int dp_design_permute(int layout, void* state, int perms, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    u64* x = (u64*)state;
    switch (layout) {
        case 0: warp_permute_kernel<0><<<1, 32, 0, st>>>(x, perms); break;
        case 1: thread_permute_kernel<<<1, 1, 0, st>>>(x, perms); break;
        case 2: warp_permute_kernel<2><<<1, 32, 0, st>>>(x, perms); break;
        case 3: warp_permute_kernel<3><<<1, 32, 0, st>>>(x, perms); break;
        case 4: warp_permute_kernel<4><<<1, 32, 0, st>>>(x, perms); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The finish kernel's parts at degree 2 or 5, for the design before its
// redesign (before = 1) or the library's (0): part 0 the whole kernel
// (before only: the library's is timed through its wrapper), 1 the partial
// sum alone (into out, V words), 2 the sponge call alone (the message words
// from `partials`' first row), 3 an empty kernel of as many threads.
extern "C" int dp_design_finish(int before, int part, int degree, const void* partials, long long nblocks,
                                void* msgs, void* chals, void* state, void* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const u64* pa = (const u64*)partials;
    u64 *m = (u64*)msgs, *c = (u64*)chals, *s = (u64*)state, *o = (u64*)out;
#define DP_PARTS(D)                                                                                     \
    if (part == 0 && before) before_finish_kernel<D><<<1, ROUND_THREADS, 0, st>>>(pa, nblocks, 0, 1, m, c, s); \
    else if (part == 1 && before) before_sum_kernel<D><<<1, ROUND_THREADS, 0, st>>>(pa, nblocks, o);           \
    else if (part == 1) finish_sum_kernel<D><<<1, ROUND_THREADS, 0, st>>>(pa, nblocks, o);                     \
    else if (part == 2 && before) before_sponge_call_kernel<D><<<1, 32, 0, st>>>(s, pa, m, c);                \
    else if (part == 2) sponge_call_kernel<D><<<1, 32, 0, st>>>(s, pa, m, c);                                 \
    else if (part == 3) empty_kernel<<<1, ROUND_THREADS, 0, st>>>();                                         \
    else return (int)cudaErrorInvalidValue
    if (degree == 2) { DP_PARTS(2); }
    else if (degree == 5) { DP_PARTS(5); }
    else return (int)cudaErrorInvalidValue;
#undef DP_PARTS
    return (int)cudaGetLastError();
}

// `rounds` sponge calls of a degree-2 tail, alone.
extern "C" int dp_design_sponge_chain(void* state, int rounds, void* msgs, void* chals, void* stream) {
    sponge_chain_kernel<2><<<1, 32, 0, (cudaStream_t)stream>>>((u64*)state, rounds, (u64*)msgs, (u64*)chals);
    return (int)cudaGetLastError();
}

// variant 0: `rounds` x 3 barriers of a cluster of `blocks`; 1: grid
// barriers over the whole card, every SM as full as the occupancy
// calculator allows. *used: blocks launched.
extern "C" int dp_design_barrier(int variant, int blocks, int rounds, void* stream, int* used) {
    cudaError_t err;
    if (variant == 0) {
        err = cudaFuncSetAttribute(cluster_barrier_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = blocks;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(blocks, 1, 1);
        cfg.blockDim = dim3(BARRIER_THREADS, 1, 1);
        cfg.stream = (cudaStream_t)stream;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        *used = blocks;
        err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, rounds);
    } else {
        int per_sm = 0, dev = 0, sms = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_barrier_kernel, BARRIER_THREADS, 0);
        if (err != cudaSuccess) return (int)err;
        *used = per_sm * sms;
        void* args[] = {&rounds};
        err = cudaLaunchCooperativeKernel((const void*)grid_barrier_kernel, dim3(*used),
                                          dim3(BARRIER_THREADS), args, 0, (cudaStream_t)stream);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
