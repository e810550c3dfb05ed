// Measurements behind the sponge's and the sumcheck tail's designs, for
// `scripts/tail_designs.py` to time on the card. Built as one shared library
// with the port's kernel library in the same translation unit, so that
// every kernel here runs the library's own device functions and adds only
// a loop around them:
//   - the permutation's layout: a chain of permutations by one warp with a
//     state word a lane (transcript.cuh `sponge::permute`, as the sponge
//     runs it) and by one thread holding all 8 words (poseidon2.cuh
//     `p2::permute`, as the Merkle kernel runs it);
//   - the tail's sponge calls alone: `rounds` calls of absorb_and_squeeze
//     by one warp, the state parked in shared memory between calls as the
//     tail parks it;
//   - the barriers alone: `rounds` x 3 cluster barriers, or grid barriers,
//     in one launch (the tail's 3 a round).

#include "kernels.cu"

namespace {

constexpr int BARRIER_THREADS = 512;  // a block of the barrier kernels, as the tail's

// s: a sponge state (18 words); its 8 sponge words are permuted `perms`
// times in turn, brought below p after each permutation as the duplex does.
__global__ void __launch_bounds__(32) warp_permute_kernel(u64* s, int perms) {
    sponge::State st;
    sponge::load(st, s);
    const int i = sponge::word();
    u64 x = st.s;
#pragma unroll 1
    for (int p = 0; p < perms; p++) x = gl::canonical(sponge::permute(x, i, st.c));
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

// layout 0: one warp, a word a lane; 1: one thread.
extern "C" int dp_design_permute(int layout, void* state, int perms, void* stream) {
    if (layout == 0)
        warp_permute_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((u64*)state, perms);
    else
        thread_permute_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((u64*)state, perms);
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
