// The Fiat-Shamir duplex sponge on the device: device functions shared by
// the sponge kernel (transcript.cu) and the sumcheck kernels (sumcheck.cu).
//
// The same machine as the host `DuplexChallenger` (transcript/challenger.py,
// plonky3's DuplexChallenger<F, P, 8, 4>) and the JAX package's
// transcript/device.py:
//   observe(v): push v on the input buffer and empty the output buffer;
//               duplex when 4 inputs are queued;
//   duplex:     OVERWRITE sponge[0, ilen) with the inputs (no addition),
//               permute, output buffer = sponge[0, 4), ilen = 0;
//   sample():   duplex when inputs are pending OR the output buffer is
//               empty, then pop from the END of the output buffer.
//
// The state lives in device memory as 18 int64 (u64 bit patterns):
// sponge[0..8), ibuf[8..12), ilen at 12, obuf[13..17), olen at 17. A kernel
// loads it into one thread's registers, runs, and stores it back. Entries
// of ibuf at or past ilen are zero; obuf keeps its popped entries (the
// plain version in transcript/device.py does the same, so states agree bit
// for bit). Every lane is brought below p after a permutation.
#pragma once

#include "poseidon2.cuh"

namespace sponge {

constexpr int RATE = 4;
constexpr int STATE_WORDS = 18;

struct State {
    u64 s[8];
    u64 ibuf[RATE];
    int ilen;
    u64 obuf[RATE];
    int olen;
};

__device__ __forceinline__ void load(State& st, const u64* g) {
#pragma unroll
    for (int i = 0; i < 8; i++) st.s[i] = g[i];
#pragma unroll
    for (int i = 0; i < RATE; i++) st.ibuf[i] = g[8 + i];
    st.ilen = (int)g[12];
#pragma unroll
    for (int i = 0; i < RATE; i++) st.obuf[i] = g[13 + i];
    st.olen = (int)g[17];
}

__device__ __forceinline__ void store(const State& st, u64* g) {
#pragma unroll
    for (int i = 0; i < 8; i++) g[i] = st.s[i];
#pragma unroll
    for (int i = 0; i < RATE; i++) g[8 + i] = st.ibuf[i];
    g[12] = (u64)st.ilen;
#pragma unroll
    for (int i = 0; i < RATE; i++) g[13 + i] = st.obuf[i];
    g[17] = (u64)st.olen;
}

__device__ __noinline__ void duplex(State& st) {
#pragma unroll
    for (int i = 0; i < RATE; i++) {
        if (i < st.ilen) st.s[i] = st.ibuf[i];
        st.ibuf[i] = 0;
    }
    p2::permute(st.s);
#pragma unroll
    for (int i = 0; i < 8; i++) st.s[i] = gl::canonical(st.s[i]);
#pragma unroll
    for (int i = 0; i < RATE; i++) st.obuf[i] = st.s[i];
    st.ilen = 0;
    st.olen = RATE;
}

// `v` must be canonical (< p).
__device__ __forceinline__ void observe(State& st, u64 v) {
    // a register array indexed by a runtime value would go to local memory
#pragma unroll
    for (int i = 0; i < RATE; i++)
        if (i == st.ilen) st.ibuf[i] = v;
    st.ilen++;
    st.olen = 0;
    if (st.ilen == RATE) duplex(st);
}

__device__ __forceinline__ u64 sample(State& st) {
    if (st.ilen > 0 || st.olen == 0) duplex(st);
    st.olen--;
    u64 out = 0;
#pragma unroll
    for (int i = 0; i < RATE; i++)
        if (i == st.olen) out = st.obuf[i];
    return out;
}

// b"Internal round" as little-endian 8-byte chunks: the label absorbed
// before every sumcheck round's challenge.
constexpr u64 ROUND_LABEL_0 = 0x6c616e7265746e49ULL;  // "Internal"
constexpr u64 ROUND_LABEL_1 = 0x0000646e756f7220ULL;  // " round\0\0"

}  // namespace sponge
