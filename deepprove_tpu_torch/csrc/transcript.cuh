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
// sponge[0..8), ibuf[8..12), ilen at 12, obuf[13..17), olen at 17. Entries
// of ibuf at or past ilen are zero; obuf keeps its popped entries (the
// plain version in transcript/device.py does the same, so states agree bit
// for bit). Every lane is brought below p after a permutation.
//
// Layout: one warp runs the sponge, lane i of each 8-lane segment holding
// word i of the state (sponge[i], and ibuf[i], obuf[i] for i < 4) in
// registers; the four segments of a warp compute the same thing, so every
// shuffle is a full-warp one and no lane waits on a mask. ilen and olen are
// the same in every lane. What this buys against one thread holding all 8
// words (PERF.md, the sponge's layout comparison):
//   - an external round's 8 S-boxes run at once, one per lane: the round
//     costs the latency of 3 dependent multiplies, not the issue of 32;
//   - M4 and the external sum go by shuffles: each lane gathers the other
//     three words of its half, forms its row of M4 unreduced, and adds the
//     other half's row (a shuffle across the halves);
//   - the internal round's sum of lanes 1..7 is a shuffle reduction that
//     runs beside lane 0's S-box, and its 8 multiply-adds run at once.
// Everything is inlined, so the state never leaves registers (0 stack and 0
// local bytes). The per-lane round constants and diagonal are loaded into
// registers once a call; the round loops stay rolled and pick a round's
// constant by comparisons, which keeps each inlined permutation small.
#pragma once

#include "poseidon2.cuh"

namespace sponge {

constexpr int RATE = 4;
constexpr int STATE_WORDS = 18;
constexpr unsigned FULL = 0xffffffffu;

// The constants of lane i: its external round constants and diagonal entry.
struct Consts {
    u64 init_rc[4], term_rc[4], diag;
};

// One lane's part of the state: lane i = threadIdx.x & 7.
struct State {
    u64 s;     // sponge[i]
    u64 ibuf;  // ibuf[i] (i < RATE; 0 in the other lanes)
    u64 obuf;  // obuf[i] (i < RATE)
    int ilen, olen;
    Consts c;
};

__device__ __forceinline__ int word() { return threadIdx.x & 7; }

__device__ __forceinline__ u64 shfl(u64 v, int src, int width = 32) {
    return (u64)__shfl_sync(FULL, (unsigned long long)v, src, width);
}

__device__ __forceinline__ u64 shfl8(u64 v, int src) { return shfl(v, src, 8); }

__device__ __forceinline__ gl::wide shfl8_xor(gl::wide v, int mask) {
    return {(u64)__shfl_xor_sync(FULL, (unsigned long long)v.lo, mask, 8),
            __shfl_xor_sync(FULL, v.hi, mask, 8)};
}

__device__ __forceinline__ u64 pick(const u64* a, int r) {
    // a register array indexed by a runtime value would go to local memory
    return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

// The external linear layer (p2::external_linear) on lane i's word x: row k
// of M4 over its half is sum + s_k + 2 s_(k+1) = 2x + 3a + b + c with a, b,
// c the words k + 1, k + 2, k + 3 of the half (7 terms); the output is twice
// the own row plus the other half's (21 terms), folded once. The sums are
// the same integers as p2's, so the lanes equal its lazy values.
__device__ __forceinline__ u64 external_linear(u64 x, int i) {
    const int g = i & 4, k = i & 3;
    const u64 a = shfl8(x, g | ((k + 1) & 3));
    const u64 b = shfl8(x, g | ((k + 2) & 3));
    const u64 c = shfl8(x, g | ((k + 3) & 3));
    const gl::wide xa = gl::wadd(x, a);
    const gl::wide n = gl::wadd(gl::wadd(xa, xa), gl::wadd(gl::wadd(b, c), a));
    return gl::fold(gl::wadd(gl::wadd(n, n), shfl8_xor(n, 4)));
}

// The 22 internal rounds (p2::internal_round) on lane i's word: lane 0
// takes the S-box, every lane adds the sum of all eight to its word times
// its diagonal entry. The sum of lanes 1..7 is a shuffle reduction that runs
// beside lane 0's S-box; the next round's constant is loaded during this one.
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
        const u64 sum = gl::fold(gl::wadd(w, shfl8(s0, 0)));
        x = gl::mul_add(i == 0 ? s0 : x, diag, sum);
        rc = next;
    }
    return x;
}

// p2::permute on lane i's word (lazy in, lazy out).
__device__ __forceinline__ u64 permute(u64 x, int i, const Consts& c) {
    x = external_linear(x, i);
#pragma unroll 1
    for (int r = 0; r < 4; r++) x = external_linear(p2::sbox(gl::add_const(x, pick(c.init_rc, r))), i);
    x = internal_rounds(x, i, c.diag);
#pragma unroll 1
    for (int r = 0; r < 4; r++) x = external_linear(p2::sbox(gl::add_const(x, pick(c.term_rc, r))), i);
    return x;
}

// Every lane of the warp: the state from device memory, the constants into
// registers.
__device__ __forceinline__ void load(State& st, const u64* g) {
    const int i = word();
    st.s = g[i];
    st.ibuf = i < RATE ? g[8 + i] : 0;
    st.obuf = i < RATE ? g[13 + i] : 0;
    st.ilen = (int)g[12];
    st.olen = (int)g[17];
#pragma unroll
    for (int r = 0; r < 4; r++) {
        st.c.init_rc[r] = INIT_RC[r][i];
        st.c.term_rc[r] = TERM_RC[r][i];
    }
    st.c.diag = DIAG[i];
}

__device__ __forceinline__ void duplex(State& st) {
    const int i = word();
    if (i < st.ilen) st.s = st.ibuf;
    st.ibuf = 0;
    st.s = gl::canonical(permute(st.s, i, st.c));
    st.obuf = st.s;
    st.ilen = 0;
    st.olen = RATE;
}

// Absorb v (squeeze false; canonical, the same in every lane) or squeeze
// one word (squeeze true; returned in every lane). The duplex that a full
// input buffer asks for waits for the next step, which runs it before its
// own absorb or squeeze: the outputs are the same, and `settle` brings the
// state to the same words before it is stored. So each call site of step
// inlines one permutation.
__device__ __forceinline__ u64 step(State& st, u64 v, bool squeeze) {
    if (squeeze ? (st.ilen > 0 || st.olen == 0) : st.ilen == RATE) duplex(st);
    if (squeeze) {
        st.olen--;
        return shfl8(st.obuf, st.olen);
    }
    if (word() == st.ilen) st.ibuf = v;
    st.ilen++;
    st.olen = 0;
    return 0;
}

__device__ __forceinline__ void observe(State& st, u64 v) { step(st, v, false); }

__device__ __forceinline__ u64 sample(State& st) { return step(st, 0, true); }

// One extension challenge (a0 sampled first), through one step site.
__device__ __forceinline__ void sample_ext(State& st, u64& a0, u64& a1) {
#pragma unroll 1
    for (int q = 0; q < 2; q++) {
        const u64 v = sample(st);
        if (q == 0) a0 = v;
        else a1 = v;
    }
}

// Called by the whole warp: runs a pending duplex, then the first segment
// writes the state.
__device__ __forceinline__ void store(State& st, u64* g) {
    if (st.ilen == RATE) duplex(st);
    const int i = word();
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

// b"Internal round" as little-endian 8-byte chunks: the label absorbed
// before every sumcheck round's challenge.
constexpr u64 ROUND_LABEL_0 = 0x6c616e7265746e49ULL;  // "Internal"
constexpr u64 ROUND_LABEL_1 = 0x0000646e756f7220ULL;  // " round\0\0"

}  // namespace sponge
