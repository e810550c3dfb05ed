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
// the same in every lane. What bounds a permutation is its chain of 112
// dependent multiplies (8 external rounds of an S-box, 3 deep; 22 internal
// rounds of an S-box and one multiply-add), and one warp's issue of the
// work around it, so the layout keeps that work off the chain and small
// (PERF.md, the sponge's and the finish kernel's designs):
//   - an external round's 8 S-boxes run at once, one per lane: the round
//     costs the latency of 3 dependent multiplies, not the issue of 32;
//     M4 and the external sum go by shuffles: each lane gathers the other
//     three words of its half, forms its row of M4 unreduced, and adds the
//     other half's row (a shuffle across the halves); the next round's
//     constant is added in the same sum before its one fold;
//   - an S-box's two middle products (x^3, x^4) are split between lanes l
//     and l ^ 8, which hold the same word, and exchanged by a shuffle: one
//     product's issue where there were two;
//   - the sponge's products are four independent 32 x 32 -> 64 products
//     added in two carry chains (mul_wide below), shorter than
//     goldilocks.cuh's chain of multiply-adds;
//   - in the internal rounds every lane carries a copy of word 0 and runs
//     its S-box itself, so no broadcast is on the chain: the sum of words
//     1..7 is a shuffle reduction beside the S-box, word 0's multiply-add
//     (s0 (d0 + 1) + S) runs in every lane, and each lane's own
//     multiply-add runs beside the next round's S-box.
// Values inside a permutation are lazy (goldilocks.cuh) and need not equal
// p2::permute's lazy values; a duplex brings every word below p, so each
// state word equals the host challenger's. Everything is inlined, so the
// state never leaves registers (0 stack and 0 local bytes). The per-lane
// round constants and diagonal are loaded into registers once a call; the
// round loops stay rolled (two internal rounds a step) and the external
// constants move down a register a round, which keeps each inlined
// permutation small.
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

// The sponge's products: the 128-bit product from four independent
// 32 x 32 -> 64 products, added in two carry chains, so that the products
// issue at once and the chain is shorter than goldilocks.cuh's chain of
// multiply-adds; a square takes its cross product once. Exact for any u64
// operands (the total is below 2^128, so the top word cannot carry out);
// reduced lazily by gl::reduce. Sponge-only: the Merkle kernel, bound by
// its multiply pipe's issue and not by a chain's latency, keeps
// goldilocks.cuh's (with these it took 0.776 ms a level against 0.677,
// PERF.md).
__device__ __forceinline__ gl::u128 mul_wide(u64 a, u64 b) {
    u64 lo, hi;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, q0, q1, u0, u1, v0, v1, w0, w1, r1, r2, r3;\n\t"
        ".reg .u64 p00, p01, p10, p11;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mov.b64 {b0, b1}, %3;\n\t"
        "mul.wide.u32 p00, a0, b0;\n\t"
        "mul.wide.u32 p01, a0, b1;\n\t"
        "mul.wide.u32 p10, a1, b0;\n\t"
        "mul.wide.u32 p11, a1, b1;\n\t"
        "mov.b64 {q0, q1}, p00;\n\t"
        "mov.b64 {u0, u1}, p01;\n\t"
        "mov.b64 {v0, v1}, p10;\n\t"
        "mov.b64 {w0, w1}, p11;\n\t"
        "add.cc.u32 r1, q1, u0;\n\t"
        "addc.cc.u32 r2, u1, w0;\n\t"
        "addc.u32 r3, w1, 0;\n\t"  // w1 <= 2^32 - 2: no carry out
        "add.cc.u32 r1, r1, v0;\n\t"
        "addc.cc.u32 r2, r2, v1;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mov.b64 %0, {q0, r1};\n\t"
        "mov.b64 %1, {r2, r3};\n\t"
        "}"
        : "=l"(lo), "=l"(hi)
        : "l"(a), "l"(b));
    return {lo, hi};
}

__device__ __forceinline__ gl::u128 sqr_wide(u64 a) {
    u64 lo, hi;
    asm("{\n\t"
        ".reg .u32 a0, a1, q0, q1, u0, u1, w0, w1, r1, r2, r3;\n\t"
        ".reg .u64 p00, p01, p11;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mul.wide.u32 p00, a0, a0;\n\t"
        "mul.wide.u32 p01, a0, a1;\n\t"
        "mul.wide.u32 p11, a1, a1;\n\t"
        "mov.b64 {q0, q1}, p00;\n\t"
        "mov.b64 {u0, u1}, p01;\n\t"
        "mov.b64 {w0, w1}, p11;\n\t"
        "add.cc.u32 r1, q1, u0;\n\t"
        "addc.cc.u32 r2, u1, w0;\n\t"
        "addc.u32 r3, w1, 0;\n\t"
        "add.cc.u32 r1, r1, u0;\n\t"
        "addc.cc.u32 r2, r2, u1;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mov.b64 %0, {q0, r1};\n\t"
        "mov.b64 %1, {r2, r3};\n\t"
        "}"
        : "=l"(lo), "=l"(hi)
        : "l"(a));
    return {lo, hi};
}

// a b + c: c's words open the first carry chain.
__device__ __forceinline__ gl::u128 mul_add_wide(u64 a, u64 b, u64 c) {
    u64 lo, hi;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, c0, c1, q0, q1, u0, u1, v0, v1, w0, w1, r0, r1, r2, r3;\n\t"
        ".reg .u64 p00, p01, p10, p11;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mov.b64 {b0, b1}, %3;\n\t"
        "mov.b64 {c0, c1}, %4;\n\t"
        "mul.wide.u32 p00, a0, b0;\n\t"
        "mul.wide.u32 p01, a0, b1;\n\t"
        "mul.wide.u32 p10, a1, b0;\n\t"
        "mul.wide.u32 p11, a1, b1;\n\t"
        "mov.b64 {q0, q1}, p00;\n\t"
        "mov.b64 {u0, u1}, p01;\n\t"
        "mov.b64 {v0, v1}, p10;\n\t"
        "mov.b64 {w0, w1}, p11;\n\t"
        "add.cc.u32 r0, q0, c0;\n\t"
        "addc.cc.u32 r1, q1, c1;\n\t"
        "addc.cc.u32 r2, u1, w0;\n\t"
        "addc.u32 r3, w1, 0;\n\t"
        "add.cc.u32 r1, r1, u0;\n\t"
        "addc.cc.u32 r2, r2, v1;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "add.cc.u32 r1, r1, v0;\n\t"
        "addc.cc.u32 r2, r2, 0;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mov.b64 %0, {r0, r1};\n\t"
        "mov.b64 %1, {r2, r3};\n\t"
        "}"
        : "=l"(lo), "=l"(hi)
        : "l"(a), "l"(b), "l"(c));
    return {lo, hi};
}

__device__ __forceinline__ u64 mul(u64 a, u64 b) { return gl::reduce(mul_wide(a, b)); }

__device__ __forceinline__ u64 sqr(u64 a) { return gl::reduce(sqr_wide(a)); }

__device__ __forceinline__ u64 mul_add(u64 a, u64 b, u64 c) { return gl::reduce(mul_add_wide(a, b, c)); }

// x^7 (p2::sbox) in lanes l and l ^ 8, which hold the same x: x^2, then
// x^3 in the one and x^4 in the other (one product's issue, not two),
// exchanged by a shuffle, then their product, the same in both.
__device__ __forceinline__ u64 sbox(u64 x) {
    const u64 x2 = sqr(x);
    const u64 t = mul(x2, (threadIdx.x & 8) ? x2 : x);
    return mul(t, (u64)__shfl_xor_sync(FULL, (unsigned long long)t, 8));
}

// The external linear layer (p2::external_linear) on lane i's word x, plus
// c (< p: the next round's constant of the lane, or 0): row k of M4 over
// its half is sum + s_k + 2 s_(k+1) = 2x + 3a + b + d with a, b, d the
// words k + 1, k + 2, k + 3 of the half (7 terms); the output is twice the
// own row plus the other half's and c (22 terms), folded once.
__device__ __forceinline__ u64 external_linear(u64 x, int i, u64 c) {
    const int g = i & 4, k = i & 3;
    const u64 a = shfl8(x, g | ((k + 1) & 3));
    const u64 b = shfl8(x, g | ((k + 2) & 3));
    const u64 d = shfl8(x, g | ((k + 3) & 3));
    const gl::wide xa = gl::wadd(x, a);
    const gl::wide n = gl::wadd(gl::wadd(xa, xa), gl::wadd(gl::wadd(b, d), a));
    return gl::fold(gl::wadd(gl::wadd(gl::wadd(n, n), c), shfl8_xor(n, 4)));
}

// Four external rounds on x (the S-box input, its constant added), each
// adding the next round's constant to its output: c1, then c2, c3, c4. The
// constants move down a register a round, so the rolled loop needs no
// comparison to pick one.
__device__ __forceinline__ u64 external_rounds(u64 x, int i, u64 c1, u64 c2, u64 c3, u64 c4) {
#pragma unroll 1
    for (int r = 0; r < 4; r++) {
        x = external_linear(sbox(x), i, c1);
        c1 = c2;
        c2 = c3;
        c3 = c4;
    }
    return x;
}

// The sum over the 8 lanes of a segment, in every lane.
__device__ __forceinline__ gl::wide sum8(gl::wide w) {
    w = gl::wadd(w, shfl8_xor(w, 1));
    w = gl::wadd(w, shfl8_xor(w, 2));
    return gl::wadd(w, shfl8_xor(w, 4));
}

// One internal round (p2::internal_round). Every lane carries y, a copy of
// word 0 plus the round's constant, and its own word x (lane 0's unused):
//   S = x_1 + ... + x_7 (a shuffle reduction, beside the S-box),
//   s0 = y^7,  sum = s0 + S,  y' = s0 (d0 + 1) + S + next,  x' = x d + sum,
// since word 0 becomes s0 d0 + sum. Only the S-box and y's multiply-add
// are on the chain.
__device__ __forceinline__ void internal_round(u64& y, u64& x, int i, u64 diag, u64 d0p1, u64 next) {
    const u64 s = gl::fold(sum8({i == 0 ? 0 : x, 0}));
    const u64 s0 = sbox(y);
    const u64 sum = gl::fold(gl::wadd(s0, s));
    y = mul_add(s0, d0p1, gl::add_const(s, next));
    x = mul_add(x, diag, sum);
}

// The 22 internal rounds on lane i's word x, lane 0's holding x0 +
// INT_RC[0]; returns the lane's word plus out_rc (< p: the first terminal
// round's constant of the lane). Two rounds a loop step, so that one
// round's reduction and multiply-add can be scheduled beside the next
// round's S-box.
__device__ __forceinline__ u64 internal_rounds(u64 x, int i, u64 diag, u64 out_rc) {
    const u64 d0p1 = DIAG[0] + 1;  // DIAG[0] < p - 1
    u64 y = shfl8(x, 0);
#pragma unroll 1
    for (int r = 0; r < 22; r += 2) {
        internal_round(y, x, i, diag, d0p1, INT_RC[r + 1]);
        internal_round(y, x, i, diag, d0p1, r < 20 ? INT_RC[r + 2] : out_rc);
    }
    return i == 0 ? y : gl::add_const(x, out_rc);
}

// p2::permute on lane i's word (lazy in, lazy out; not p2's lazy values).
// Each round's constant is added by the layer before it: the first initial
// one by the first external layer, INT_RC[0] (lane 0) by the last initial
// round, the first terminal one by the internal rounds.
__device__ __forceinline__ u64 permute(u64 x, int i, const Consts& c) {
    x = external_linear(x, i, c.init_rc[0]);
    x = external_rounds(x, i, c.init_rc[1], c.init_rc[2], c.init_rc[3], i == 0 ? INT_RC[0] : 0);
    x = internal_rounds(x, i, c.diag, c.term_rc[0]);
    return external_rounds(x, i, c.term_rc[1], c.term_rc[2], c.term_rc[3], 0);
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

// `count` (1-32) observes of the warp's words (lane w holding word w), then
// sample_ext: the same state and challenge, with one duplex a full buffer
// and no step a word, through one permutation site. A pass fills the input
// buffer from ilen with the next words and duplexes: for the words to come
// when the buffer is full (a pending full buffer too, with nothing taken),
// for the squeeze after the last words.
__device__ __forceinline__ void absorb_and_sample_ext(State& st, u64 mine, int count, u64& a0, u64& a1) {
    const int i = word();
    int done = 0;
#pragma unroll 1
    for (;;) {
        const int take = min(RATE - st.ilen, count - done);
        const u64 v = shfl(mine, (done + i - st.ilen) & 31);
        if (i >= st.ilen && i < st.ilen + take) st.ibuf = v;
        st.ilen += take;
        done += take;
        duplex(st);
        if (done == count) break;
    }
    st.olen = RATE - 2;
    a0 = shfl8(st.obuf, RATE - 1);
    a1 = shfl8(st.obuf, RATE - 2);
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
