// The Poseidon2 permutation over Goldilocks, width 8, for CUDA kernels.
//
// One state of 8 lanes in registers; 4 + 22 + 4 rounds, x^7 S-box, the
// external layer block-M4 "MDS-light", the internal layer J + diag(d). The
// rounds are rolled (`#pragma unroll 1`) so that a kernel holds one round
// body; the 8 lanes of a round stay unrolled. Values are lazy (any u64
// congruent mod p, goldilocks.cuh): `permute` leaves them so, and a caller
// brings the lanes it keeps below p with `gl::canonical`.
//
// The round constants come from `poseidon2_constants.h`, which the build
// writes from hashing/constants.py; the library's one translation unit
// (kernels.cu) holds one copy of them in __constant__ memory.
#pragma once

#include "goldilocks.cuh"

#define P2_CONST static __constant__
#include "poseidon2_constants.h"

namespace p2 {

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

}  // namespace p2
