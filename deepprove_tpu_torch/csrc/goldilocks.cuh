// Goldilocks field arithmetic for CUDA: p = 2^64 - 2^32 + 1.
//
// Lazy form: inside a computation an element is ANY u64 congruent to its
// value mod p, so [0, 2^64) holds each element once or twice (x and x + p
// for x < 2^64 - p). Nothing is brought below p until `canonical`, once, on
// the values that leave the kernel; the torch and host versions are
// canonical everywhere, and the outputs agree bit for bit.
//
// The 128-bit product is one carry chain over the four 32x32 partial
// products; reductions use 2^64 = 2^32 - 1 (EPS) and 2^96 = -1 (mod p)
// with carry and borrow flags and no branches. Each asm block holds its
// whole carry chain: the flags do not survive from one block to the next.
// A flag is read back by an instruction of the kind that set it: `addc`
// after an addition, `subc` after a subtraction (a `subc` reading the carry
// of an addition gave wrong results on sm_90a). Every step states the
// operand range that keeps it exact.
#pragma once

#include <stdint.h>

typedef uint64_t u64;
typedef uint32_t u32;

namespace gl {

constexpr u64 P = 0xFFFFFFFF00000001ULL;

struct u128 {
    u64 lo, hi;
};

// An unreduced sum lo + hi * 2^64 of a few lazy elements (hi < 2^32 - 1).
struct wide {
    u64 lo;
    u32 hi;
};

// a * b exactly, for any u64 a, b. Each partial product is at most
// (2^32 - 1)^2, and each word gathers at most two of them plus carries, so
// the chain is exact below 2^128.
__device__ __forceinline__ u128 mul_wide(u64 a, u64 b) {
    u64 lo, hi;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, r0, r1, r2, r3;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mov.b64 {b0, b1}, %3;\n\t"
        "mul.lo.u32 r0, a0, b0;\n\t"
        "mul.hi.u32 r1, a0, b0;\n\t"
        "mad.lo.cc.u32 r1, a0, b1, r1;\n\t"
        "madc.hi.u32 r2, a0, b1, 0;\n\t"  // hi(a0 b1) + carry <= 2^32 - 1
        "mad.lo.cc.u32 r1, a1, b0, r1;\n\t"
        "madc.hi.cc.u32 r2, a1, b0, r2;\n\t"
        "madc.hi.u32 r3, a1, b1, 0;\n\t"  // same bound
        "mad.lo.cc.u32 r2, a1, b1, r2;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mov.b64 %0, {r0, r1};\n\t"
        "mov.b64 %1, {r2, r3};\n\t"
        "}"
        : "=l"(lo), "=l"(hi)
        : "l"(a), "l"(b));
    return {lo, hi};
}

// a * b + c exactly, for any u64 a, b, c: (2^64 - 1)^2 + 2^64 - 1 < 2^128.
__device__ __forceinline__ u128 mul_add_wide(u64 a, u64 b, u64 c) {
    u64 lo, hi;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, c0, c1, r0, r1, r2, r3;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mov.b64 {b0, b1}, %3;\n\t"
        "mov.b64 {c0, c1}, %4;\n\t"
        "mad.lo.cc.u32 r0, a0, b0, c0;\n\t"
        "madc.hi.cc.u32 r1, a0, b0, c1;\n\t"
        "addc.u32 r2, 0, 0;\n\t"  // a0 b0 + c < 2^65
        "mad.lo.cc.u32 r2, a1, b1, r2;\n\t"
        "madc.hi.u32 r3, a1, b1, 0;\n\t"
        "mad.lo.cc.u32 r1, a0, b1, r1;\n\t"
        "madc.hi.cc.u32 r2, a0, b1, r2;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "mad.lo.cc.u32 r1, a1, b0, r1;\n\t"
        "madc.hi.cc.u32 r2, a1, b0, r2;\n\t"
        "addc.u32 r3, r3, 0;\n\t"  // the total is < 2^128: no carry out of r3
        "mov.b64 %0, {r0, r1};\n\t"
        "mov.b64 %1, {r2, r3};\n\t"
        "}"
        : "=l"(lo), "=l"(hi)
        : "l"(a), "l"(b), "l"(c));
    return {lo, hi};
}

// Any 128-bit x -> a u64 congruent to x. With x = lo + (h1 * 2^32 + h0) * 2^64,
// x = lo + h0 * (2^32 - 1) - h1 = lo + h0 * 2^32 - s, s = h0 + h1 (mod p):
// adds and subtractions only, which leave the multiply pipe to the products.
// u = lo + h0 * 2^32 - s is taken mod 2^64, its carry and borrow counted in
// k = carry - borrow, and x = u + k * 2^64 = u + k * EPS (mod p). One
// correction, and it cannot wrap again:
//   k = 1:  x < 2^65 - 2^32, so u = x - 2^64 < 2^64 - 2^32 and u + EPS < 2^64;
//   k = -1: x >= -s > -2^33, so x + p > 0; u + (2^64 - EPS) = u + p wraps once,
//           to x + p, the wrap being the 2^64 that u carries.
__device__ __forceinline__ u64 reduce(u128 x) {
    u64 r;
    asm("{\n\t"
        ".reg .u32 l0, l1, h0, h1, s0, s1, k, e;\n\t"
        "mov.b64 {l0, l1}, %1;\n\t"
        "mov.b64 {h0, h1}, %2;\n\t"
        "add.cc.u32 s0, h0, h1;\n\t"
        "addc.u32 s1, 0, 0;\n\t"  // s = h0 + h1 <= 2^33 - 2
        "add.cc.u32 l1, l1, h0;\n\t"
        "addc.u32 k, 0, 0;\n\t"  // the carry of lo + h0 * 2^32
        "sub.cc.u32 l0, l0, s0;\n\t"
        "subc.cc.u32 l1, l1, s1;\n\t"
        "subc.u32 k, k, 0;\n\t"  // less the borrow of - s: k in {-1, 0, 1}
        // + k * EPS mod 2^64: words (-k, 0) for k = 1, (1, 0xffffffff) = p for k = -1
        "neg.s32 e, k;\n\t"
        "shr.s32 k, k, 31;\n\t"
        "add.cc.u32 l0, l0, e;\n\t"
        "addc.u32 l1, l1, k;\n\t"
        "mov.b64 %0, {l0, l1};\n\t"
        "}"
        : "=l"(r)
        : "l"(x.lo), "l"(x.hi));
    return r;
}

__device__ __forceinline__ u64 mul(u64 a, u64 b) { return reduce(mul_wide(a, b)); }

__device__ __forceinline__ u64 mul_add(u64 a, u64 b, u64 c) {
    return reduce(mul_add_wide(a, b, c));
}

// x + c for any u64 x and c < p. A carry dropped 2^64 = EPS: add EPS back.
// After a carry x + c - 2^64 < c < p = 2^64 - EPS, so that cannot carry.
__device__ __forceinline__ u64 add_const(u64 x, u64 c) {
    u64 r;
    asm("{\n\t"
        ".reg .u32 x0, x1, c0, c1, m;\n\t"
        "mov.b64 {x0, x1}, %1;\n\t"
        "mov.b64 {c0, c1}, %2;\n\t"
        "add.cc.u32 x0, x0, c0;\n\t"
        "addc.cc.u32 x1, x1, c1;\n\t"
        "addc.u32 m, 0, 0;\n\t"
        "neg.s32 m, m;\n\t"
        "add.cc.u32 x0, x0, m;\n\t"
        "addc.u32 x1, x1, 0;\n\t"
        "mov.b64 %0, {x0, x1};\n\t"
        "}"
        : "=l"(r)
        : "l"(x), "l"(c));
    return r;
}

// Unreduced sums: exact as long as the number of u64 terms stays below
// 2^32 - 1 (the callers add at most 21).
__device__ __forceinline__ wide wadd(wide a, wide b) {
    wide r;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1;\n\t"
        "mov.b64 {a0, a1}, %2;\n\t"
        "mov.b64 {b0, b1}, %4;\n\t"
        "add.cc.u32 a0, a0, b0;\n\t"
        "addc.cc.u32 a1, a1, b1;\n\t"
        "addc.u32 %1, %3, %5;\n\t"
        "mov.b64 %0, {a0, a1};\n\t"
        "}"
        : "=l"(r.lo), "=r"(r.hi)
        : "l"(a.lo), "r"(a.hi), "l"(b.lo), "r"(b.hi));
    return r;
}

__device__ __forceinline__ wide wadd(wide a, u64 b) { return wadd(a, wide{b, 0}); }

__device__ __forceinline__ wide wadd(u64 a, u64 b) { return wadd(wide{a, 0}, wide{b, 0}); }

// lo + hi * 2^64 -> a u64 congruent to it: lo + hi * EPS, hi < 2^32 - 1.
// A carry dropped 2^64 = EPS: add EPS back. After a carry the sum is
// < hi * EPS, and hi * EPS + EPS < 2^64, so that cannot carry.
__device__ __forceinline__ u64 fold(wide w) {
    u64 r;
    asm("{\n\t"
        ".reg .u32 l0, l1, m;\n\t"
        "mov.b64 {l0, l1}, %1;\n\t"
        "mad.lo.cc.u32 l0, %2, 0xffffffff, l0;\n\t"
        "madc.hi.cc.u32 l1, %2, 0xffffffff, l1;\n\t"
        "addc.u32 m, 0, 0;\n\t"
        "neg.s32 m, m;\n\t"
        "add.cc.u32 l0, l0, m;\n\t"
        "addc.u32 l1, l1, 0;\n\t"
        "mov.b64 %0, {l0, l1};\n\t"
        "}"
        : "=l"(r)
        : "l"(w.lo), "r"(w.hi));
    return r;
}

// The one value below p: x < 2^64 < 2p needs at most one subtraction.
__device__ __forceinline__ u64 canonical(u64 x) { return x >= P ? x - P : x; }

}  // namespace gl
