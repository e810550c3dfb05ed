// Goldilocks field arithmetic for CUDA: p = 2^64 - 2^32 + 1.
//
// Values are canonical (< p) at every function boundary, matching the
// torch and host implementations bit for bit. Multiplication takes the
// 128-bit product from the hardware's 64x64 multiply (`a * b` for the low
// word, `__umul64hi` for the high word) and reduces it with the identity
// 2^64 = 2^32 - 1 (EPS) and 2^96 = -1 (mod p).
#pragma once

#include <stdint.h>

typedef uint64_t u64;

namespace gl {

constexpr u64 P = 0xFFFFFFFF00000001ULL;
constexpr u64 EPS = 0xFFFFFFFFULL;  // 2^64 mod p

__device__ __forceinline__ u64 add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) {
        s += EPS;  // carried past 2^64; cannot carry again for a, b < p
    } else if (s >= P) {
        s -= P;
    }
    return s;
}

__device__ __forceinline__ u64 sub(u64 a, u64 b) {
    u64 d = a - b;
    if (a < b) d += P;
    return d;
}

__device__ __forceinline__ u64 reduce128(u64 lo, u64 hi) {
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & EPS;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPS;
    u64 t1 = hi_lo * EPS;
    u64 t2 = t0 + t1;
    if (t2 < t1) t2 += EPS;
    if (t2 >= P) t2 -= P;
    return t2;
}

__device__ __forceinline__ u64 mul(u64 a, u64 b) {
    return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace gl
