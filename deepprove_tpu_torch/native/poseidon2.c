/* Goldilocks Poseidon2 width-8 permutation — native host implementation.
 *
 * The Fiat-Shamir transcript and Merkle path verification are sequential
 * host-side work. Constants are injected from hashing/constants.py at build
 * time (native/__init__.py writes poseidon2_constants.h), so the host C and
 * the CUDA kernel share exactly one source of truth.
 *
 * Field: p = 2^64 - 2^32 + 1; reduction uses the classic reduce128 identity
 * 2^64 ≡ 2^32 - 1, 2^96 ≡ -1 (mod p).
 */

#include <stdint.h>
#include <stddef.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

static const u64 P = 0xFFFFFFFF00000001ULL;
static const u64 EPS = 0xFFFFFFFFULL; /* 2^64 mod p */

#include "poseidon2_constants.h"

static inline u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) s += EPS;          /* wrapped past 2^64 */
    if (s >= P) s -= P;
    return s;
}

static inline u64 gl_reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u64 hi_hi = hi >> 32;
    u64 hi_lo = hi & 0xFFFFFFFFULL;
    u64 t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPS;
    u64 t1 = hi_lo * EPS;
    u64 t2 = t0 + t1;
    if (t2 < t1) t2 += EPS;
    if (t2 >= P) t2 -= P;
    return t2;
}

static inline u64 gl_mul(u64 a, u64 b) {
    return gl_reduce128((u128)a * (u128)b);
}

static inline u64 gl_sbox(u64 x) {
    u64 x2 = gl_mul(x, x);
    u64 x4 = gl_mul(x2, x2);
    u64 x6 = gl_mul(x4, x2);
    return gl_mul(x6, x);
}

/* M4 = circ(2,3,1,1) applied in place (plonky3 MDSMat4). */
static inline void m4(u64 *s) {
    u64 t01 = gl_add(s[0], s[1]);
    u64 t23 = gl_add(s[2], s[3]);
    u64 t0123 = gl_add(t01, t23);
    u64 t01123 = gl_add(t0123, s[1]);
    u64 t01233 = gl_add(t0123, s[3]);
    u64 n3 = gl_add(t01233, gl_add(s[0], s[0]));
    u64 n1 = gl_add(t01123, gl_add(s[2], s[2]));
    u64 n0 = gl_add(t01123, t01);
    u64 n2 = gl_add(t01233, t23);
    s[0] = n0; s[1] = n1; s[2] = n2; s[3] = n3;
}

static inline void external_linear(u64 *st) {
    m4(st);
    m4(st + 4);
    for (int k = 0; k < 4; k++) {
        u64 sum = gl_add(st[k], st[4 + k]);
        st[k] = gl_add(st[k], sum);
        st[4 + k] = gl_add(st[4 + k], sum);
    }
}

void poseidon2_permute(u64 *st) {
    external_linear(st);
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < 8; i++)
            st[i] = gl_sbox(gl_add(st[i], INIT_RC[r][i]));
        external_linear(st);
    }
    for (int r = 0; r < 22; r++) {
        st[0] = gl_sbox(gl_add(st[0], INT_RC[r]));
        u64 sum = st[0];
        for (int i = 1; i < 8; i++) sum = gl_add(sum, st[i]);
        for (int i = 0; i < 8; i++)
            st[i] = gl_add(gl_mul(st[i], DIAG[i]), sum);
    }
    for (int r = 0; r < 4; r++) {
        for (int i = 0; i < 8; i++)
            st[i] = gl_sbox(gl_add(st[i], TERM_RC[r][i]));
        external_linear(st);
    }
}

void poseidon2_permute_batch(u64 *states, size_t n) {
    for (size_t i = 0; i < n; i++)
        poseidon2_permute(states + 8 * i);
}

/* two_to_one compression (poseidon_hash.rs:67): observe 8, sample 4.
 * digest = [s3, s2, s1, s0] of the final state (pop-from-end). */
void poseidon2_compress_batch(const u64 *left, const u64 *right, u64 *out,
                              size_t n) {
    for (size_t i = 0; i < n; i++) {
        u64 st[8];
        for (int k = 0; k < 4; k++) st[k] = left[4 * i + k];
        for (int k = 4; k < 8; k++) st[k] = 0;
        poseidon2_permute(st);
        for (int k = 0; k < 4; k++) st[k] = right[4 * i + k];
        poseidon2_permute(st);
        out[4 * i + 0] = st[3];
        out[4 * i + 1] = st[2];
        out[4 * i + 2] = st[1];
        out[4 * i + 3] = st[0];
    }
}
