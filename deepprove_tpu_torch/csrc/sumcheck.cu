// The sumcheck rounds on the device, with the Fiat-Shamir sponge in the same
// launches: no round reads the host.
//
// Replaces the JAX package's jitted round loop, sumcheck/fused.py
// `_round_step_kernel` (:164) and `_fused_kernel` (:64). It proves
//   sum_{x in {0,1}^n} sum_p c_p prod_f rows[idx[p][f]](x)
// over m extension rows held as two int64 planes (a0, a1), laid end to
// end. A row may be shorter than 2^n: a row of 2^l entries stands for its
// tiling over the high variables, and is read at entry e mod 2^l. The fold
// takes entries 2j and 2j + 1, low variable first, so a tiled row stays
// periodic through every round and reading it modulo its length gives what
// the tiling gave, at the cost of its own length. Each row's word of
// `meta` is (offset << 6) | l: the row's 2^l entries (room for at least 4,
// offset a multiple of 4) start at `offset` in the first buffer and at
// offset / 2 in the second, which holds each row folded once (ping-pong
// buffers: a row after k folds lies in the first buffer when k is even). Each round: fold the previous
// round's challenge into every row (the lowest variable), form the round
// message (the sum at t = 0..D of the lowest variable), absorb it with the
// label b"Internal round" and squeeze the next challenge. A factor index of
// -1 is the constant 1 (it pads a product of lower degree).
//
// Three kernels, D (the degree, 1..5) a template parameter:
//   round_kernel  one pass over the card's grid: folds the rows by the
//                 challenge read from device memory (none in round 0) into
//                 a second buffer (ping-pong: a fold in place would race),
//                 forms the round's terms from the folded pairs in its
//                 registers, and writes each block's partial message to
//                 scratch;
//   finish_kernel one block: sums the partials, writes the message, runs the
//                 sponge (transcript.cuh, one warp) and writes the challenge
//                 where the next round_kernel reads it;
//   tail_kernel   one cooperative launch over the whole card: every
//                 remaining round once the rows are short, then the last
//                 fold into the final evaluations.
// So a sumcheck of n variables is 2 launches a round above the tail and one
// for the tail (sumcheck/fused.py picks the split).
//
// What bounds them: round_kernel reads the rows' own entries (16 bytes an
// element) once and writes their halves once, and does an extension
// multiply a folded entry and about D (D + 1) a product a pair. Its bound
// is the bytes, but on an H100 at degree 2 the arithmetic alone takes
// longer: integer instructions run at 64 an SM a clock, a Goldilocks
// product takes some 25 of them, and the compares and selects that keep
// values canonical are 29 % of the kernel's (scripts/round_kernel_designs.py
// times the kernel without its loads and without its products: the first
// takes longer at the timed shape; PERF.md). Its work follows the rows'
// own entries, not the longest row:
//   - the host lays out the round's units (sumcheck/fused.py
//     `round_plan`): one (item, pair) a unit, an item a product over
//     the pairs of its longest factor (a shorter factor read at j modulo
//     its own pairs, the item's coefficient scaled by the number of times
//     the tiling repeats it) or a row that no product lists (its fold
//     alone); so a row of 2^8 entries beside one of 2^28 costs its own
//     pairs, not 2^27;
//   - the units are spread evenly over a grid the size of the card (every
//     SM, as many blocks as the occupancy calculator lets it hold), each
//     thread taking every grid's-width-th unit: the partial messages are at
//     most that many rows, whatever the shape, for the finish kernel; a
//     thread decodes an item once for its units of it and applies the
//     item's coefficient once, to their sum;
//   - a unit reads each factor's four source entries as two 16-byte words a
//     plane (rows start at a multiple of 4 entries), neighbouring threads on
//     neighbouring words, every load of the unit issued before any
//     arithmetic, and the thread's next unit prefetched into L2 before it,
//     so that the arithmetic runs while the bytes stream; the one slot of
//     the schedule that writes a row (its first listing) stores the folded
//     pair as one 16-byte word a plane, and the same registers feed the
//     terms: nothing is read back;
//   - the items' words and bases and the rows' words are staged in shared
//     memory when they fit (48 KB).
// The finish and tail kernels are latency: every round's challenge is a chain
// of dependent permutations that the next round's fold waits on. The tail
// spreads each round's work over every SM so that a round's pass costs
// little beside its sponge call:
//   - the fold takes one thread a (row, output entry) and the message one
//     thread a (product, pair), so no thread walks all rows or products;
//   - the rows stay in device memory, read and written at L2: a product
//     reads rows that other blocks folded, and L2 holds them from the
//     tail's second round on (the batch opening's 126 rows of 2^14 after
//     its first fold are 33 MB against 50 MB);
//   - the blocks write their partial messages to scratch; block 0 sums them
//     and its first warp runs the sponge and writes the challenge; three
//     grid barriers a round order the fold, the partials and the challenge.
// A thread-block cluster of 16 SMs, summing through distributed shared
// memory, has cheaper barriers (scripts/tail_designs.py times both) but
// runs the passes on an eighth of the card; it was built first and was
// slower than the grid (PERF.md). A grid the card cannot hold is an
// error, with no other route.
//
// Arithmetic is canonical (every value below p), so messages, challenges and
// evaluations equal the plain torch version bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "transcript.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_DEGREE = 5;
constexpr int ROUND_THREADS = 256;  // round_kernel and finish_kernel blocks
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

// 7 t1 + t0 below p: 7 t1 < 2^67, so the sum is a wide value folded once.
__device__ __forceinline__ u64 mul7_add(u64 t1, u64 t0) {
    const gl::wide w = {t1 * 7, (u32)__umul64hi(t1, 7)};
    return gl::canonical(gl::fold(gl::wadd(w, t0)));
}

// Karatsuba over X^2 = 7, as fields/gf.py `ext_mul`.
__device__ __forceinline__ ext emul(ext a, ext b) {
    u64 t0 = fmul(a.a0, b.a0);
    u64 t1 = fmul(a.a1, b.a1);
    u64 t2 = fmul(fadd(a.a0, a.a1), fadd(b.a0, b.a1));
    return {mul7_add(t1, t0), fsub(fsub(t2, t0), t1)};
}

__device__ __forceinline__ ext load(const u64* p0, const u64* p1, long long i) {
    return {p0[i], p1[i]};
}

// Rows that other SMs wrote in this launch: read and written at L2, past
// the SM's own L1.
__device__ __forceinline__ u64 ld_l2(const u64* p) {
    return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ ext load_l2(const u64* p0, const u64* p1, long long i) {
    return {ld_l2(p0 + i), ld_l2(p1 + i)};
}

__device__ __forceinline__ void store_l2(u64* p0, u64* p1, long long i, ext v) {
    __stcg(reinterpret_cast<unsigned long long*>(p0 + i), (unsigned long long)v.a0);
    __stcg(reinterpret_cast<unsigned long long*>(p1 + i), (unsigned long long)v.a1);
}

// lo + r (hi - lo)
__device__ __forceinline__ ext fold_pair(ext lo, ext hi, ext r) { return eadd(lo, emul(r, esub(hi, lo))); }

// A round's challenge with the sum of its halves, which every Karatsuba
// product by it takes: emul's arithmetic with that sum made once a round.
struct Challenge {
    ext r;
    u64 rs;  // r.a0 + r.a1
};

__device__ __forceinline__ ext emul_by(const Challenge& c, ext b) {
    u64 t0 = fmul(c.r.a0, b.a0);
    u64 t1 = fmul(c.r.a1, b.a1);
    u64 t2 = fmul(c.rs, fadd(b.a0, b.a1));
    return {mul7_add(t1, t0), fsub(fsub(t2, t0), t1)};
}

__device__ __forceinline__ ext fold_by(ext lo, ext hi, const Challenge& c) { return eadd(lo, emul_by(c, esub(hi, lo))); }

// A row's place: its offset in the buffer that holds it after `drop`
// folds, and its length's log there (a row folded past its length is one
// constant entry).
struct Row {
    long long off;
    int lg;
};

__device__ __forceinline__ Row row_at(u64 meta, int drop) {
    const int lg0 = (int)(meta & 63);
    return {(long long)(meta >> 6) >> (drop & 1), lg0 > drop ? lg0 - drop : 0};
}

// Entries 2j, 2j + 1 of a row (lo, hi), read modulo its length; a row of one
// entry gives it twice. The tail (TAIL) reads at L2.
template <bool TAIL>
__device__ __forceinline__ void read_pair(const u64* v0, const u64* v1, Row r, long long j, ext& lo,
                                          ext& hi) {
    if (r.lg == 0) {
        lo = hi = TAIL ? load_l2(v0, v1, r.off) : load(v0, v1, r.off);
        return;
    }
    const long long o = r.off + 2 * (j & ((1LL << (r.lg - 1)) - 1));
    lo = TAIL ? load_l2(v0, v1, o) : load(v0, v1, o);
    hi = TAIL ? load_l2(v0, v1, o + 1) : load(v0, v1, o + 1);
}

// Product p at pair j at t = 0..D, times its coefficient, added into
// sums[0..D]; pair(row, lo, hi) gives a factor row's pair. The coefficient
// is one more factor, the same at every t.
template <int D, class Pair>
__device__ __forceinline__ void add_product(int p, const int* fidx, const u64* c0, const u64* c1, Pair pair,
                                            ext* sums) {
    ext acc[D + 1];
    bool any = false;
#pragma unroll
    for (int f = 0; f <= D; f++) {
        ext lo, hi;
        if (f < D) {
            const int row = fidx[p * D + f];
            if (row < 0) continue;  // the constant 1
            pair(row, lo, hi);
        } else {
            lo = hi = load(c0, c1, p);
        }
        const ext diff = esub(hi, lo);
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
#pragma unroll
    for (int t = 0; t <= D; t++) sums[t] = eadd(sums[t], acc[t]);
}

// The round kernel's work: one unit a (item, pair j) of the round, laid out
// by the host (sumcheck/fused.py `round_plan`). An item is a product,
// or a row that no product lists (its fold alone). Its word is D + 1 ints:
// the product (-1 for a row alone), then D factor words, each the row's
// index, with WRITES set in the one slot of the whole schedule that writes
// that row's folded entries (its first listing), or -1 for the constant 1.
// Item i takes units base[i] .. base[i + 1] - 1 of the round: its span, the
// pairs of its longest factor after this round's fold. A shorter factor is
// read at j modulo its own pairs, and the item's terms count
// (pairs of the round) / span times: its coefficient is scaled by that
// power of two, which is what the tiled rows would have summed to.
constexpr int WRITES = 1 << 30;

// 16-byte loads of the source rows (not written in the launch: the fold
// writes the other buffer) and 16-byte stores of the folded pairs.
__device__ __forceinline__ ulonglong2 ld16(const u64* p) { return __ldg(reinterpret_cast<const ulonglong2*>(p)); }

__device__ __forceinline__ void st16(u64* p, u64 x, u64 y) {
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(x, y);
}

// The schedule's tables, in shared memory when they fit, else where the
// host put them.
struct Plan {
    const long long* base;
    const int* word;
    const u64* meta;
};

// The item a thread works on, decoded once an item: a thread's units are a
// grid's width apart, so it takes each item of more units than the grid
// has threads (every row of 2^17 entries and up at the card's grid) for
// several units in turn. Each factor's place in the source rows and, when
// its slot writes the row, in the destination; the mask that reads it at j
// modulo its own pairs; how it is read:
//   NONE  the constant 1;
//   ONE   a row of one entry, its one entry as both of every pair;
//   PAIR  one 16-byte word a plane: the pair 2jj, 2jj + 1 (no fold), or a
//         row of two entries (a fold: its one folded entry);
//   QUAD  two 16-byte words a plane: the entries 4jj .. 4jj + 3 that fold
//         into the pair 2jj, 2jj + 1.
enum { NONE, ONE, PAIR, QUAD };

template <int D>
struct Item {
    int prod;  // -1: a row alone (its fold only)
    int kind[D];
    bool writes[D];
    long long src[D], dst[D], mask[D];
    ext c;  // the coefficient, scaled
};

template <int D>
__device__ __forceinline__ Item<D> decode_item(const Plan& pl, const u64* c0, const u64* c1, int i, long long span,
                                               long long count, bool fold, int drop) {
    Item<D> it;
    const int* wd = pl.word + i * (D + 1);
    it.prod = wd[0];
#pragma unroll
    for (int f = 0; f < D; f++) {
        const int w = wd[1 + f];
        it.kind[f] = NONE;
        it.writes[f] = false;
        it.src[f] = it.dst[f] = it.mask[f] = 0;
        if (w < 0) continue;
        const u64 word = pl.meta[w & (WRITES - 1)];
        const Row src = row_at(word, drop);
        it.src[f] = src.off;
        it.writes[f] = fold && (w & WRITES);
        it.dst[f] = row_at(word, drop + 1).off;
        if (src.lg == 0) {
            it.kind[f] = ONE;
        } else if (fold && src.lg >= 2) {
            it.kind[f] = QUAD;
            it.mask[f] = (1LL << (src.lg - 2)) - 1;
        } else {
            it.kind[f] = PAIR;
            it.mask[f] = fold ? 0 : (1LL << (src.lg - 1)) - 1;
        }
    }
    it.c = {0, 0};
    if (it.prod >= 0) {
        it.c = {c0[it.prod], c1[it.prod]};
        const u64 k = (u64)count >> (__ffsll(span) - 1);  // both powers of two
        if (k > 1) it.c = {fmul(it.c.a0, k), fmul(it.c.a1, k)};
    }
    return it;
}

// An item's terms over a thread's units of it, unreduced (gl::wadd; a
// thread takes fewer than 2^32 units of an item): an add a word.
struct wext {
    gl::wide a0, a1;
};

__device__ __forceinline__ void prefetch_l2(const u64* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }

// The item at unit j (below its span): each factor's pair, folded by r
// (with `fold`) and written when its slot writes the row and j is below the
// row's pairs; then, for a product, its terms at t = 0..D added into acc
// (the coefficient is applied once an item, in round_kernel). Every load of
// the unit is issued before any arithmetic, then a prefetch into L2 of the
// thread's next unit jn of the same item (-1: none), so that its rows
// stream from device memory while this unit's arithmetic runs: the
// arithmetic alone takes longer than the unit's bytes (PERF.md).
template <int D>
__device__ __forceinline__ void unit_pass(const Item<D>& it, long long j, long long jn, bool fold,
                                          const Challenge& r, const u64* s0, const u64* s1, u64* d0, u64* d1,
                                          wext* acc) {
    ulonglong2 a[D], b[D], c[D], d[D];  // planes 0 (a: entries 0, 1; b: 2, 3) and 1 (c, d)
#pragma unroll
    for (int f = 0; f < D; f++) {
        const long long o = it.src[f] + (it.kind[f] == QUAD ? 4 : 2) * (j & it.mask[f]);
        if (it.kind[f] == ONE) {
            const u64 e0 = __ldg(reinterpret_cast<const unsigned long long*>(s0 + o));
            const u64 e1 = __ldg(reinterpret_cast<const unsigned long long*>(s1 + o));
            a[f] = b[f] = make_ulonglong2(e0, e0);
            c[f] = d[f] = make_ulonglong2(e1, e1);
        } else if (it.kind[f] != NONE) {
            a[f] = ld16(s0 + o);
            c[f] = ld16(s1 + o);
            b[f] = it.kind[f] == QUAD ? ld16(s0 + o + 2) : a[f];
            d[f] = it.kind[f] == QUAD ? ld16(s1 + o + 2) : c[f];
        }
    }
    if (jn >= 0) {
#pragma unroll
        for (int f = 0; f < D; f++) {
            if (it.kind[f] != QUAD && it.kind[f] != PAIR) continue;
            const long long o = it.src[f] + (it.kind[f] == QUAD ? 4 : 2) * (jn & it.mask[f]);
            prefetch_l2(s0 + o);
            prefetch_l2(s1 + o);
        }
    }
    ext u[D + 1];
    bool any = false;
#pragma unroll
    for (int f = 0; f < D; f++) {
        if (it.kind[f] == NONE) continue;
        ext lo = {a[f].x, c[f].x}, hi = {a[f].y, c[f].y};
        if (fold) {
            const ext l2 = {b[f].x, d[f].x}, h2 = {b[f].y, d[f].y};
            lo = fold_by(lo, hi, r);
            hi = fold_by(l2, h2, r);
            if (it.writes[f]) {
                if (it.kind[f] == QUAD) {
                    if (j <= it.mask[f]) {
                        st16(d0 + it.dst[f] + 2 * j, lo.a0, hi.a0);
                        st16(d1 + it.dst[f] + 2 * j, lo.a1, hi.a1);
                    }
                } else if (j == 0) {
                    d0[it.dst[f]] = lo.a0;
                    d1[it.dst[f]] = lo.a1;
                }
            }
        }
        if (it.prod < 0) continue;  // a row alone: its fold only
        const ext diff = esub(hi, lo);
        ext v = lo;
#pragma unroll
        for (int t = 0; t <= D; t++) {
            if (t == 1) v = hi;
            else if (t >= 2) v = eadd(v, diff);
            u[t] = any ? emul(u[t], v) : v;
        }
        any = true;
    }
    if (it.prod < 0) return;
#pragma unroll
    for (int t = 0; t <= D; t++) {
        const ext v = any ? u[t] : ext{1, 0};
        acc[t] = {gl::wadd(acc[t].a0, v.a0), gl::wadd(acc[t].a1, v.a1)};
    }
}

// The terms a thread gathered over its units of one item, reduced, times
// the item's coefficient, into sums.
template <int D>
__device__ __forceinline__ void flush_item(const Item<D>& it, wext* acc, ext* sums) {
    if (it.prod >= 0) {
#pragma unroll
        for (int t = 0; t <= D; t++) {
            const ext a = {gl::canonical(gl::fold(acc[t].a0)), gl::canonical(gl::fold(acc[t].a1))};
            sums[t] = eadd(sums[t], emul(a, it.c));
        }
    }
#pragma unroll
    for (int t = 0; t <= D; t++) acc[t] = {{0, 0}, {0, 0}};
}

// The block's sums into total[0..V), V = 2(D + 1) words (t-major, a0 then
// a1); every thread of the block takes part. round_kernel and
// finish_kernel: shuffles within each warp, then V threads add the warps'
// sums (red: V words a warp).
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

// The same sum for the tail, by columns: each thread writes its V words
// into column form in cols (V * blockDim words), then warp k sums word k
// (and k + warps, ...) and reduces it by shuffles: a short stretch of
// code, which the tail reads afresh every round.
template <int D>
__device__ __forceinline__ void block_sum_cols(const ext* sums, u64* cols, u64* total) {
    constexpr int V = 2 * (D + 1);
    const int n = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int t = 0; t <= D; t++) {
        cols[(2 * t) * n + threadIdx.x] = sums[t].a0;
        cols[(2 * t + 1) * n + threadIdx.x] = sums[t].a1;
    }
    __syncthreads();
    for (int k = warp; k < V; k += n >> 5) {
        u64 s = 0;
        for (int i = lane; i < n; i += 32) s = fadd(s, cols[k * n + i]);
#pragma unroll
        for (int off = 16; off; off >>= 1)
            s = fadd(s, (u64)__shfl_down_sync(0xffffffffu, (unsigned long long)s, off));
        if (lane == 0) total[k] = s;
    }
    __syncthreads();
}

// One warp, lane k < 2(D + 1) holding word k of message `rnd` (t-major, a0
// then a1): write the message into msgs (2, n, D + 1), absorb it and the
// round label, squeeze the challenge into chals (2, n); the challenge is
// returned in every lane.
template <int D>
__device__ __forceinline__ ext absorb_and_squeeze(sponge::State& st, u64 word, int rnd, int n,
                                                  u64* msgs, u64* chals) {
    constexpr int V = 2 * (D + 1);
    const int lane = threadIdx.x & 31;
    if (lane < V) msgs[(long long)(lane & 1) * n * (D + 1) + rnd * (D + 1) + (lane >> 1)] = word;
    const u64 mine = lane < V ? word : lane == V ? sponge::ROUND_LABEL_0 : sponge::ROUND_LABEL_1;
    ext c;
    sponge::absorb_and_sample_ext(st, mine, V + 2, c.a0, c.a1);
    if (lane == 0) {
        chals[rnd] = c.a0;
        chals[n + rnd] = c.a1;
    }
    return c;
}

// The round kernel's tables in shared memory: base (items + 1), meta (m)
// and the item words (items x (D + 1)), when they fit in STAGE_LIMIT bytes
// (a launch needs no opt-in up to 48 KB).
constexpr int STAGE_LIMIT = 48 * 1024;

template <int D>
__host__ __device__ constexpr long long round_stage_bytes(int items, int m) {
    return 8LL * (items + 1) + 8LL * m + 4LL * (D + 1) * items;
}

template <int D>
__global__ void __launch_bounds__(ROUND_THREADS)
round_kernel(const u64* __restrict__ s0, const u64* __restrict__ s1, u64* __restrict__ d0, u64* __restrict__ d1,
             int m, const u64* __restrict__ meta, int drop, long long count, const u64* r0, const u64* r1,
             int items, const int* __restrict__ word, const long long* __restrict__ base,
             const u64* __restrict__ c0, const u64* __restrict__ c1, int staged, u64* __restrict__ partials) {
    constexpr int V = 2 * (D + 1);
    __shared__ u64 red[(ROUND_THREADS / 32) * V];
    __shared__ u64 total[V];
    extern __shared__ __align__(16) unsigned char stage[];
    const bool fold = r0 != nullptr;
    Plan pl = {base, word, meta};
    if (staged) {
        long long* sb = reinterpret_cast<long long*>(stage);
        u64* sm = reinterpret_cast<u64*>(sb + items + 1);
        int* sw = reinterpret_cast<int*>(sm + m);
        for (int k = threadIdx.x; k <= items; k += ROUND_THREADS) sb[k] = base[k];
        for (int k = threadIdx.x; k < m; k += ROUND_THREADS) sm[k] = meta[k];
        for (int k = threadIdx.x; k < items * (D + 1); k += ROUND_THREADS) sw[k] = word[k];
        pl = {sb, sw, sm};
        __syncthreads();
    }
    ext sums[D + 1];
    wext acc[D + 1];
#pragma unroll
    for (int t = 0; t <= D; t++) {
        sums[t] = {0, 0};
        acc[t] = {{0, 0}, {0, 0}};
    }
    Challenge r = {{0, 0}, 0};
    if (fold) r = {{*r0, *r1}, fadd(*r0, *r1)};
    const long long work = pl.base[items], nth = (long long)gridDim.x * ROUND_THREADS;
    // the item of unit w: w only grows, so the search walks each item once
    int i = -1;
    long long lo = 0, hi = 0;  // the item's units
    Item<D> it;
    it.prod = -1;
    for (long long w = (long long)blockIdx.x * ROUND_THREADS + threadIdx.x; w < work; w += nth) {
        if (w >= hi) {
            flush_item<D>(it, acc, sums);
            do i++;
            while (pl.base[i + 1] <= w);
            lo = pl.base[i];
            hi = pl.base[i + 1];
            it = decode_item<D>(pl, c0, c1, i, hi - lo, count, fold, drop);
        }
        unit_pass<D>(it, w - lo, w + nth < hi ? w + nth - lo : -1, fold, r, s0, s1, d0, d1, acc);
    }
    flush_item<D>(it, acc, sums);
    block_sum<D>(sums, red, total);
    if (threadIdx.x < V) partials[(long long)blockIdx.x * V + threadIdx.x] = total[threadIdx.x];
}

// The round kernel's grid at degree D for `items` items over m rows: every
// SM, with as many blocks as the occupancy calculator lets it hold at the
// launch's shared memory (*stage_bytes, 0 when the tables stay in device
// memory). Queried at every call, as the tail's grid is.
template <int D>
cudaError_t round_grid(int items, int m, int* blocks, int* per_sm, int* stage_bytes) {
    const long long want = round_stage_bytes<D>(items, m);
    *stage_bytes = want <= STAGE_LIMIT ? (int)want : 0;
    int dev = 0, sms = 0, fits = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, round_kernel<D>, ROUND_THREADS, *stage_bytes);
    if (err == cudaSuccess && fits * sms < 1) err = cudaErrorInvalidConfiguration;
    *blocks = err == cudaSuccess ? fits * sms : 0;
    *per_sm = fits;
    return err;
}

template <int D>
int launch_round(const void* s0, const void* s1, void* d0, void* d1, int m, const void* meta, int drop,
                 long long count, const void* r0, const void* r1, int items, const void* word, const void* base,
                 long long work, const void* c0, const void* c1, void* partials, int* blocks, cudaStream_t stream) {
    int grid, per_sm, stage_bytes;
    cudaError_t err = round_grid<D>(items, m, &grid, &per_sm, &stage_bytes);
    if (err != cudaSuccess) return (int)err;
    const long long need = (work + ROUND_THREADS - 1) / ROUND_THREADS;
    *blocks = (int)(need < grid ? (need > 0 ? need : 1) : grid);
    round_kernel<D><<<*blocks, ROUND_THREADS, stage_bytes, stream>>>(
        (const u64*)s0, (const u64*)s1, (u64*)d0, (u64*)d1, m, (const u64*)meta, drop, count, (const u64*)r0,
        (const u64*)r1, items, (const int*)word, (const long long*)base, (const u64*)c0, (const u64*)c1,
        stage_bytes > 0, (u64*)partials);
    return (int)cudaGetLastError();
}

// The partial messages' sum (V = 2(D + 1) words a row, row b at words
// b V ...), returned in the lanes of warp 0 (lane k < V: word k). The
// shuffle-first reduction of block_sum, arranged so that nothing before the
// sponge branches on the thread index within a warp: ptxas then needs no
// divergence check before the sponge's shuffles. block_sum's last step is
// such a branch, and with it ptxas guards each of them (PERF.md, the finish
// kernel's design):
//   - each thread loads FINISH_BATCH rows as 16-byte (a0, a1) words, every
//     load issued before any add (one latency of L2 for the timed shape's
//     1024 rows, not one a row), in a loop whose trip count is the same in
//     every thread (rows past nblocks are zeros by predicate);
//   - butterfly shuffles leave each warp's sum in every lane, which all
//     write to red (the same word);
//   - after one barrier every lane of warp 0 adds the warps' words (lanes
//     at or past V add word 0 and keep it unused).
constexpr int FINISH_BATCH = 4;

template <int D>
__device__ __forceinline__ u64 finish_sum(const u64* __restrict__ partials, long long nblocks) {
    constexpr int V = 2 * (D + 1), WARPS = ROUND_THREADS / 32;
    __shared__ u64 red[WARPS * V];
    const int warp = threadIdx.x >> 5;
    const ulonglong2* rows = reinterpret_cast<const ulonglong2*>(partials);  // row b: words b (D + 1) + t
    ext sums[D + 1];
#pragma unroll
    for (int t = 0; t <= D; t++) sums[t] = {0, 0};
    for (long long base = 0; base < nblocks; base += FINISH_BATCH * ROUND_THREADS) {
        ulonglong2 v[FINISH_BATCH][D + 1];
#pragma unroll
        for (int k = 0; k < FINISH_BATCH; k++) {
            const long long b = base + k * ROUND_THREADS + threadIdx.x;
#pragma unroll
            for (int t = 0; t <= D; t++) v[k][t] = b < nblocks ? rows[b * (D + 1) + t] : make_ulonglong2(0, 0);
        }
#pragma unroll
        for (int k = 0; k < FINISH_BATCH; k++)
#pragma unroll
            for (int t = 0; t <= D; t++) sums[t] = eadd(sums[t], ext{v[k][t].x, v[k][t].y});
    }
#pragma unroll
    for (int t = 0; t <= D; t++) {
        u64 a = sums[t].a0, b = sums[t].a1;
#pragma unroll
        for (int off = 16; off; off >>= 1) {
            a = fadd(a, (u64)__shfl_xor_sync(0xffffffffu, (unsigned long long)a, off));
            b = fadd(b, (u64)__shfl_xor_sync(0xffffffffu, (unsigned long long)b, off));
        }
        red[warp * V + 2 * t] = a;
        red[warp * V + 2 * t + 1] = b;
    }
    __syncthreads();
    const int k = (threadIdx.x & 31) < V ? threadIdx.x & 31 : 0;
    u64 word = 0;
#pragma unroll
    for (int w = 0; w < WARPS; w++) word = fadd(word, red[w * V + k]);
    return word;
}

template <int D>
__global__ void __launch_bounds__(ROUND_THREADS, 1)
finish_kernel(const u64* __restrict__ partials, long long nblocks, int rnd, int n, u64* msgs,
              u64* chals, u64* state) {
    // Every warp loads the state (in flight during the sum), and warp 0 alone
    // runs the sponge: a load guarded by the thread index brings back ptxas'
    // divergence checks on the sponge's shuffles (PERF.md).
    sponge::State st;
    sponge::load(st, state);
    const u64 word = finish_sum<D>(partials, nblocks);
    if ((threadIdx.x >> 5) == 0) {
        absorb_and_squeeze<D>(st, word, rnd, n, msgs, chals);
        sponge::store(st, state);
    }
}

// The tail's rounds, each over the grid's threads (thread tid of nth).

// The rows in x (after `drop` folds) fold by r into y: one thread an output
// entry e = (row, q), q below 2^lg_half (the longest folded row's length);
// a row's entries past its own folded length are left alone. A thread
// loads FOLD_BATCH entries' pairs before it folds any, so that their loads
// are in flight together.
constexpr int FOLD_BATCH = 2;

__device__ __forceinline__ void fold_rows(const u64* x0, const u64* x1, u64* y0, u64* y1, int m,
                                          const u64* meta, int drop, int lg_half, ext r, long long tid,
                                          long long nth) {
    const long long count = (long long)m << lg_half;
    for (long long e0 = tid; e0 < count; e0 += FOLD_BATCH * nth) {
        ext lo[FOLD_BATCH], hi[FOLD_BATCH];
        long long dst[FOLD_BATCH];
#pragma unroll
        for (int k = 0; k < FOLD_BATCH; k++) {
            const long long e = e0 + k * nth;
            dst[k] = -1;
            if (e < count) {
                const int row = (int)(e >> lg_half);
                const long long q = e & ((1LL << lg_half) - 1);
                const Row src = row_at(meta[row], drop);
                if (src.lg == 0 ? q == 0 : q < (1LL << (src.lg - 1))) {
                    dst[k] = row_at(meta[row], drop + 1).off + q;
                    lo[k] = load_l2(x0, x1, src.off + (src.lg ? 2 * q : 0));
                    hi[k] = load_l2(x0, x1, src.off + (src.lg ? 2 * q + 1 : 0));
                }
            }
        }
#pragma unroll
        for (int k = 0; k < FOLD_BATCH; k++)
            if (dst[k] >= 0) store_l2(y0, y1, dst[k], fold_pair(lo[k], hi[k], r));
    }
}

// The message's terms over pairs of the rows in v (after `drop` folds, the
// longest 2^(lg_pairs + 1) long): one thread a (product, pair), added into
// the thread's sums.
template <int D>
__device__ __forceinline__ void message_terms(const u64* v0, const u64* v1, const u64* meta, int drop,
                                              int lg_pairs, const int* fidx, int np, const u64* c0,
                                              const u64* c1, long long tid, long long nth, ext* sums) {
    const long long pairs = 1LL << lg_pairs, count = (long long)np << lg_pairs;
    for (long long e = tid; e < count; e += nth) {
        const long long j = e & (pairs - 1);
        auto pair = [&](int row, ext& lo, ext& hi) { read_pair<true>(v0, v1, row_at(meta[row], drop), j, lo, hi); };
        add_product<D>((int)(e >> lg_pairs), fidx, c0, c1, pair, sums);
    }
}

// The products' factor indices and coefficients of the tail, in shared
// memory when they fit in STAGE_BYTES (every main-path sumcheck: at most
// 117 products), else read where they are: they are read every round, and
// the barriers' acquire empties the L1 each time.
constexpr int STAGE_BYTES = 8192;

struct Products {
    const int* fidx;
    const u64 *c0, *c1;
};

template <int D>
__device__ __forceinline__ Products stage_products(const int* fidx, int np, const u64* c0,
                                                     const u64* c1, unsigned char* stage) {
    if ((long long)np * (4 * D + 16) > STAGE_BYTES) return {fidx, c0, c1};
    u64* s0 = reinterpret_cast<u64*>(stage);
    u64* s1 = s0 + np;
    int* sf = reinterpret_cast<int*>(s1 + np);
    for (int i = threadIdx.x; i < np * D; i += blockDim.x) sf[i] = fidx[i];
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
        s0[i] = c0[i];
        s1[i] = c1[i];
    }
    return {sf, s0, s1};  // visible to the block after its next barrier
}

// The rows' words, in shared memory when they fit in META_BYTES (512 rows),
// for the same reason.
constexpr int META_BYTES = 4096;

__device__ __forceinline__ const u64* stage_meta(const u64* meta, int m, u64* stage) {
    if ((long long)m * 8 > META_BYTES) return meta;
    for (int i = threadIdx.x; i < m; i += blockDim.x) stage[i] = meta[i];
    return stage;  // visible to the block after its next barrier
}

// A tail block's threads at degree D: 512 up to degree 3, 256 above, where
// a thread of the message pass holds more sums and factors than 128
// registers (the most at 512 threads an SM) keep without a stack.
template <int D>
__host__ __device__ constexpr int tail_threads() {
    return D <= 3 ? 512 : 256;
}

// Rounds rnd0..n-1 on the rows in buffer x, the longest 2^lg long
// (folding first by challenge rnd0 - 1 when rnd0 > 0), ping-ponging with
// buffer y (the rows' places after one fold more: see `meta`); then the
// last fold into finals (2, m). One cooperative
// launch: every block of the card takes part in every round, and three
// grid barriers a round order the fold, the partial messages (in scratch:
// a row of V words a block, then the challenge's 2 words) and the
// challenge. The row buffers are neither restrict nor read through the
// read-only path: both are written and read again inside the launch, by
// other SMs.
template <int D>
__global__ void __launch_bounds__(tail_threads<D>(), 1)
tail_kernel(u64* x0, u64* x1, u64* y0, u64* y1, int m, const u64* __restrict__ meta, int lg, int rnd0, int n,
            const int* __restrict__ fidx, int np, const u64* __restrict__ c0,
            const u64* __restrict__ c1, u64* msgs, u64* chals, u64* state, u64* finals,
            u64* scratch) {
    constexpr int V = 2 * (D + 1), THREADS = tail_threads<D>();
    __shared__ u64 cols[V * THREADS];
    __shared__ u64 total[V];
    __shared__ u64 home[sponge::STATE_WORDS];  // block 0's: the sponge state between rounds
    __shared__ __align__(16) unsigned char stage[STAGE_BYTES];
    __shared__ u64 meta_stage[META_BYTES / 8];
    const Products prod = stage_products<D>(fidx, np, c0, c1, stage);
    const u64* rows = stage_meta(meta, m, meta_stage);
    cg::grid_group grid = cg::this_grid();
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long nth = (long long)gridDim.x * THREADS;
    const bool leader = blockIdx.x == 0 && threadIdx.x < 32;  // the warp that runs the sponge
    u64* partials = scratch;
    u64* rg = scratch + (long long)gridDim.x * V;
    // the state is in registers while a round's call runs and in shared
    // memory between calls, so that the passes keep every register
    const u64* from = state;
    bool fold = rnd0 > 0;
    int drop = fold ? rnd0 - 1 : 0;  // the folds the rows in x have had
    ext r = fold ? ext{chals[rnd0 - 1], chals[n + rnd0 - 1]} : ext{0, 0};
    __syncthreads();  // the staged products and rows
    for (int rnd = rnd0; rnd < n; rnd++) {
        if (fold) {
            fold_rows(x0, x1, y0, y1, m, rows, drop, lg - 1, r, tid, nth);
            u64* t0 = x0;
            u64* t1 = x1;
            x0 = y0;
            x1 = y1;
            y0 = t0;
            y1 = t1;
            lg--;
            drop++;
            grid.sync();  // the folded rows, for every block's products
        }
        ext sums[D + 1];
#pragma unroll
        for (int t = 0; t <= D; t++) sums[t] = {0, 0};
        message_terms<D>(x0, x1, rows, drop, lg - 1, prod.fidx, np, prod.c0, prod.c1, tid, nth, sums);
        block_sum_cols<D>(sums, cols, total);
        if (threadIdx.x < V)
            __stcg(reinterpret_cast<unsigned long long*>(partials) + (long long)blockIdx.x * V + threadIdx.x,
                   (unsigned long long)total[threadIdx.x]);
        grid.sync();  // the partial messages, for block 0
        if (blockIdx.x == 0) {
#pragma unroll
            for (int t = 0; t <= D; t++) sums[t] = {0, 0};
            for (long long b = threadIdx.x; b < gridDim.x; b += THREADS) {
#pragma unroll
                for (int t = 0; t <= D; t++)
                    sums[t] = eadd(sums[t], load_l2(partials + 2 * t, partials + 2 * t + 1, b * V));
            }
            block_sum_cols<D>(sums, cols, total);
            if (leader) {
                sponge::State st;
                sponge::load(st, from);
                const ext c = absorb_and_squeeze<D>(st, threadIdx.x < V ? total[threadIdx.x] : 0, rnd, n,
                                                    msgs, chals);
                sponge::store(st, home);
                from = home;
                if (threadIdx.x == 0) store_l2(rg, rg + 1, 0, c);
            }
        }
        grid.sync();  // the challenge, for every block
        r = load_l2(rg, rg + 1, 0);
        fold = true;
    }
    // the rows are at most 2 long: fold the last challenge in
    for (long long i = tid; i < m; i += nth) {
        const Row row = row_at(rows[i], drop);
        const ext f = fold_pair(load_l2(x0, x1, row.off), load_l2(x0, x1, row.off + (row.lg ? 1 : 0)), r);
        finals[i] = f.a0;
        finals[m + i] = f.a1;
    }
    if (leader && threadIdx.x < sponge::STATE_WORDS) state[threadIdx.x] = home[threadIdx.x];
}

// The tail's grid at degree D on the current device: every SM, with as
// many blocks as the occupancy calculator lets a cooperative launch hold
// (*per_sm). Queried at every call (a few microseconds beside the launch),
// so each device gets its own grid. An error when none fits.
template <int D>
cudaError_t tail_grid(int* blocks, int* per_sm) {
    int dev = 0, sms = 0, fits = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, tail_kernel<D>, tail_threads<D>(), 0);
    if (err == cudaSuccess && fits * sms < 1) err = cudaErrorInvalidConfiguration;
    *blocks = err == cudaSuccess ? fits * sms : 0;
    *per_sm = fits;
    return err;
}

template <int D>
int launch_tail(void* x0, void* x1, void* y0, void* y1, int m, const void* meta, long long L, int rnd0,
                int n, const void* fidx, int np, const void* c0, const void* c1, void* msgs, void* chals,
                void* state, void* finals, void* scratch, cudaStream_t stream) {
    int blocks, per_sm;
    cudaError_t err = tail_grid<D>(&blocks, &per_sm);
    if (err != cudaSuccess) return (int)err;
    if (L < 2 || (L & (L - 1))) return (int)cudaErrorInvalidValue;
    u64 *ax0 = (u64*)x0, *ax1 = (u64*)x1, *ay0 = (u64*)y0, *ay1 = (u64*)y1;
    int lg = __builtin_ctzll((unsigned long long)L);
    const int* afidx = (const int*)fidx;
    const u64 *ac0 = (const u64*)c0, *ac1 = (const u64*)c1, *ameta = (const u64*)meta;
    u64 *amsgs = (u64*)msgs, *achals = (u64*)chals, *astate = (u64*)state, *afinals = (u64*)finals;
    u64* ascratch = (u64*)scratch;
    void* args[] = {&ax0, &ax1, &ay0, &ay1, &m, &ameta, &lg, &rnd0, &n, &afidx, &np, &ac0, &ac1,
                    &amsgs, &achals, &astate, &afinals, &ascratch};
    err = cudaLaunchCooperativeKernel((const void*)tail_kernel<D>, dim3(blocks),
                                      dim3(tail_threads<D>()), args, 0, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
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

extern "C" int dp_sumcheck_limits(int* max_degree) {
    *max_degree = MAX_DEGREE;
    return 0;
}

// The tail's launch at `degree`: blocks of its cooperative grid, threads a
// block, and blocks an SM. Returns the CUDA error that refuses the shape
// (0 = none).
extern "C" int dp_sumcheck_tail_config(int degree, int* blocks, int* threads, int* per_sm) {
    cudaError_t err = cudaErrorInvalidValue;
#define DP_CONFIG(D)                         \
    err = tail_grid<D>(blocks, per_sm); \
    *threads = tail_threads<D>()
    DP_DISPATCH(degree, DP_CONFIG)
#undef DP_CONFIG
    return (int)err;
}

// The round kernel's grid at `degree` for `items` items over m rows: the
// most blocks a launch takes (the rows of partials it writes), blocks an
// SM, and the shared memory it stages its tables in (0: none). Returns the
// CUDA error that refuses the shape (0 = none).
extern "C" int dp_sumcheck_round_config(int degree, int items, int m, int* blocks, int* per_sm,
                                        int* stage_bytes) {
    cudaError_t err = cudaErrorInvalidValue;
#define DP_CONFIG(D) err = round_grid<D>(items, m, blocks, per_sm, stage_bytes)
    DP_DISPATCH(degree, DP_CONFIG)
#undef DP_CONFIG
    return (int)err;
}

// One round above the tail on the rows in (s0, s1) after `drop` folds: the
// round's `count` pairs (the longest row's, after its fold), r0/r1 the
// previous challenge (both null in round 0: no fold, d0/d1 unused); the
// schedule's `items` words and this round's bases (items + 1, the last
// `work`); partials gets one 2(D + 1)-word row a block, *blocks of them.
// Returns cudaGetLastError() of the launch.
extern "C" int dp_sumcheck_round(int degree, const void* s0, const void* s1, void* d0, void* d1, int m,
                                 const void* meta, int drop, long long count, const void* r0, const void* r1,
                                 int items, const void* word, const void* base, long long work, const void* c0,
                                 const void* c1, void* partials, int* blocks, void* stream) {
    int err = (int)cudaErrorInvalidValue;
#define DP_ROUND(D)                                                                                     \
    err = launch_round<D>(s0, s1, d0, d1, m, meta, drop, count, r0, r1, items, word, base, work, c0, c1, \
                          partials, blocks, (cudaStream_t)stream)
    DP_DISPATCH(degree, DP_ROUND)
#undef DP_ROUND
    return err;
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

// The rows in (x0, x1) (rounds 0..rnd0 - 2 folded in), the longest L = 2^k
// long, placed by `meta`; (y0, y1) the other buffer; scratch blocks *
// 2(degree + 1) + 2 words (dp_sumcheck_tail_config's blocks). Launches one
// cooperative grid; returns the CUDA error of the launch.
extern "C" int dp_sumcheck_tail(int degree, void* x0, void* x1, void* y0, void* y1, int m,
                                const void* meta, long long L, int rnd0, int n, const void* fidx, int np,
                                const void* c0, const void* c1, void* msgs, void* chals,
                                void* state, void* finals, void* scratch, void* stream) {
    int err = (int)cudaErrorInvalidValue;
#define DP_TAIL(D)                                                                                  \
    err = launch_tail<D>(x0, x1, y0, y1, m, meta, L, rnd0, n, fidx, np, c0, c1, msgs, chals, state, \
                         finals, scratch, (cudaStream_t)stream)
    DP_DISPATCH(degree, DP_TAIL)
#undef DP_TAIL
    return err;
}
