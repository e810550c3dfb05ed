// Throughput of the 32-bit integer multiplies that a Goldilocks product
// lowers to on sm_90a, one kernel per PTX instruction:
//   mad.wide.u32  (SASS IMAD.WIDE.U32: 32x32 -> 64-bit product + 64-bit addend)
//   mad.lo.u32    (SASS IMAD: the low 32 bits)
//   mad.hi.u32    (SASS IMAD.HI.U32: the high 32 bits)
// Each multiply takes the previous result of its chain as an operand, so
// the compiler can neither hoist a product out of the loop nor turn it into
// an addition; each thread runs ACC independent chains, so issue, not
// latency, limits the rate once a few warps share a scheduler. Thread 0 of
// block 0 records the SM clock and the global timer at its start and end,
// from which the caller reads the clock the SMs ran at. Built and timed by
// scripts/profile_torch_slice.py (part `kernel`).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ACC = 8;     // independent chains a thread
constexpr int UNROLL = 8;  // loop iterations unrolled: ACC * UNROLL multiplies a pass

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

#define RATE_KERNEL(NAME, ACC_T, PTX, CONSTRAINT)                                 \
    __global__ void __launch_bounds__(256, 4)                                     \
    NAME(const uint32_t* in, unsigned long long* out, long long* clocks, int passes) { \
        const uint32_t a = in[0] + threadIdx.x, b = in[1];                        \
        ACC_T acc[ACC];                                                           \
        for (int i = 0; i < ACC; ++i) acc[i] = a + i;                             \
        const bool timer = blockIdx.x == 0 && threadIdx.x == 0;                   \
        if (timer) { clocks[0] = clock64(); clocks[1] = global_ns(); }            \
        for (int p = 0; p < passes; ++p) {                                        \
            _Pragma("unroll") for (int u = 0; u < UNROLL; ++u) {                  \
                _Pragma("unroll") for (int i = 0; i < ACC; ++i)                   \
                    asm volatile(PTX : "+" CONSTRAINT(acc[i]) : "r"(b));          \
            }                                                                     \
        }                                                                         \
        if (timer) { clocks[2] = clock64(); clocks[3] = global_ns(); }            \
        unsigned long long s = 0;                                                 \
        for (int i = 0; i < ACC; ++i) s ^= acc[i];                                \
        out[blockIdx.x * blockDim.x + threadIdx.x] = s;                           \
    }

// acc = lo32(acc) * b + acc (64-bit), acc = acc * b + acc, acc = hi32(acc * b) + acc
RATE_KERNEL(mad_wide_u32_kernel, unsigned long long,
            "{ .reg .u32 t; cvt.u32.u64 t, %0; mad.wide.u32 %0, t, %1, %0; }", "l")
RATE_KERNEL(mad_lo_u32_kernel, uint32_t, "mad.lo.u32 %0, %0, %1, %0;", "r")
RATE_KERNEL(mad_hi_u32_kernel, uint32_t, "mad.hi.u32 %0, %0, %1, %0;", "r")

}  // namespace

extern "C" {

// Multiplies one launch issues: blocks x threads x passes x this.
int dp_rate_muls_per_pass() { return ACC * UNROLL; }

// op 0 = mad.wide.u32, 1 = mad.lo.u32, 2 = mad.hi.u32. `in` holds two u32
// operands, `out` one u64 a thread, `clocks` four i64 (clock and global
// timer ns at start, then at end). Returns the cudaError_t of the launch.
int dp_rate_launch(int op, const void* in, void* out, void* clocks, int blocks, int threads,
                   int passes, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto i = static_cast<const uint32_t*>(in);
    auto o = static_cast<unsigned long long*>(out);
    auto c = static_cast<long long*>(clocks);
    if (op == 0) mad_wide_u32_kernel<<<blocks, threads, 0, s>>>(i, o, c, passes);
    else if (op == 1) mad_lo_u32_kernel<<<blocks, threads, 0, s>>>(i, o, c, passes);
    else if (op == 2) mad_hi_u32_kernel<<<blocks, threads, 0, s>>>(i, o, c, passes);
    else return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
