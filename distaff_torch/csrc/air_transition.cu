// K4 air_transition: the combined transition constraint over the whole
// evaluation domain, one thread per row.
//
// Replaces the fused XLA kernel of the JAX package,
// distaff_tpu/stark/constraints/device_eval.py::_transition_kernel, which
// traced the polymorphic AIR over device columns.  Here each thread runs the
// scalar evaluator of air_row.cuh (a port of native/air.cpp) at its row j:
// it reads rows j and (j + 8) mod n of the stride-(ext/8) LDE slice (staged
// in shared memory from the slice's strides), evaluates the decoder and
// stack constraints, folds them with the transcript's coefficient pairs and
// each degree group's adjustment x^incr (a lookup in the domain root's two
// small power tables, one multiply: no series of n values a group), and
// writes one element.  The trace-step rows
// (j % 8 == 0) other than the last step's, whose wrap-around transition is
// legitimately nonzero, add one to `bad` where the result is nonzero.
// On a slot of a mesh (parallel/mesh_stages.transition_sharded) a launch
// takes the rows [first, first + rows) of the domain: its slice holds
// those rows, j is first + its row, and the 8 rows after its last come
// from `halo` (the next slot's first 8, the first slot's at the last);
// without a halo the slice is the whole domain and wraps around.
//
// Bound on this card: operations.  A row does a few hundred 128-bit field
// multiplies (air_kernels.air_ops_per_row counts them from this code)
// against 16 bytes per register read and 16 written.
// With 255 registers a thread, an SM holds 8 warps, too few to hide the
// latency of the multiplies' dependent chains, so the design keeps what a
// row holds at once small: the library is built for one geometry, the
// trace's depths given as -DAIR_CTX, -DAIR_LOOP and -DAIR_STACK
// (ops/air_kernels.air_lib builds one per triple at first use), so every
// index is a compile-time constant; the block's rows are staged in shared
// memory (each next-state row read from device memory once, not twice) and
// the two trace states are read from there where each value is used; each
// constraint is folded into the combination as it is produced, with its
// coefficient position and degree group fixed at compile time; and the
// multiplies are field128.cuh's PTX carry chain.
// Transcript-dependent inputs (coefficients) and the periodic ARK/mask
// tables arrive as device tensors with each launch, the groups' exponents
// as kernel arguments.

#include <cuda_runtime.h>
#include <cstdint>

#include "air_row.cuh"

#if !defined(AIR_CTX) || !defined(AIR_LOOP) || !defined(AIR_STACK)
#error "K4 is built for one geometry: -DAIR_CTX=<ctx depth> -DAIR_LOOP=<loop depth> -DAIR_STACK=<stack depth>"
#endif
static_assert(0 <= AIR_CTX && AIR_CTX <= air::kMaxCtx && 0 <= AIR_LOOP &&
              AIR_LOOP <= air::kMaxLoop && 0 <= AIR_STACK && AIR_STACK <= air::kMaxStack,
              "depths out of range");

namespace {

using Geometry = air::Layout<AIR_CTX, AIR_LOOP, AIR_STACK>;
constexpr int kRegs = 15 + AIR_CTX + AIR_LOOP + AIR_STACK;
constexpr int kThreads = 128;
// a block's rows: its own and the next trace step's 8 beyond them
constexpr int kRows = kThreads + air::kStepRows;
constexpr int kStagedBytes = kRegs * kRows * (int)sizeof(uint4);

// The block stages the registers of rows [j0, j0 + kRows) of the slice in
// shared memory, register-major (thread t reads row t as its current state
// and row t + 8 as its next one, neighbouring threads on neighbouring
// elements), then each thread evaluates its row reading the states there.
// The staging loads are streaming (ld.global.cs, evict first): each line is
// read once, and the slice's lines, a quarter of each used at its row
// stride of 64 bytes, otherwise fill the L2 and evict the registers the
// evaluator spills (about twice K4's time with ordinary loads:
// tools/air_probe.py, PERF.md).
// The launch's rows: [first, first + count) of the n-row domain, the 8
// rows after them in halo ((R, 8) register-major), or the whole domain
// (first 0, count n) wrapping around where halo is null.
struct Shard {
    long long first, count;
    const uint4* halo;
};

__global__ void __launch_bounds__(kThreads)
air_transition_kernel(air::Inputs in, Shard shard, uint4* __restrict__ out,
                      int* __restrict__ bad) {
    extern __shared__ uint4 rows[];
    const long long j0 = (long long)blockIdx.x * kThreads;
    for (int e = threadIdx.x; e < kRegs * kRows; e += kThreads) {
        const int r = e / kRows;
        long long row = j0 + (e - r * kRows);
        if (shard.halo && row >= shard.count) {
            // past the halo: a row no thread reads as its next state
            const long long h = row - shard.count;
            rows[e] = __ldcs(shard.halo + r * air::kStepRows +
                             (h < air::kStepRows ? h : air::kStepRows - 1));
            continue;
        }
        while (row >= shard.count) row -= shard.count;       // the last step wraps around
        rows[e] = __ldcs(in.trace + row * in.row_stride + r * in.reg_stride);
    }
    __syncthreads();
    const long long i = j0 + threadIdx.x;
    if (i >= shard.count) return;
    const long long j = shard.first + i;
    const f128::u128 v = air::eval_row<AIR_CTX, AIR_LOOP, AIR_STACK>(
        in, rows + threadIdx.x, rows + threadIdx.x + air::kStepRows, kRows, j);
    out[i] = f128::to_limbs(v);
    if (v != 0 && j % air::kStepRows == 0 && j != in.n - air::kStepRows) atomicAdd(bad, 1);
}

}  // namespace

// The geometry this library was built for: depths[0..3) = ctx, loop and
// stack depth; degrees[c] = the degree of constraint c for c < the count
// returned (at most air::kMaxCtx + kMaxLoop + kMaxStack + 22).
extern "C" int distaff_air_layout(int* depths, int* degrees) {
    depths[0] = AIR_CTX;
    depths[1] = AIR_LOOP;
    depths[2] = AIR_STACK;
    for (int c = 0; c < Geometry::kCount; c++) degrees[c] = Geometry::degree(c);
    return Geometry::kCount;
}

// trace: the (R, count) slice of the rows [first, first + count) of the
// n-row domain, element strides reg_stride and row_stride, and halo the (R,
// 8) rows after them (contiguous), or null where the slice is the whole
// domain (first 0, count n); the tables as described in air_row.cuh::
// Inputs, incr with one exponent per degree group (groups of them, < n, n
// a power of two), x_hi may be null; out: (count, 4) limbs; bad: one int32
// counter, added to.
extern "C" int distaff_air_transition(
    const void* trace, long long n, long long reg_stride, long long row_stride,
    const void* dec_ark, const void* masks, const void* stk_ark, int cycle, const void* mds,
    const void* cc, const long long* incr, int groups, const void* x_lo, const void* x_hi,
    int log_lo, void* out, void* bad, long long first, long long count, const void* halo,
    void* stream) {
    if (n < air::kStepRows || (n & (n - 1)) || cycle < 1 || groups != Geometry::kGroups ||
        log_lo < 0 || log_lo > 30 || first < 0 || count < 1 || first + count > n ||
        (!halo && (first != 0 || count != n)))
        return (int)cudaErrorInvalidValue;
    const Shard shard{first, count, (const uint4*)halo};
    air::Inputs in;
    in.trace = (const uint4*)trace;
    in.n = n;
    in.reg_stride = reg_stride;
    in.row_stride = row_stride;
    in.dec_ark = (const uint4*)dec_ark;
    in.masks = (const uint4*)masks;
    in.stk_ark = (const uint4*)stk_ark;
    in.cycle = cycle;
    in.mds = (const uint4*)mds;
    in.cc = (const uint4*)cc;
    for (int g = 0; g < air::kMaxGroups; g++) in.incr[g] = g < groups ? incr[g] : 0;
    in.x_lo = (const uint4*)x_lo;
    in.x_hi = (const uint4*)x_hi;
    in.log_lo = log_lo;
    if (kStagedBytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            air_transition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStagedBytes);
        if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = (count + kThreads - 1) / kThreads;
    air_transition_kernel<<<(unsigned)blocks, kThreads, kStagedBytes, (cudaStream_t)stream>>>(
        in, shard, (uint4*)out, (int*)bad);
    return (int)cudaGetLastError();
}
