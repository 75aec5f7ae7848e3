// K2 field_ew: elementwise add, sub, mul and exp_const in the 128-bit field.
//
// Replaces the arithmetic that the TPU side expressed twice: inside both
// Pallas kernels of distaff_tpu/ops/field_pallas.py (_add_limbs, _sub_limbs,
// _mul_limbs) and as the XLA code of distaff_tpu/math/field_jax.py (add,
// sub, mul, exp_const), which every device step of the prover calls.
//
// Bound on this card: add, sub and mul move 48 bytes per element against
// at most ~120 integer instructions, so they are bound by memory traffic;
// exp_const is bound by the multiplies it issues, on the FMA pipe.  One
// thread per element, operands read as 16-byte vectors.  exp_const serves
// a general constant exponent (the kernel bench); the prover's inverses go
// through K6 (inv_batch.cu), which runs one chain a block instead of one an
// element.
//
// exp_const runs a schedule that the host builds from the exponent and
// passes in the kernel's parameter (field_kernels.exp_schedule): the same
// short list of steps for every thread, "square k times", "multiply by
// table entry j", "store as entry j", "load entry j", "one", with x in
// entry 0 of a per-thread table.  For e = M - 2 (the Fermat inverse) the
// schedule takes 127 squarings and 12 multiplies from the powers
// x^(2^(2^k) - 1), against square-and-multiply's 127 and 123; any other e
// takes the cheaper of that chain and a sliding window.  Squarings go
// through field128.cuh's sqr_limbs (10 limb products in place of 16).
//
// Operands may be broadcast or strided: the wrapper collapses the output's
// batch dimensions (size-1 dimensions dropped, neighbours that are
// contiguous in both operands merged), and each remaining dimension has its
// own element stride per operand, 0 where the operand is broadcast along
// it.  One instantiation serves every layout: a contiguous operation, one
// with a constant operand and one over a strided slice collapse to one
// dimension and divide nothing; the four-step twiddle table repeated over a
// batch collapses to two.  (Separate contiguous and constant-operand
// instantiations were measured no faster: PERF.md.)

#include <cuda_runtime.h>
#include <cstdint>

#include "field128.cuh"

namespace {

struct Broadcast {
    int inner;          // dimensions inside the outermost one (0..3)
    long long dim[3];   // their sizes, innermost first
    long long sa[3];    // their element strides in a (0 = broadcast)
    long long sb[3];    // and in b
    long long osa, osb; // element strides of the outermost dimension
};

enum Op { kAdd = 0, kSub = 1, kMul = 2 };

constexpr int kThreads = 256;

unsigned grid_for(long long n) {
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = 132LL * 64;   // grid-stride beyond a few waves
    return (unsigned)(blocks < cap ? blocks : cap);
}

template <int OP>
__device__ __forceinline__ uint4 apply(uint4 x, uint4 y) {
    f128::u128 a = f128::from_limbs(x), b = f128::from_limbs(y);
    if (OP == kAdd) return f128::to_limbs(f128::add(a, b));
    if (OP == kSub) return f128::to_limbs(f128::sub(a, b));
    return f128::to_limbs(f128::mul(a, b));
}

template <int OP>
__global__ void binary_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                              uint4* __restrict__ out, long long n, Broadcast bc) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        long long rest = i, ia = 0, ib = 0;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            if (d >= bc.inner) break;
            const long long q = rest / bc.dim[d];
            const long long k = rest - q * bc.dim[d];
            ia += k * bc.sa[d];
            ib += k * bc.sb[d];
            rest = q;
        }
        out[i] = apply<OP>(a[ia + rest * bc.osa], b[ib + rest * bc.osb]);
    }
}

// exp_const's schedule: kExpSteps steps at most, each an operation in its
// high byte and its argument in the low one (field_kernels.exp_schedule)
constexpr int kExpSteps = 256;
constexpr int kExpTable = 16;
enum ExpOp { kExpSqr = 0, kExpMul = 1, kExpStore = 2, kExpLoad = 3, kExpOne = 4 };

struct ExpSchedule {
    int steps;
    uint16_t step[kExpSteps];
};

__global__ void __launch_bounds__(kThreads)
exp_kernel(const uint4* __restrict__ a, uint4* __restrict__ out, long long n,
           const __grid_constant__ ExpSchedule s) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        f128::u128 table[kExpTable];
        f128::u128 acc = f128::from_limbs(a[i]);
        table[0] = acc;
        for (int k = 0; k < s.steps; ++k) {
            const int op = s.step[k] >> 8, arg = s.step[k] & 0xFF;
            if (op == kExpSqr) {
#pragma unroll 1
                for (int j = 0; j < arg; ++j) acc = f128::sqr(acc);
            } else if (op == kExpMul) {
                acc = f128::mul(acc, table[arg]);
            } else if (op == kExpStore) {
                table[arg] = acc;
            } else if (op == kExpLoad) {
                acc = table[arg];
            } else {
                acc = 1;
            }
        }
        out[i] = f128::to_limbs(acc);
    }
}

}  // namespace

// op: 0 add, 1 sub, 2 mul.  The output has n elements over `ndim` (1..4)
// batch dimensions of sizes `dims`, outermost first; `sa` and `sb` are the
// operands' element strides along them (0 where an operand is broadcast).
extern "C" int distaff_field_binary(int op, int ndim, const void* a, const void* b, void* out,
                                    long long n, const long long* dims, const long long* sa,
                                    const long long* sb, void* stream) {
    if (op < kAdd || op > kMul || ndim < 1 || ndim > 4 || n < 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Broadcast bc;
    bc.inner = ndim - 1;
    for (int j = 0; j < bc.inner; ++j) {
        const int d = ndim - 1 - j;
        if (dims[d] < 1) return (int)cudaErrorInvalidValue;
        bc.dim[j] = dims[d];
        bc.sa[j] = sa[d];
        bc.sb[j] = sb[d];
    }
    bc.osa = sa[0];
    bc.osb = sb[0];
    cudaStream_t s = (cudaStream_t)stream;
    const uint4* pa = (const uint4*)a;
    const uint4* pb = (const uint4*)b;
    uint4* po = (uint4*)out;
    const unsigned grid = grid_for(n);
    if (op == kAdd) binary_kernel<kAdd><<<grid, kThreads, 0, s>>>(pa, pb, po, n, bc);
    else if (op == kSub) binary_kernel<kSub><<<grid, kThreads, 0, s>>>(pa, pb, po, n, bc);
    else binary_kernel<kMul><<<grid, kThreads, 0, s>>>(pa, pb, po, n, bc);
    return (int)cudaGetLastError();
}

// out[i] = a[i]^e for i < n, e given by its schedule: `count` steps
extern "C" int distaff_field_exp(const void* a, void* out, long long n, const uint16_t* steps,
                                 int count, void* stream) {
    if (n < 0 || count < 0 || count > kExpSteps) return (int)cudaErrorInvalidValue;
    ExpSchedule s;
    s.steps = count;
    for (int k = 0; k < count; ++k) {
        const int op = steps[k] >> 8, arg = steps[k] & 0xFF;
        if (op > kExpOne || (op == kExpSqr && arg == 0) ||
            ((op == kExpMul || op == kExpStore || op == kExpLoad) && arg >= kExpTable))
            return (int)cudaErrorInvalidValue;
        s.step[k] = steps[k];
    }
    if (n == 0) return (int)cudaSuccess;
    exp_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (uint4*)out, n, s);
    return (int)cudaGetLastError();
}
