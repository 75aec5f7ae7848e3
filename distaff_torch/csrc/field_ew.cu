// K2 field_ew: elementwise add, sub, mul and exp_const in the 128-bit field.
//
// Replaces the arithmetic that the TPU side expressed twice: inside both
// Pallas kernels of distaff_tpu/ops/field_pallas.py (_add_limbs, _sub_limbs,
// _mul_limbs) and as the XLA code of distaff_tpu/math/field_jax.py (add,
// sub, mul, exp_const), which every device step of the prover calls.
//
// Bound on this card: add, sub and mul move 48 bytes per element against
// at most ~120 integer instructions, so they are bound by memory traffic;
// exp_const runs a 128-step square-and-multiply chain per element and is
// bound by operations.  One thread per element, operands read as 16-byte
// vectors.  exp_const serves a general constant exponent (the kernel
// bench); the prover's inverses go through K6 (inv_batch.cu), which runs
// one chain a block instead of one an element.
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

__global__ void exp_kernel(const uint4* __restrict__ a, uint4* __restrict__ out,
                           long long n, unsigned long long e_lo, unsigned long long e_hi) {
    const f128::u128 e = ((f128::u128)e_hi << 64) | e_lo;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
        out[i] = f128::to_limbs(f128::pow(f128::from_limbs(a[i]), e));
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

extern "C" int distaff_field_exp(const void* a, void* out, long long n,
                                 unsigned long long e_lo, unsigned long long e_hi, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    exp_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (uint4*)out, n, e_lo, e_hi);
    return (int)cudaGetLastError();
}
