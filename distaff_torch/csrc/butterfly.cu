// K5 butterfly: one radix-2 NTT stage over n pairs, (a + b, (a - b) * w)
// in the 128-bit field.
//
// Replaces the TPU kernel distaff_tpu/ops/field_pallas.py::_butterfly_kernel
// (launched by butterfly_stage_planes, wrapped by butterfly_stage and driven
// stage by stage by _ntt_pallas_impl / ntt_pallas), which read a, b and w
// as (4, rows, 128) structure-of-arrays limb planes in (256, 128) blocks
// because the TPU's vector unit works on 32-bit lanes.  On this card an
// element is one 16-byte load, so the operands stay in the (n, 4) layout of
// the rest of the port and each thread does one butterfly on field128.cuh.
//
// Bound on this card: bytes.  A butterfly reads 48 bytes and writes 32
// against one add, one sub and one 128-bit multiply (~90 integer
// instructions), below the card's ratio of instructions to bytes.

#include <cuda_runtime.h>
#include <cstdint>

#include "field128.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void butterfly_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                                 const uint4* __restrict__ w, uint4* __restrict__ even,
                                 uint4* __restrict__ odd, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        const f128::u128 x = f128::from_limbs(a[i]), y = f128::from_limbs(b[i]);
        even[i] = f128::to_limbs(f128::add(x, y));
        odd[i] = f128::to_limbs(f128::mul(f128::sub(x, y), f128::from_limbs(w[i])));
    }
}

}  // namespace

// a, b, w, even, odd: n contiguous field elements each
extern "C" int distaff_butterfly(const void* a, const void* b, const void* w, void* even,
                                 void* odd, long long n, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = 132LL * 64;   // grid-stride beyond a few waves
    if (blocks > cap) blocks = cap;
    butterfly_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, (const uint4*)w, (uint4*)even, (uint4*)odd, n);
    return (int)cudaGetLastError();
}
