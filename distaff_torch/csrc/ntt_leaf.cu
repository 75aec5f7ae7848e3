// K1 ntt_leaf: natural-order NTTs of size n <= 1024 over a batch of leaves.
//
// Replaces the TPU kernel distaff_tpu/ops/field_pallas.py::_leaf_ntt_kernel
// (launched by _leaf_ntt_planes, wrapped by leaf_ntt_bm): all log2(n) Pease
// radix-2 stages of a leaf run in on-chip memory, so each element is read
// from and written to device memory once per transform.  The TPU kernel
// left its output bit-reversed for the wrapper to permute; here the
// bit-reversal is folded into the store.
//
// Bound on this card: operations.  A leaf of n points does (n/2)*log2(n)
// butterflies (one add, one sub, one 128-bit modular multiply each) against
// 32 bytes of device traffic per point.  The design keeps the leaf and its
// twiddles in shared memory (2 x 16 KB ping-pong buffers and 8 KB of
// twiddles at n = 1024) and gives every thread one butterfly per stage;
// a block always holds 1024 points, so small transforms (the deep levels
// of the four-step recursion, n down to 2) pack 1024/n leaves per block.
//
// Stage s multiplies pair i by tw[(i >> s) << s]: the root power series
// with each stride-2^s entry repeated 2^s times, as _stage_twiddle_planes
// builds it.

#include <cuda_runtime.h>
#include <cstdint>

#include "field128.cuh"

namespace {

constexpr int kBlockPoints = 1024;
constexpr int kThreads = kBlockPoints / 2;

__global__ void __launch_bounds__(kThreads)
ntt_leaf_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                const uint4* __restrict__ tw, long long batch, int log_n) {
    __shared__ uint4 buf[2][kBlockPoints];
    __shared__ uint4 stw[kBlockPoints / 2];

    const int n = 1 << log_n;
    const int half = n >> 1;
    const int leaves_per_block = kBlockPoints >> log_n;
    const long long leaf0 = (long long)blockIdx.x * leaves_per_block;
    long long remaining = batch - leaf0;
    const int leaves = remaining < leaves_per_block ? (int)remaining : leaves_per_block;
    const int points = leaves << log_n;
    const long long base = leaf0 << log_n;

    for (int e = threadIdx.x; e < points; e += blockDim.x) buf[0][e] = in[base + e];
    for (int e = threadIdx.x; e < half; e += blockDim.x) stw[e] = tw[e];
    __syncthreads();

    int cur = 0;
    for (int s = 0; s < log_n; ++s) {
        for (int t = threadIdx.x; t < (points >> 1); t += blockDim.x) {
            const int leaf = t >> (log_n - 1);
            const int i = t & (half - 1);
            const int off = leaf << log_n;
            f128::u128 a = f128::from_limbs(buf[cur][off + i]);
            f128::u128 b = f128::from_limbs(buf[cur][off + i + half]);
            f128::u128 w = f128::from_limbs(stw[(i >> s) << s]);
            buf[cur ^ 1][off + 2 * i] = f128::to_limbs(f128::add(a, b));
            buf[cur ^ 1][off + 2 * i + 1] = f128::to_limbs(f128::mul(f128::sub(a, b), w));
        }
        cur ^= 1;
        __syncthreads();
    }

    // Pease output is bit-reversed: point k of the transform sits at rev(k)
    for (int e = threadIdx.x; e < points; e += blockDim.x) {
        const int leaf = e >> log_n;
        const int k = e & (n - 1);
        const int r = (int)(__brev((unsigned)k) >> (32 - log_n));
        out[base + e] = buf[cur][(leaf << log_n) + r];
    }
}

}  // namespace

extern "C" int distaff_ntt_leaf(const void* in, void* out, const void* tw,
                                long long batch, int log_n, void* stream) {
    if (log_n < 1 || log_n > 10 || batch < 0) return (int)cudaErrorInvalidValue;
    if (batch == 0) return (int)cudaSuccess;
    const long long leaves_per_block = kBlockPoints >> log_n;
    const long long blocks = (batch + leaves_per_block - 1) / leaves_per_block;
    ntt_leaf_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)in, (uint4*)out, (const uint4*)tw, batch, log_n);
    return (int)cudaGetLastError();
}

extern "C" const char* distaff_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
