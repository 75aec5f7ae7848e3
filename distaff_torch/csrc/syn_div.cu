// K11 syn_div on the card: the three launches of syn_div.cuh (design and
// bound there) and the call that queues them.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "syn_div.cuh"

namespace {

using syn_div::kLogThreads;
using syn_div::kThreads;

// launch 1: each tile's totals of a_j and f_j b^j
__global__ void __launch_bounds__(kThreads) syn_div_totals_kernel(syn_div::Args g) {
    __shared__ syn_div::ScanBuffer s;
    syn_div::Column c;
    syn_div::load(g, blockIdx.x, threadIdx.x, c, s);
    __syncthreads();
    for (int k = 0; k < kLogThreads; ++k) {
        syn_div::scan_step(s, k, threadIdx.x);
        __syncthreads();
    }
    syn_div::store_totals(g, s, blockIdx.x, threadIdx.x);
}

// launch 2, one block: the totals into the sums of the tiles after each
__global__ void __launch_bounds__(kThreads) syn_div_carries_kernel(syn_div::Args g) {
    __shared__ syn_div::ScanBuffer s;
    syn_div::chunk_sums(g, s, threadIdx.x);
    __syncthreads();
    for (int k = 0; k < kLogThreads; ++k) {
        syn_div::scan_step(s, k, threadIdx.x);
        __syncthreads();
    }
    syn_div::chunk_carries(g, s, threadIdx.x);
}

// launch 3: each tile's scans from its carry, and out
__global__ void __launch_bounds__(kThreads) syn_div_finish_kernel(syn_div::Args g) {
    __shared__ syn_div::ScanBuffer s;
    syn_div::Column c;
    syn_div::load(g, blockIdx.x, threadIdx.x, c, s);
    __syncthreads();
    for (int k = 0; k < kLogThreads; ++k) {
        syn_div::scan_step(s, k, threadIdx.x);
        __syncthreads();
    }
    syn_div::finish(g, c, s, blockIdx.x, threadIdx.x);
}

}  // namespace

// out[0, n) from the rows a, f, t of polys (row r at r row_stride
// elements); the power tables of b and of 1/b (his may be null); neg_e: the
// host's 4 words of -e; totals: scratch of 2 tiles elements
extern "C" int distaff_syn_div(const void* polys, long long row_stride, long long n, long long d,
                               const void* b_lo, const void* b_hi, const void* binv_lo,
                               const void* binv_hi, int log_lo, const uint32_t* neg_e,
                               void* totals, void* out, void* stream) {
    if (n < 1 || d < 1 || d > n || row_stride < n || log_lo < 0 || log_lo > 30)
        return (int)cudaErrorInvalidValue;
    const uint4* p = (const uint4*)polys;
    syn_div::Args g{p, p + row_stride, p + 2 * row_stride, n, d,
                    (const uint4*)b_lo, (const uint4*)b_hi, (const uint4*)binv_lo,
                    (const uint4*)binv_hi, log_lo, {}, (uint4*)totals, (uint4*)out};
    std::memcpy(&g.neg_e, neg_e, sizeof(g.neg_e));
    const long long tiles = syn_div::tiles(g);
    if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    syn_div_totals_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(g);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    syn_div_carries_kernel<<<1, kThreads, 0, s>>>(g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    syn_div_finish_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(g);
    return (int)cudaGetLastError();
}
