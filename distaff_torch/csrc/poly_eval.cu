// K8 poly_eval on the card: the kernel of poly_eval.cuh (design and bound
// there) and the launch of one pass.

#include <cuda_runtime.h>
#include <cstdint>

#include "poly_eval.cuh"

namespace {

using poly_eval::kLogThreads;
using poly_eval::kMaxPoints;
using poly_eval::kThreads;

__global__ void __launch_bounds__(kThreads) poly_eval_kernel(poly_eval::Args a) {
    __shared__ f128::u128 buf[kMaxPoints * kThreads];
    const long long chunk = blockIdx.x, row = blockIdx.y;
    poly_eval::horner(a, chunk, row, threadIdx.x, buf);
    __syncthreads();
    for (int level = 0; level < kLogThreads; ++level) {
        poly_eval::reduce(a, row, threadIdx.x, level, buf);
        __syncthreads();
    }
    poly_eval::store(a, chunk, row, threadIdx.x, buf);
}

}  // namespace

// One pass over `rows` rows of `len` coefficients into (rows, points,
// out_len), out_len = ceil(len / 4096)
extern "C" int distaff_poly_eval(const void* in, void* out, const void* sq, long long len,
                                 long long out_len, long long rows, int points, int row_period,
                                 int sq_len, int sq_off, void* stream) {
    if (len < 1 || out_len != (len + poly_eval::kSpan - 1) / poly_eval::kSpan || rows < 1 ||
        rows > 65535 || points < 1 || points > kMaxPoints || row_period < 1 ||
        sq_off < 0 || sq_off + kLogThreads >= sq_len || out_len > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const poly_eval::Args a{(const uint4*)in, (uint4*)out, (const uint4*)sq, len, out_len,
                            points, row_period, sq_len, sq_off};
    poly_eval_kernel<<<dim3((unsigned)out_len, (unsigned)rows), kThreads, 0,
                       (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
