// K9 fri_fold on the card: the kernel of fri_fold.cuh (design and bound
// there) and its launch.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "fri_fold.cuh"

namespace {

using fri_fold::kThreads;

__global__ void __launch_bounds__(kThreads, 4) fri_fold_kernel(fri_fold::Args a) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i < a.q) fri_fold::fold(a, i);
}

}  // namespace

// out[i] for i < q from the column of 4q points; constants: the host's 16
// words of special_x, special_x^2, I special_x and 1/4; hi may be null
extern "C" int distaff_fri_fold(const void* column, long long q, const void* lo, const void* hi,
                                int log_lo, long long stride, const uint32_t* constants,
                                void* out, void* stream) {
    if (q < 1 || stride < 1 || log_lo < 0 || log_lo > 30)
        return (int)cudaErrorInvalidValue;
    fri_fold::Args a{(const uint4*)column, q, (const uint4*)lo, (const uint4*)hi, log_lo,
                     stride, {}, (uint4*)out};
    std::memcpy(&a.k, constants, sizeof(a.k));
    const long long blocks = fri_fold::blocks(a);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    fri_fold_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
