// K1 ntt_pass on the card: the kernel of ntt_pass.cuh (design and bound
// there) and its launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "ntt_pass.cuh"

namespace {

__global__ void __launch_bounds__(ntt_pass::kThreads, 3)
ntt_pass_kernel(ntt_pass::Args p) {
    extern __shared__ uint4 tile[];
    const long long block = blockIdx.x;
    ntt_pass::load_tile(p, tile, block, threadIdx.x);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int rem = p.log_m; rem > 0;) {
        const int stages = ntt_pass::round_stages(rem);
        rem -= stages;
        ntt_pass::round_dispatch(p, tile, threadIdx.x, stages, rem);
        __syncthreads();
    }
    ntt_pass::store_tile(p, tile, block, threadIdx.x);
}

}  // namespace

extern "C" int distaff_ntt_pass(const void* in, void* out, const void* tw, const void* lo,
                                const void* hi, long long batch, int log_cols, int log_m,
                                long long in_bs, long long in_cs, long long in_ps,
                                long long n_in, long long out_bs, long long out_cs,
                                long long out_ps, int log_lo, void* stream) {
    if (log_m < 1 || log_m > ntt_pass::kMaxLogM || log_cols < 0 || log_cols > 40 ||
        batch < 0 || log_lo < 0 || log_lo > 40)
        return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ntt_pass::kTilePoints * (int)sizeof(uint4));
    if (attr != cudaSuccess) return (int)attr;
    const ntt_pass::Args p = ntt_pass::make_args(in, out, tw, lo, hi, batch, log_cols, log_m,
                                                 in_bs, in_cs, in_ps, n_in, out_bs, out_cs,
                                                 out_ps, log_lo);
    const long long blocks = ntt_pass::blocks(p);
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    ntt_pass_kernel<<<(unsigned)blocks, ntt_pass::kThreads,
                      ntt_pass::kTilePoints * sizeof(uint4), (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

extern "C" const char* distaff_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
