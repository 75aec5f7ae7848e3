// K14 trace_absorb on the card: the kernel of trace_absorb.cuh (design and
// bound there) and one launch of it.

#include <cuda_runtime.h>
#include <cstdint>

#include "trace_absorb.cuh"

namespace {

__global__ void __launch_bounds__(trace_absorb::kThreads)
    trace_absorb_kernel(const __grid_constant__ trace_absorb::Args a) {
    const long long d = (long long)blockIdx.x * trace_absorb::kThreads + threadIdx.x;
    if (d < a.rows) trace_absorb::row(a, d);
}

}  // namespace

// One block of every row: n_regs (1-4) registers at regs (strides in 16-byte
// units), the (rows, 8) chaining values cv updated in place; chunk0 null or
// chunk 0's values (the launch then writes the parent node); slice null or
// the group's slice rows.  flags, block_len and counter as BLAKE3 takes them.
extern "C" int distaff_trace_absorb(const void* regs, long long reg_stride, int n_regs,
                                    long long rows, void* cv, const void* chunk0, void* slice,
                                    long long slice_stride, int slice_shift, unsigned flags,
                                    unsigned block_len, unsigned long long counter,
                                    void* stream) {
    if (n_regs < 1 || n_regs > trace_absorb::kBlockRegisters || rows < 0 || reg_stride < rows ||
        block_len < 1 || block_len > 64 || slice_shift < 0 || slice_shift > 30)
        return (int)cudaErrorInvalidValue;
    const trace_absorb::Args a{(const uint4*)regs, reg_stride, n_regs, rows, (uint4*)cv,
                               (const uint4*)chunk0, (uint4*)slice, slice_stride, slice_shift,
                               flags, block_len, counter};
    const long long blocks = trace_absorb::blocks(a);
    if (blocks == 0) return (int)cudaSuccess;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    trace_absorb_kernel<<<(unsigned)blocks, trace_absorb::kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
