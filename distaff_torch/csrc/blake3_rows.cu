// K3 blake3_rows: BLAKE3 of N equal-length rows, one digest per row.
//
// Replaces the XLA BLAKE3 of distaff_tpu/ops/blake3_jax.py (_compress,
// hash_rows_u32, parent_root): the leaves of the proof's trees - the trace
// rows and the first FRI layer's rows - are hashed here (K9 hashes the
// folded layers' rows, K13 every internal Merkle node).
// native/blake3.cpp is the scalar reference.
//
// Bound on this card: a 64-byte compression is at least 680 integer
// instructions (7 rounds x 8 G x 12, plus 8 output xors); at the trace's
// 320-byte rows that takes about as long as moving the bytes.  One thread
// per row keeps the 16-word state and the message block in registers
// (blake3.cuh, which K9 shares for the leaf digests of the FRI layers it
// folds, and K13 for the nodes).
//
// A row of up to 2048 bytes is one or two 1024-byte chunks, hashed as
// hash_rows_u32 does: chunk counter per chunk, CHUNK_START/CHUNK_END
// flags, ROOT on a single chunk, else a PARENT|ROOT node over the two
// chunk chaining values.  The row is made of 16-byte registers: register j
// of row i starts at word i*row_stride + j*reg_stride, so a trace LDE laid
// out (registers, rows, 4 limbs) is hashed in place without a transpose.

#include <cuda_runtime.h>
#include <cstdint>

#include "blake3.cuh"

namespace {

using blake3::compress;
using blake3::iv;
using blake3::kChunkEnd;
using blake3::kChunkStart;
using blake3::kParent;
using blake3::kRoot;

__global__ void blake3_rows_kernel(const uint4* __restrict__ src, uint32_t* __restrict__ out,
                                   long long n_rows, int n_regs, long long row_stride,
                                   long long reg_stride) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n_rows) return;
    const uint4* base = src + row * row_stride;

    const int byte_len = n_regs * 16;
    const int n_blocks = (byte_len + 63) / 64;
    const int n_chunks = (n_blocks + 15) / 16;

    uint32_t chunk0[8];
    uint32_t cv[8];
    for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = iv(i);
        const int first = c * 16;
        const int last = min((c + 1) * 16, n_blocks) - 1;
        for (int blk = first; blk <= last; ++blk) {
            uint32_t m[16];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int reg = blk * 4 + j;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (reg < n_regs) v = base[reg * reg_stride];
                m[4 * j] = v.x;
                m[4 * j + 1] = v.y;
                m[4 * j + 2] = v.z;
                m[4 * j + 3] = v.w;
            }
            uint32_t flags = 0;
            if (blk == first) flags |= kChunkStart;
            if (blk == last) {
                flags |= kChunkEnd;
                if (n_chunks == 1) flags |= kRoot;
            }
            const uint32_t blen = blk < n_blocks - 1 ? 64u : (uint32_t)(byte_len - 64 * (n_blocks - 1));
            compress(cv, m, (uint64_t)c, blen, flags);
        }
        if (c == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i) chunk0[i] = cv[i];
        }
    }
    if (n_chunks == 2) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            m[i] = chunk0[i];
            m[8 + i] = cv[i];
            cv[i] = iv(i);
        }
        compress(cv, m, 0, 64, kParent | kRoot);
    }
    uint4* dst = reinterpret_cast<uint4*>(out + row * 8);
    dst[0] = make_uint4(cv[0], cv[1], cv[2], cv[3]);
    dst[1] = make_uint4(cv[4], cv[5], cv[6], cv[7]);
}

}  // namespace

// src: rows of n_regs 16-byte registers (1 <= n_regs <= 128); strides in
// 16-byte units.  out: (n_rows, 8) uint32 digests, contiguous.
extern "C" int distaff_blake3_rows(const void* src, void* out, long long n_rows, int n_regs,
                                   long long row_stride, long long reg_stride, void* stream) {
    if (n_regs < 1 || n_regs > 128 || n_rows < 0) return (int)cudaErrorInvalidValue;
    if (n_rows == 0) return (int)cudaSuccess;
    constexpr int kThreads = 128;
    const long long blocks = (n_rows + kThreads - 1) / kThreads;
    blake3_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)src, (uint32_t*)out, n_rows, n_regs, row_stride, reg_stride);
    return (int)cudaGetLastError();
}
