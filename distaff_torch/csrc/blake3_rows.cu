// K3 blake3_rows: BLAKE3 of N equal-length rows, one digest per row.
//
// Replaces the XLA BLAKE3 of distaff_tpu/ops/blake3_jax.py (_compress,
// hash_rows_u32, parent_root) and the level hashing of
// distaff_tpu/crypto/merkle_dev.py (_build_flat_nodes): every commitment of
// the proof - trace rows, constraint evaluations, FRI layer rows and every
// internal Merkle level - is hashed here.  native/blake3.cpp is the scalar
// reference.
//
// Bound on this card: a 64-byte compression is at least 680 integer
// instructions (7 rounds x 8 G x 12, plus 8 output xors); at the trace's
// 320-byte rows that takes about as long as moving the bytes, and a parent
// level is bound by its bytes.  One thread per row keeps the
// 16-word state and the message block in registers; the message schedule
// is unrolled so that no register array is ever indexed at run time.
//
// A row of up to 2048 bytes is one or two 1024-byte chunks, hashed as
// hash_rows_u32 does: chunk counter per chunk, CHUNK_START/CHUNK_END
// flags, ROOT on a single chunk, else a PARENT|ROOT node over the two
// chunk chaining values.  The row is made of 16-byte registers: register j
// of row i starts at word i*row_stride + j*reg_stride, so a trace LDE laid
// out (registers, rows, 4 limbs) is hashed in place without a transpose.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t kChunkStart = 1, kChunkEnd = 2, kParent = 4, kRoot = 8;

__device__ __forceinline__ uint32_t iv(int i) {
    switch (i) {
        case 0: return 0x6A09E667u; case 1: return 0xBB67AE85u;
        case 2: return 0x3C6EF372u; case 3: return 0xA54FF53Au;
        case 4: return 0x510E527Fu; case 5: return 0x9B05688Cu;
        case 6: return 0x1F83D9ABu; default: return 0x5BE0CD19u;
    }
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
    return __funnelshift_r(x, x, n);
}

#define B3_G(a, b, c, d, mx, my)          \
    do {                                  \
        s[a] = s[a] + s[b] + (mx);        \
        s[d] = rotr(s[d] ^ s[a], 16);     \
        s[c] = s[c] + s[d];               \
        s[b] = rotr(s[b] ^ s[c], 12);     \
        s[a] = s[a] + s[b] + (my);        \
        s[d] = rotr(s[d] ^ s[a], 8);      \
        s[c] = s[c] + s[d];               \
        s[b] = rotr(s[b] ^ s[c], 7);      \
    } while (0)

// the BLAKE3 message permutation (2,6,3,10,7,0,4,13,1,11,12,5,9,14,15,8)
__device__ __forceinline__ void permute(uint32_t m[16]) {
    uint32_t t[16];
    t[0] = m[2];   t[1] = m[6];   t[2] = m[3];   t[3] = m[10];
    t[4] = m[7];   t[5] = m[0];   t[6] = m[4];   t[7] = m[13];
    t[8] = m[1];   t[9] = m[11];  t[10] = m[12]; t[11] = m[5];
    t[12] = m[9];  t[13] = m[14]; t[14] = m[15]; t[15] = m[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = t[i];
}

// cv <- compress(cv, m, counter, block_len, flags), truncated to 8 words
__device__ __forceinline__ void compress(uint32_t cv[8], uint32_t m[16], uint64_t counter,
                                         uint32_t block_len, uint32_t flags) {
    uint32_t s[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = cv[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[8 + i] = iv(i);
    s[12] = (uint32_t)counter;
    s[13] = (uint32_t)(counter >> 32);
    s[14] = block_len;
    s[15] = flags;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
        B3_G(0, 4, 8, 12, m[0], m[1]);
        B3_G(1, 5, 9, 13, m[2], m[3]);
        B3_G(2, 6, 10, 14, m[4], m[5]);
        B3_G(3, 7, 11, 15, m[6], m[7]);
        B3_G(0, 5, 10, 15, m[8], m[9]);
        B3_G(1, 6, 11, 12, m[10], m[11]);
        B3_G(2, 7, 8, 13, m[12], m[13]);
        B3_G(3, 4, 9, 14, m[14], m[15]);
        if (r < 6) permute(m);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = s[i] ^ s[i + 8];
}

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
