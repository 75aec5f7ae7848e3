// The BLAKE3 compression function, shared by K3 (blake3_rows.cu) and K9
// (fri_fold.cu, which hashes each folded leaf row where it computes it).
//
// The port's counterpart of distaff_tpu/ops/blake3_jax.py::_compress;
// native/blake3.cpp is the scalar reference.  The 16-word state and the
// message block stay in registers: the message schedule is unrolled so that
// no register array is ever indexed at run time.  A compression is at
// least 680 integer instructions (7 rounds x 8 G x 12, plus 8 output xors).
//
// Compiles as plain C++ too (field128.cuh's qualifiers), so that the CPU
// tests can run K9's leaf digests.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace blake3 {

constexpr uint32_t kChunkStart = 1, kChunkEnd = 2, kParent = 4, kRoot = 8;

F128_FN uint32_t iv(int i) {
    switch (i) {
        case 0: return 0x6A09E667u; case 1: return 0xBB67AE85u;
        case 2: return 0x3C6EF372u; case 3: return 0xA54FF53Au;
        case 4: return 0x510E527Fu; case 5: return 0x9B05688Cu;
        case 6: return 0x1F83D9ABu; default: return 0x5BE0CD19u;
    }
}

F128_FN uint32_t rotr(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
    return __funnelshift_r(x, x, n);
#else
    return (x >> n) | (x << (32 - n));
#endif
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
F128_FN void permute(uint32_t m[16]) {
    uint32_t t[16];
    t[0] = m[2];   t[1] = m[6];   t[2] = m[3];   t[3] = m[10];
    t[4] = m[7];   t[5] = m[0];   t[6] = m[4];   t[7] = m[13];
    t[8] = m[1];   t[9] = m[11];  t[10] = m[12]; t[11] = m[5];
    t[12] = m[9];  t[13] = m[14]; t[14] = m[15]; t[15] = m[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = t[i];
}

// cv <- compress(cv, m, counter, block_len, flags), truncated to 8 words
F128_FN void compress(uint32_t cv[8], uint32_t m[16], uint64_t counter, uint32_t block_len,
                      uint32_t flags) {
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

#undef B3_G

// The digest of one 64-byte message (one chunk of one block: chunk start,
// chunk end and root), as hash_rows_u32 hashes a 64-byte row: cv <- its 8
// words.  m is consumed.
F128_FN void hash_block(uint32_t cv[8], uint32_t m[16]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = iv(i);
    compress(cv, m, 0, 64, kChunkStart | kChunkEnd | kRoot);
}

}  // namespace blake3
