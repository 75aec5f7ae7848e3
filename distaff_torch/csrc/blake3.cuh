// The BLAKE3 compression function, shared by K3 (blake3_rows.cu), K9
// (fri_fold.cu, which hashes each folded leaf row where it computes it), K13
// (merkle_tree.cu, a node a compression) and K14 (trace_absorb.cu).
//
// The port's counterpart of distaff_tpu/ops/blake3_jax.py::_compress;
// native/blake3.cpp is the scalar reference.  The 16-word state and the
// message block stay in registers: the message schedule is unrolled so that
// no register array is ever indexed at run time.  A compression is at
// least 680 integer instructions (7 rounds x 8 G x 12, plus 8 output xors).
//
// The two integer pipes.  An H100 SM issues 32-bit adds, logic, shifts and
// byte permutes (IADD3, LOP3, SHF, PRMT) to its integer-only pipe, 64 lanes
// a cycle, and IMAD to the FMA pipe's other 64.  A G step is 12 such
// instructions (2 three-input adds, 2 adds, 4 xors, 4 rotates), and the
// compiler issues about a fifth of the adds as IMAD: in K13's build 590 of
// 713 integer instructions went to the integer-only pipe, which bounded
// the compression.  Its additions are a policy:
// - AluAdds: x + y, as the compiler emits it;
// - FmaAdds: y * one + x, issued as IMAD on the FMA pipe: `one` is 1 read
//   from constant memory, which the compiler cannot prove to be 1, so it
//   keeps the multiply-add (a literal 1 folds back into IADD3).  A
//   three-input add is two of them.  The integer-only pipe keeps the xors
//   and rotates: 483 of K13's 818.
// A compression whose chaining value and counter are constants (hash_block:
// the IV, counter 0, a 64-byte block, flags start | end | root) runs its
// first round's column step on plain adds, so that the compiler folds the
// constants (IV words added to IV words, xors with a zero counter).  The
// diagonal steps take a policy of their own, so that a variant can move
// part of their work alone (tools/air_probe.py k13).

// Compiles as plain C++ too (field128.cuh's qualifiers; `one` is then the
// literal 1), so that the CPU tests can run the compressions of K9's leaf
// digests and of K13's nodes.

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

// the constant 1 of FmaAdds, in constant memory (see above)
#ifdef __CUDACC__
static __constant__ uint32_t kOne = 1;
#endif

F128_FN uint32_t one() {
#ifdef __CUDA_ARCH__
    return kOne;
#else
    return 1;
#endif
}

struct AluAdds {
    F128_FN uint32_t operator()(uint32_t x, uint32_t y) const { return x + y; }
    F128_FN uint32_t operator()(uint32_t x, uint32_t y, uint32_t z) const { return x + y + z; }
    template <int n>
    F128_FN uint32_t rot(uint32_t x) const { return rotr(x, n); }
};

struct FmaAdds {
    uint32_t one;
    F128_FN uint32_t operator()(uint32_t x, uint32_t y) const {
#ifdef __CUDA_ARCH__
        uint32_t r;
        asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(y), "r"(one), "r"(x));
        return r;
#else
        return y * one + x;
#endif
    }
    F128_FN uint32_t operator()(uint32_t x, uint32_t y, uint32_t z) const {
        return (*this)((*this)(x, y), z);
    }
    // the rotates stay on the integer-only pipe: moved to the FMA pipe (an
    // IMAD.WIDE by 2^(32 - n) and an IMAD of its halves) they were slower,
    // all of them or those of the diagonal steps (tools/air_probe.py k13)
    template <int n>
    F128_FN uint32_t rot(uint32_t x) const { return rotr(x, n); }
};

#define B3_G(add, a, b, c, d, mx, my)                    \
    do {                                                 \
        s[a] = add(s[a], s[b], (mx));                    \
        s[d] = add.template rot<16>(s[d] ^ s[a]);        \
        s[c] = add(s[c], s[d]);                          \
        s[b] = add.template rot<12>(s[b] ^ s[c]);        \
        s[a] = add(s[a], s[b], (my));                    \
        s[d] = add.template rot<8>(s[d] ^ s[a]);         \
        s[c] = add(s[c], s[d]);                          \
        s[b] = add.template rot<7>(s[b] ^ s[c]);         \
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

// cv <- compress(cv, m, counter, block_len, flags), truncated to 8 words:
// the first round's column step adds with `first`, the other column steps
// with `column` and the diagonal steps with `diagonal`
template <class First, class Column, class Diagonal>
F128_FN void compress(uint32_t cv[8], uint32_t m[16], uint64_t counter, uint32_t block_len,
                      uint32_t flags, const First& first, const Column& column,
                      const Diagonal& diagonal) {
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
        if (r == 0) {
            B3_G(first, 0, 4, 8, 12, m[0], m[1]);
            B3_G(first, 1, 5, 9, 13, m[2], m[3]);
            B3_G(first, 2, 6, 10, 14, m[4], m[5]);
            B3_G(first, 3, 7, 11, 15, m[6], m[7]);
        } else {
            B3_G(column, 0, 4, 8, 12, m[0], m[1]);
            B3_G(column, 1, 5, 9, 13, m[2], m[3]);
            B3_G(column, 2, 6, 10, 14, m[4], m[5]);
            B3_G(column, 3, 7, 11, 15, m[6], m[7]);
        }
        B3_G(diagonal, 0, 5, 10, 15, m[8], m[9]);
        B3_G(diagonal, 1, 6, 11, 12, m[10], m[11]);
        B3_G(diagonal, 2, 7, 8, 13, m[12], m[13]);
        B3_G(diagonal, 3, 4, 9, 14, m[14], m[15]);
        if (r < 6) permute(m);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = s[i] ^ s[i + 8];
}

#undef B3_G

// The compression of K3, K9 and K14: its adds on the FMA pipe (FmaAdds),
// which made each of them faster on the H100 than the compiler's adds
// (tools/air_probe.py b3).
F128_FN void compress(uint32_t cv[8], uint32_t m[16], uint64_t counter, uint32_t block_len,
                      uint32_t flags) {
    const FmaAdds adds{one()};
    compress(cv, m, counter, block_len, flags, adds, adds, adds);
}

// The digest of one 64-byte message (one chunk of one block: chunk start,
// chunk end and root), as hash_rows_u32 hashes a 64-byte row: cv <- its 8
// words.  m is consumed.  Its chaining value and counter are constants: the
// first round's column step adds on plain adds, which fold them.
template <class Column, class Diagonal>
F128_FN void hash_block(uint32_t cv[8], uint32_t m[16], const Column& column,
                        const Diagonal& diagonal) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = iv(i);
    compress(cv, m, 0, 64, kChunkStart | kChunkEnd | kRoot, AluAdds{}, column, diagonal);
}

F128_FN void hash_block(uint32_t cv[8], uint32_t m[16]) {
    const FmaAdds adds{one()};
    hash_block(cv, m, adds, adds);
}

}  // namespace blake3
