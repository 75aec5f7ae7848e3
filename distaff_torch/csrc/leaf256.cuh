// K16 leaf256: the 256-point leaf NTT as two stages of byte-limb matrix
// products on the int8 tensor cores, a tile of 8 leaves a block in one
// launch.
//
// Replaces the JAX package's distaff_tpu/ops/mxu_ntt.py::_leaf256_impl
// (with _matrices and _reduce_digits), which ran the same products as bf16
// matmuls on the TPU's matrix unit with f32 sums; here they are mma.sync
// u8 x u8 products with s32 sums, exact alike (every digit sum is at most
// 16 * 16 * 255^2 < 2^24).  With n = i1 + 16 i2 and k = k2 + 16 k1
// (ops/mxu_ntt.py):
//   stage A   A[b, i1, k2] = sum_i2 W[k2][i2] x[b, i1 + 16 i2]
//   stage B   X[b, 16 k1 + k2] = sum_i1 C[k2][k1][i1] A[b, i1, k2]
// Each is "apply a 16 x 16 field matrix m to vectors v": stage A applies W
// to the 16 vectors (b, i1) of a leaf (v_j = x[b, i1 + 16 j]), stage B
// applies C[k2] to the leaves (v_j = A[b, j, k2]).
//
// The data is expanded, not the matrix.  With m8[p] and x8[q] the byte
// planes of m and of the vectors, digit d (weight 2^(8d), d = 0..30) of
// output element (i, v) is
//   D_d[i][v] = sum_p sum_j m8[p][i][j] x8[d - p][j][v],
// one product over K = 256 bytes (p, j): A is the matrix's 16 byte planes
// side by side (16 rows i by 256 bytes), B the window of the data's planes
// d, d - 1, ..., d - 15 (0 outside 0..15).  So:
// - A is fixed: a matrix is 32 registers of m16n8k32 A fragments (k-step
//   kk: planes 2kk and 2kk + 1), laid out in fragment order by
//   ops/mxu_ntt.kernel_entries (17 matrices, 4 KB each) and loaded with
//   eight coalesced 16-byte loads a lane (L1-resident: every block reads
//   the same 68 KB), W a tile of vectors and each C[k2] once.  Nothing is
//   built from bytes in the product loop.
// - B is a register choice: a lane's word t of plane q of vector g is
//   bytes q of elements j = 4t..4t+3, P[q] (planes: eight byte_perms an
//   element, in registers); the window of digit d at k-step kk is (P[d -
//   2kk], P[d - 2kk - 1]).  A lane's 16 words serve all 31 digits.
// - k-steps that meet no plane are skipped (live): 136 of the 248 (digit,
//   k-step) pairs an application to eight vectors.  An odd digit's window
//   (P[2m + 1], P[2m]) is a register pair: one m16n8k32.  An even digit's,
//   (P[2m], P[2m - 1]), straddles two of them: two m16n8k16, one a plane
//   (the quad's halves are pairs too), and none for a plane outside 0..15.
//   A leaf: 256 m16n8k32 and 512 m16n8k16 (768 IMMA; dense over the
//   expanded matrix: 1,024 m16n8k32), with no register moved.  The even
//   windows paired in registers of their own would make it 544 m16n8k32,
//   but do not fit 128 registers: they spill at 16 warps an SM.  kstep is
//   the dispatch, on the card (leaf256.cu) and in the CPU tests alike.
// - Each lane reduces its own elements.  mma's accumulator puts rows g,
//   g + 8 and columns 2t, 2t + 1 in lane (g, t), so over the 31 digits a
//   lane holds every digit of its four elements.  Digits are taken in
//   groups of four (a 32-bit limb: four mma chains interleaved): two digits
//   make a 16-bit column, the column pair and the previous limb's carry the
//   limb (take: a multiply-add pair on the FMA pipe).  Limbs 0-3 wait in
//   the lane's own 16-byte units of shared memory (four stores and loads a
//   tile: without them the kernel spills at 128 registers); no digit
//   leaves its lane.  fold takes the nine limbs twice through R = 2^128 mod
//   M = 0x2D00 2^32 - 1 (multiplies by 0x2D00 on the FMA pipe, adds and
//   borrows on the integer-only pipe), then below (stage A: under 2^128)
//   or canonical (stage B: under M).
//
// A block: 128 threads, 8 leaves, 43,136 B of shared memory and at most
// 128 registers a thread, so four blocks (16 warps) an SM.  Stage A: warp w
// takes four n8 tiles (leaf, h): vectors i1 = 8h..8h+7, lane (g, t)
// reading elements x[b, 8h + g + 16 (4t + e)] from device memory, and
// stores its four elements A[b, i1, k2] into mid.  A barrier.  Stage B:
// warp w takes k2 = 4w..4w+3, each C[k2] applied to the tile's eight
// leaves; lane (g, t) reads A[g, 4t + e, k2] (e = 0..3) and writes X[b, 16
// k1 + k2] into the slots it read from: a (leaves, k2) slab of mid is read
// and written by one warp alone, so only __syncwarp orders them.  A
// barrier, then the block writes its leaves out, coalesced.  mid's slot of
// (leaf, column, k2) is leaf 273 + k2 17 + column ^ 2 (column >> 3) in
// 16-byte units: stage A's stores, stage B's loads and stores and the final
// reads are free of bank conflicts (each quarter warp's eight units on
// eight distinct 16-byte bank groups).  A ragged last tile loads zeros and
// stores only its leaves.
//
// Bound on the H100 (ops/mxu_ntt.leaf256_work): per leaf 8 KB of device
// memory (2.45 us per 1,000 leaves at 3.35 TB/s; the 68 KB of fragments
// are read once from device memory), against the fewest byte products the
// function needs, 16 x 16 x 256 multiply-adds an application, 32
// applications a leaf (2.12 us per 1,000 leaves at 1,979 TOPS), and 512
// element reductions.  The bytes bound it.  mma.sync reaches about two
// thirds of that int8 rate with m16n8k32 and under half with m16n8k16
// (tools/air_probe.py k16), and its issue slots are shared with the
// reductions' integer work; chip_smoke.py prints the SASS mix and per-pipe
// floors and times K16 beside K1.
//
// This header compiles as plain C++ too: the CPU tests run a block's
// stages through tests/torch_mma_host.h's emulation of mma on the
// fragments, windows and slots below, and the PTX of take and fold
// through an interpreter of its instructions.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace leaf256 {

constexpr int kPoints = 256;                   // a leaf
constexpr int kSide = 16;                      // 256 = 16 x 16
constexpr int kTile = 8;                       // leaves a block: stage B's n8 tile
constexpr int kWarps = kTile / 2;              // a warp per two leaves
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 16 / kWarps;        // blocks an SM for 16 warps
constexpr int kATiles = 2 * kTile / kWarps;    // stage A's n8 tiles a warp: 4
constexpr int kBTiles = kSide / kWarps;        // stage B's n8 tiles (k2) a warp: 4
constexpr int kKSteps = kSide / 2;             // 32-byte k-steps: planes 2kk and 2kk + 1
constexpr int kLimbs = 8;                      // the 31 digits' 32-bit limbs below 2^256
// mid: a (leaf, k2) row of 16 units and a pad, a leaf of 16 rows and a pad
constexpr int kRowUnits = kSide + 1;
constexpr int kLeafUnits = kSide * kRowUnits + 1;
// parked limbs after mid: limbs 0-3 of a lane's four elements, a 16-byte
// unit a limb and lane, 128 units a warp
constexpr int kParkUnits = 4 * 32 * kWarps;
constexpr int kSharedBytes = 16 * (kTile * kLeafUnits + kParkUnits);   // 43,136

// Does k-step kk meet a plane of the data for digit d?  Its window's
// planes are d - 2kk and d - 2kk - 1.
F128_FN constexpr bool live(int d, int kk) { return d - 2 * kk >= 0 && d - 2 * kk <= kSide; }

// The data plane of B's word `half` (b0: plane 2kk of the matrix, b1: 2kk
// + 1) for digit d at k-step kk, or -1 for a zero word.
F128_FN constexpr int window(int d, int kk, int half) {
    return d - 2 * kk - half >= 0 && d - 2 * kk - half < kSide ? d - 2 * kk - half : -1;
}

// word q of a lane's planes, 0 outside 0..15
F128_FN uint32_t plane(const uint32_t (&p)[kSide], int q) { return q < 0 ? 0u : p[q]; }

// Half h of digit d's k-step kk, a live one, for a lane whose quad of
// the k-step's A fragment is a and whose planes are p: the window
// (P[d - 2kk], P[d - 2kk - 1]) against planes 2kk and 2kk + 1 of the
// matrix.  An odd digit's window is a register pair, (P[2m + 1], P[2m]):
// one m16n8k32 in half 0, op.k32(a, b0, b1).  An even digit's, (P[2m],
// P[2m - 1]), straddles two of those pairs, so its k-step is its two
// planes' m16n8k16, op.k16(a0, a1, b0): plane 2kk + h of the matrix is
// (a[2h], a[2h + 1]), half of the quad and itself an aligned pair, and none
// is issued for a data plane outside 0..15.  The same sum, and no register
// moved to pair them.
template <class Op>
F128_FN void kstep(Op& op, const uint32_t (&a)[4], const uint32_t (&p)[kSide], int d, int kk,
                   int h) {
    if (d % 2 == 1) {
        if (h == 0) op.k32(a, plane(p, window(d, kk, 0)), plane(p, window(d, kk, 1)));
    } else if (window(d, kk, h) >= 0) {
        op.k16(a[2 * h], a[2 * h + 1], p[window(d, kk, h)]);
    }
}

// A matrix's A fragment of k-step kk for a lane: its 16-byte unit in
// kernel_entries' (17, 8, 32, 4) words
F128_FN int fragment_unit(int m, int kk, int lane) { return (m * kKSteps + kk) * 32 + lane; }

// mid's slot of (leaf, column, k2), in 16-byte units (see the header)
F128_FN int slot(int leaf, int column, int k2) {
    return leaf * kLeafUnits + k2 * kRowUnits + (column ^ ((column >> 3) << 1));
}

// accumulator i of a lane: its row (the matrix's row) and column (vector)
F128_FN int acc_row(int lane, int i) { return (lane >> 2) + 8 * (i >> 1); }
F128_FN int acc_column(int lane, int i) { return 2 * (lane & 3) + (i & 1); }

// Stage A: n8 tile r of a warp, its leaf and half h (vectors i1 = 8h..8h+7)
F128_FN int a_leaf(int warp, int r) { return (warp + kWarps * r) >> 1; }
F128_FN int a_half(int warp, int r) { return (warp + kWarps * r) & 1; }
// the leaf's point that a lane reads as element e of its vector: i1 + 16 j
// with i1 = 8h + g, j = 4t + e
F128_FN int a_point(int h, int lane, int e) {
    return 8 * h + (lane >> 2) + kSide * (4 * (lane & 3) + e);
}
// its stores: accumulator i is A[leaf, 8h + column, k2 = row]
F128_FN int a_store(int leaf, int h, int lane, int i) {
    return slot(leaf, 8 * h + acc_column(lane, i), acc_row(lane, i));
}
// Stage B: n8 tile t of a warp (the tile's eight leaves), its k2
F128_FN int b_k2(int warp, int t) { return kBTiles * warp + t; }
// a lane's element e at k2 is A[g, 4t + e, k2]; accumulator i is
// X[column, 16 row + k2], kept in the slot of (column, row, k2)
F128_FN int b_load(int k2, int lane, int e) { return slot(lane >> 2, 4 * (lane & 3) + e, k2); }
F128_FN int b_store(int k2, int lane, int i) {
    return slot(acc_column(lane, i), acc_row(lane, i), k2);
}
// a lane's first parking unit (limb 0; limb k at 32 k further on)
F128_FN int park_unit(int warp, int lane) { return kTile * kLeafUnits + 4 * 32 * warp + lane; }

// the tile's output element e (leaf e / 256, point 16 k1 + k2) in mid
F128_FN int out_slot(int e) {
    const int n = e % kPoints;
    return slot(e / kPoints, n / kSide, n % kSide);
}

// bytes of the 8-byte y:x picked by the selector's nibbles (CUDA's __byte_perm)
F128_FN uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
    return __byte_perm(x, y, s);
#else
    const uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t r = 0;
    for (int e = 0; e < 4; ++e) r |= (uint32_t)((v >> (8 * ((s >> (4 * e)) & 7))) & 0xFF) << (8 * e);
    return r;
#endif
}

// A lane's planes of its four elements v[0..3] (j = 4t..4t+3): P[4c + r]
// = byte r of word c of v[0], v[1], v[2], v[3], a 4 x 4 byte transpose a
// word c (eight byte_perms)
F128_FN void planes(const uint4 (&v)[4], uint32_t (&p)[kSide]) {
    const uint32_t w[4][4] = {{v[0].x, v[1].x, v[2].x, v[3].x}, {v[0].y, v[1].y, v[2].y, v[3].y},
                              {v[0].z, v[1].z, v[2].z, v[3].z}, {v[0].w, v[1].w, v[2].w, v[3].w}};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const uint32_t lo_ab = byte_perm(w[c][0], w[c][1], 0x5140);    // a0 b0 a1 b1
        const uint32_t hi_ab = byte_perm(w[c][0], w[c][1], 0x7362);    // a2 b2 a3 b3
        const uint32_t lo_cd = byte_perm(w[c][2], w[c][3], 0x5140);
        const uint32_t hi_cd = byte_perm(w[c][2], w[c][3], 0x7362);
        p[4 * c] = byte_perm(lo_ab, lo_cd, 0x5410);
        p[4 * c + 1] = byte_perm(lo_ab, lo_cd, 0x7632);
        p[4 * c + 2] = byte_perm(hi_ab, hi_cd, 0x5410);
        p[4 * c + 3] = byte_perm(hi_ab, hi_cd, 0x7632);
    }
}

// An element's digits so far: limbs 0..k-1 done, and what limb k - 1's
// digits leave for limb k (pend: the top half of its upper column and the
// carries, < 2^17)
struct Digits {
    uint32_t limb[kLimbs];
    uint32_t pend;
};

// 2^16 for take's multiply-add, in constant memory on the card: ptxas
// cannot prove it a power of two, so it keeps the multiply-adds on the FMA
// pipe in place of shifts and adds on the integer-only pipe
#ifdef __CUDACC__
static __constant__ uint32_t kColumn = 1u << 16;
#endif

F128_FN uint32_t column() {
#ifdef __CUDA_ARCH__
    return kColumn;
#else
    return 1u << 16;
#endif
}

// Limb k's digits 4k..4k+3 (d3 = 0 for k = 7) into the element.  A digit
// is at most 16 x 16 x 255^2 = 16,646,400 < 2^24, so two digits make a
// 16-bit column in 32 bits: c0 = d0 + 2^8 d1 + pend <= 257 x 16,646,400 +
// 2^17 < 2^32 at bit 32k, c1 = d2 + 2^8 d3 at bit 32k + 16.  Limb k is the
// low word of c0 + c1 2^16, the pend its high word (on the card a
// multiply-add pair, operands %0 the limb, %1 the pend, %2 c1, %3 2^16,
// %4 c0).
F128_FN void take(Digits& s, int k, uint32_t d0, uint32_t d1, uint32_t d2, uint32_t d3) {
    const uint32_t c0 = d0 + (d1 << 8) + s.pend, c1 = d2 + (d3 << 8);
#ifdef __CUDA_ARCH__
    asm("mad.lo.cc.u32 %0, %2, %3, %4;\n\t"
        "madc.hi.u32 %1, %2, %3, 0;"
        : "=r"(s.limb[k]), "=r"(s.pend) : "r"(c1), "r"(column()), "r"(c0));
#else
    const f128::u64 sum = (f128::u64)c1 * column() + c0;
    s.limb[k] = (uint32_t)sum;
    s.pend = (uint32_t)(sum >> 32);
#endif
}

// The element sum_k limb_k 2^(32k) (below 2^265: limb 8, the pend, below
// 2^9) folded twice through R = 2^128 mod M = c 2^32 - 1 (c = 0x2D00): t =
// lo + h R, h = limbs 4..8, as u - h with u = lo + c h 2^32 (t < 2^184);
// then w = t_lo + T R the same way, T = t's limbs 4, 5 (below 2^56).  w
// (w[4] its bit 128) is below 2^128 + 2^102.  On the card one PTX carry
// chain (operands %0-%4 w, %5-%13 the limbs).
F128_FN void fold(const Digits& s, uint32_t (&w)[5]) {
#ifdef __CUDA_ARCH__
    asm("{\n\t"
        ".reg .u32 u1, u2, u3, u4, u5, t1, t2, t3, t4, t5;\n\t"
        // u = lo + c h 2^32: the low halves of c h_k, then the high halves
        "mad.lo.cc.u32 u1, %9, 0x2D00, %6;\n\t"
        "madc.lo.cc.u32 u2, %10, 0x2D00, %7;\n\t"
        "madc.lo.cc.u32 u3, %11, 0x2D00, %8;\n\t"
        "madc.lo.cc.u32 u4, %12, 0x2D00, 0;\n\t"
        "madc.lo.u32 u5, %13, 0x2D00, 0;\n\t"
        "mad.hi.cc.u32 u2, %9, 0x2D00, u2;\n\t"
        "madc.hi.cc.u32 u3, %10, 0x2D00, u3;\n\t"
        "madc.hi.cc.u32 u4, %11, 0x2D00, u4;\n\t"
        "madc.hi.u32 u5, %12, 0x2D00, u5;\n\t"
        // t = u - h
        "sub.cc.u32 %0, %5, %9;\n\t"
        "subc.cc.u32 t1, u1, %10;\n\t"
        "subc.cc.u32 t2, u2, %11;\n\t"
        "subc.cc.u32 t3, u3, %12;\n\t"
        "subc.cc.u32 t4, u4, %13;\n\t"
        "subc.u32 t5, u5, 0;\n\t"
        // w = t_lo + c T 2^32 - T, T = t4 + t5 2^32
        "mad.lo.cc.u32 %1, t4, 0x2D00, t1;\n\t"
        "madc.lo.cc.u32 %2, t5, 0x2D00, t2;\n\t"
        "addc.cc.u32 %3, t3, 0;\n\t"
        "addc.u32 %4, 0, 0;\n\t"
        "mad.hi.cc.u32 %2, t4, 0x2D00, %2;\n\t"
        "madc.hi.cc.u32 %3, t5, 0x2D00, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "sub.cc.u32 %0, %0, t4;\n\t"
        "subc.cc.u32 %1, %1, t5;\n\t"
        "subc.cc.u32 %2, %2, 0;\n\t"
        "subc.cc.u32 %3, %3, 0;\n\t"
        "subc.u32 %4, %4, 0;\n\t"
        "}"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]), "=r"(w[4])
        : "r"(s.limb[0]), "r"(s.limb[1]), "r"(s.limb[2]), "r"(s.limb[3]), "r"(s.limb[4]),
          "r"(s.limb[5]), "r"(s.limb[6]), "r"(s.limb[7]), "r"(s.pend));
#else
    typedef long long i64;
    constexpr uint32_t c = 0x2D00;
    const uint32_t h[5] = {s.limb[4], s.limb[5], s.limb[6], s.limb[7], s.pend};
    uint32_t t[6];
    i64 acc = 0;
    for (int k = 0; k < 6; ++k) {
        if (k < 4) acc += s.limb[k];
        if (k < 5) acc -= h[k];
        if (k > 0) acc += (i64)((f128::u64)h[k - 1] * c);
        t[k] = (uint32_t)acc;
        acc >>= 32;
    }
    acc = (i64)t[0] - t[4];
    w[0] = (uint32_t)acc;
    acc = (acc >> 32) + t[1] - t[5] + (i64)((f128::u64)t[4] * c);
    w[1] = (uint32_t)acc;
    acc = (acc >> 32) + t[2] + (i64)((f128::u64)t[5] * c);
    w[2] = (uint32_t)acc;
    acc = (acc >> 32) + t[3];
    w[3] = (uint32_t)acc;
    w[4] = (uint32_t)(acc >> 32);                              // 0 or 1
#endif
}

// w below 2^128: R added once more where w carried into bit 128 (w_lo is
// below 2^102 then).  Operands %0-%3 the result, %4-%8 w.
F128_FN uint4 below(const uint32_t (&w)[5]) {
    uint4 r;
#ifdef __CUDA_ARCH__
    asm("mad.lo.cc.u32 %0, %8, 0xFFFFFFFF, %4;\n\t"
        "madc.lo.cc.u32 %1, %8, 0x2CFF, %5;\n\t"
        "addc.cc.u32 %2, %6, 0;\n\t"
        "addc.u32 %3, %7, 0;"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(w[4]));
#else
    f128::u64 x = (f128::u64)w[0] + (w[4] ? 0xFFFFFFFFu : 0u);
    r.x = (uint32_t)x;
    x = (x >> 32) + w[1] + (w[4] ? 0x2CFFu : 0u);
    r.y = (uint32_t)x;
    x = (x >> 32) + w[2];
    r.z = (uint32_t)x;
    r.w = w[3] + (uint32_t)(x >> 32);
#endif
    return r;
}

// w mod M: w - M unless that borrows (w < 2^128 + 2^102 < 2M; M =
// 0xFFFFFFFF_FFFFFFFF_FFFFD300_00000001).  Operands %0-%3 the result,
// %4-%8 w.
F128_FN uint4 canonical(const uint32_t (&w)[5]) {
    uint4 r;
#ifdef __CUDA_ARCH__
    asm("{\n\t"
        ".reg .u32 d0, d1, d2, d3, d4;\n\t"
        ".reg .pred under;\n\t"
        "sub.cc.u32 d0, %4, 0x00000001;\n\t"
        "subc.cc.u32 d1, %5, 0xFFFFD300;\n\t"
        "subc.cc.u32 d2, %6, 0xFFFFFFFF;\n\t"
        "subc.cc.u32 d3, %7, 0xFFFFFFFF;\n\t"
        "subc.u32 d4, %8, 0;\n\t"
        "setp.ne.u32 under, d4, 0;\n\t"
        "selp.b32 %0, %4, d0, under;\n\t"
        "selp.b32 %1, %5, d1, under;\n\t"
        "selp.b32 %2, %6, d2, under;\n\t"
        "selp.b32 %3, %7, d3, under;\n\t"
        "}"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(w[4]));
#else
    const f128::u128 lo = f128::from_limbs(uint4{w[0], w[1], w[2], w[3]});
    r = f128::to_limbs(w[4] ? lo - f128::modulus() : lo % f128::modulus());   // mod 2^128
#endif
    return r;
}

// the element mod M: canonical (below M) if reduced, else only below 2^128
F128_FN uint4 finish(const Digits& s, bool reduced) {
    uint32_t w[5];
    fold(s, w);
    return reduced ? canonical(w) : below(w);
}

}  // namespace leaf256
