// The transition AIR at one row of the evaluation domain: the per-row
// evaluator of kernel K4 (air_transition.cu).
//
// A port of native/air.cpp::dt_eval_transition (itself a port of the
// polymorphic AIR of distaff_tpu/stark/constraints/{decoder_air,stack_air,
// evaluator}.py): from row j and row j + 8 (the next trace step) of the
// stride-(ext/8) LDE slice it rebuilds the two trace states, evaluates every
// decoder and stack constraint, and folds them into the degree-grouped
// random linear combination.  The reference's quirks are kept: ld_flags[2]
// takes cf_bits[1] (trace_state.rs:301), both SWAP terms aggregate into
// slot 0, and the PUSH/ASSERT fix-ups come after the BEGIN and NOOP flags.
//
// Layout of the evaluation vector (that of the Python evaluator):
//   [0..15)  op-bit constraints        [15..19) sponge (hacc)
//   [19]     loop image                [20..20+CD) ctx stack
//   [..+LD)  loop stack                [..] 2 aux + stack_depth user stack
// with CD = max(ctx_depth, 1) and LD = max(loop_depth, 1).  The user stack's
// constraints are those of a window padded to SD = max(stack_depth, 8)
// registers (pads zero), of which the first stack_depth are kept: only the
// kept slots are evaluated.  The arrays are sized by the maximum depths.
//
// The reference adds each constraint term as its own flag * value product.
// Here the work is what the combined column needs, with the same values:
// the terms of one slot whose values are equal (a stack shift or copy,
// olds[i + shift] - news[i], or a value the left shifts move in, news[i])
// sum their flags first and share one multiply (SlotTerms); products that
// several operations read are computed once; op flags no operation reads
// are left out; and multiplies by small constants are additions.
//
// Like field128.cuh, the header compiles as plain C++ (air_row_host.cpp), so
// the evaluator is checked on a host without a GPU; there, with
// AIR_COUNT_OPS defined, it also counts its field operations.

#pragma once
#include <cstdint>

#include "field128.cuh"

namespace air {

using f128::u128;

constexpr int kStepRows = 8;                 // rows of D_ev per trace step
constexpr int kMaxCtx = 16, kMaxLoop = 8, kMaxStack = 32;
constexpr int kStackWindow = 8;              // the user stack's least window
constexpr int kMaxConstraints = 20 + kMaxCtx + kMaxLoop + 2 + kMaxStack;
// offsets of the four matrices in Inputs::mds
constexpr int kSpongeMds = 0, kSpongeInvMds = 16, kHasherMds = 32, kHasherInvMds = 68;

#ifdef AIR_COUNT_OPS
extern long long op_counts[3];               // multiplies, adds, subtractions
#define AIR_COUNT(k) (++op_counts[k])
#else
#define AIR_COUNT(k) ((void)0)
#endif

F128_FN u128 fadd(u128 a, u128 b) { AIR_COUNT(1); return f128::add(a, b); }
F128_FN u128 fsub(u128 a, u128 b) { AIR_COUNT(2); return f128::sub(a, b); }
F128_FN u128 fmul(u128 a, u128 b) { AIR_COUNT(0); return f128::mul(a, b); }
F128_FN u128 fdouble(u128 a) { return fadd(a, a); }
F128_FN u128 fcube(u128 a) { return fmul(fmul(a, a), a); }
F128_FN u128 bnot(u128 v) { return fsub(1, v); }
F128_FN u128 is_binary(u128 v) { return fsub(fmul(v, v), v); }
// c * a + (1 - c) * b
F128_FN u128 mux(u128 c, u128 a, u128 b) { return fadd(b, fmul(c, fsub(a, b))); }

// Everything a row reads.  Element pointers are 16-byte limbs; strides are
// in elements.  Periodic tables are (k, cycle) row-major, xp is
// (n_groups, n) row-major.
struct Inputs {
    const uint4* trace;
    long long n, reg_stride, row_stride;
    int ctx_depth, loop_depth, stack_depth;
    const uint4* dec_ark;      // 8 x cycle
    const uint4* masks;        // 3 x cycle
    const uint4* stk_ark;      // 12 x cycle
    int cycle;
    const uint4* mds;          // sponge, sponge inverse (4x4), hasher, hasher inverse (6x6)
    const uint4* cc;           // coefficient pairs in consumption order
    const int32_t* group_idx;  // constraint indices, group by group
    const int32_t* group_size;
    int n_groups;
    const uint4* xp;
};

struct State {
    u128 op_counter;
    u128 sponge[4];
    u128 cf_bits[3], ld_bits[5], hd_bits[2];
    u128 ctx[kMaxCtx], loops[kMaxLoop], stack[kMaxStack];
};

struct Flags {
    u128 cf[8], ld[32], hd[4];
    u128 begin, noop;
};

F128_FN u128 load(const uint4* p, long long i) { return f128::from_limbs(p[i]); }

F128_FN void load_state(const Inputs& in, long long j, State& s) {
    const uint4* row = in.trace + j * in.row_stride;
    const long long rs = in.reg_stride;
    s.op_counter = load(row, 0);
    for (int i = 0; i < 4; i++) s.sponge[i] = load(row, (1 + i) * rs);
    for (int i = 0; i < 3; i++) s.cf_bits[i] = load(row, (5 + i) * rs);
    for (int i = 0; i < 5; i++) s.ld_bits[i] = load(row, (8 + i) * rs);
    for (int i = 0; i < 2; i++) s.hd_bits[i] = load(row, (13 + i) * rs);
    const int c0 = 15, l0 = c0 + in.ctx_depth, s0 = l0 + in.loop_depth;
    for (int i = 0; i < kMaxCtx; i++) s.ctx[i] = i < in.ctx_depth ? load(row, (c0 + i) * rs) : 0;
    for (int i = 0; i < kMaxLoop; i++)
        s.loops[i] = i < in.loop_depth ? load(row, (l0 + i) * rs) : 0;
    for (int i = 0; i < kMaxStack; i++)
        s.stack[i] = i < in.stack_depth ? load(row, (s0 + i) * rs) : 0;
}

// ld flags 15, 22, 23 and 30 belong to no operation
F128_FN bool ld_flag_read(int i) { return i != 15 && i != 22 && i != 23 && i != 30; }

// The op flags as binary splits: the combinations of the low bits times
// those of the high bits (the plain version's factoring; field products
// are exact, so the association order changes nothing).
F128_FN void compute_flags(const State& s, Flags& f) {
    u128 n0 = bnot(s.cf_bits[0]), n1 = bnot(s.cf_bits[1]);
    u128 low[4] = {fmul(n0, n1), fmul(s.cf_bits[0], n1), fmul(n0, s.cf_bits[1]),
                   fmul(s.cf_bits[0], s.cf_bits[1])};
    const u128 n2 = bnot(s.cf_bits[2]);
    for (int i = 0; i < 4; i++) {
        f.cf[i] = fmul(low[i], n2);
        f.cf[4 + i] = fmul(low[i], s.cf_bits[2]);
    }

    // ld: combination 2 of the low two bits takes cf_bits[1], the
    // reference's quirk
    n0 = bnot(s.ld_bits[0]);
    n1 = bnot(s.ld_bits[1]);
    low[0] = fmul(n0, n1);
    low[1] = fmul(s.ld_bits[0], n1);
    low[2] = fmul(n0, s.cf_bits[1]);
    low[3] = fmul(s.ld_bits[0], s.ld_bits[1]);
    const u128 n3 = bnot(s.ld_bits[3]), n4 = bnot(s.ld_bits[4]);
    const u128 nb2 = bnot(s.ld_bits[2]);
    const u128 mid[4] = {fmul(nb2, n3), fmul(s.ld_bits[2], n3), fmul(nb2, s.ld_bits[3]),
                         fmul(s.ld_bits[2], s.ld_bits[3])};
    u128 high[8];
    for (int i = 0; i < 4; i++) {
        high[i] = fmul(mid[i], n4);
        high[4 + i] = fmul(mid[i], s.ld_bits[4]);
    }
    for (int i = 0; i < 32; i++) f.ld[i] = ld_flag_read(i) ? fmul(low[i & 3], high[i >> 2]) : 0;

    n0 = bnot(s.hd_bits[0]);
    n1 = bnot(s.hd_bits[1]);
    f.hd[0] = fmul(n0, n1);
    f.hd[1] = fmul(s.hd_bits[0], n1);
    f.hd[2] = fmul(n0, s.hd_bits[1]);
    f.hd[3] = fmul(s.hd_bits[0], s.hd_bits[1]);

    f.begin = fmul(f.ld[0], f.hd[0]);
    f.noop = fmul(f.ld[31], f.hd[3]);

    f.hd[0] = fmul(f.hd[0], s.ld_bits[0]);      // PUSH fix-up
    f.ld[0] = fmul(f.ld[0], s.hd_bits[0]);      // ASSERT fix-up
}

// ld bits + 2 * ... + 32 * hd bit 0 + 64 * hd bit 1, by doubling
F128_FN u128 op_code(const State& s) {
    u128 r = s.hd_bits[1];
    r = fadd(fdouble(r), s.hd_bits[0]);
    for (int i = 4; i >= 0; i--) r = fadd(fdouble(r), s.ld_bits[i]);
    return r;
}

F128_FN void agg(u128* res, int idx, u128 flag, u128 value) {
    res[idx] = fadd(res[idx], fmul(flag, value));
}

// row i of mds x in, for a w x w matrix
F128_FN u128 mds_row(const uint4* mds, int i, const u128* in, int w) {
    u128 acc = fmul(load(mds, i * w), in[0]);
    for (int k = 1; k < w; k++) acc = fadd(acc, fmul(load(mds, i * w + k), in[k]));
    return acc;
}

// The flag-weighted shift and copy terms of one slot of a stack window
// (user, ctx or loop stack) of length len.  A term adds
// flag * (olds[slot + shift] - news[slot]), or flag * news[slot] for a
// tail (what a left shift moves in); terms of one kind sum their flags, and
// apply() does one multiply per kind present.
constexpr int kMinShift = -4, kMaxShift = 7;
constexpr int kTail = kMaxShift - kMinShift + 1;
constexpr int kKinds = kTail + 1;

struct SlotTerms {
    int slot;
    u128 coef[kKinds];
    // 0: no term of this kind; 1: the kind adds coef; -1: it subtracts coef
    int sign[kKinds];

    F128_FN explicit SlotTerms(int i) : slot(i) {
        for (int k = 0; k < kKinds; k++) sign[k] = 0;
    }

    F128_FN void add(int k, u128 flag, bool negate) {
        if (sign[k] == 0) {
            coef[k] = flag;
            sign[k] = negate ? -1 : 1;
        } else if (negate == (sign[k] < 0)) {
            coef[k] = fadd(coef[k], flag);
        } else if (sign[k] > 0) {
            coef[k] = fsub(coef[k], flag);
        } else {
            coef[k] = fsub(flag, coef[k]);
            sign[k] = 1;
        }
    }
    // the term at slots [lo, hi); negated: flag * (news[slot] - olds[slot + shift])
    F128_FN void span(int lo, int hi, int shift, u128 flag, bool negate = false) {
        if (lo <= slot && slot < hi) add(shift - kMinShift, flag, negate);
    }
    F128_FN void tail(int lo, int hi, u128 flag) {
        if (lo <= slot && slot < hi) add(kTail, flag, false);
    }
    // the reference's stack_copy, right_shift and left_shift
    F128_FN void copy(int len, int from, u128 flag) { span(from, len, 0, flag); }
    F128_FN void right_shift(int len, int slots, u128 flag) { span(slots, len, -slots, flag); }
    F128_FN void left_shift(int len, int from, int slots, u128 flag) {
        span(from - slots, len - slots, slots, flag);
        tail(len - slots, len, flag);
    }

    F128_FN u128 apply(u128 res, const u128* olds, const u128* news) const {
#pragma unroll
        for (int k = 0; k < kKinds; k++) {
            if (sign[k] == 0) continue;
            const u128 v = k == kTail ? news[slot]
                                      : fsub(olds[slot + k + kMinShift], news[slot]);
            const u128 t = fmul(coef[k], v);
            res = sign[k] > 0 ? fadd(res, t) : fsub(res, t);
        }
        return res;
    }
};

// decoder ------------------------------------------------------------------------------------

F128_FN void enforce_op_bits(u128* res, const State& cur, const Flags& f, const State& nxt,
                             u128 next_void, const u128* mask) {
    int i = 0;
    u128 cf_sum = 0;
    for (int k = 0; k < 3; k++) {
        res[i++] = is_binary(cur.cf_bits[k]);
        cf_sum = k ? fadd(cf_sum, cur.cf_bits[k]) : cur.cf_bits[k];
    }
    u128 ld_prod = cur.ld_bits[0];
    res[i++] = is_binary(cur.ld_bits[0]);
    for (int k = 1; k < 5; k++) {
        res[i++] = is_binary(cur.ld_bits[k]);
        ld_prod = fmul(ld_prod, cur.ld_bits[k]);
    }
    res[i++] = is_binary(cur.hd_bits[0]);
    res[i++] = is_binary(cur.hd_bits[1]);
    const u128 hd_prod = fmul(cur.hd_bits[0], cur.hd_bits[1]);

    // op_counter increments by 1 on HACC, stays constant otherwise:
    // (op + 1) * hacc + op * (1 - hacc) = op + hacc
    res[i++] = fsub(fadd(cur.op_counter, f.cf[0]), nxt.op_counter);
    // ld/hd ops cannot be all 0s except at the first step
    res[i++] = fmul(fmul(cur.op_counter, bnot(ld_prod)), bnot(hd_prod));
    // when cf ops are not all 0s, user ops must be all 1s (NOOP)
    res[i++] = fmul(cf_sum, bnot(fmul(ld_prod, hd_prod)));
    // VOID can be followed only by VOID
    res[i++] = fmul(f.cf[7], bnot(next_void));

    // BEGIN, LOOP, WRAP, BREAK on 15 mod 16; TEND, FEND on 0 mod 16; PUSH on 0 mod 8
    u128 v = fmul(fadd(fadd(f.cf[1], f.cf[4]), fadd(f.cf[5], f.cf[6])), mask[1]);
    agg(&v, 0, fadd(f.cf[2], f.cf[3]), mask[0]);
    agg(&v, 0, f.hd[0], mask[2]);
    res[i] = v;
}

// one hacc sponge round, met in the middle
F128_FN void enforce_hacc(u128* res, const Inputs& in, const State& cur, const Flags& f,
                          const State& nxt, const u128* ark) {
    const u128 op_value = fmul(nxt.stack[0], f.hd[0]);
    u128 old_s[4], inv[4];
    for (int i = 0; i < 4; i++) old_s[i] = fcube(fadd(cur.sponge[i], ark[i]));
    for (int i = 0; i < 4; i++) inv[i] = mds_row(in.mds + kSpongeInvMds, i, nxt.sponge, 4);
    for (int i = 0; i < 4; i++) {
        u128 t = mds_row(in.mds + kSpongeMds, i, old_s, 4);
        if (i == 0) t = fadd(t, op_code(cur));
        if (i == 1) t = fadd(t, op_value);
        const u128 new_s = fsub(fcube(inv[i]), ark[4 + i]);
        agg(res, i, f.cf[0], fsub(t, new_s));
    }
}

F128_FN void enforce_flow(u128* res, int cd, int ld, const State& cur, const Flags& f,
                          const State& nxt) {
    const u128* g = f.cf;            // 1 BEGIN, 2 TEND, 3 FEND, 4 LOOP, 5 WRAP, 6 BREAK, 7 VOID
    const u128* s = cur.sponge;
    const u128* ns = nxt.sponge;

    // the sponge: BEGIN, LOOP and WRAP take the next sponge (TEND and FEND
    // its last element), BREAK and VOID keep it; TEND and FEND move the
    // first ctx element in
    const u128 starts = fadd(fadd(g[1], g[4]), g[5]);
    const u128 ends = fadd(g[2], g[3]);
    const u128 keeps = fadd(g[6], g[7]);
    for (int i = 0; i < 4; i++) {
        agg(res, i, i == 3 ? fadd(starts, ends) : starts, ns[i]);
        agg(res, i, keeps, fsub(s[i], ns[i]));
    }
    agg(res, 0, ends, fsub(cur.ctx[0], ns[0]));
    agg(res, 1, g[2], fsub(s[0], ns[1]));
    agg(res, 2, g[3], fsub(s[0], ns[2]));
    // the loop image: WRAP and BREAK
    agg(res, 4, fadd(g[5], g[6]), fsub(s[0], cur.loops[0]));

    u128* ctx_res = res + 5;
    u128* loop_res = ctx_res + cd;
    agg(ctx_res, 0, fadd(g[1], g[4]), fsub(s[0], nxt.ctx[0]));     // BEGIN, LOOP
    for (int i = 0; i < cd; i++) {
        SlotTerms t(i);
        t.right_shift(cd, 1, g[1]);
        t.left_shift(cd, 1, 1, g[2]);
        t.left_shift(cd, 1, 1, g[3]);
        t.right_shift(cd, 1, g[4]);
        for (int k = 5; k < 8; k++) t.copy(cd, 0, g[k]);
        ctx_res[i] = t.apply(ctx_res[i], cur.ctx, nxt.ctx);
    }
    for (int i = 0; i < ld; i++) {
        SlotTerms t(i);
        for (int k = 1; k < 4; k++) t.copy(ld, 0, g[k]);
        t.right_shift(ld, 1, g[4]);
        t.copy(ld, 0, g[5]);
        t.left_shift(ld, 1, 1, g[6]);
        t.copy(ld, 0, g[7]);
        loop_res[i] = t.apply(loop_res[i], cur.loops, nxt.loops);
    }
}

// user stack ---------------------------------------------------------------------------------

// aux: the two auxiliary constraints; res: the kept slots [0, keep) of the
// window of length len
F128_FN void enforce_stack(u128* aux, u128* res, int keep, int len, const Inputs& in,
                           const State& cur, const Flags& f, const State& nxt, const u128* ark) {
    const u128* olds = cur.stack;
    const u128* news = nxt.stack;
    const u128* ld = f.ld;
    const u128* hd = f.hd;

    for (int i = 0; i < keep; i++) {
        SlotTerms t(i);
        t.left_shift(len, 1, 1, ld[0]);                                     // ASSERT
        t.left_shift(len, 2, 2, ld[1]);                                     // ASSERTEQ
        t.right_shift(len, 1, ld[16]);                                      // READ
        t.right_shift(len, 2, ld[17]);                                      // READ2
        t.span(0, 1, 0, ld[18], true);                                      // DUP
        t.right_shift(len, 1, ld[18]);
        t.span(0, 2, 0, ld[19], true);                                      // DUP2
        t.right_shift(len, 2, ld[19]);
        t.span(0, 4, 0, ld[20], true);                                      // DUP4
        t.right_shift(len, 4, ld[20]);
        t.tail(0, 2, ld[21]);                                               // PAD2
        t.right_shift(len, 2, ld[21]);
        t.left_shift(len, 1, 1, ld[3]);                                     // DROP
        t.left_shift(len, 4, 4, ld[4]);                                     // DROP4
        t.span(0, 1, 1, ld[24], true);                   // SWAP; its second term is below
        t.copy(len, 2, ld[24]);
        t.span(0, 2, 2, ld[25], true);                                      // SWAP2
        t.span(2, 4, -2, ld[25], true);
        t.copy(len, 4, ld[25]);
        t.span(0, 4, 4, ld[26], true);                                      // SWAP4
        t.span(4, 8, -4, ld[26], true);
        t.copy(len, 8, ld[26]);
        t.span(0, 1, 3, ld[27], true);                                      // ROLL4
        t.span(1, 4, -1, ld[27], true);
        t.copy(len, 4, ld[27]);
        t.span(0, 1, 7, ld[28], true);                                      // ROLL8
        t.span(1, 8, -1, ld[28], true);
        t.copy(len, 8, ld[28]);
        t.left_shift(len, 2, 1, ld[8]);                                     // ADD
        t.left_shift(len, 2, 1, ld[9]);                                     // MUL
        t.copy(len, 1, ld[12]);                                             // INV
        t.copy(len, 1, ld[13]);                                             // NEG
        t.copy(len, 1, ld[14]);                                             // NOT
        t.left_shift(len, 2, 1, ld[10]);                                    // AND
        t.left_shift(len, 2, 1, ld[11]);                                    // OR
        t.left_shift(len, 3, 2, ld[2]);                                     // EQ
        t.tail(1, 2, ld[29]);                                               // BINACC
        t.copy(len, 4, ld[29]);
        t.left_shift(len, 3, 2, ld[5]);                                     // CHOOSE
        t.left_shift(len, 6, 4, ld[6]);                                     // CHOOSE2
        t.left_shift(len, 6, 2, ld[7]);                                     // CSWAP2
        t.right_shift(len, 1, hd[0]);                                       // PUSH
        t.copy(len, 8, hd[1]);                                              // CMP
        t.copy(len, 6, hd[2]);                                              // RESCR
        t.copy(len, 0, f.begin);                        // BEGIN and NOOP: the stack stays
        t.copy(len, 0, f.noop);
        res[i] = t.apply(res[i], olds, news);
    }

    // the auxiliary constraints: ASSERT, ASSERTEQ, NOT, AND, OR, EQ and the
    // choices' condition bits
    const u128 diff = fsub(olds[1], olds[2]);                       // EQ
    agg(aux, 0, ld[0], bnot(olds[0]));
    agg(aux, 0, ld[1], fsub(olds[0], olds[1]));
    agg(aux, 0, fadd(fadd(ld[14], ld[10]), ld[11]), is_binary(olds[0]));
    agg(aux, 1, fadd(ld[10], ld[11]), is_binary(olds[1]));
    agg(aux, 0, ld[2], fmul(news[0], diff));
    agg(aux, 0, ld[5], is_binary(olds[2]));
    agg(aux, 0, fadd(ld[6], ld[7]), is_binary(olds[4]));

    // the terms of their own, at the kept slots.  CHOOSE2 and CSWAP2 select
    // by olds[4]; CMP compares bits x = news[1] and y = news[2]
    const u128 c4 = olds[4];
    if (keep > 0) {
        const u128 o01 = fmul(olds[0], olds[1]);
        const u128 m02 = mux(c4, olds[0], olds[2]);
        agg(res, 0, ld[24], fsub(news[1], olds[0]));                       // SWAP
        agg(res, 0, ld[8], fsub(news[0], fadd(olds[0], olds[1])));         // ADD
        agg(res, 0, fadd(ld[9], ld[10]), fsub(news[0], o01));              // MUL, AND
        agg(res, 0, ld[12], bnot(fmul(news[0], olds[0])));                 // INV
        agg(res, 0, ld[13], fadd(news[0], olds[0]));                       // NEG
        agg(res, 0, ld[14], fsub(news[0], bnot(olds[0])));                 // NOT
        // OR: 1 - (1 - a)(1 - b) = a + b - ab
        agg(res, 0, ld[11], fsub(news[0], fsub(fadd(olds[0], olds[1]), o01)));
        agg(res, 0, ld[2], fsub(news[0], bnot(fmul(diff, olds[0]))));      // EQ
        agg(res, 0, ld[29], is_binary(news[0]));                           // BINACC
        agg(res, 0, ld[5], fsub(news[0], mux(olds[2], olds[0], olds[1])));  // CHOOSE
        agg(res, 0, ld[6], fsub(news[0], m02));                            // CHOOSE2
        // CSWAP2: c * o2 + (1 - c) * o0 = o0 + o2 - m02
        agg(res, 0, ld[7], fsub(news[0], fsub(fadd(olds[0], olds[2]), m02)));
        agg(res, 0, hd[1], is_binary(news[1]));                            // CMP
        if (keep > 2) agg(res, 2, ld[7], fsub(news[2], m02));              // CSWAP2
    }
    if (keep > 1) {
        const u128 m13 = mux(c4, olds[1], olds[3]);
        agg(res, 1, ld[6], fsub(news[1], m13));                            // CHOOSE2
        agg(res, 1, ld[7], fsub(news[1], fsub(fadd(olds[1], olds[3]), m13)));  // CSWAP2
        agg(res, 1, hd[1], is_binary(news[2]));                            // CMP
        if (keep > 3) agg(res, 3, ld[7], fsub(news[3], m13));              // CSWAP2
    }
    if (keep > 2) {
        const u128 x = news[1], y = news[2], not_set = news[3];
        const u128 xy = fmul(x, y);
        agg(res, 2, ld[29], fsub(news[2], fdouble(olds[2])));              // BINACC
        // CMP: x (1 - y) = x - xy
        agg(res, 2, hd[1], fsub(news[4], fadd(olds[4], fmul(fsub(x, xy), not_set))));
        if (keep > 3) {
            agg(res, 3, ld[29], fsub(news[3], fadd(olds[3], fmul(news[0], olds[2]))));
            // CMP: y (1 - x) = y - xy
            agg(res, 3, hd[1], fsub(news[5], fadd(olds[5], fmul(fsub(y, xy), not_set))));
        }
    }
    if (keep > 4) agg(res, 4, hd[1], fsub(news[6], fadd(olds[6], fmul(news[2], olds[0]))));
    if (keep > 5) agg(res, 5, hd[1], fsub(news[7], fadd(olds[7], fmul(news[1], olds[0]))));
    if (keep > 6) agg(res, 6, hd[1], fsub(news[3], fmul(bnot(olds[5]), bnot(olds[4]))));
    if (keep > 7) agg(res, 7, hd[1], fsub(fdouble(news[0]), olds[0]));

    if (keep > 0) {   // RESCR (hd 2): one Rescue round, met in the middle
        const int rows = keep < 6 ? keep : 6;
        u128 cubes[6];
        for (int i = 0; i < 6; i++) cubes[i] = fcube(fadd(olds[i], ark[i]));
        for (int i = 0; i < rows; i++) {
            const u128 t = mds_row(in.mds + kHasherMds, i, cubes, 6);
            const u128 inv = mds_row(in.mds + kHasherInvMds, i, news, 6);
            agg(res, i, hd[2], fsub(fsub(fcube(inv), ark[6 + i]), t));
        }
    }
}

// the combined transition constraint at row j
F128_FN u128 eval_row(const Inputs& in, long long j) {
    State cur, nxt;
    load_state(in, j, cur);
    load_state(in, (j + kStepRows) % in.n, nxt);
    Flags f;
    compute_flags(cur, f);
    // the next state's VOID flag: cf bits 0, 1 and 2 all set
    const u128 next_void = fmul(fmul(nxt.cf_bits[0], nxt.cf_bits[1]), nxt.cf_bits[2]);

    const int ci = (int)(j % in.cycle);
    u128 dec_ark[8], mask[3], stk_ark[12];
    for (int k = 0; k < 8; k++) dec_ark[k] = load(in.dec_ark, (long long)k * in.cycle + ci);
    for (int k = 0; k < 3; k++) mask[k] = load(in.masks, (long long)k * in.cycle + ci);
    for (int k = 0; k < 12; k++) stk_ark[k] = load(in.stk_ark, (long long)k * in.cycle + ci);

    const int cd = in.ctx_depth > 1 ? in.ctx_depth : 1;
    const int ld = in.loop_depth > 1 ? in.loop_depth : 1;
    const int sd = in.stack_depth > kStackWindow ? in.stack_depth : kStackWindow;
    const int n_dec = 20 + cd + ld;

    u128 evals[kMaxConstraints];
    for (int k = 0; k < kMaxConstraints; k++) evals[k] = 0;
    enforce_op_bits(evals, cur, f, nxt, next_void, mask);
    enforce_hacc(evals + 15, in, cur, f, nxt, dec_ark);
    enforce_flow(evals + 15, cd, ld, cur, f, nxt);
    enforce_stack(evals + n_dec, evals + n_dec + 2, in.stack_depth, sd, in, cur, f, nxt,
                  stk_ark);

    // the pseudo-random linear combination, degree group by degree group
    u128 result = 0;
    int i = 0;
    for (int g = 0; g < in.n_groups; g++) {
        u128 adj = 0;
        for (int k = 0; k < in.group_size[g]; k++, i++) {
            const u128 e = evals[in.group_idx[i]];
            result = fadd(result, fmul(e, load(in.cc, 2 * i)));
            adj = fadd(adj, fmul(e, load(in.cc, 2 * i + 1)));
        }
        result = fadd(result, fmul(adj, load(in.xp, (long long)g * in.n + j)));
    }
    return result;
}

}  // namespace air
