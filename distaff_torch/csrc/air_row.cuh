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
// The evaluator is a template over the trace's depths (CTX, LOOP, STACK),
// one instantiation per geometry, as the JAX package compiled its AIR per
// geometry: every index is a compile-time constant, so nothing is indexed
// at run time, and the trace states are read register by register where
// each value is used (State).  Layout of the constraints (that of the
// Python evaluator):
//   [0..15)  op-bit constraints        [15..19) sponge (hacc)
//   [19]     loop image                [20..20+CD) ctx stack
//   [..+LD)  loop stack                [..] 2 aux + STACK user stack
// with CD = max(CTX, 1) and LD = max(LOOP, 1).  The user stack's
// constraints are those of a window padded to SD = max(STACK, 8) registers
// (pads zero), of which the first STACK are kept: only the kept slots are
// evaluated.  Each constraint is folded into the combination as soon as its
// value is complete: its coefficient pair and its degree group follow from
// the degree table below (Layout), so no vector of constraint values is
// kept.
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
#include <utility>

#include "field128.cuh"

namespace air {

using f128::u128;

constexpr int kStepRows = 8;                 // rows of D_ev per trace step
constexpr int kMaxCtx = 16, kMaxLoop = 8, kMaxStack = 32;
constexpr int kStackWindow = 8;              // the user stack's least window
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
// acc + flag * value
F128_FN u128 agg(u128 acc, u128 flag, u128 value) { return fadd(acc, fmul(flag, value)); }

// f(Int<0>()), ..., f(Int<N - 1>()): a loop whose index is a compile-time
// constant in the body, for indices that choose a template argument
template <int I>
struct Int {
    static constexpr int value = I;
};
template <typename F, int... I>
F128_FN void unroll_seq(F& f, std::integer_sequence<int, I...>) {
    (f(Int<I>()), ...);
}
template <int N, typename F>
F128_FN void unroll(F f) {
    unroll_seq(f, std::make_integer_sequence<int, N>());
}

// constraint c's degree (decoder_air.py OP_CONSTRAINT_DEGREES,
// SPONGE_CONSTRAINT_DEGREES, the loop image's and the ctx/loop stacks' 4;
// stack_air.py's 7 for the aux and user-stack constraints), the aux
// constraints starting at aux0
F128_FN constexpr int constraint_degree(int c, int aux0) {
    return c < 10 ? 2 : c == 10 ? 3 : c < 13 ? 8 : c == 13 ? 6 : c == 14 ? 4
         : c < 19 ? (c == 16 ? 7 : 6) : c < aux0 ? 4 : 7;
}
// the distinct degrees below d among count constraints
F128_FN constexpr int groups_below(int d, int count, int aux0) {
    int g = 0;
    for (int e = 0; e < d; e++) {
        bool present = false;
        for (int c = 0; c < count; c++) present = present || constraint_degree(c, aux0) == e;
        g += present;
    }
    return g;
}

// The constraints of one geometry: their count, degrees and where each
// one's coefficient pair and degree group lie in the combination
// (evaluator.py group_transition_constraints: groups by ascending degree,
// constraints in index order within a group).
template <int CTX, int LOOP, int STACK>
struct Layout {
    static constexpr int kCtx = CTX, kLoop = LOOP, kStack = STACK;
    static constexpr int kCd = CTX > 1 ? CTX : 1;
    static constexpr int kLd = LOOP > 1 ? LOOP : 1;
    static constexpr int kSd = STACK > kStackWindow ? STACK : kStackWindow;
    static constexpr int kCtx0 = 20, kLoop0 = kCtx0 + kCd, kAux0 = kLoop0 + kLd;
    static constexpr int kStack0 = kAux0 + 2, kCount = kStack0 + STACK;
    static constexpr int kGroups = groups_below(9, kCount, kAux0);

    static F128_FN constexpr int degree(int c) { return constraint_degree(c, kAux0); }
    static F128_FN constexpr int group(int c) { return groups_below(degree(c), kCount, kAux0); }
    // the index of c's coefficient pair
    static F128_FN constexpr int position(int c) {
        int p = 0;
        for (int k = 0; k < kCount; k++)
            p += degree(k) < degree(c) || (degree(k) == degree(c) && k < c);
        return p;
    }
};

constexpr int kMaxGroups = 8;                // degree groups (the degrees are 2-4 and 6-8)

// Everything a row reads besides the depths.  Element pointers are 16-byte
// limbs; strides are in elements.  Periodic tables are (k, cycle)
// row-major.  Group g's degree adjustment at row j is x^incr[g] with x =
// r^j, r the root of the n-point domain (n a power of two): r^e with e =
// incr[g] j mod n, read from r's two power tables as x_lo[e mod 2^log_lo]
// x_hi[e >> log_lo] (ops/tiles._store_factors; x_hi null up to 2^log_lo
// points).
struct Inputs {
    const uint4* trace;
    long long n, reg_stride, row_stride;
    const uint4* dec_ark;      // 8 x cycle
    const uint4* masks;        // 3 x cycle
    const uint4* stk_ark;      // 12 x cycle
    int cycle;
    const uint4* mds;          // sponge, sponge inverse (4x4), hasher, hasher inverse (6x6)
    const uint4* cc;           // coefficient pairs in consumption order
    long long incr[kMaxGroups];
    const uint4* x_lo;
    const uint4* x_hi;
    int log_lo;
};

F128_FN u128 load(const uint4* p, long long i) { return f128::from_limbs(p[i]); }

// A trace state (one row of the slice) read register by register where it
// is used, so that no register holds a trace value across the evaluation:
// register r at p[r * stride].  Registers: op counter, sponge 4, op bits
// 10, then the ctx, loop and user stacks; a stack slot beyond its depth
// reads zero.  On the card p points into the block's rows staged in shared
// memory and each read is a volatile load, which the compiler neither
// merges with another read nor hoists; the host build reads the slice in
// place.
template <class L>
struct State {
    const uint4* p;
    long long stride;

    F128_FN u128 reg(int r) const {
#ifdef __CUDA_ARCH__
        uint4 v;
        const unsigned addr = (unsigned)__cvta_generic_to_shared(p + r * stride);
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
        return f128::from_limbs(v);
#else
        return load(p, r * stride);
#endif
    }
    F128_FN u128 op_counter() const { return reg(0); }
    F128_FN u128 sponge(int i) const { return reg(1 + i); }
    F128_FN u128 cf_bits(int i) const { return reg(5 + i); }
    F128_FN u128 ld_bits(int i) const { return reg(8 + i); }
    F128_FN u128 hd_bits(int i) const { return reg(13 + i); }
    F128_FN u128 ctx(int i) const { return i < L::kCtx ? reg(15 + i) : 0; }
    F128_FN u128 loops(int i) const { return i < L::kLoop ? reg(15 + L::kCtx + i) : 0; }
    F128_FN u128 stack(int i) const {
        return i < L::kStack ? reg(15 + L::kCtx + L::kLoop + i) : 0;
    }
};

// the random linear combination, folded one constraint at a time
template <class L>
struct Combination {
    const uint4* cc;
    u128 result;
    u128 adj[L::kGroups];

    F128_FN explicit Combination(const uint4* coefficients) : cc(coefficients), result(0) {
#pragma unroll
        for (int g = 0; g < L::kGroups; g++) adj[g] = 0;
    }
    template <int C>
    F128_FN void fold(u128 e) {
        constexpr int pos = L::position(C), g = L::group(C);
        static_assert(C < L::kCount, "constraint index out of range");
        result = fadd(result, fmul(e, load(cc, 2 * pos)));
        adj[g] = fadd(adj[g], fmul(e, load(cc, 2 * pos + 1)));
    }
    // each group's adjusted sum times its degree adjustment x^incr at row j,
    // from the power tables: one multiply a group where there is x_hi
    F128_FN u128 finish(const Inputs& in, long long j) {
        static_assert(L::kGroups <= kMaxGroups, "too many degree groups");
#pragma unroll
        for (int g = 0; g < L::kGroups; g++) {
            const long long e = (in.incr[g] * j) & (in.n - 1);
            u128 x = load(in.x_lo, e & ((1LL << in.log_lo) - 1));
            if (in.x_hi) x = fmul(x, load(in.x_hi, e >> in.log_lo));
            result = agg(result, adj[g], x);
        }
        return result;
    }
};

// The op flags as binary splits: the combinations of the low bits times
// those of the high bits (the plain version's factoring; field products
// are exact, so the association order changes nothing).  cf and hd flags
// first, with the PUSH fix-up (hd[0] times ld bit 0) applied; hd0 keeps
// the flag before it, for BEGIN.
struct DecoderFlags {
    u128 cf[8], hd[4];
    u128 hd0;
};

template <class L>
F128_FN DecoderFlags decoder_flags(const State<L>& s) {
    DecoderFlags f;
    u128 n0 = bnot(s.cf_bits(0)), n1 = bnot(s.cf_bits(1));
    const u128 low[4] = {fmul(n0, n1), fmul(s.cf_bits(0), n1), fmul(n0, s.cf_bits(1)),
                         fmul(s.cf_bits(0), s.cf_bits(1))};
    const u128 n2 = bnot(s.cf_bits(2));
#pragma unroll
    for (int i = 0; i < 4; i++) {
        f.cf[i] = fmul(low[i], n2);
        f.cf[4 + i] = fmul(low[i], s.cf_bits(2));
    }
    n0 = bnot(s.hd_bits(0));
    n1 = bnot(s.hd_bits(1));
    f.hd0 = fmul(n0, n1);
    f.hd[1] = fmul(s.hd_bits(0), n1);
    f.hd[2] = fmul(n0, s.hd_bits(1));
    f.hd[3] = fmul(s.hd_bits(0), s.hd_bits(1));
    f.hd[0] = fmul(f.hd0, s.ld_bits(0));                    // PUSH fix-up
    return f;
}

// ld flags, with BEGIN and NOOP and then the ASSERT fix-up (ld[0] times hd
// bit 0).  Combination 2 of the low two bits takes cf_bits[1], the
// reference's quirk; ld flags 15, 22, 23 and 30 belong to no operation and
// stay zero.
struct StackFlags {
    u128 ld[32];
    u128 begin, noop;
};

F128_FN constexpr bool ld_flag_read(int i) { return i != 15 && i != 22 && i != 23 && i != 30; }

template <class L>
F128_FN StackFlags stack_flags(const State<L>& s, const DecoderFlags& d) {
    StackFlags f;
    const u128 n0 = bnot(s.ld_bits(0)), n1 = bnot(s.ld_bits(1));
    const u128 low[4] = {fmul(n0, n1), fmul(s.ld_bits(0), n1), fmul(n0, s.cf_bits(1)),
                         fmul(s.ld_bits(0), s.ld_bits(1))};
    const u128 n3 = bnot(s.ld_bits(3)), n4 = bnot(s.ld_bits(4));
    const u128 nb2 = bnot(s.ld_bits(2));
    const u128 mid[4] = {fmul(nb2, n3), fmul(s.ld_bits(2), n3), fmul(nb2, s.ld_bits(3)),
                         fmul(s.ld_bits(2), s.ld_bits(3))};
    u128 high[8];
#pragma unroll
    for (int i = 0; i < 4; i++) {
        high[i] = fmul(mid[i], n4);
        high[4 + i] = fmul(mid[i], s.ld_bits(4));
    }
#pragma unroll
    for (int i = 0; i < 32; i++) f.ld[i] = ld_flag_read(i) ? fmul(low[i & 3], high[i >> 2]) : 0;
    f.begin = fmul(f.ld[0], d.hd0);
    f.noop = fmul(f.ld[31], d.hd[3]);
    f.ld[0] = fmul(f.ld[0], s.hd_bits(0));                  // ASSERT fix-up
    return f;
}

// ld bits + 2 * ... + 32 * hd bit 0 + 64 * hd bit 1, by doubling
template <class L>
F128_FN u128 op_code(const State<L>& s) {
    u128 r = s.hd_bits(1);
    r = fadd(fdouble(r), s.hd_bits(0));
#pragma unroll
    for (int i = 4; i >= 0; i--) r = fadd(fdouble(r), s.ld_bits(i));
    return r;
}

// row i of mds x in, for a W x W matrix; in(k) gives the vector's entries
template <int W, class In>
F128_FN u128 mds_row(const uint4* mds, int i, const In& in) {
    u128 acc = fmul(load(mds, i * W), in(0));
#pragma unroll
    for (int k = 1; k < W; k++) acc = fadd(acc, fmul(load(mds, i * W + k), in(k)));
    return acc;
}

// The flag-weighted shift and copy terms of slot SLOT of a stack window
// (user, ctx or loop stack) of length len.  A term adds
// flag * (olds[SLOT + shift] - news[SLOT]), or flag * news[SLOT] for a
// tail (what a left shift moves in); terms of one kind sum their flags, and
// apply() does one multiply per kind present.  Every call's arguments are
// constants, so the kinds present and their signs fold at compile time.
constexpr int kMinShift = -4, kMaxShift = 7;
constexpr int kTail = kMaxShift - kMinShift + 1;
constexpr int kKinds = kTail + 1;

template <int SLOT>
struct SlotTerms {
    u128 coef[kKinds];
    // 0: no term of this kind; 1: the kind adds coef; -1: it subtracts coef
    int sign[kKinds];

    F128_FN SlotTerms() {
#pragma unroll
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
        if (lo <= SLOT && SLOT < hi) add(shift - kMinShift, flag, negate);
    }
    F128_FN void tail(int lo, int hi, u128 flag) {
        if (lo <= SLOT && SLOT < hi) add(kTail, flag, false);
    }
    // the reference's stack_copy, right_shift and left_shift
    F128_FN void copy(int len, int from, u128 flag) { span(from, len, 0, flag); }
    F128_FN void right_shift(int len, int slots, u128 flag) { span(slots, len, -slots, flag); }
    F128_FN void left_shift(int len, int from, int slots, u128 flag) {
        span(from - slots, len - slots, slots, flag);
        tail(len - slots, len, flag);
    }

    // the sum of the terms; olds(i) and news(i) read slot i of a window of N slots
    template <int N, class Old, class New>
    F128_FN u128 apply(const Old& olds, const New& news) const {
        u128 res = 0;
        bool first = true;
#pragma unroll
        for (int k = 0; k < kKinds; k++) {
            const int at = SLOT + k + kMinShift;
            if (sign[k] == 0 || (k != kTail && (at < 0 || at >= N))) continue;
            const u128 v = k == kTail ? news(SLOT) : fsub(olds(at), news(SLOT));
            const u128 t = fmul(coef[k], v);
            res = first && sign[k] > 0 ? t : sign[k] > 0 ? fadd(res, t) : fsub(res, t);
            first = false;
        }
        return res;
    }
};

// decoder ------------------------------------------------------------------------------------

template <class L, class Mask>
F128_FN void fold_op_bits(Combination<L>& acc, const State<L>& cur, const DecoderFlags& f,
                          const State<L>& nxt, const Mask& mask) {
    u128 cf_sum = cur.cf_bits(0);
    acc.template fold<0>(is_binary(cur.cf_bits(0)));
    acc.template fold<1>(is_binary(cur.cf_bits(1)));
    acc.template fold<2>(is_binary(cur.cf_bits(2)));
    cf_sum = fadd(fadd(cf_sum, cur.cf_bits(1)), cur.cf_bits(2));
    u128 ld_prod = cur.ld_bits(0);
    acc.template fold<3>(is_binary(cur.ld_bits(0)));
    unroll<4>([&](auto k) {
        constexpr int K = decltype(k)::value + 1;
        acc.template fold<3 + K>(is_binary(cur.ld_bits(K)));
        ld_prod = fmul(ld_prod, cur.ld_bits(K));
    });
    acc.template fold<8>(is_binary(cur.hd_bits(0)));
    acc.template fold<9>(is_binary(cur.hd_bits(1)));
    const u128 hd_prod = fmul(cur.hd_bits(0), cur.hd_bits(1));

    // op_counter increments by 1 on HACC, stays constant otherwise:
    // (op + 1) * hacc + op * (1 - hacc) = op + hacc
    acc.template fold<10>(fsub(fadd(cur.op_counter(), f.cf[0]), nxt.op_counter()));
    // ld/hd ops cannot be all 0s except at the first step
    acc.template fold<11>(fmul(fmul(cur.op_counter(), bnot(ld_prod)), bnot(hd_prod)));
    // when cf ops are not all 0s, user ops must be all 1s (NOOP)
    acc.template fold<12>(fmul(cf_sum, bnot(fmul(ld_prod, hd_prod))));
    // VOID can be followed only by VOID: the next state's VOID flag is its
    // cf bits 0, 1 and 2 all set
    const u128 next_void = fmul(fmul(nxt.cf_bits(0), nxt.cf_bits(1)), nxt.cf_bits(2));
    acc.template fold<13>(fmul(f.cf[7], bnot(next_void)));

    // BEGIN, LOOP, WRAP, BREAK on 15 mod 16; TEND, FEND on 0 mod 16; PUSH on 0 mod 8
    u128 v = fmul(fadd(fadd(f.cf[1], f.cf[4]), fadd(f.cf[5], f.cf[6])), mask(1));
    v = agg(v, fadd(f.cf[2], f.cf[3]), mask(0));
    acc.template fold<14>(agg(v, f.hd[0], mask(2)));
}

// The sponge constraints: one hacc sponge round met in the middle, and the
// flow terms (BEGIN, LOOP and WRAP take the next sponge, TEND and FEND its
// last element, BREAK and VOID keep it; TEND and FEND move the first ctx
// element in); then the loop image (WRAP and BREAK)
template <class L, class Ark>
F128_FN void fold_sponge(Combination<L>& acc, const Inputs& in, const State<L>& cur,
                         const DecoderFlags& f, const State<L>& nxt, const Ark& ark) {
    const u128* g = f.cf;            // 1 BEGIN, 2 TEND, 3 FEND, 4 LOOP, 5 WRAP, 6 BREAK, 7 VOID
    const auto s = [&](int i) { return cur.sponge(i); };
    const auto ns = [&](int i) { return nxt.sponge(i); };
    const u128 op_value = fmul(nxt.stack(0), f.hd[0]);
    u128 old_s[4], inv[4];
#pragma unroll
    for (int i = 0; i < 4; i++) old_s[i] = fcube(fadd(s(i), ark(i)));
#pragma unroll
    for (int i = 0; i < 4; i++) inv[i] = mds_row<4>(in.mds + kSpongeInvMds, i, ns);
    const u128 starts = fadd(fadd(g[1], g[4]), g[5]);
    const u128 ends = fadd(g[2], g[3]);
    const u128 keeps = fadd(g[6], g[7]);
    unroll<4>([&](auto k) {
        constexpr int I = decltype(k)::value;
        u128 t = mds_row<4>(in.mds + kSpongeMds, I, [&](int k) { return old_s[k]; });
        if (I == 0) t = fadd(t, op_code(cur));
        if (I == 1) t = fadd(t, op_value);
        const u128 new_s = fsub(fcube(inv[I]), ark(4 + I));
        u128 v = fmul(g[0], fsub(t, new_s));
        v = agg(v, I == 3 ? fadd(starts, ends) : starts, ns(I));
        v = agg(v, keeps, fsub(s(I), ns(I)));
        if (I == 0) v = agg(v, ends, fsub(cur.ctx(0), ns(0)));
        if (I == 1) v = agg(v, g[2], fsub(s(0), ns(1)));
        if (I == 2) v = agg(v, g[3], fsub(s(0), ns(2)));
        acc.template fold<15 + I>(v);
    });
    acc.template fold<19>(fmul(fadd(g[5], g[6]), fsub(s(0), cur.loops(0))));
}

// the ctx and loop stacks
template <class L>
F128_FN void fold_flow_stacks(Combination<L>& acc, const State<L>& cur, const DecoderFlags& f,
                              const State<L>& nxt) {
    const u128* g = f.cf;
    constexpr int cd = L::kCd, ld = L::kLd;
    unroll<cd>([&](auto k) {
        constexpr int I = decltype(k)::value;
        SlotTerms<I> t;
        t.right_shift(cd, 1, g[1]);
        t.left_shift(cd, 1, 1, g[2]);
        t.left_shift(cd, 1, 1, g[3]);
        t.right_shift(cd, 1, g[4]);
#pragma unroll
        for (int j = 5; j < 8; j++) t.copy(cd, 0, g[j]);
        u128 v = t.template apply<cd>([&](int i) { return cur.ctx(i); },
                                      [&](int i) { return nxt.ctx(i); });
        if (I == 0) v = agg(v, fadd(g[1], g[4]), fsub(cur.sponge(0), nxt.ctx(0)));  // BEGIN, LOOP
        acc.template fold<L::kCtx0 + I>(v);
    });
    unroll<ld>([&](auto k) {
        constexpr int I = decltype(k)::value;
        SlotTerms<I> t;
#pragma unroll
        for (int j = 1; j < 4; j++) t.copy(ld, 0, g[j]);
        t.right_shift(ld, 1, g[4]);
        t.copy(ld, 0, g[5]);
        t.left_shift(ld, 1, 1, g[6]);
        t.copy(ld, 0, g[7]);
        acc.template fold<L::kLoop0 + I>(t.template apply<ld>(
            [&](int i) { return cur.loops(i); }, [&](int i) { return nxt.loops(i); }));
    });
}

// user stack ---------------------------------------------------------------------------------

template <class L, class Ark>
F128_FN void fold_stack(Combination<L>& acc, const Inputs& in, const State<L>& cur,
                        const DecoderFlags& d, const StackFlags& f, const State<L>& nxt,
                        const Ark& ark) {
    constexpr int keep = L::kCount - L::kStack0, len = L::kSd;
    const auto olds = [&](int i) { return cur.stack(i); };
    const auto news = [&](int i) { return nxt.stack(i); };
    const u128* ld = f.ld;
    const u128* hd = d.hd;

    // the auxiliary constraints: ASSERT, ASSERTEQ, NOT, AND, OR, EQ and the
    // choices' condition bits
    const u128 diff = fsub(olds(1), olds(2));                        // EQ
    u128 aux = fmul(ld[0], bnot(olds(0)));
    aux = agg(aux, ld[1], fsub(olds(0), olds(1)));
    aux = agg(aux, fadd(fadd(ld[14], ld[10]), ld[11]), is_binary(olds(0)));
    aux = agg(aux, ld[2], fmul(news(0), diff));
    aux = agg(aux, ld[5], is_binary(olds(2)));
    aux = agg(aux, fadd(ld[6], ld[7]), is_binary(olds(4)));
    acc.template fold<L::kAux0>(aux);
    acc.template fold<L::kAux0 + 1>(fmul(fadd(ld[10], ld[11]), is_binary(olds(1))));
    if (keep == 0) return;

    // values the terms of the first slots share.  CHOOSE2 and CSWAP2 select
    // by olds(4); CMP compares bits x = news(1) and y = news(2)
    const u128 c4 = olds(4);
    const u128 o01 = fmul(olds(0), olds(1));
    const u128 m02 = mux(c4, olds(0), olds(2));
    const u128 m13 = keep > 1 ? mux(c4, olds(1), olds(3)) : 0;
    const u128 xy = keep > 2 ? fmul(news(1), news(2)) : 0;
    // RESCR (hd 2): one Rescue round, met in the middle, at slots [0, 6)
    u128 cubes[6];
#pragma unroll
    for (int i = 0; i < 6; i++) cubes[i] = fcube(fadd(olds(i), ark(i)));

    unroll<keep>([&](auto k) {
        constexpr int I = decltype(k)::value;
        SlotTerms<I> t;
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
        u128 v = t.template apply<len>(olds, news);

        // the terms of their own
        if (I == 0) {
            v = agg(v, ld[24], fsub(news(1), olds(0)));                      // SWAP
            v = agg(v, ld[8], fsub(news(0), fadd(olds(0), olds(1))));        // ADD
            v = agg(v, fadd(ld[9], ld[10]), fsub(news(0), o01));             // MUL, AND
            v = agg(v, ld[12], bnot(fmul(news(0), olds(0))));                // INV
            v = agg(v, ld[13], fadd(news(0), olds(0)));                      // NEG
            v = agg(v, ld[14], fsub(news(0), bnot(olds(0))));                // NOT
            // OR: 1 - (1 - a)(1 - b) = a + b - ab
            v = agg(v, ld[11], fsub(news(0), fsub(fadd(olds(0), olds(1)), o01)));
            v = agg(v, ld[2], fsub(news(0), bnot(fmul(diff, olds(0)))));     // EQ
            v = agg(v, ld[29], is_binary(news(0)));                          // BINACC
            v = agg(v, ld[5], fsub(news(0), mux(olds(2), olds(0), olds(1))));  // CHOOSE
            v = agg(v, ld[6], fsub(news(0), m02));                           // CHOOSE2
            // CSWAP2: c * o2 + (1 - c) * o0 = o0 + o2 - m02
            v = agg(v, ld[7], fsub(news(0), fsub(fadd(olds(0), olds(2)), m02)));
            v = agg(v, hd[1], is_binary(news(1)));                           // CMP
        }
        if (I == 1) {
            v = agg(v, ld[6], fsub(news(1), m13));                           // CHOOSE2
            v = agg(v, ld[7], fsub(news(1), fsub(fadd(olds(1), olds(3)), m13)));  // CSWAP2
            v = agg(v, hd[1], is_binary(news(2)));                           // CMP
        }
        if (I == 2) {
            v = agg(v, ld[7], fsub(news(2), m02));                           // CSWAP2
            v = agg(v, ld[29], fsub(news(2), fdouble(olds(2))));             // BINACC
            // CMP: x (1 - y) = x - xy
            v = agg(v, hd[1], fsub(news(4), fadd(olds(4), fmul(fsub(news(1), xy), news(3)))));
        }
        if (I == 3) {
            v = agg(v, ld[7], fsub(news(3), m13));                           // CSWAP2
            v = agg(v, ld[29], fsub(news(3), fadd(olds(3), fmul(news(0), olds(2)))));
            // CMP: y (1 - x) = y - xy
            v = agg(v, hd[1], fsub(news(5), fadd(olds(5), fmul(fsub(news(2), xy), news(3)))));
        }
        if (I == 4) v = agg(v, hd[1], fsub(news(6), fadd(olds(6), fmul(news(2), olds(0)))));
        if (I == 5) v = agg(v, hd[1], fsub(news(7), fadd(olds(7), fmul(news(1), olds(0)))));
        if (I == 6) v = agg(v, hd[1], fsub(news(3), fmul(bnot(olds(5)), bnot(olds(4)))));
        if (I == 7) v = agg(v, hd[1], fsub(fdouble(news(0)), olds(0)));
        if (I < 6) {
            const u128 r = mds_row<6>(in.mds + kHasherMds, I, [&](int k) { return cubes[k]; });
            const u128 inv = mds_row<6>(in.mds + kHasherInvMds, I, news);
            v = agg(v, hd[2], fsub(fsub(fcube(inv), ark(6 + I)), r));
        }
        acc.template fold<L::kStack0 + I>(v);
    });
}

// The combined transition constraint at row j, the current state's registers
// at cur[r * stride] and the next state's at nxt[r * stride].  The periodic
// ARK and mask values of row j are read where they are used.
template <int CTX, int LOOP, int STACK>
F128_FN u128 eval_row(const Inputs& in, const uint4* cur_row, const uint4* nxt_row,
                      long long stride, long long j) {
    using L = Layout<CTX, LOOP, STACK>;
    const State<L> cur{cur_row, stride}, nxt{nxt_row, stride};
    const long long ci = j % in.cycle;
    const auto dec_ark = [&](int k) { return load(in.dec_ark, k * in.cycle + ci); };
    const auto mask = [&](int k) { return load(in.masks, k * in.cycle + ci); };
    const auto stk_ark = [&](int k) { return load(in.stk_ark, k * in.cycle + ci); };

    Combination<L> acc(in.cc);
    const DecoderFlags d = decoder_flags(cur);
    fold_op_bits(acc, cur, d, nxt, mask);
    fold_sponge(acc, in, cur, d, nxt, dec_ark);
    fold_flow_stacks(acc, cur, d, nxt);
    const StackFlags f = stack_flags(cur, d);
    fold_stack(acc, in, cur, d, f, nxt, stk_ark);
    return acc.finish(in, j);
}

}  // namespace air
