"""K2's exp_const, K4's, K6's-K11's, K13's, K15's and K16's design choices
measured on the card, each against the kernel with that one choice undone.

Usage (from the root of the repository, on a machine with the card):

    python -m distaff_torch.tools.air_probe [k4] [k6] [k2exp] [k7] [k8] [k9] [k10] [k11] [k13]
        [k15] [b3] [k16] [--parent-csrc DIR]

(all twelve by default).

K4 at the bench program's depths (1, 0, 4) on the 2^16 Fibonacci LDE slice
(the (20, 2^19) stride-4 view the proof passes) and on a contiguous copy of
it, built as it is and as these variants, each compiled from a patched copy
of distaff_torch/csrc and held equal to the production build:

  ordinary-loads   the rows are staged with ordinary loads (ld.global), not
                   streaming ones (ld.global.cs, evict first)
  u128-multiply    field128.cuh's multiply is its portable u128 code, not
                   the PTX carry chain
  128-registers    __launch_bounds__(128, 4): at most 128 registers a
                   thread, 16 warps an SM instead of 8, more spills

and K6 at 2^14, 2^18, 2^20 and 2^21 split into its phases (builds that
stop after the forward pass, the tree, the inversion: K6_SPLITS), with
the block's product inverted by Kaliski's inverse (production), the
binary extended Euclid, exp_const's x^(2^(2^k) - 1) chain and
square-and-multiply, and at other shapes (K6_VARIANTS), and with
--parent-csrc another checkout's K6 split the same way (probe_k6); K2's
exp_const at M - 2 under its schedule's squarings and multiplies apart,
under square-and-multiply's schedule, built with the squarings as general
multiplies, and the instructions of one squaring and one multiply on each
integer pipe with the per-pipe bounds they give (probe_k2exp); and K7 at
the 2^16 and 2^18 proofs' calls and the
streamed 2^16 proof's with other points an inversion (DEEP_ROUND_PAIRS),
one block an SM, cp.async copies in place of the bulk copies
(WSUM_CP_ASYNC) and other ring depths (WSUM_MAX_STAGES), and built
without its phases (K7_DROPS), and K15 at the streamed 2^16 and 2^22
proofs' calls likewise (probe_k7, probe_k15); K8 at the 2^16
and 2^20 proofs' calls with 8 or 64 coefficients a thread at every size
and without its ticket (probe_k8); and K10 at (20,
2^19) at point strides 1-8 beside PyTorch's copy of each strided slice,
and built without its product, its epilogue or both (probe_k10); K9 at
the 2^16 proof's first, second, third and fifth layers (2^19, 2^17,
2^15 and 2^11 rows) and the 2^18 proof's first (2^21 rows) at four rows a
thread and one (four lanes a leaf), with and without the leaf digests, built with a 64-register cap and
with blocks of 64, 128 or 256 threads at every size (probe_k9); and K11 at the 2^16, 2^18 and 2^20
proofs' step 4 built without its look-back, its R chain, its epilogue,
and with only its loads and scans (probe_k11); and K13 at every tree of
the 2^16 proof and at 2^23-2^25 leaves under other plans (_k13_plans:
other bottom subtrees, other splits of the stages above) and built with
other adds and rotates in its compression (K13_VARIANTS)
(probe_k13); and K3, K9 and K14 built with the compression on the
compiler's adds in place of the FMA pipe's (probe_b3); and K16 at
(4096, 256) and (163840, 256) with its even digits' k-steps as two
m16n8k16, and built with its products alone and its reductions alone,
K1 beside (probe_k16).  Times
come from CUDA events around calls queued behind a spin kernel
(tools/timing.time_ms); ptxas' spill line of each build is printed.  Any
difference from the production build raises (but K10's, K11's, K16's
split builds and the K7_DROPS and K15_DROPS builds, which drop work by
design).
"""

import argparse
import ctypes
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import air_kernels, cuda_lib
from .timing import card_line, random_elements, time_ms

BENCH_DEPTHS = (1, 0, 4)
MUL_DEVICE = "#ifdef __CUDA_ARCH__\n    return from_limbs(mul_limbs(to_limbs(a), to_limbs(b)));\n#else"
STAGE = "rows[e] = __ldcs(in.trace + row * in.row_stride + r * in.reg_stride);"
BOUNDS = "__launch_bounds__(kThreads)"
# variant: a patch, (file, text, replacement)
K4_VARIANTS = {
    "ordinary-loads": ("air_transition.cu", STAGE,
                       "rows[e] = in.trace[row * in.row_stride + r * in.reg_stride];"),
    "u128-multiply": ("field128.cuh", MUL_DEVICE, "#if 0\n#else"),
    "128-registers": ("air_transition.cu", BOUNDS, "__launch_bounds__(kThreads, 4)"),
}
# K7's and K15's variants: (patches, -D definitions); ONE_BLOCK gives a
# block the whole SM's shared memory (the ring's two-block layout refused)
ONE_BLOCK = ("wsum_product.cuh",
             "l.stages = (kSharedPerSM / 2 - kReserved - fixed) / l.slot_bytes;", "l.stages = 0;")
WSUM_VARIANTS = {
    "cp.async copies in place of the bulk copies": ((), ("WSUM_CP_ASYNC",)),
    "one block an SM": ((ONE_BLOCK,), ()),
    "one block an SM, cp.async copies": ((ONE_BLOCK,), ("WSUM_CP_ASYNC",)),
    "one block an SM, at most 2 stages": ((ONE_BLOCK,), ("WSUM_MAX_STAGES=2",)),
    "at most 4 stages": ((), ("WSUM_MAX_STAGES=4",)),
}
K7_VARIANTS = {
    "512 points an inversion": ((), ("DEEP_ROUND_PAIRS=2",)),
    "2048 points an inversion": ((), ("DEEP_ROUND_PAIRS=8",)),
    "one inversion a block": ((), ("DEEP_ROUND_PAIRS=1073741824",)),
    **WSUM_VARIANTS,
}
# builds that drop phases of K7 or K15 (their outputs are wrong by design
# and are not held), so that the time splits into the phases
NO_PRODUCT = ("wsum_product.cuh",
              "        product(l.pitch, group_regs(s.regs, l.group, at.g), shared_address(a_s),\n"
              "                shared_address(b_s + at.slot * l.slot_bytes), warp & 1, warp >> 1, "
              "lane, acc,\n                RunB());", "")
NO_WALK = ("deep_compose.cu", "walk_back(a, blockIdx.x, gridDim.x, mine, k >> 1, tid,\n"
           "                      inv_block::inverse_of_total<kThreads>(sums, q));",
           "inv_block::inverse_of_total<kThreads>(sums, q);")
NO_INVERSION = ("deep_compose.cu", "inv_block::inverse_of_total<kThreads>(sums, q));", "q);")
NO_FORWARD = ("deep_compose.cu", "if (i >= 0) forward(a, sums, i, tid, in, q);",
              "if (i >= 0) a.out[i] = in.c;")
NO_REDUCE = ("deep_compose.cu", "keep_sum(sums, k, digits, tid);", "(void)digits;")
NO_TREE = ("deep_compose.cu", "inv_block::inverse_of_total<kThreads>(sums, q);", "")
K7_DROPS = {
    "without the inversion": (NO_INVERSION,),
    "without the walk back": (NO_WALK,),
    "without the forward": (NO_FORWARD,),
    "copies, product and reductions only": (NO_FORWARD, NO_WALK, NO_TREE),
    "copies and reductions only": (NO_FORWARD, NO_WALK, NO_TREE, NO_PRODUCT),
    "copies only": (NO_FORWARD, NO_WALK, NO_TREE, NO_PRODUCT, NO_REDUCE),
}
K15_DROPS = {
    "copies and product only": (("coeff_wsum.cu", "store(a, blockIdx.x + k * gridDim.x, digits, "
                                 "threadIdx.x);", "(void)k; (void)digits;"),),
    "copies only": (("coeff_wsum.cu", "store(a, blockIdx.x + k * gridDim.x, digits, "
                     "threadIdx.x);", "(void)k; (void)digits;"), NO_PRODUCT),
}
# K6: builds that stop after a phase (not held: their outputs are wrong by
# design), so that the time splits into the forward pass, the tree, the
# inversion and the backward pass; builds with other inversions of the
# block's product and other shapes (held equal)
K6_TREE = "const u128 inv_q = inv_batch::invert_total(q, tree);"
K6_BACK = "inv_batch::backward(g, b, tid, count, inv_q);"
K6_ROOT = "f128::inv(f128::from_limbs(shared[kWarps]))"
K6_KEEP = "if (count > 0) g.out[inv_batch::element(g, b, tid, 0)] = f128::to_limbs(inv_q);"
K6_SPLITS = {
    "forward only": (("inv_batch.cu", K6_TREE, "const u128 inv_q = q;"),
                     ("inv_batch.cu", K6_BACK, K6_KEEP)),
    "forward and tree": (("inv_batch.cuh", K6_ROOT, "f128::from_limbs(shared[kWarps])"),
                         ("inv_batch.cu", K6_BACK, K6_KEEP)),
    "forward, tree and inversion": (("inv_batch.cu", K6_BACK, K6_KEEP),),
    "all but the inversion": (("inv_batch.cuh", K6_ROOT, "f128::from_limbs(shared[kWarps])"),),
}
# the Fermat inverse w^(M - 2) by exp_const's schedule for M - 2: t_k =
# w^(2^(2^k) - 1) for k <= 6, then 82 = 64 + 16 + 2 ones, 010010, 40 = 32 + 8
# ones; 127 squarings on sqr_limbs and 12 multiplies
FERMAT_CHAIN = (
    "[&] {\n"
    "    u128 t[7], r = f128::from_limbs(shared[kWarps]);\n"
    "    t[0] = r;\n"
    "    for (int k = 0; k < 6; ++k) {\n"
    "        for (int j = 0; j < (1 << k); ++j) r = f128::sqr(r);\n"
    "        t[k + 1] = r = f128::mul(r, t[k]);\n"
    "    }\n"
    "    const int squarings[6] = {16, 2, 2, 3, 33, 8}, entry[6] = {4, 1, 0, 0, 5, 3};\n"
    "    for (int s = 0; s < 6; ++s) {\n"
    "        for (int j = 0; j < squarings[s]; ++j) r = f128::sqr(r);\n"
    "        r = f128::mul(r, t[entry[s]]);\n"
    "    }\n"
    "    return r;\n"
    "}()")
# the block's product inverted by lane 0 of warp 0 ahead of the shuffle that
# broadcasts it, in place of thread 0 between two barriers
K6_IN_WARP = ("inv_batch.cuh", """        __syncwarp();
        if (lane < kWarps) shared[lane] = f128::to_limbs(other_warps);
        if (lane == 0) shared[kWarps] = f128::to_limbs(w);
    }
    __syncthreads();
    if (threadIdx.x == 0)
        shared[kWarps] = f128::to_limbs(f128::inv(f128::from_limbs(shared[kWarps])));
    others = f128::mul(others, f128::from_limbs(shared[warp]));""", """        u128 inv = 0;
        if (lane == 0) inv = f128::inv(w);
        uint4 r = f128::to_limbs(inv);
        r.x = __shfl_sync(0xFFFFFFFFu, r.x, 0);
        r.y = __shfl_sync(0xFFFFFFFFu, r.y, 0);
        r.z = __shfl_sync(0xFFFFFFFFu, r.z, 0);
        r.w = __shfl_sync(0xFFFFFFFFu, r.w, 0);
        if (lane < kWarps)
            shared[lane] = f128::to_limbs(f128::mul(f128::from_limbs(r), other_warps));
        if (lane == 0) shared[kWarps] = f128::to_limbs(1);
    }
    __syncthreads();
    others = f128::mul(others, f128::from_limbs(shared[warp]));""")
# Kaliski's inverse one bit a step (a halving or a subtraction and a
# halving), in place of a subtraction and all the trailing zeros a step
K6_ONE_BIT = ("field128.cuh", """    int k = trailing_zeros(a);
    u128 u = m_, v = a >> k, r = 0, s = 1;
    while (u != v) {
        int t;
        if (u > v) {
            u -= v;
            t = trailing_zeros(u);
            u >>= t;
            r += s;
            s <<= t;
        } else {
            v -= u;
            t = trailing_zeros(v);
            v >>= t;
            s += r;
            r <<= t;
        }
        k += t;
    }
""", """    u128 u = m_, v = a, r = 0, s = 1;
    int k = 0;
    while (u != v) {
        if ((u & 1) == 0) {
            u >>= 1;
            s <<= 1;
        } else if ((v & 1) == 0) {
            v >>= 1;
            r <<= 1;
        } else if (u > v) {
            u = (u - v) >> 1;
            r += s;
            s <<= 1;
        } else {
            v = (v - u) >> 1;
            s += r;
            r <<= 1;
        }
        ++k;
    }
""")
# the binary extended Euclid (the parent's f128::inv): u = w, v = M with x1 w
# = u and x2 w = v (mod M); halvings of u or v with modular halvings of x1
# or x2, and subtractions, until u or v is 1
EUCLID = (
    "[&] {\n"
    "    const u128 half = (f128::modulus() >> 1) + 1;\n"
    "    u128 u = f128::from_limbs(shared[kWarps]), v = f128::modulus(), x1 = 1, x2 = 0;\n"
    "    while (u != 1 && v != 1) {\n"
    "        while ((u & 1) == 0) {\n"
    "            u >>= 1;\n"
    "            x1 = (x1 & 1) ? (x1 >> 1) + half : x1 >> 1;\n"
    "        }\n"
    "        while ((v & 1) == 0) {\n"
    "            v >>= 1;\n"
    "            x2 = (x2 & 1) ? (x2 >> 1) + half : x2 >> 1;\n"
    "        }\n"
    "        if (u >= v) {\n"
    "            u -= v;\n"
    "            x1 = f128::sub(x1, x2);\n"
    "        } else {\n"
    "            v -= u;\n"
    "            x2 = f128::sub(x2, x1);\n"
    "        }\n"
    "    }\n"
    "    return u == 1 ? x1 : x2;\n"
    "}()")
K6_MIN = "constexpr long long kMinElements = 16;"
# variant: patches (each held equal)
K6_VARIANTS = {
    "the block's inverse by Kaliski's steps of one bit": (K6_ONE_BIT,),
    "the block's inverse by the binary extended Euclid (the parent's)": (
        ("inv_batch.cuh", K6_ROOT, EUCLID),),
    "the block's inverse by the x^(2^(2^k) - 1) chain (139 operations)": (
        ("inv_batch.cuh", K6_ROOT, FERMAT_CHAIN),),
    "the block's inverse by square-and-multiply (250 multiplies)": (
        ("inv_batch.cuh", K6_ROOT,
         "f128::pow(f128::from_limbs(shared[kWarps]), f128::modulus() - 2)"),),
    "the loops not unrolled": (
        ("inv_batch.cuh", "constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;"),),
    "at least 8 elements a thread": (("inv_batch.cu", K6_MIN, K6_MIN.replace("16", "8")),),
    "at least 32 elements a thread": (("inv_batch.cu", K6_MIN, K6_MIN.replace("16", "32")),),
    "as few elements a thread as fill the resident blocks": (
        ("inv_batch.cu", K6_MIN, K6_MIN.replace("16", "1")),),
    "the inversion in warp 0, ahead of a shuffle": (K6_IN_WARP,),
}
# the parent's K6 (inv_block.cuh's tree, prefixes through out), built from
# another checkout's csrc (--parent-csrc) and split the same way
K6_PARENT_TREE = "u128 inv_q = inv_block::inverse_of_total<kThreads>(tree, run);"
K6_PARENT_KEEP = " if (n > 0) { out[first] = f128::to_limbs(inv_q); return; }"
K6_PARENT_ROOT = ("inv_block.cuh", "tree[1] = f128::inv(tree[1]);", "")
K6_PARENT_SPLITS = {
    "forward only": (("inv_batch.cu", K6_PARENT_TREE, "u128 inv_q = run;" + K6_PARENT_KEEP),),
    "forward and tree": (("inv_batch.cu", K6_PARENT_TREE, K6_PARENT_TREE + K6_PARENT_KEEP),
                         K6_PARENT_ROOT),
    "forward, tree and inversion": (("inv_batch.cu", K6_PARENT_TREE,
                                     K6_PARENT_TREE + K6_PARENT_KEEP),),
    "all but the inversion": (K6_PARENT_ROOT,),
    "as it is": (),
}
# K2 exp_const: builds with the squarings as general multiplies (held),
# and with one more squaring or multiply a step, whose SASS less the
# production build's is one operation's instructions (not held)
EXP_SQR = "for (int j = 0; j < arg; ++j) acc = f128::sqr(acc);"
EXP_MUL = "acc = f128::mul(acc, table[arg]);"
EXP_VARIANTS = {
    "squarings as general multiplies": (
        ("field_ew.cu", EXP_SQR, "for (int j = 0; j < arg; ++j) acc = f128::mul(acc, acc);"),),
}
EXP_EXTRA = {
    "squaring": (("field_ew.cu", EXP_SQR,
                  "for (int j = 0; j < arg; ++j) acc = f128::sqr(f128::sqr(acc));"),),
    "multiply": (("field_ew.cu", EXP_MUL,
                  "acc = f128::mul(f128::mul(acc, table[arg]), table[arg]);"),),
}
K10_PRODUCT = ("boundary_columns.cu",
               "wsum::product(l.pitch, group_regs(a, l, at.g), shared_address(a_s),\n"
               "                      shared_address(b_s + at.slot * l.slot_bytes), warp & 3, "
               "warp >> 2, lane,\n                      acc, PointB{l.pitch});", "")
K10_EPILOGUE = ("boundary_columns.cu",
                "if ((tid & 1) == 0) finish(a, at.tile, tid, value, f128::from_limbs(v));", "")
K8_CHOICE = "const int log = log_per_thread(rows, len);"
# variant: patches
K8_VARIANTS = {
    "8 coefficients a thread at every size": (
        ("poly_eval.cu", K8_CHOICE, "const int log = kShortLog;"),),
    "64 coefficients a thread at every size": (
        ("poly_eval.cu", K8_CHOICE, "const int log = kLongLog;"),),
    "no ticket": (("poly_eval.cu",
                   "last = atomicAdd(a.tickets + row, 1u) == (unsigned)a.blocks - 1;",
                   "last = 0;"),),
}
# variant: (patches, -D definitions)
K9_BLOCK = "return threads(a) >= 2LL * sms * kThreads ? kThreads : kSmallThreads;"
K9_VARIANTS = {
    "64-register cap": ((("fri_fold.cu", "__launch_bounds__(kThreads)\n",
                          "__launch_bounds__(kThreads, 65536 / (64 * kThreads))\n"),), ()),
    "blocks of 64 threads at every size": ((("fri_fold.cuh", K9_BLOCK,
                                             "return kSmallThreads;"),), ()),
    "blocks of 128 threads at every size": ((("fri_fold.cuh", K9_BLOCK, "return 128;"),), ()),
    "blocks of 256 threads at every size": ((("fri_fold.cuh", K9_BLOCK, "return kThreads;"),),
                                            ()),
}
K11_LOOK_BACK = ("syn_div.cu", "        look_back(g, tile, lane, carry);\n",
                 "        carry[0] = carry[1] = 0;\n")
K11_R_CHAIN = (("syn_div.cu", "    if (tid == 0) wait_r(g, tile);\n", ""),
               ("syn_div.cu", "    store_r(g, s, tile, tid);\n", ""))
K11_EPILOGUE = ("syn_div.cu", "    finish(g, s, tile, tid, after);\n", "")
# variant: (patches, -D definitions); those with patches drop work (their
# outputs are not held), the other tiles are held equal
K11_VARIANTS = {
    "no look-back": ((K11_LOOK_BACK,), ()),
    "no R chain": (K11_R_CHAIN, ()),
    "no epilogue": ((K11_EPILOGUE,), ()),
    "look-back alone (no R chain, no epilogue)": ((*K11_R_CHAIN, K11_EPILOGUE), ()),
    "loads and scans alone": ((K11_LOOK_BACK, *K11_R_CHAIN, K11_EPILOGUE), ()),
    "tile 2048, 256 threads x 8": ((), ("SYN_DIV_PER_THREAD=8",)),
    "tile 512, 128 threads x 4": ((), ("SYN_DIV_THREADS=128",)),
}
K11_MIN_TILE = 512
# K13's compression (csrc/merkle_tree.cuh, blake3.cuh): variant -> patches
K13_HASH = "    blake3::hash_block(cv, msg);\n"


# a policy whose rotates in kRotates (bit 0 by 16, 1 by 12, 2 by 8, 3 by 7)
# also leave the integer-only pipe: the halves of the 64-bit product
# x 2^(32 - n) (IMAD.WIDE) added by an IMAD
B3_FMA_ROTATES = ("blake3.cuh", "#define B3_G(add, a, b, c, d, mx, my)", r"""
template <int kRotates>
struct FmaRotates : FmaAdds {
    template <int n>
    F128_FN uint32_t rot(uint32_t x) const {
        constexpr int bit = n == 16 ? 0 : n == 12 ? 1 : n == 8 ? 2 : 3;
        if (!((kRotates >> bit) & 1)) return rotr(x, n);
#ifdef __CUDA_ARCH__
        uint32_t lo, hi;
        asm("{\n\t.reg .u64 t;\n\tmul.wide.u32 t, %2, %3;\n\tmov.b64 {%0, %1}, t;\n\t}"
            : "=r"(lo), "=r"(hi) : "r"(x), "r"(one << (32 - n)));
        return (*this)(lo, hi);
#else
        return rotr(x, n);
#endif
    }
};

#define B3_G(add, a, b, c, d, mx, my)""")


def _k13_hash(column, diagonal):
    """Patches of K13's node hash onto these add policies of the column and
    the diagonal steps (FmaRotates<mask> moves rotates too)."""
    return (B3_FMA_ROTATES,
            ("merkle_tree.cuh", K13_HASH,
             f"    {{ const blake3::{column} c{{{{blake3::one()}}}}; const blake3::{diagonal} "
             f"d{{{{blake3::one()}}}}; blake3::hash_block(cv, msg, c, d); }}\n"))


K13_VARIANTS = {
    "the compiler's adds (AluAdds, the parent's)": (
        ("merkle_tree.cuh", K13_HASH,
         "    blake3::hash_block(cv, msg, blake3::AluAdds{}, blake3::AluAdds{});\n"),),
    "three-input adds as IADD3, two-input as IMAD": (
        ("blake3.cuh", "        return (*this)((*this)(x, y), z);", "        return x + y + z;"),),
    "the first round's column step on IMAD too": (
        ("blake3.cuh", "compress(cv, m, 0, 64, kChunkStart | kChunkEnd | kRoot, AluAdds{}, column,",
         "compress(cv, m, 0, 64, kChunkStart | kChunkEnd | kRoot, column, column,"),),
    "rotates by 7 on the FMA pipe": _k13_hash("FmaRotates<8>", "FmaRotates<8>"),
    "the diagonal steps' rotates by 7 on the FMA pipe": _k13_hash("FmaAdds", "FmaRotates<8>"),
    "the diagonal steps' rotates by 16 on the FMA pipe": _k13_hash("FmaAdds", "FmaRotates<1>"),
    "the diagonal steps' rotates by 16 and 7 on the FMA pipe": _k13_hash("FmaAdds",
                                                                        "FmaRotates<9>"),
    "rotates by 16 and 7 on the FMA pipe": _k13_hash("FmaRotates<9>", "FmaRotates<9>"),
}
K13_SIZES = [1 << k for k in (25, 24, 23, 21, 20, 19, 17, 15, 13, 11, 9, 7, 5)]


def _upper_split(plan, cap):
    """The plan with its stages above the first split evenly into stages
    of at most `cap` levels."""
    rest = sum(plan[1:])
    stages = -(-rest // cap)
    return plan[:1] + [rest // stages + (i < rest % stages) for i in range(stages)]


def _k13_plans(sms):
    """K13's plans by name: n -> levels of each stage (None: production)."""
    from ..ops import blake3_torch as b3

    return {
        "production (one block up to 2^9 leaves, else a block an SM, bottom 2^8 at least, "
        "11 levels a stage above)": None,
        **{f"bottom 2^{m} at least": (lambda n, m=m: b3.tree_plan(n, sms, min_bottom=m))
           for m in (6, 7, 9, 10)},
        **{f"{k} blocks an SM": (lambda n, k=k: b3.tree_plan(n, sms, blocks_per_sm=k))
           for k in (2, 4)},
        "bottom 2^11 (0 blocks an SM)": lambda n: b3.tree_plan(n, sms, blocks_per_sm=0),
        **{f"stages above of at most {c} levels": (
            lambda n, c=c: _upper_split(b3.tree_plan(n, sms), c)) for c in (3, 5, 9)},
    }


# K3, K9 and K14 built with the parent's compression: blake3.cuh's defaults
# on the compiler's adds (AluAdds) in place of FmaAdds
B3_ALU = (("blake3.cuh", "    const FmaAdds adds{one()};\n    compress(",
           "    const AluAdds adds;\n    compress("),
          ("blake3.cuh", "    const FmaAdds adds{one()};\n    hash_block(",
           "    const AluAdds adds;\n    hash_block("))


# variant: patches
K10_VARIANTS = {
    "copies only": (K10_PRODUCT, K10_EPILOGUE),
    "copies and product": (K10_EPILOGUE,),
    "copies and epilogue": (K10_PRODUCT,),
}


# the SASS opcode mix of each variant build, and its SASS, by name
BUILD_OPCODES = {}
BUILD_SASS = {}


def _build(name, source, patches=(), defines=(), csrc=None):
    """A copy of csrc (or of another checkout's csrc directory) with the
    (file, text, replacement) `patches` applied, `source` built into a
    library: (ctypes handle, ptxas' spill lines)."""
    work = Path(tempfile.mkdtemp(prefix=f"air_probe-{name}-"))
    try:
        for f in Path(csrc or cuda_lib.CSRC).glob("*.cu*"):
            shutil.copy(f, work)
        for file, old, new in patches:
            text = (work / file).read_text()
            if old not in text:
                raise RuntimeError(f"air_probe: {name}: the text to patch is not in {file}")
            (work / file).write_text(text.replace(old, new))
        command = cuda_lib.compile_command(work / source)
        command = command[:command.index("-c")] + [f"-D{d}" for d in defines] + [
            "-shared", str(work / source), "-o", str(work / "lib.so")]
        proc = subprocess.run([str(c) for c in command], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"air_probe: {name} failed to build:\n{proc.stderr[-3000:]}")
        spills = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                  if "spill" in line or "registers" in line]
        text = cuda_lib.sass_file(work / "lib.so")
        if text is not None:
            BUILD_OPCODES[name] = cuda_lib.opcode_counts(text)
            BUILD_SASS[name] = text
        return ctypes.CDLL(str(work / "lib.so")), spills
    finally:
        shutil.rmtree(work, ignore_errors=True)      # the loaded library stays mapped


def _fibonacci_case():
    from .. import assembly, native, ProgramInputs
    from ..stark.constraints.device_eval import air_tables
    from ..stark.constraints.evaluator import Evaluator
    from ..stark.trace_table import TraceTable

    inputs = ProgramInputs.from_public([1, 0])
    program = assembly.compile(f"begin repeat.{(1 << 16) * 3 // 64} swap dup.2 drop add end end")
    regs, ctx, loop = native.execute_u64(program, inputs)
    trace = TraceTable(regs, ctx, loop, 32)
    trace.extend("cuda")
    evaluator = Evaluator.from_trace(trace, trace.build_merkle_tree("blake3").root(),
                                     inputs.get_public_inputs(),
                                     trace.get_last_state().user_stack[:1])
    lde = trace.lde_dev[:, ::4]
    if (ctx, loop, evaluator.stack_depth) != BENCH_DEPTHS:
        raise RuntimeError(f"air_probe: the bench program's depths are {(ctx, loop)}")
    return lde, air_tables(evaluator, "cuda")


def probe_k4():
    lde, t = _fibonacci_case()
    layouts = (("LDE slice", lde), ("contiguous copy", lde.contiguous()))
    want, _ = air_kernels.air_transition(lde, t)
    spills = [line for line in air_kernels.ptxas_report(BENCH_DEPTHS) if "spill" in line]
    print(f"K4 production: {spills[0].strip()}", flush=True)
    for layout, x in layouts:
        ms = time_ms(lambda: air_kernels.air_transition(x, t), 20, 7, queued=True)
        print(f"K4 production, {layout}: {ms:.4f} ms", flush=True)
    defines = [f"AIR_{k}={v}" for k, v in zip(("CTX", "LOOP", "STACK"), BENCH_DEPTHS)]
    with ThreadPoolExecutor(len(K4_VARIANTS)) as pool:
        built = dict(zip(K4_VARIANTS, pool.map(
            lambda kv: _build(kv[0], "air_transition.cu", (kv[1],), defines),
            K4_VARIANTS.items())))
    p, n = cuda_lib.ptr, lde.shape[1]
    for name, (handle, spills) in built.items():
        fn = handle.distaff_air_transition
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       *[ctypes.c_void_p] * 3, ctypes.c_int, *[ctypes.c_void_p] * 2,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, *[ctypes.c_void_p] * 2,
                       ctypes.c_int, *[ctypes.c_void_p] * 2, ctypes.c_longlong,
                       ctypes.c_longlong, *[ctypes.c_void_p] * 2]
        fn.restype = ctypes.c_int

        def run(x):
            out = torch.empty((n, 4), dtype=torch.uint32, device="cuda")
            bad = torch.zeros((1,), dtype=torch.int32, device="cuda")
            cuda_lib.check(fn(p(x), n, x.stride(0) // 4, x.stride(1) // 4, p(t.dec_ark),
                              p(t.masks), p(t.stk_ark), t.dec_ark.shape[1], p(t.mds), p(t.cc),
                              *air_kernels.series_args(t), p(out), p(bad), 0, n,
                              ctypes.c_void_p(None), cuda_lib.stream(x)), name)
            return out

        print(f"K4 {name}: {'; '.join(spills)}", flush=True)
        for layout, x in layouts:
            if not torch.equal(run(x), want):
                raise AssertionError(f"air_probe: K4 {name} differs from the production build")
            ms = time_ms(lambda: run(x), 20, 7, queued=True)
            print(f"K4 {name}, {layout}: {ms:.4f} ms", flush=True)


def _inv_entry(handle):
    fn = handle.distaff_inv_batch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(a):
        out = torch.empty_like(a)
        cuda_lib.check(fn(cuda_lib.ptr(a), cuda_lib.ptr(out), a.shape[0], cuda_lib.stream(a)),
                       "inv_batch (probe build)")
        return out
    return run


K6_SIZES = (14, 18, 20, 21)


def probe_k6(parent_csrc=None):
    """K6 at 2^14, 2^18, 2^20 and 2^21 elements: the production build, the
    builds of K6_SPLITS (stopped after a phase), then K6_VARIANTS (held
    equal); with a parent checkout's csrc, its K6 split the same way
    (K6_PARENT_SPLITS).  Each build's ptxas line and SASS mix (IMAD's forms,
    the integer-only pipe's) is printed."""
    from ..ops import field_kernels as fk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    xs = {k: random_elements(gen, (1 << k,)) for k in K6_SIZES}
    want = {k: fk.inv_batch(a) for k, a in xs.items()}
    sass = cuda_lib.sass("inv_batch")
    if sass is not None:
        mix = cuda_lib.opcode_counts(cuda_lib.function_sass(sass, "inv_batch_kernel"),
                                     cuda_lib.MULTIPLY_OPCODES)
        print(f"K6 production SASS: {mix}", flush=True)
    print("K6 production: " + ", ".join(
        f"2^{k} {time_ms(lambda a=a: fk.inv_batch(a), 50, 7, queued=True):.4f} ms"
        for k, a in xs.items()), flush=True)
    builds = {f"split: {name}": (patches, (), None, False) for name, patches in K6_SPLITS.items()}
    builds.update({name: (patches, (), None, True) for name, patches in K6_VARIANTS.items()})
    if parent_csrc:
        builds.update({f"parent, {name}": (patches, (), parent_csrc, name == "as it is")
                       for name, patches in K6_PARENT_SPLITS.items()})
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(
            lambda kv: _build(f"k6-{list(builds).index(kv[0])}", "inv_batch.cu", kv[1][0],
                              kv[1][1], kv[1][2]), builds.items())))
    for k, (name, (handle, spills)) in enumerate(built.items()):
        run, held = _inv_entry(handle), builds[name][3]
        text = BUILD_SASS.get(f"k6-{k}")
        mix = cuda_lib.opcode_counts(cuda_lib.function_sass(text, "inv_batch_kernel"),
                                     cuda_lib.MULTIPLY_OPCODES) if text else None
        times = []
        for log_n, a in xs.items():
            if held and not torch.equal(run(a), want[log_n]):
                raise AssertionError(f"air_probe: K6 {name} differs at 2^{log_n}")
            times.append(f"2^{log_n} {time_ms(lambda a=a: run(a), 50, 7, queued=True):.4f} ms")
        print(f"K6 {name}: {', '.join(times)}{' (held equal)' if held else ''}; "
              f"{'; '.join(spills)}; SASS {mix}", flush=True)


def _exp_entry(handle):
    fn = handle.distaff_field_exp
    fn.argtypes = cuda_lib.lib().distaff_field_exp.argtypes
    fn.restype = ctypes.c_int

    def run(a, steps):
        out = torch.empty_like(a)
        words = (ctypes.c_uint16 * len(steps))(*[op << 8 | arg for op, arg in steps])
        cuda_lib.check(fn(cuda_lib.ptr(a), cuda_lib.ptr(out), a.shape[0], words, len(steps),
                          cuda_lib.stream(a)), "exp_const (probe build)")
        return out
    return run


def probe_k2exp():
    """K2's exp_const at e = M - 2 (2^18, 2^20, 2^21 elements): the
    production build under its schedule, under the schedule's squarings
    alone and its multiplies alone, and under square-and-multiply's
    schedule (the sliding window of 1 bit: 127 squarings, 123 multiplies);
    the build with the squarings as general multiplies (EXP_VARIANTS, held
    equal) under both schedules; then the instructions of one squaring and
    of one multiply on each pipe (the SASS of exp_kernel built with one
    more of each, less the production build's: EXP_EXTRA), and the
    per-pipe bound of each schedule and of K6's 3 multiplies an element at
    64 lanes an SM."""
    from ..ops import field_kernels as fk

    e = fk.M - 2
    chain = fk.exp_schedule(e)
    binary = fk.window_schedule(e, 1)
    schedules = {
        "the schedule (127 squarings, 12 multiplies)": chain,
        "its squarings alone": [st for st in chain if st[0] != fk.EXP_MUL],
        "its multiplies alone": [st for st in chain if st[0] != fk.EXP_SQR],
        "square-and-multiply (127 squarings, 123 multiplies)": binary,
    }
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    xs = {k: random_elements(gen, (1 << k,)) for k in (18, 20, 21)}
    want = {k: fk.exp_const(a, e) for k, a in xs.items()}
    production = _exp_entry(cuda_lib.lib())
    builds = {**EXP_VARIANTS, **{f"one more {op}": patches for op, patches in EXP_EXTRA.items()}}
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(
            lambda kv: _build(f"exp-{list(builds).index(kv[0])}", "field_ew.cu", kv[1]),
            builds.items())))
    runs = {"production": production, **{name: _exp_entry(built[name][0]) for name in EXP_VARIANTS}}
    for build, run in runs.items():
        for name, steps in schedules.items():
            if name in (list(schedules)[0], list(schedules)[3]):
                for k, a in xs.items():
                    if not torch.equal(run(a, steps), want[k]):
                        raise AssertionError(f"air_probe: exp_const {build}, {name} differs")
            elif build != "production":
                continue
            times = ", ".join(
                f"2^{k} {time_ms(lambda a=a: run(a, steps), 5, 7, queued=True):.4f} ms"
                for k, a in xs.items())
            print(f"exp_const {build}, {name}: {times}", flush=True)
    text = cuda_lib.sass("field_ew")
    if text is None:
        print("exp_const: no cuobjdump found, instructions not counted", flush=True)
        return
    base = cuda_lib.pipe_counts(cuda_lib.function_sass(text, "exp_kernel"))
    mix = cuda_lib.opcode_counts(cuda_lib.function_sass(text, "exp_kernel"),
                                 cuda_lib.MULTIPLY_OPCODES)
    print(f"exp_kernel production SASS: {mix}; FMA pipe {base[0]}, integer-only pipe {base[1]}",
          flush=True)
    per_op = {}
    for op in EXP_EXTRA:
        name = f"exp-{list(builds).index(f'one more {op}')}"
        extra = cuda_lib.pipe_counts(cuda_lib.function_sass(BUILD_SASS[name], "exp_kernel"))
        per_op[op] = (extra[0] - base[0], extra[1] - base[1])
        print(f"one {op}: FMA pipe {per_op[op][0]}, integer-only pipe {per_op[op][1]} "
              f"instructions", flush=True)
    rate = _pipe_rate()
    n = 1 << 21
    for name, (squarings, multiplies) in (
            ("exp_const, the schedule", fk.exp_schedule_ops(chain)),
            ("exp_const, square-and-multiply", fk.exp_schedule_ops(binary)),
            ("K6, 3 multiplies an element", (0, 3))):
        pipes = [squarings * per_op["squaring"][p] + multiplies * per_op["multiply"][p]
                 for p in (0, 1)]
        print(f"per-pipe bound of {name} at 2^21: FMA pipe {n * pipes[0] / rate * 1e3:.4f} ms, "
              f"integer-only pipe {n * pipes[1] / rate * 1e3:.4f} ms", flush=True)


def _pipe_rate():
    """Instructions a pipe of 64 lanes an SM issues a second, at the card's
    maximum SM clock."""
    clock_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count * 64 * float(clock_mhz) * 1e6


def _k7_case(regs, n, seed):
    from ..math import field as hostfield
    from ..math import field_torch as ft
    from ..stark import utils

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lde, c_lde = random_elements(gen, (regs, n)), random_elements(gen, (n,))
    w1, w2 = (random_elements(gen, (regs,)) for _ in range(2)) if regs > 2 else (
        ft.from_ints([1, 0], "cuda"), ft.from_ints([0, 1], "cuda"))
    scalars = [int.from_bytes(bytes([k + 1] * 16), "little") % hostfield.M for k in range(8)]
    return (lde, c_lde, w1, w2, hostfield.get_root_of_unity(n),
            utils.get_incremental_trace_degree(n // 32), scalars)


def probe_k7():
    """K7 at the 2^16 and 2^18 proofs' calls ((20, 2^21), (20, 2^23)) and the
    streamed 2^16 proof's ((2, 2^21), weights (1, 0) and (0, 1)) on random
    values: the production build (bulk copies, 2048 points an inversion,
    two blocks an SM at R = 20), then each build of K7_VARIANTS (points an
    inversion, one block an SM, cp.async copies, ring depth), held equal
    and timed."""
    from ..ops import deep_kernels as dk

    cases = [_k7_case(regs, n, 7 + regs) for regs, n in ((20, 1 << 21), (20, 1 << 23),
                                                           (2, 1 << 21))]
    wants = [dk.deep_compose(*case) for case in cases]
    spills = [line.strip() for line in cuda_lib.ptxas_report("deep_compose")
              if "spill" in line or "registers" in line]
    times = [time_ms(lambda: dk.deep_compose(*case), 20, 7, queued=True) for case in cases]
    print(f"K7 production: {'; '.join(spills)}; " + ", ".join(
        f"({c[0].shape[0]}, {c[0].shape[1]}) {ms:.4f} ms" for c, ms in zip(cases, times)),
        flush=True)
    builds = {**K7_VARIANTS, **{name: (patches, ()) for name, patches in K7_DROPS.items()}}
    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(builds, pool.map(
            lambda kv: _build(kv[0].replace(" ", "-").replace(",", ""), "deep_compose.cu",
                              *kv[1]), builds.items())))
    p, nul = cuda_lib.ptr, ctypes.c_void_p(None)
    for name, (handle, spills) in built.items():
        fn = handle.distaff_deep_compose
        fn.argtypes = cuda_lib.lib().distaff_deep_compose.argtypes
        fn.restype = ctypes.c_int
        line = []
        for case, want in zip(cases, wants):
            lde, c_lde, w1, w2, root, incr, scalars = case
            stride, regs, n, tables, words = dk.compose_args(lde, root, incr, scalars)

            def run():
                out = torch.empty((n, 4), dtype=torch.uint32, device="cuda")
                cuda_lib.check(fn(p(lde), stride, regs, n, p(c_lde), p(w1), p(w2),
                                  *[nul if t is None else p(t) for t in tables], dk.LOG_LO,
                                  (ctypes.c_uint32 * 32)(*words), p(out), 0,
                                  cuda_lib.stream(out)), name)
                return out

            if name in K7_VARIANTS and not torch.equal(run(), want):
                raise AssertionError(f"air_probe: K7 {name} differs from the production build")
            line.append(f"({regs}, {n}) {time_ms(run, 20, 7, queued=True):.4f} ms")
        print(f"K7 {name}: {'; '.join(spills)}; {', '.join(line)}", flush=True)


def probe_k15():
    """K15 at the streamed 2^16 and 2^22 proofs' calls ((20, 2^16), (20,
    2^22)) on random values: the production build, then each build of
    WSUM_VARIANTS (one block an SM, cp.async copies, ring depth), held
    equal and timed."""
    from ..ops import deep_kernels as dk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    cases = [(random_elements(gen, (20, n)), random_elements(gen, (20,)),
              random_elements(gen, (20,))) for n in (1 << 16, 1 << 22)]
    wants = [dk.coeff_wsum(*case) for case in cases]
    spills = [line.strip() for line in cuda_lib.ptxas_report("coeff_wsum")
              if "spill" in line or "registers" in line]
    times = [time_ms(lambda: dk.coeff_wsum(*case), 20, 7, queued=True) for case in cases]
    print(f"K15 production: {'; '.join(spills)}; " + ", ".join(
        f"(20, {c[0].shape[1]}) {ms:.4f} ms" for c, ms in zip(cases, times)), flush=True)
    builds = {**WSUM_VARIANTS, **{name: (patches, ()) for name, patches in K15_DROPS.items()}}
    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(builds, pool.map(
            lambda kv: _build("k15-" + kv[0].replace(" ", "-").replace(",", ""),
                              "coeff_wsum.cu", *kv[1]), builds.items())))
    p = cuda_lib.ptr
    for name, (handle, spills) in built.items():
        fn = handle.distaff_coeff_wsum
        fn.argtypes = cuda_lib.lib().distaff_coeff_wsum.argtypes
        fn.restype = ctypes.c_int
        line = []
        for (polys, w1, w2), want in zip(cases, wants):
            n = polys.shape[1]

            def run():
                out = torch.empty((2, n, 4), dtype=torch.uint32, device="cuda")
                cuda_lib.check(fn(p(polys), polys.stride(0) // 4, 20, n, p(w1), p(w2), p(out),
                                  cuda_lib.stream(out)), name)
                return out

            if name in WSUM_VARIANTS and not torch.equal(run(), want):
                raise AssertionError(f"air_probe: K15 {name} differs from the production build")
            line.append(f"(20, {n}) {time_ms(run, 20, 7, queued=True):.4f} ms")
        print(f"K15 {name}: {'; '.join(spills)}; {', '.join(line)}", flush=True)


def probe_k10():
    """K10 at (20, 2^19) on random registers and weights: the production
    build at point strides 1, 2, 4 and 8 (the proof's is 4) beside
    PyTorch's copy of the same strided slice to a contiguous tensor (the
    card's rate for reading it), and at strides 4 and 1 the builds
    K10_VARIANTS that drop phases of the kernel (their outputs are wrong by
    design and are not held), so that the time splits into copies, product
    and epilogue."""
    import random

    from ..math import field as hostfield
    from ..ops import boundary_kernels as bk
    from ..ops import tiles

    regs, n = 20, 1 << 19
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    full = random_elements(gen, (regs, 8 * n))
    rng = random.Random(10)
    parts = [([rng.randrange(hostfield.M) for _ in range(regs)] for _ in range(2))
             for _ in range(2)]
    parts = [(*ws, rng.randrange(hostfield.M), rng.randrange(hostfield.M)) for ws in parts]
    root = hostfield.exp(hostfield.get_root_of_unity(n), 37)
    slices = {s: full[:, : s * n : s] for s in (1, 2, 4, 8)}
    spills = [line.strip() for line in cuda_lib.ptxas_report("boundary_columns")
              if "spill" in line or "registers" in line]
    print(f"K10 production: {'; '.join(spills)}", flush=True)
    for stride, x in slices.items():
        ms = time_ms(lambda: bk.boundary_columns(x, *parts, root), 20, 7, queued=True)
        copy = time_ms(lambda: x.contiguous(), 20, 7, queued=True)
        print(f"K10 production, point stride {stride}: {ms:.4f} ms; PyTorch's copy of the "
              f"slice {copy:.4f} ms", flush=True)
    with ThreadPoolExecutor(len(K10_VARIANTS)) as pool:
        built = dict(zip(K10_VARIANTS, pool.map(
            lambda kv: _build(kv[0].replace(" ", "-"), "boundary_columns.cu", kv[1]),
            K10_VARIANTS.items())))
    p = cuda_lib.ptr
    for name, (handle, spills) in built.items():
        fn = handle.distaff_boundary_columns
        fn.argtypes = cuda_lib.lib().distaff_boundary_columns.argtypes
        fn.restype = ctypes.c_int
        for stride in (4, 1):
            x = slices[stride]
            weights, (lo, hi), words = bk.boundary_args(x, *parts, root)

            def run():
                out = torch.empty((2, n, 4), dtype=torch.uint32, device="cuda")
                cuda_lib.check(fn(p(x), x.stride(0) // 4, x.stride(1) // 4, regs, n,
                                  (ctypes.c_uint32 * len(weights))(*weights), p(lo),
                                  ctypes.c_void_p(None) if hi is None else p(hi), tiles._LOG_LO,
                                  (ctypes.c_uint32 * 16)(*words), p(out), 0,
                                  cuda_lib.stream(out)), name)
                return out

            ms = time_ms(run, 20, 7, queued=True)
            print(f"K10 {name}, point stride {stride}: {'; '.join(spills)}; {ms:.4f} ms",
                  flush=True)


def probe_k8():
    """K8 at the 2^16 and 2^20 proofs' calls ((20, n) at two points, (1, 8n)
    at one) on random coefficients and points, the production build (8
    coefficients a thread under 2^22 coefficients a call, 64 from there on)
    against K8_VARIANTS: one choice at every size, held equal, and the
    production build without the ticket and the last block's sum (not
    held)."""
    import random

    from ..math import field as hostfield
    from ..ops import deep_kernels as dk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    rng = random.Random(8)
    calls = [(random_elements(gen, (regs, length)),
              [rng.randrange(hostfield.M) for _ in range(count)])
             for regs, length, count in ((20, 1 << 16, 2), (1, 1 << 19, 1), (20, 1 << 20, 2),
                                         (1, 1 << 23, 1))]
    spills = [line.strip() for line in cuda_lib.ptxas_report("poly_eval")
              if "spill" in line or "registers" in line]
    print(f"K8 production: {'; '.join(spills)}", flush=True)
    for polys, points in calls:
        ms = time_ms(lambda: dk.poly_eval(polys, points), 20, 7, queued=True)
        print(f"K8 production, {tuple(polys.shape[:2])} at {len(points)} points: {ms:.4f} ms",
              flush=True)
    with ThreadPoolExecutor(len(K8_VARIANTS)) as pool:
        built = dict(zip(K8_VARIANTS, pool.map(
            lambda kv: _build(kv[0].replace(" ", "-"), "poly_eval.cu", kv[1]),
            K8_VARIANTS.items())))
    for name, (handle, spills) in built.items():
        fn = handle.distaff_poly_eval
        fn.argtypes = cuda_lib.lib().distaff_poly_eval.argtypes
        fn.restype = ctypes.c_int

        def launch(polys, out, partial, tickets, length, rows, count, words):
            cuda_lib.check(fn(cuda_lib.ptr(polys), cuda_lib.ptr(out), cuda_lib.ptr(partial),
                              cuda_lib.ptr(tickets), length, rows, count,
                              (ctypes.c_uint32 * len(words))(*words), cuda_lib.stream(out)), name)

        for polys, points in calls:
            run = lambda: dk.evaluate_group(polys, points, launch)
            if "ticket" not in name and not torch.equal(run(), dk.poly_eval(polys, points)):
                raise AssertionError(f"air_probe: K8 {name} differs from the production build")
            ms = time_ms(run, 20, 7, queued=True)
            print(f"K8 {name}, {tuple(polys.shape[:2])} at {len(points)} points: "
                  f"{'; '.join(spills)}; {ms:.4f} ms", flush=True)


def probe_k9():
    """K9 on random columns at the 2^16 proof's first, second, third and
    fifth layers and the 2^18 proof's first, at the LDE domain's root: the
    production build at four rows a thread and at one (four lanes a leaf),
    with and without the leaf digests, then K9_VARIANTS at the same, each
    held equal to the production build."""
    import random

    from ..math import field as hostfield
    from ..ops import fri_torch, tiles

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rng = random.Random(9)
    layers = [(1 << 21, 1 << 21, 1), (1 << 19, 1 << 21, 4), (1 << 17, 1 << 21, 16),
              (1 << 13, 1 << 21, 1 << 8), (1 << 23, 1 << 23, 1)]
    cases = [(random_elements(gen, (length,)), rng.randrange(hostfield.M),
              hostfield.get_root_of_unity(domain), stride) for length, domain, stride in layers]
    spills = [line.strip() for line in cuda_lib.ptxas_report("fri_fold")
              if "spill" in line or "registers" in line]
    print(f"K9 production: {'; '.join(spills)}", flush=True)
    p = cuda_lib.ptr
    nul = ctypes.c_void_p(None)

    def same(got, want):
        return all(map(torch.equal, got, want)) if isinstance(got, tuple) else \
            torch.equal(got, want)

    def runner(fn, column, special_x, root, stride, rows, digests):
        n = column.shape[0]
        q = n // 4
        lo, hi = tiles._store_factors(n * stride, int(root), 1, column.device)
        words = (ctypes.c_uint32 * 32)(*fri_torch.fold_words(special_x, root, stride, q))

        def run():
            out = torch.empty((q, 4), dtype=torch.uint32, device="cuda")
            leaves = torch.empty((q // 4, 8), dtype=torch.uint32, device="cuda")
            cuda_lib.check(fn(p(column), q, rows, p(lo), nul if hi is None else p(hi),
                              tiles._LOG_LO, stride, words, p(out), p(leaves) if digests else nul,
                              0, 0, cuda_lib.stream(out)), "fri_fold")
            return (out, leaves) if digests else out

        return run

    modes = (("4 rows a thread, with the leaf digests", 4, True),
             ("4 rows a thread, fold only", 4, False),
             ("1 row a thread (4 lanes a leaf), with the leaf digests", 1, True),
             ("1 row a thread, fold only", 1, False))
    want = {}
    for column, special_x, root, stride in cases:
        key = f"{column.shape[0] // 4} rows, stride {stride}"
        for mode, rows, digests in modes:
            run = runner(cuda_lib.lib().distaff_fri_fold, column, special_x, root, stride, rows,
                         digests)
            got = run()
            if not same(got, want.setdefault((key, digests), got)):
                raise AssertionError(f"air_probe: K9 at {key}, {mode} differs from 4 rows a "
                                     f"thread")
            ms = time_ms(run, 20, 7, queued=True)
            print(f"K9 production, {key}, {mode}: {ms:.4f} ms", flush=True)
    with ThreadPoolExecutor(len(K9_VARIANTS)) as pool:
        built = dict(zip(K9_VARIANTS, pool.map(
            lambda kv: _build(kv[0].replace(" ", "-"), "fri_fold.cu", *kv[1]),
            K9_VARIANTS.items())))
    for name, (handle, spills) in built.items():
        fn = handle.distaff_fri_fold
        fn.argtypes = cuda_lib.lib().distaff_fri_fold.argtypes
        fn.restype = ctypes.c_int
        for column, special_x, root, stride in cases:
            key = f"{column.shape[0] // 4} rows, stride {stride}"
            for mode, rows, digests in modes:
                run = runner(fn, column, special_x, root, stride, rows, digests)
                if not same(run(), want[(key, digests)]):
                    raise AssertionError(f"air_probe: K9 {name} differs from the production "
                                         f"build at {key}, {mode}")
                ms = time_ms(run, 20, 7, queued=True)
                print(f"K9 {name}, {key}, {mode}: {'; '.join(spills)}; {ms:.4f} ms", flush=True)


def probe_k11():
    """K11 on random coefficients at the 2^16, 2^18 and 2^20 proofs' step 4
    ((3, 8n), degree n): the production build, then K11_VARIANTS, so that
    its time splits into the loads and scans, the look-back, the R chain
    and the epilogue, beside other tiles."""
    from ..math import field as hostfield
    from ..ops import syndiv_kernels as sk
    from ..ops import tiles

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    calls = []
    for log2 in (16, 18, 20):
        degree = 1 << log2
        calls.append((random_elements(gen, (3, 8 * degree)), degree,
                      hostfield.exp(hostfield.get_root_of_unity(degree), degree - 1)))
    spills = [line.strip() for line in cuda_lib.ptxas_report("syn_div")
              if "spill" in line or "registers" in line]
    print(f"K11 production: {'; '.join(spills)}", flush=True)
    want = []
    for polys3, degree, x_last in calls:
        want.append(sk.syn_div(polys3, degree, x_last))
        ms = time_ms(lambda: sk.syn_div(polys3, degree, x_last), 20, 7, queued=True)
        print(f"K11 production, (3, {polys3.shape[1]}) degree {degree}: {ms:.4f} ms", flush=True)
    with ThreadPoolExecutor(len(K11_VARIANTS)) as pool:
        built = dict(zip(K11_VARIANTS, pool.map(
            lambda kv: _build("k11-" + "".join(c for c in kv[0] if c.isalnum()), "syn_div.cu",
                              *kv[1]),
            K11_VARIANTS.items())))
    p = cuda_lib.ptr
    nul = ctypes.c_void_p(None)
    for name, (handle, spills) in built.items():
        fn = handle.distaff_syn_div
        fn.argtypes = cuda_lib.lib().distaff_syn_div.argtypes
        fn.restype = ctypes.c_int
        for (polys3, degree, x_last), ref in zip(calls, want):
            n = polys3.shape[1]
            (b_lo, b_hi), (i_lo, i_hi), words = sk.syn_div_args(n, x_last, polys3.device)
            n_tiles = -(-n // K11_MIN_TILE)            # scratch for the smallest tile
            flags = torch.empty(2 * n_tiles + 1, dtype=torch.int32, device="cuda")
            sums = torch.empty((n_tiles, 4, 4), dtype=torch.uint32, device="cuda")
            r = torch.zeros((n, 4), dtype=torch.uint32, device="cuda")
            out = torch.empty((n, 4), dtype=torch.uint32, device="cuda")

            def run():
                cuda_lib.check(fn(p(polys3), polys3.stride(0) // 4, n, degree, p(b_lo),
                                  nul if b_hi is None else p(b_hi), p(i_lo),
                                  nul if i_hi is None else p(i_hi), tiles._LOG_LO,
                                  (ctypes.c_uint32 * 4)(*words[:4]),
                                  (ctypes.c_uint32 * 4)(*words[4:]), p(flags), p(sums), p(r),
                                  p(out), cuda_lib.stream(out)), name)
                return out

            if not K11_VARIANTS[name][0] and not torch.equal(run(), ref):
                raise AssertionError(f"air_probe: K11 {name} differs from the production build")
            ms = time_ms(run, 20, 7, queued=True)
            print(f"K11 {name}, (3, {n}) degree {degree}: {'; '.join(spills)}; {ms:.4f} ms",
                  flush=True)


def _swapped(entry, handle):
    """cuda_lib's library with `entry` taken from another build's handle
    (the wrappers then launch that build)."""
    production = cuda_lib.lib()
    fn = getattr(handle, entry)
    fn.argtypes = getattr(production, entry).argtypes
    fn.restype = ctypes.c_int

    class Library:
        def __getattr__(self, name):
            return fn if name == entry else getattr(production, name)
    return Library()


def _with_library(library, fn):
    """fn() with cuda_lib's library replaced by `library`."""
    def run():
        saved = cuda_lib._lib
        cuda_lib._lib = library
        try:
            return fn()
        finally:
            cuda_lib._lib = saved
    return run


def probe_k13():
    """K13 on random leaf digests at K13_SIZES: the production build under
    each plan of _k13_plans, then each build of K13_VARIANTS under the
    production plan, each tree held equal to the production build's; per
    plan the sum over the 2^16 proof's ten trees.  The SASS opcode mix of
    each build is printed."""
    from ..ops import blake3_torch as b3

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    trees = [(n, random_elements(gen, (n, 2)).view(n, 8)) for n in K13_SIZES]
    proof_trees = [1 << k for k in (21, 20, 19, 17, 15, 13, 11, 9, 7, 5)]
    spills = [line.strip() for line in cuda_lib.ptxas_report("merkle_tree")
              if "spill" in line or "registers" in line]
    print(f"K13 production: {'; '.join(spills)}", flush=True)
    sass = cuda_lib.sass("merkle_tree")
    if sass is not None:
        print(f"K13 production SASS: {cuda_lib.opcode_counts(sass)}", flush=True)
    want = {n: b3.merkle_tree(leaves) for n, leaves in trees}
    sms = b3.device_sms(0)

    def report(name, plan_of, library=None):
        times, launches = {}, {}
        for n, leaves in trees:
            plan = (plan_of or (lambda n: b3.tree_plan(n, sms)))(n)
            run = lambda leaves=leaves, plan=plan: b3.merkle_tree(leaves, plan)
            if library is not None:
                run = _with_library(library, run)
            for _ in range(3):
                if not torch.equal(run(), want[n]):
                    raise AssertionError(f"air_probe: K13 {name} differs at {n} leaves")
            times[n], launches[n] = time_ms(run, 20, 7, queued=True), plan
        print(f"K13 {name}: " + ", ".join(
            f"2^{n.bit_length() - 1} {times[n]:.4f} ms {launches[n]}" for n, _ in trees)
            + f"; the 2^16 proof's trees {sum(times[n] for n in proof_trees):.4f} ms",
            flush=True)

    for name, plan_of in _k13_plans(sms).items():
        report(name, plan_of)
    with ThreadPoolExecutor(len(K13_VARIANTS)) as pool:
        built = dict(zip(K13_VARIANTS, pool.map(
            lambda kv: _build(f"k13-{list(K13_VARIANTS).index(kv[0])}", "merkle_tree.cu",
                              kv[1]), K13_VARIANTS.items())))
    for k, (name, (handle, spills)) in enumerate(built.items()):
        print(f"K13 {name}: {'; '.join(spills)}; SASS {BUILD_OPCODES.get(f'k13-{k}')}",
              flush=True)
        report(name, None, _swapped("distaff_merkle_tree", handle))


def probe_b3():
    """K3, K9 and K14 as built (blake3.cuh's compression on FmaAdds: its
    adds as IMAD on the FMA pipe) against builds on the compiler's adds
    (AluAdds, the parent's): K3 over 2^21 rows of 320 bytes, K9 at the 2^16 proof's first
    layer (2^19 rows, with the leaf digests), K14 at a middle block of
    (4, 2^21) and (4, 2^25) points; each held equal and timed, with the
    SASS opcode mix of each build."""
    import random

    from ..math import field as hostfield
    from ..ops import blake3_torch as b3
    from ..ops import fri_torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = random_elements(gen, (1 << 21, 20))
    column = random_elements(gen, (1 << 21,))
    special_x = random.Random(3).randrange(hostfield.M)
    root = hostfield.get_root_of_unity(1 << 21)
    groups = [random_elements(gen, (4, d)) for d in (1 << 21, 1 << 25)]
    cvs = [random_elements(gen, (d, 2)).view(d, 8) for d in (1 << 21, 1 << 25)]
    cases = {
        "blake3_rows": [("K3, 2^21 rows of 320 B", lambda: b3.hash_rows(rows))],
        "fri_fold": [("K9, 2^19 rows with the leaf digests",
                      lambda: fri_torch.fri_fold(column, special_x, root, 1, digests=True))],
        "trace_absorb": [(f"K14, a middle block of (4, 2^{d.bit_length() - 1})",
                          lambda g=g, cv=cv: b3.trace_absorb(g, cv.clone(), 1, 320))
                         for g, cv, d in zip(groups, cvs, (1 << 21, 1 << 25))],
    }
    with ThreadPoolExecutor(len(cases)) as pool:
        built = dict(zip(cases, pool.map(
            lambda stem: _build(f"b3-{stem}", f"{stem}.cu", B3_ALU), cases)))
    for stem, runs in cases.items():
        handle, spills = built[stem]
        entry = "distaff_" + stem
        sass = cuda_lib.sass(stem)
        if sass is not None:
            print(f"{stem} production SASS: {cuda_lib.opcode_counts(sass)}", flush=True)
        print(f"{stem} on AluAdds: {'; '.join(spills)}; SASS {BUILD_OPCODES.get(f'b3-{stem}')}",
              flush=True)
        library = _swapped(entry, handle)
        for name, run in runs:
            want, got = run(), _with_library(library, run)()
            same = all(map(torch.equal, want, got)) if isinstance(want, tuple) else \
                torch.equal(want, got)
            if not same:
                raise AssertionError(f"air_probe: {name} on AluAdds differs")
            times = [time_ms(fn, 20, 7, queued=True)
                     for fn in (run, _with_library(library, run)) * 2]
            print(f"{name}: production (FmaAdds) {times[0]:.4f}, {times[2]:.4f} ms; "
                  f"AluAdds {times[1]:.4f}, {times[3]:.4f} ms", flush=True)


# K16 builds: (patches, held equal to the production build)
K16_TAKE = "            take(s[i], k, acc[0][i], acc[1][i], acc[2][i], acc[3][i]);"
K16_FINISH = "    for (int i = 0; i < 4; ++i) y[i] = finish(s[i], reduced);"
K16_K32 = "        mma(c, a, b0, b1);\n"
K16_K16 = "        mma16(c, a0, a1, b0);\n"
K16_BOUNDS = "__launch_bounds__(kThreads, kMinBlocks)"
K16_VARIANTS = {
    "bound of 2 blocks": ((("leaf256.cu", K16_BOUNDS, "__launch_bounds__(kThreads, 2)"),), True),
    "W once": ((("leaf256.cu", "        load_fragments(frags, 0, lane, a);\n", ""),
                ("leaf256.cu", "#pragma unroll 1\n    for (int r = 0; r < kATiles; ++r) {\n",
                 "    load_fragments(frags, 0, thread_index() & 31, a);\n#pragma unroll 1\n"
                 "    for (int r = 0; r < kATiles; ++r) {\n")), True),
    "products-only": ((("leaf256.cu", K16_TAKE,
                        "            s[i].pend ^= acc[0][i] ^ acc[1][i] ^ acc[2][i] ^ acc[3][i];"),
                       ("leaf256.cu", K16_FINISH,
                        "    for (int i = 0; i < 4; ++i) y[i] = make_uint4(s[i].pend, reduced, "
                        "0, 0);")), False),
    "no-products": ((("leaf256.cu", K16_K32, "        c[2] += b0 ^ a[2];\n"),
                     ("leaf256.cu", K16_K16, "        c[0] += b0 ^ a0;\n")), False),
}
K16_LEAVES = (4096, 163840)
# the int8 mma.sync rate alone: CHAINS independent accumulators a warp
IMMA_RATE_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void imma_rate(int* out, int iters) {
    const uint32_t a0 = threadIdx.x * 0x9E3779B9u, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
    const uint32_t b0 = a0 * 11, b1 = a0 * 13;
    int c[CHAINS][4] = {};
    for (int it = 0; it < iters; ++it)
#pragma unroll
        for (int k = 0; k < CHAINS; ++k)
#if K16
            asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
                         "{%4, %5}, {%6}, {%0, %1, %2, %3};"
                         : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
                         : "r"(a0), "r"(a1), "r"(b0));
#else
            asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
                         "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                         : "+r"(c[k][0]), "+r"(c[k][1]), "+r"(c[k][2]), "+r"(c[k][3])
                         : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
#endif
    int sum = 0;
    for (int k = 0; k < CHAINS; ++k) sum += c[k][0] + c[k][1] + c[k][2] + c[k][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}
extern "C" int imma_rate_launch(int* out, int blocks, int threads, int iters, void* stream) {
    imma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
    return (int)cudaGetLastError();
}
"""


def _imma_rate():
    """The card's int8 mma.sync rate, m16n8k32 and m16n8k16, at 2, 4 and 8
    independent chains a warp and 16 or 32 warps an SM (the tensor floor of
    a design on mma.sync, and what it needs in flight)."""
    work = Path(tempfile.mkdtemp(prefix="air_probe-imma-"))
    (work / "imma.cu").write_text(IMMA_RATE_SOURCE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 2048
    out = torch.empty(4 * sms * threads, dtype=torch.int32, device="cuda")
    for k16 in (0, 1):
        for chains in (2, 4, 8):
            lib = work / f"imma-{k16}-{chains}.so"
            command = [cuda_lib.nvcc_path(), "-gencode", cuda_lib.ARCH, "-O3", "-Xcompiler",
                       "-fPIC", "-shared", f"-DK16={k16}", f"-DCHAINS={chains}",
                       str(work / "imma.cu"), "-o", str(lib)]
            subprocess.run(command, check=True, capture_output=True)
            handle = ctypes.CDLL(str(lib))
            handle.imma_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p]
            for blocks in (2 * sms, 4 * sms):
                run = lambda blocks=blocks: cuda_lib.check(handle.imma_rate_launch(
                    cuda_lib.ptr(out), blocks, threads, iters, cuda_lib.stream(out)), "imma_rate")
                ms = time_ms(run, 3, 5, queued=True)
                ops = blocks * threads // 32 * iters * chains * 2 * 16 * 8 * (16 if k16 else 32)
                print(f"int8 mma.sync m16n8k{16 if k16 else 32}, {chains} chains a warp, "
                      f"{blocks * threads // 32 // sms} warps an SM: "
                      f"{ops / ms / 1e9:.1f} TOPS ({ms:.4f} ms)", flush=True)
    shutil.rmtree(work, ignore_errors=True)


def probe_k16(sass_dir=None):
    """The int8 mma.sync rate (_imma_rate), then K16 at (4096, 256) and
    (163840, 256) as built and as the builds of K16_VARIANTS (held equal):
    a launch bound of 2 blocks (more registers, fewer warps), W's fragments
    held across the tiles, and split into its products alone (the reductions replaced by an xor) and
    its loads, planes and reductions alone (each mma replaced by an xor and
    an add), K1 beside; ptxas' lines and the SASS opcode mix of each."""
    from ..math import field as hostfield
    from ..ops import mxu_ntt, tiles

    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    root = hostfield.get_root_of_unity(256)
    cases = [random_elements(gen, (n, 256)) for n in K16_LEAVES]
    spills = [line.strip() for line in cuda_lib.ptxas_report("leaf256")
              if "spill" in line or "registers" in line]
    sass = cuda_lib.sass("leaf256")
    print(f"K16 production: {'; '.join(spills)}; SASS "
          f"{cuda_lib.opcode_counts(sass) if sass is not None else None}", flush=True)
    with ThreadPoolExecutor(len(K16_VARIANTS)) as pool:
        built = dict(zip(K16_VARIANTS, pool.map(
            lambda kv: _build(f"k16-{kv[0]}", "leaf256.cu", kv[1][0]),
            K16_VARIANTS.items())))
    for name, (handle, lines) in built.items():
        print(f"K16 {name}: {'; '.join(lines)}; SASS {BUILD_OPCODES.get(f'k16-{name}')}",
              flush=True)
    for name, text in [("production", sass)] + [(n, BUILD_SASS.get(f"k16-{n}")) for n in built]:
        if text is not None and sass_dir:
            Path(sass_dir, f"k16-{name.replace(', ', '-').replace(' ', '-')}.sass").write_text(text)
        if text is not None:
            print(f"K16 {name} SASS, every opcode: "
                  f"{dict(cuda_lib.opcode_mix(text).most_common(24))}", flush=True)
    _imma_rate()
    for x in cases:
        run = lambda x=x: mxu_ntt.leaf_ntt256(x, root)
        want = run()
        times = {"production": time_ms(run, 20, 7, queued=True)}
        for name, (handle, _) in built.items():
            variant = _with_library(_swapped("distaff_leaf256", handle), run)
            if K16_VARIANTS[name][1] and not torch.equal(variant(), want):
                raise AssertionError(f"air_probe: K16 {name} differs at {tuple(x.shape)}")
            times[name] = time_ms(variant, 20, 7, queued=True)
        times["production again"] = time_ms(run, 20, 7, queued=True)
        times["K1"] = time_ms(lambda x=x: tiles.ntt_batched(x, root), 20, 7, queued=True)
        print(f"K16 at ({x.shape[0]}, 256): " + ", ".join(f"{k} {v:.4f} ms"
                                                          for k, v in times.items()), flush=True)


def main(argv=None):
    import sys

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("probes", nargs="*", help="the probes to run (all by default)")
    parser.add_argument("--parent-csrc", help="k6 also splits the K6 of this csrc directory "
                                              "(another checkout's, its K6_PARENT_SPLITS)")
    parser.add_argument("--sass-dir", help="k16 writes the SASS of each of its builds there")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    probes = {"k4": probe_k4, "k6": lambda: probe_k6(args.parent_csrc), "k2exp": probe_k2exp,
              "k7": probe_k7, "k8": probe_k8, "k9": probe_k9, "k10": probe_k10,
              "k11": probe_k11, "k13": probe_k13, "k15": probe_k15, "b3": probe_b3,
              "k16": lambda: probe_k16(args.sass_dir)}
    if not torch.cuda.is_available():
        raise RuntimeError("air_probe: no CUDA device is available")
    print(f"device: {card_line()}", flush=True)
    for name in args.probes or list(probes):
        probes[name]()


if __name__ == "__main__":
    main()
