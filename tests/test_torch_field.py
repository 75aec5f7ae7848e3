"""distaff_torch field arithmetic (kernel K2's plain version on the CPU)
against distaff_tpu.math.field_jax on the same limbs: exact equality,
since this is integer field arithmetic.

Every JAX call here uses one operand shape, (128, 4), so that the file
costs only a handful of XLA compiles."""

import random
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu.math import field as jax_host_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.math import quartic
import distaff_torch
from distaff_torch.crypto.ark_constants import INV_ALPHA
from distaff_torch.interop import limbs_from_numpy, limbs_to_numpy
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import field_kernels as fk
from distaff_torch.ops import fri_torch
from torch_ptx_host import asm_block, run_ptx

M = ft.M
EDGE = [0, 1, 2, M - 1, M - 2, 2**96, 2**96 + 12345, 2**127, 2**64 - 1, 2**64, M // 2]
N = 128


def _elements(n, seed):
    """n canonical field elements as (n, 4) uint32 limbs, uniform below M,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.uint64)
    limbs[:, 3] %= 0xFFFFFFFF                     # top limb below M's keeps x < M
    return limbs.astype(np.uint32)


def _edge_pairs():
    """(128, 4) operands: every edge value against every edge value (121
    pairs), then random elements."""
    edge = np.asarray(fj.from_ints(EDGE))
    a, b = _elements(N, 1), _elements(N, 2)
    k = len(EDGE) ** 2
    a[:k] = np.repeat(edge, len(EDGE), axis=0)
    b[:k] = np.tile(edge, (len(EDGE), 1))
    return a, b


def _port(arr):
    return limbs_from_numpy(arr, "cpu")


def _same(port_tensor, jax_array):
    return np.array_equal(limbs_to_numpy(port_tensor), np.asarray(jax_array))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_field_jax(op):
    a, b = _edge_pairs()
    assert _same(getattr(ft, op)(_port(a), _port(b)), getattr(fj, op)(a, b))


def test_neg_matches_field_jax():
    a, _ = _edge_pairs()
    assert _same(ft.neg(_port(a)), fj.neg(a))


@pytest.mark.parametrize("e", [0, 2**64 + 7])
def test_exp_const_matches_field_jax(e):
    a, _ = _edge_pairs()
    assert _same(ft.exp_const(_port(a), e), fj.exp_const(a, e))


def test_inv_batch_matches_field_jax_zero_to_zero():
    # K6's wrapper (its plain version on the CPU) against field_jax.inv_batch:
    # inv_batch_scan, the function K6 ports, takes about a minute of XLA:CPU
    # compile even at 16 elements, and inverses are unique
    a, _ = _edge_pairs()                          # the first 11 are zero
    got = ft.inv_batch(_port(a))
    assert _same(got, fj.inv_batch(a))
    for v, x in zip(ft.to_ints(got), ft.to_ints(a)):
        assert (v == 0) if x == 0 else (v * x % M == 1)


def test_cumsum_matches_field_jax():
    a = _elements(N, 3)
    assert _same(ft.cumsum(_port(a), axis=0), fj.cumsum(a, axis=0))
    # along a middle axis too (the port's scan moves it first)
    grid = ft.cumsum(_port(a.reshape(4, 32, 4)), axis=1)
    rows = ft.to_ints(a.reshape(4, 32, 4))
    assert ft.to_ints(grid).tolist() == [
        [sum(row[: j + 1]) % M for j in range(32)] for row in rows]


def test_power_series_matches_field_jax():
    x = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321 % M
    assert _same(ft.power_series(x, N, "cpu"), fj.power_series(x, N))


def test_sum_reduce_matches_host():
    a = _elements(5 * 7, 4).reshape(5, 7, 4)
    want = [sum(col) % M for col in ft.to_ints(a).T]
    assert ft.to_ints(ft.sum_reduce(_port(a), axis=0)).tolist() == want


def test_broadcast_operands_match_expanded():
    x = _port(_elements(96, 5).reshape(3, 8, 4, 4))
    for b in (_elements(32, 6).reshape(8, 4, 4), _elements(24, 7).reshape(3, 8, 1, 4),
              _elements(1, 8)[0]):
        full = _port(b).expand(x.shape).contiguous()
        assert torch.equal(ft.mul(x, _port(b)), ft.mul(x, full))
        assert torch.equal(ft.sub(_port(b), x), ft.sub(full, x))


def _operand_cases():
    """(a, b, collapsed dimension count): the broadcasts K2 meets on the
    prover's path, at small sizes, as views of one base tensor."""
    base = _port(_elements(8 * 16 * 8, 10)).reshape(8, 16, 8, 4)
    flat = base.reshape(-1, 4)
    column = base[:3, :8, :1]
    return {
        "contiguous": (flat, flat.flip(0), 1),
        "constant": (base, flat[5], 1),
        "neg": (ft.zeros((), "cpu"), flat, 1),
        "table": (base, base[0], 2),                        # four-step twiddles
        "slice": (base.reshape(4, -1, 4)[3, ::4], flat[7], 1),  # LDE stride slice
        "column": (base[:3, :8, :4], column, 3),
        "points": (base[None, 0], base[:2, 0, None], 3),     # poly eval (P, R, n)
    }


@pytest.mark.parametrize("case", sorted(_operand_cases()))
def test_kernel_indexing_of_broadcast_operands(case):
    # K2 reads element i of an operand at sum_d k_d * stride_d over the
    # collapsed dimensions (k_d the digits of i): emulate that on the host
    a, b, dims = _operand_cases()[case]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    sizes, strides = fk.collapse_dims(shape, a, b)
    assert len(sizes) == dims
    count = 1
    for size in sizes:
        count *= size
    assert count * 4 == torch.Size(shape).numel()
    for t, st in zip((a, b), strides):
        storage = torch.tensor([], dtype=torch.uint32).set_(t.untyped_storage()).reshape(-1, 4)
        rest, offset = torch.arange(count), torch.full((count,), t.storage_offset() // 4)
        for size, stride in zip(reversed(sizes), reversed(st)):
            offset += (rest % size) * stride
            rest //= size
        read = storage.index_select(0, offset)
        assert torch.equal(read, t.expand(shape).reshape(-1, 4))


def test_fold_rows_matches_quartic_interpolation():
    # the fold is the reference's interpolate-then-evaluate of each 4-point
    # row (distaff_tpu/math/quartic.py), at the layer's special_x
    q, n = 8, 32
    root = jax_host_field.get_root_of_unity(n)
    ys = ft.to_ints(_elements(q * 4, 9).reshape(q, 4, 4))
    x0 = [pow(root, i, M) for i in range(q)]
    inv3 = [pow(jax_host_field.inv(x), 3, M) for x in x0]
    sx = 0x0BAD_CAFE_F00D_1234_5678_9ABC_DEF0_1357
    got = fri_torch.fold_rows(ft.from_ints(ys, "cpu"), ft.from_ints(x0, "cpu"),
                              ft.from_ints(inv3, "cpu"), ft.constant(sx, "cpu"))
    xs = [[x * pow(root, j * q, M) % M for j in range(4)] for x in x0]
    want = quartic.evaluate_batch(quartic.interpolate_batch(xs, ys.tolist()), sx)
    assert ft.to_ints(got).tolist() == want


def _run_schedule(x, steps):
    """field_ew.cu's exp_kernel over Python ints: its steps on x, with x in
    table entry 0."""
    table = [None] * fk.EXP_TABLE
    table[0] = acc = x
    for op, arg in steps:
        if op == fk.EXP_SQR:
            for _ in range(arg):
                acc = acc * acc % M
        elif op == fk.EXP_MUL:
            acc = acc * table[arg] % M
        elif op == fk.EXP_STORE:
            table[arg] = acc
        elif op == fk.EXP_LOAD:
            acc = table[arg]
        else:
            assert op == fk.EXP_ONE
            acc = 1
    return acc


# K2 exp_const's exponents: the edge cases, the Fermat inverse (K6's and the
# kernel bench's), 2^127, the S-box inverse and a seeded random 128-bit e
EXPONENTS = [0, 1, 2, 3, M - 2, M - 1, 2**127, INV_ALPHA,
             random.Random(15).randrange(1 << 128), (1 << 128) - 1]


@pytest.mark.parametrize("e", EXPONENTS)
def test_exp_schedule_matches_host_pow(e):
    # the schedule that the host builds for K2's exp_kernel, run over Python
    # ints as the kernel runs it, equals pow(x, e, M) (0^0 = 1); every step
    # is one that the kernel takes (field_ew.cu checks the same)
    steps = fk.exp_schedule(e)
    assert len(steps) <= fk.EXP_STEPS
    for op, arg in steps:
        assert 0 <= op <= fk.EXP_ONE and 0 <= arg < 256
        assert op != fk.EXP_SQR or arg > 0
        assert op not in (fk.EXP_MUL, fk.EXP_STORE, fk.EXP_LOAD) or arg < fk.EXP_TABLE
    rng = random.Random(e % 1000)
    for x in EDGE + [M - 3] + [rng.randrange(M) for _ in range(20)]:
        assert _run_schedule(x, steps) == pow(x, e, M), (hex(e), hex(x))
    squarings, multiplies = fk.exp_schedule_ops(steps)
    if e == M - 2:
        # the x^(2^(2^k) - 1) chain: 127 squarings (e's bits below its top
        # one) and 12 multiplies, against square-and-multiply's 127 + 123
        assert (squarings, multiplies) == (127, 12)
    if e:
        assert squarings >= e.bit_length() - fk.EXP_WINDOW   # a first window's bits


def test_exp_schedule_of_random_exponents():
    # any e below 2^128: seeded random exponents of every length, each
    # schedule within the kernel's step limit and equal to pow
    rng = random.Random(16)
    for bits in range(1, 129):
        e = rng.randrange(1 << (bits - 1), 1 << bits)
        steps = fk.exp_schedule(e)
        assert len(steps) <= fk.EXP_STEPS
        x = rng.randrange(M)
        assert _run_schedule(x, steps) == pow(x, e, M), hex(e)


@pytest.mark.parametrize("e", [0, 2**64 + 7])
def test_exp_schedule_matches_field_jax(e):
    # the kernel's schedule over the edge pairs against field_jax.exp_const
    # at the exponents compiled above (no new XLA compile)
    a, _ = _edge_pairs()
    want = np.asarray(fj.exp_const(a, e))
    steps = fk.exp_schedule(e)
    got = [_run_schedule(int(sum(int(v) << (32 * k) for k, v in enumerate(row))), steps)
           for row in a]
    assert [int(sum(int(v) << (32 * k) for k, v in enumerate(row))) for row in want] == got


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_110exp_kernelEPK5uint4PS0_x12ExpSchedule
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;   /* 0x00000a00ff017624 */
        /*0010*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;            /* 0x0000000504027225 */
        /*0020*/                   IMAD.HI.U32 R6, R4, R5, R6 ;              /* 0x0000000504067227 */
        /*0030*/              @!P0 IADD3.X R7, RZ, R7, RZ, P1, !PT ;         /* 0x00000007ff078210 */
        /*0040*/                   LOP3.LUT R8, R8, 0x1, RZ, 0xc0, !PT ;     /* 0x0000000108087812 */
        /*0050*/                   SEL R9, R2, R3, !P2 ;                     /* 0x0000000302097207 */
\t\tFunction : _ZN12_GLOBAL__N_113binary_kernelILi2EEEvPK5uint4S3_PS1_x9Broadcast
        /*0000*/                   IMAD R2, R4, R5, RZ ;                     /* 0x0000000504027224 */
        /*0010*/                   SHFL.IDX R3, R4, RZ, 0x1f ;               /* 0x00001fff04037589 */
"""


def test_sass_opcode_counts_by_function_and_pipe():
    # the counts phase 1 of chip_smoke.py and tools/air_probe.py print: an
    # opcode without a '.' counts all its forms, one with a '.' those it
    # begins; a function's section alone; IMAD on the FMA pipe, the rest
    # of these on the integer-only pipe (SHFL is neither)
    from distaff_torch.ops import cuda_lib

    exp = cuda_lib.function_sass(_SASS, "exp_kernel")
    assert cuda_lib.opcode_counts(exp, cuda_lib.MULTIPLY_OPCODES) == {
        "IMAD": 3, "IMAD.WIDE": 1, "IMAD.HI": 1, "IMAD.X": 0, "IMAD.MOV": 1, "IADD3": 1,
        "LOP3": 1, "SHF": 0, "SEL": 1, "ISETP": 0}
    assert cuda_lib.pipe_counts(exp) == (3, 3)
    assert cuda_lib.pipe_counts(cuda_lib.function_sass(_SASS, "binary_kernel")) == (1, 0)
    assert cuda_lib.opcode_counts(_SASS)["IMAD"] == 4


def test_wrapper_on_cpu_uses_plain_version():
    a, b = (_port(x) for x in _edge_pairs())
    assert torch.equal(fk.mul(a, b), fk.mul_plain(a, b))
    assert torch.equal(fk.exp_const(a, 9), fk.exp_const_plain(a, 9))
    assert torch.equal(fk.inv_batch(a), fk.exp_const_plain(a, M - 2))


_HARNESS = r"""
#include "field128.cuh"
#include <cstdio>
using f128::u128;
static u128 parse(const char* s) {
    u128 v = 0;
    for (; *s; ++s) v = v * 16 + (*s <= '9' ? *s - '0' : (*s | 32) - 'a' + 10);
    return v;
}
static void put(u128 v) {
    printf("%016llx%016llx ", (unsigned long long)(v >> 64), (unsigned long long)v);
}
int main(int argc, char** argv) {
    if (argc > 1) {                       // "digits": kDigits hex digits a line
        char d[40];
        uint32_t digits[f128::kDigits];
        for (;;) {
            for (int k = 0; k < f128::kDigits; ++k) {
                if (scanf("%39s", d) != 1) return 0;
                digits[k] = (uint32_t)parse(d);
            }
            put(f128::reduce_digits(digits, 1));
            printf("\n");
        }
    }
    char a[40], b[40], e[40];
    while (scanf("%39s %39s %39s", a, b, e) == 3) {
        u128 x = parse(a), y = parse(b);
        if (f128::from_limbs(f128::to_limbs(x)) != x) return 1;
        put(f128::add(x, y)); put(f128::sub(x, y)); put(f128::mul(x, y));
        put(f128::pow(x, parse(e))); put(f128::inv(x));
        printf("\n");
    }
}
"""


@pytest.fixture(scope="module")
def arithmetic_harness(tmp_path_factory):
    """csrc/field128.cuh built with g++ into a program that reads operands
    on its standard input (or, with an argument, digit vectors)."""
    tmp = tmp_path_factory.mktemp("field128")
    csrc = Path(distaff_torch.__file__).resolve().parent / "csrc"
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-I", str(csrc), str(tmp / "harness.cpp"),
                    "-o", str(tmp / "harness")], check=True, timeout=120)
    return tmp / "harness"


def test_kernel_arithmetic_header_matches_host_ints(arithmetic_harness):
    # csrc/field128.cuh, the arithmetic of the kernels, compiles as plain
    # C++: check its host branch against Python integers (inv: Kaliski's
    # inverse that K6 and K7 run once a block)
    rng = random.Random(0)
    cases = [(x, y, rng.choice([0, 1, 2, M - 2, rng.randrange(M)])) for x in EDGE for y in EDGE]
    cases += [(rng.randrange(M), rng.randrange(M), rng.randrange(1 << 64)) for _ in range(500)]
    feed = "\n".join(f"{x:x} {y:x} {e:x}" for x, y, e in cases)
    out = subprocess.run([str(arithmetic_harness)], input=feed, capture_output=True,
                         text=True, check=True, timeout=120).stdout.splitlines()
    assert len(out) == len(cases)
    for (x, y, e), line in zip(cases, out):
        assert [int(v, 16) for v in line.split()] == [
            (x + y) % M, (x - y) % M, x * y % M, pow(x, e, M), pow(x, M - 2, M)], (x, y, e)


def _byte_products(w, v):
    """The 31 digits of w v split into bytes: digit d = sum_q byte(w, d - q)
    byte(v, q)."""
    wb, vb = w.to_bytes(16, "little"), v.to_bytes(16, "little")
    return [sum(wb[d - q] * vb[q] for q in range(16) if 0 <= d - q < 16) for d in range(31)]


def _digits_of(value):
    """31 digits, each below 2^32, that sum to value < 2^272 at weights
    2^(8d): its bytes, the last digit everything from bit 240 up."""
    return [(value >> (8 * d)) & 0xFF for d in range(30)] + [value >> 240]


def test_reduce_digits_matches_host_ints(arithmetic_harness):
    # f128::reduce_digits (K10's reduction of its tensor-core digit sums):
    # random digits below 2^27 (K10's bound) and below 2^32; the digits of
    # K10's worst case, R = 128 with every value and weight M - 1; digits
    # at 0; and values built to carry past 2^256 twice (lo + carry R^2 wraps
    # with bits 128-255 all set), the largest 2^272 - 1
    rng = random.Random(3)
    r2 = ((45 << 40) - 1) ** 2
    cases = [[rng.randrange(1 << 27) for _ in range(31)] for _ in range(200)]
    cases += [[rng.randrange(1 << 32) for _ in range(31)] for _ in range(100)]
    cases += [[128 * d for d in _byte_products(M - 1, M - 1)], [0] * 31, [(1 << 32) - 1] * 31]
    cases += [_digits_of((1 << 257) - s) for s in (1, 2, r2 - 1, rng.randrange(1, r2))]
    cases += [_digits_of((1 << 272) - 1), _digits_of(M), _digits_of(M - 1), _digits_of(1 << 256)]
    feed = "\n".join(" ".join(f"{d:x}" for d in digits) for digits in cases)
    out = subprocess.run([str(arithmetic_harness), "digits"], input=feed, capture_output=True,
                         text=True, check=True, timeout=120).stdout.splitlines()
    assert len(out) == len(cases)
    for digits, line in zip(cases, out):
        want = sum(d << (8 * k) for k, d in enumerate(digits)) % M
        assert int(line, 16) == want, digits
    assert max(128 * d for d in _byte_products(M - 1, M - 1)) < 1 << 27


# ------------------------------------------------------------------------------------------------
# the device multiply: field128.cuh's PTX run by an interpreter of its instructions
# ------------------------------------------------------------------------------------------------

def _ptx_mul_limbs(signature="mul_limbs(uint4 a, uint4 b)"):
    """The instructions of field128.cuh's mul_limbs (or of the function of
    another signature there) and its operand names, in order (%0-%3 the
    result, then a and b)."""
    return asm_block("field128.cuh", signature)


def test_device_multiply_ptx_matches_host_ints():
    # the PTX carry chain of field128.cuh's mul_limbs (the multiply of every
    # kernel on the card) against Python integers, on the edge values, limbs
    # of all ones below M and random elements
    instructions, names = _ptx_mul_limbs()
    assert names == ["r.x", "r.y", "r.z", "r.w", "a.x", "a.y", "a.z", "a.w",
                     "b.x", "b.y", "b.z", "b.w"]
    assert len(instructions) > 80
    rng = random.Random(1)
    values = EDGE + [M - 3, 2**64 + 1, 2**128 - 2**96 - 1, 2**96 - 1, (1 << 127) - 1]
    values += [rng.randrange(M) for _ in range(20)]
    cases = [(x, y) for x in values for y in values]
    # products 2^127 y whose first fold t = p_lo + p_hi R lies less than
    # 2^93 below a multiple of 2^128, so that the second fold carries into
    # bit 128 (1 in 2^35 of random products): y = 2h with h R = 2^128 - d
    # mod 2^128 for d of every size up to 2^93
    r = (45 << 40) - 1
    for bits in range(1, 94):
        h = (-rng.randrange(1 << (bits - 1), 1 << bits)) * pow(r, -1, 1 << 128) % (1 << 128)
        if 2 * h < M:
            cases.append((1 << 127, 2 * h))
    assert len(cases) > len(values) ** 2 + 30
    for x, y in cases:
        limbs = [(v >> (32 * k)) & 0xFFFFFFFF for v in (x, y) for k in range(4)]
        out = run_ptx(instructions, [0, 0, 0, 0] + limbs)
        got = sum(out[k] << (32 * k) for k in range(4))
        assert got == x * y % M, (hex(x), hex(y))


def test_device_squaring_ptx_matches_host_ints():
    # the PTX carry chain of field128.cuh's sqr_limbs (K2's exp_const
    # squarings: the 6 cross products once, doubled, and the 4 squares)
    # against Python integers, on the edge values, limbs of all ones below
    # M, squares whose first fold carries into bit 128 and random elements
    instructions, names = _ptx_mul_limbs("sqr_limbs(uint4 a)")
    assert names == ["r.x", "r.y", "r.z", "r.w", "a.x", "a.y", "a.z", "a.w"]
    assert sum(ins.split(".")[0] in ("mul", "mad", "madc") for ins in instructions) == \
        20 + 25                  # 10 products lo and hi, then mul_limbs' folds
    rng = random.Random(2)
    values = EDGE + [M - 3, 2**64 + 1, 2**128 - 2**96 - 1, 2**96 - 1, (1 << 127) - 1,
                     2**32 - 1, 2**128 - 2**64 - 1, M - 2**32]
    values += [(1 << 32) * k - 1 for k in (2**32 - 1, 2**64 - 1, 2**96 - 2**64)]
    values += [rng.randrange(M) for _ in range(300)]
    # x = 2^127 + 2^63 - u with u near R / 2: x^2 = h 2^128 + l whose first
    # fold t = l + h R lies within t_hi R below a multiple of 2^128, so that
    # the second fold carries into bit 128 (about half of them)
    r = (45 << 40) - 1

    def second_fold_carries(x):
        t = x * x % (1 << 128) + (x * x >> 128) * r
        return t % (1 << 128) + (t >> 128) * r >= 1 << 128

    folds = [(1 << 127) + (1 << 63) - (r - 1) // 2 - rng.randrange(-1 << 17, 1 << 17)
             for _ in range(40)]
    assert sum(map(second_fold_carries, folds)) >= 10
    for x in values + folds:
        limbs = [(x >> (32 * k)) & 0xFFFFFFFF for k in range(4)]
        out = run_ptx(instructions, [0, 0, 0, 0] + limbs)
        got = sum(out[k] << (32 * k) for k in range(4))
        assert got == x * x % M, hex(x)


# ------------------------------------------------------------------------------------------------
# K6 inv_batch: its passes (csrc/inv_batch.cuh) built with g++, a block and a
# thread at a time, the tree's shuffles over an array of lanes
# ------------------------------------------------------------------------------------------------

_K6_HARNESS = r"""
#include "inv_batch.cuh"
#include <cstdio>
#include <vector>
using namespace inv_batch;
using f128::u128;
static u128 parse(const char* s) {
    u128 v = 0;
    for (; *s; ++s) v = v * 16 + (*s <= '9' ? *s - '0' : (*s | 32) - 'a' + 10);
    return v;
}
int main(int argc, char** argv) {
    char h[40];
    if (argc > 1) {                       // "inverse": one element a line
        while (scanf("%39s", h) == 1) {
            const u128 r = f128::inv(parse(h));
            printf("%016llx%016llx\n", (unsigned long long)(r >> 64), (unsigned long long)r);
        }
        return 0;
    }
    long long n, per_thread;
    if (scanf("%lld %lld", &n, &per_thread) != 2) return 1;
    std::vector<uint4> a(n), out(n);
    for (long long i = 0; i < n; ++i) {
        if (scanf("%39s", h) != 1) return 1;
        a[i] = f128::to_limbs(parse(h));
    }
    Args g{a.data(), out.data(), n, per_thread};
    const long long blocks = (n + per_thread * kThreads - 1) / (per_thread * kThreads);
    for (long long b = 0; b < blocks; ++b) {
        std::vector<u128> q(kThreads), v(kThreads), others(kThreads);
        for (int t = 0; t < kThreads; ++t)
            v[t] = q[t] = forward(g, b, t, count(g, b, t));
        // invert_total: the butterflies of shuffles, lane by lane
        for (int l = 0; l < 5; ++l) {
            std::vector<u128> partner(kThreads);
            for (int t = 0; t < kThreads; ++t) partner[t] = v[t ^ (1 << l)];
            for (int t = 0; t < kThreads; ++t) {
                v[t] = f128::mul(v[t], partner[t]);
                others[t] = l ? f128::mul(others[t], partner[t]) : partner[t];
            }
        }
        std::vector<u128> warp_inv(kWarps), w(32), other_warps(32, 1);
        const int levels = kWarps == 1 ? 0 : kWarps == 2 ? 1 : kWarps == 4 ? 2 : 3;
        for (int lane = 0; lane < 32; ++lane) w[lane] = v[32 * (lane % kWarps)];
        for (int l = 0; l < levels; ++l) {
            std::vector<u128> partner(32);
            for (int lane = 0; lane < 32; ++lane) partner[lane] = w[lane ^ (1 << l)];
            for (int lane = 0; lane < 32; ++lane) {
                w[lane] = f128::mul(w[lane], partner[lane]);
                other_warps[lane] = l ? f128::mul(other_warps[lane], partner[lane]) : partner[lane];
            }
        }
        const u128 root = f128::inv(w[0]);
        for (int lane = 0; lane < kWarps; ++lane)
            warp_inv[lane] = f128::mul(root, other_warps[lane]);
        for (int t = 0; t < kThreads; ++t)
            backward(g, b, t, count(g, b, t), f128::mul(warp_inv[t >> 5], others[t]));
    }
    for (long long i = 0; i < n; ++i) {
        const u128 r = f128::from_limbs(out[i]);
        printf("%016llx%016llx\n", (unsigned long long)(r >> 64), (unsigned long long)r);
    }
}
"""


@pytest.fixture(scope="module")
def k6_harness(tmp_path_factory):
    """csrc/inv_batch.cuh built with g++ (blocks of 64 threads, two warps,
    and of the card's 256) into programs that run K6 on their standard
    input: n, elements a thread, then the elements (or, with an argument,
    elements to invert alone by f128::inv)."""
    tmp = tmp_path_factory.mktemp("inv_batch")
    csrc = Path(distaff_torch.__file__).resolve().parent / "csrc"
    (tmp / "k6.cpp").write_text(_K6_HARNESS)
    built = {}
    for threads in (64, 256):
        built[threads] = tmp / f"k6_{threads}"
        subprocess.run(["g++", "-O1", "-std=c++17", f"-DK6_THREADS={threads}", "-I", str(csrc),
                        str(tmp / "k6.cpp"), "-o", str(built[threads])], check=True, timeout=120)
    return built


def _k6_values(n, kind, seed):
    rng = random.Random(seed)
    if kind == "all M - 1":
        return [M - 1] * n
    values = [rng.randrange(M) for _ in range(n)]
    if kind == "zeros and edge values":
        for i in range(0, n, 7):
            values[i] = 0
        values[1:1 + len(EDGE)] = EDGE[:max(0, n - 1)]
        values = values[:n]
    return values


def test_inv_batch_block_inverse_matches_host_ints(k6_harness):
    # the inversion of a block's product (field128.cuh's inv, Kaliski's
    # almost Montgomery inverse and the division by 2^k in 32-bit steps)
    # against pow(a, M - 2, M): the edge values, 2^k (the longest and
    # shortest loops) and seeded random elements
    rng = random.Random(7)
    values = [v for v in EDGE if v] + [M - 3, 3, 2**127 - 1, 2**128 - 2**96 - 1]
    values += [1 << k for k in range(128)] + [rng.randrange(1, M) for _ in range(2000)]
    feed = "\n".join(f"{v:x}" for v in values)
    out = subprocess.run([str(k6_harness[64]), "inverse"], input=feed, capture_output=True,
                         text=True, check=True, timeout=120).stdout.split()
    assert [int(x, 16) for x in out] == [pow(v, M - 2, M) for v in values]


# (threads, n, elements a thread): one element; ragged lengths in one block
# and over several
K6_CASES = [(64, 1, 1), (64, 255, 4), (64, 2049, 11), (64, 5000, 24), (256, 2049, 8),
            (256, 9000, 13), (256, 4096, 40)]


@pytest.mark.parametrize("kind", ["random", "zeros and edge values", "all M - 1"])
def test_inv_batch_kernel_body_matches_plain(k6_harness, kind):
    # K6's forward and backward passes and its tree, run as the card runs
    # them, against inv_batch_plain (exp_const_plain(a, M - 2)) on the same
    # values: zero to zero
    values = _k6_values(5000 if kind != "random" else 9000, kind, 6)
    want = limbs_to_numpy(fk.inv_batch_plain(_port(np.asarray(
        [[(v >> (32 * k)) & 0xFFFFFFFF for k in range(4)] for v in values], dtype=np.uint32))))
    want = [int(sum(int(x) << (32 * k) for k, x in enumerate(row))) for row in want]
    for build, n, per_thread in K6_CASES:
        if n > len(values):
            continue
        feed = f"{n} {per_thread}\n" + "\n".join(f"{v:x}" for v in values[:n])
        out = subprocess.run([str(k6_harness[build])], input=feed, capture_output=True,
                             text=True, check=True, timeout=120).stdout.split()
        assert [int(x, 16) for x in out] == want[:n], (build, n, per_thread)


@pytest.mark.parametrize("table", ["K6_SPLITS", "K6_VARIANTS", "EXP_VARIANTS", "EXP_EXTRA"])
def test_probe_patches_match_the_kernel_sources(table):
    # tools/air_probe.py builds K6's and exp_const's variants from patched
    # copies of csrc/: every text it replaces must be in the source it
    # patches, once, or the probe raises on the card after its first builds
    from distaff_torch.tools import air_probe

    csrc = Path(distaff_torch.__file__).resolve().parent / "csrc"
    for name, entry in getattr(air_probe, table).items():
        for file, old, _ in entry:
            assert (csrc / file).read_text().count(old) == 1, (name, file, old)


# ------------------------------------------------------------------------------------------------
# K12 power_series: its plain version and its kernel body against the JAX
# package's tiled series (distaff_tpu/ops/tiles.py) and power_series_dev
# ------------------------------------------------------------------------------------------------

PS_X = 0x0BAD_CAFE_F00D_1234_5678_9ABC_DEF0_1357 % M
PS_C = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321 % M
# one row, two, either side of K12's 1024-row block, and four blocks
PS_SIZES = [1, 2, 1023, 1024, 1025, 1 << 12]


@pytest.mark.parametrize("n", PS_SIZES)
def test_power_series_plain_matches_jax_tiled_series(n):
    from distaff_tpu.ops import tiles as jax_tiles

    want = fj.to_ints(np.asarray(jax_tiles.scale(jax_tiles.power_series(PS_X, n), PS_C)))
    got = fk.power_series_plain(PS_X, n, "cpu", PS_C)
    assert ft.to_ints(got).tolist() == want.tolist()
    assert torch.equal(fk.power_series(PS_X, n, "cpu", PS_C), got)


@pytest.mark.parametrize("n", [2, 1 << 12])
def test_power_series_plain_matches_jax_power_series_dev(n):
    # power_series_dev's doubling scan (n <= 64) and its baby-step/giant-step
    # branch
    want = [v * PS_C % M for v in fj.to_ints(np.asarray(fj.power_series_dev(fj.constant(PS_X), n)))]
    assert ft.to_ints(fk.power_series_plain(PS_X, n, "cpu", PS_C)).tolist() == want


_PS_HARNESS = r"""
#include <vector>
#include "power_series.cuh"

// K12's launch on the CPU, a block at a time, each phase for every thread
// before the next: warp 0's lanes x^l, warp 1's lanes (its five shuffle
// steps as the same products over an array of 32 lanes), then every
// thread's rows.  Returns the launch's blocks, or -1 for a list the kernel
// does not take.
extern "C" long long power_series_host(const void* factors, void* out, int tables,
                                       const long long* factor_offsets, const int* counts,
                                       const long long* rows, const long long* out_offsets) {
    using namespace power_series;
    Args a{(const uint4*)factors, (uint4*)out, 0, {}};
    const long long blocks = set_tables(a, tables, factor_offsets, counts, rows, out_offsets);
    std::vector<uint4> low(kLanes), high(kLanes);
    for (long long block = 0; block < blocks; ++block) {
        const Table& t = a.table[table_of(a, block)];
        const long long b = block - t.first_block;
        u128 p[kLanes], h[kLanes], q[kLanes];
        for (int lane = 0; lane < kLanes; ++lane) {
            low[lane] = f128::to_limbs(power(a, t, 0, lane));
            p[lane] = prefix_factor(a, t, b, lane);
            h[lane] = power(a, t, 5, lane);
        }
        for (int d = 1; d < kLanes; d <<= 1) {
            for (int lane = 0; lane < kLanes; ++lane) q[lane] = f128::mul(p[lane], p[lane ^ d]);
            for (int lane = 0; lane < kLanes; ++lane) p[lane] = q[lane];
        }
        for (int lane = 0; lane < kLanes; ++lane) high[lane] = f128::to_limbs(f128::mul(p[lane], h[lane]));
        for (int tid = 0; tid < kThreads; ++tid) store(a, t, b, low.data(), high.data(), tid);
    }
    return blocks;
}
"""


@pytest.fixture(scope="module")
def k12_body(tmp_path_factory):
    """csrc/power_series.cuh built with g++ as a host function of one
    launch over a list of tables, called as the wrapper launches it."""
    import ctypes

    tmp = tmp_path_factory.mktemp("k12")
    csrc = Path(fk.__file__).resolve().parent.parent / "csrc"
    (tmp / "harness.cpp").write_text(_PS_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(csrc),
                    str(tmp / "harness.cpp"), "-o", str(tmp / "libps.so")], check=True)
    lib = ctypes.CDLL(str(tmp / "libps.so"))
    llp = ctypes.POINTER(ctypes.c_longlong)
    lib.power_series_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, llp,
                                      ctypes.POINTER(ctypes.c_int), llp, llp]
    lib.power_series_host.restype = ctypes.c_longlong

    def launch(specs):
        """The tables of specs [(x, n, c)] from one launch of the harness,
        laid out as power_series_many lays them out."""
        factors, offsets, counts, rows, outs = [], [], [], [], []
        for x, n, c in specs:
            offsets.append(len(factors))
            factors += fk.power_series_factors(x, n, c)
            counts.append(len(factors) - offsets[-1])
            outs.append(sum(rows))
            rows.append(n)
        limbs = ft.from_ints(factors, "cpu")
        out = torch.zeros((sum(rows), 4), dtype=torch.uint32)
        k = len(specs)
        blocks = lib.power_series_host(
            limbs.data_ptr(), out.data_ptr(), k, (ctypes.c_longlong * k)(*offsets),
            (ctypes.c_int * k)(*counts), (ctypes.c_longlong * k)(*rows),
            (ctypes.c_longlong * k)(*outs))
        assert blocks == sum(-(-n // fk.POWER_SERIES_TILE) for n in rows)
        return [out[o:o + n] for o, n in zip(outs, rows)]
    return launch


def test_power_series_kernel_body_matches_plain(k12_body):
    root = jax_host_field.get_root_of_unity(1 << 12)
    specs = [(x, n, c) for x, c in ((PS_X, PS_C), (root, 1), (root, PS_C)) for n in PS_SIZES]
    for (x, n, c), got in zip(specs, k12_body(specs)):
        assert torch.equal(got, fk.power_series_plain(x, n, "cpu", c)), (x, n, c)


def test_power_series_kernel_body_mixed_list_matches_jax_series(k12_body):
    # one launch over a table of one row, a ragged one, 2048 rows and 2^20
    # rows (1024 blocks: the prefix takes ten squarings), with c != 1,
    # against the JAX package's tiled series times c
    from distaff_tpu.ops import tiles as jax_tiles

    root = jax_host_field.get_root_of_unity(1 << 20)
    specs = [(PS_X, 1, PS_C), (root, 3000, PS_C), (PS_X, 2048, 1), (root, 1 << 20, PS_C)]
    for (x, n, c), got in zip(specs, k12_body(specs)):
        want = np.asarray(jax_tiles.scale(jax_tiles.power_series(x, n), c))
        assert np.array_equal(got.numpy(), want.reshape(n, 4)), (n, c)


def test_power_series_many_is_each_table_on_the_cpu():
    root = jax_host_field.get_root_of_unity(1 << 12)
    specs = [(PS_X, 1, PS_C), (root, 0, 1), (root, 1500, PS_C)]
    got = fk.power_series_many(specs, "cpu")
    assert [t.shape[0] for t in got] == [1, 0, 1500]
    for (x, n, c), table in zip(specs, got):
        assert torch.equal(table, fk.power_series_plain(x, n, "cpu", c))
