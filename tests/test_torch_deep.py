"""distaff_torch step 6 on the CPU: kernel K7's plain version (the DEEP
composition) against the JAX package's _compose_tiles_batched, kernel K8's
plain version (point evaluations) against its _poly_eval_rows_multi, both
kernels' bodies built with g++ from their headers and run a block and a
thread at a time against the plain versions, and step 6's calls counted.
Exact equality throughout (integer field arithmetic)."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu.math import field as jax_host_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.stark import prover as jax_prover
from distaff_torch import assembly, native, ProgramInputs
from distaff_torch.interop import limbs_from_numpy
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import deep_kernels as dk
from distaff_torch.ops import field_kernels as fk
from distaff_torch.stark import prover, utils
from distaff_torch.stark.trace_table import TraceTable

M = jax_host_field.M
CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"
TESTS = Path(__file__).resolve().parent          # torch_mma_host.h: the tensor-core emulation


def _ints(count, rng):
    return [int.from_bytes(rng.bytes(16), "little") % M for _ in range(count)]


def _limbs(ints):
    return ft.from_ints(np.array(ints, dtype=object), "cpu")


def _case(regs, n, seed, zero=None):
    """A random LDE (regs, n), constraint evaluations, weights and the eight
    scalars, from a numpy seed; with zero = (k, j), z = w^k and zg = w^j, so
    that x - z and x - zg vanish at points k and j."""
    rng = np.random.default_rng(seed)
    lde = [_ints(n, rng) for _ in range(regs)]
    c_lde, w1, w2 = _ints(n, rng), _ints(regs, rng), _ints(regs, rng)
    z, zg, s1, s2, cz, k1, k2, kc = _ints(8, rng)
    root = jax_host_field.get_root_of_unity(n)
    if zero is not None:
        z, zg = pow(root, zero[0], M), pow(root, zero[1], M)
    return lde, c_lde, w1, w2, root, (z, zg, s1, s2, cz, k1, k2, kc)


def _port_case(case):
    lde, c_lde, w1, w2, root, scalars = case
    return _limbs(lde), _limbs(c_lde), _limbs(w1), _limbs(w2), root, scalars


@pytest.mark.parametrize("zero", [None, (5, 77)])
def test_deep_compose_plain_matches_jax_compose_tiles(zero):
    # two tiles of 64 points, the JAX package's tile inputs (the weighted
    # sums, the tile prefixes and the power series over a tile) built from
    # host ints; with zero, x - z and x - zg vanish at points 5 and 77
    regs, n, tile, incr = 3, 128, 64, 37
    case = _case(regs, n, 11, zero)
    lde, c_lde, w1, w2, root, scalars = case
    z, zg, s1, s2, cz, k1, k2, kc = scalars
    a1 = [sum(w * row[i] for w, row in zip(w1, lde)) % M for i in range(n)]
    a2 = [sum(w * row[i] for w, row in zip(w2, lde)) % M for i in range(n)]
    base = pow(root, incr, M)

    def tiles(values):
        return fj.from_ints(np.array(values, dtype=object).reshape(n // tile, tile))

    want = jax_prover._compose_tiles_batched(
        tiles(a1), tiles(a2), tiles(c_lde),
        fj.from_ints([pow(root, j, M) for j in range(tile)]),
        fj.from_ints([pow(root, lo, M) for lo in range(0, n, tile)]),
        *(fj.constant(v) for v in scalars),
        fj.from_ints([pow(base, j, M) for j in range(tile)]),
        fj.from_ints([pow(base, lo, M) for lo in range(0, n, tile)]), False)
    got = dk.deep_compose(*_port_case(case)[:5], incr, scalars)
    assert ft.to_ints(got).tolist() == fj.to_ints(want).reshape(n).tolist()
    if zero is not None:
        assert ft.to_ints(got)[list(zero)].tolist() == [0, 0]


def test_deep_compose_plain_at_an_offset_matches_the_whole_domain():
    # chip_smoke.py holds K7 over long domains a window of points at a time
    incr = 99
    lde, c_lde, w1, w2, root, scalars = _port_case(_case(2, 512, 8, (300, 301)))
    want = dk.deep_compose_plain(lde, c_lde, w1, w2, root, incr, scalars)
    for start, stop in ((0, 128), (128, 512), (296, 304)):
        got = dk.deep_compose_plain(lde[:, start:stop], c_lde[start:stop], w1, w2, root, incr,
                                    scalars, start=start)
        assert torch.equal(got, want[start:stop])


@pytest.mark.parametrize("regs,length,points", [(3, 256, 2), (1, 1024, 1)])
def test_poly_eval_plain_matches_jax_rows_multi(regs, length, points):
    rng = np.random.default_rng(length + points)
    rows = [_ints(length, rng) for _ in range(regs)]
    xs = _ints(points, rng)
    want = jax_prover._poly_eval_rows_multi(fj.from_ints(np.array(rows, dtype=object)), xs)
    got = dk.poly_eval(_limbs(rows), xs)
    assert ft.to_ints(got).tolist() == want


_HARNESS = r"""
#include <array>
#include <cstring>
#include <vector>
#include "deep_compose.cuh"
#include "poly_eval.cuh"
#include "torch_mma_host.h"

// K7's launch on the CPU over a grid of `grid` blocks: the ring, product
// and digits of tests/torch_mma_host.h, then deep_compose.cu's epilogue,
// each phase (keep_sum, forward, the tree's levels, backward) for every
// thread of the block before the next
extern "C" void deep_compose_host(const void* lde, long long lde_stride, int regs, long long n,
                                  const void* c_lde, const void* w1, const void* w2,
                                  const void* x_lo, const void* x_hi, const void* i_lo,
                                  const void* i_hi, int log_lo, const uint32_t* scalars,
                                  void* out, long long grid) {
    using namespace deep_compose;
    Args a{{(const uint4*)lde, lde_stride, regs, n, (const uint4*)w1, (const uint4*)w2},
           (const uint4*)c_lde, (const uint4*)x_lo, (const uint4*)x_hi, (const uint4*)i_lo,
           (const uint4*)i_hi, log_lo, {}, (uint4*)out};
    std::memcpy(&a.s, scalars, sizeof(a.s));
    const wsum::Ring l = wsum::ring(regs, kSumsBytes);
    std::vector<u128> q(kThreads, 1);
    std::vector<long long> at(kThreads, -1);
    std::vector<Inputs> in(kThreads);
    auto reduce = [&](long long block, long long k, long long mine, const uint32_t* digits,
                      uint8_t* shared) {
        u128* const sums = (u128*)(shared + wsum::extra_at(l));
        for (int tid = 0; tid < kThreads; ++tid) {
            keep_sum(sums, k, digits, tid);
            if ((k & 1) == 0) {
                at[tid] = pair_point(a, block, grid, mine, k >> 1, tid);
                if (at[tid] >= 0) in[tid] = fetch(a, at[tid]);
            }
        }
    };
    auto then = [&](long long block, long long k, long long mine, uint8_t* shared) {
        u128* const sums = (u128*)(shared + wsum::extra_at(l));
        if (!pair_done(k, mine)) return;
        for (int tid = 0; tid < kThreads; ++tid)
            if (at[tid] >= 0) forward(a, sums, at[tid], tid, in[tid], q[tid]);
        if (!round_done(k, mine)) return;
        u128* const tree = sums;
        for (int tid = 0; tid < kThreads; ++tid) tree[kThreads + tid] = q[tid];
        for (int level = 0; (kThreads >> level) > 1; ++level)
            for (int tid = 0; tid < kThreads; ++tid) inv_block::up(tree, kThreads, tid, level);
        inv_block::invert_root(tree);
        for (int level = inv_block::Log2<kThreads>::value - 1; level >= 0; --level)
            for (int tid = 0; tid < kThreads; ++tid) inv_block::down(tree, kThreads, tid, level);
        for (int tid = 0; tid < kThreads; ++tid) {
            walk_back(a, block, grid, mine, k >> 1, tid, tree[kThreads + tid]);
            q[tid] = 1;
        }
    };
    mma_host::run(a.lde, kSumsBytes, grid, reduce, then);
}

extern "C" long long deep_compose_round_points() { return 2 * deep_compose::kTile * deep_compose::kRoundPairs; }

// K8's launch on the CPU at 2^log coefficients a thread: each row's blocks
// in order (so that the last block to take its ticket is the last index),
// each phase for every thread of the block before the next, a shuffle
// level as lane t taking lane t + 2^k's value
extern "C" void poly_eval_host(const void* in, void* out, void* partial, uint32_t* tickets,
                               long long len, long long rows, int points,
                               const uint32_t* squarings, int log) {
    using namespace poly_eval;
    using f128::u128;
    const int log_span = kLogThreads + log;
    Args a{(const uint4*)in, (uint4*)out, (uint4*)partial, tickets, len, log_span,
           (int)((len + (1LL << log_span) - 1) >> log_span), points, {}};
    std::memcpy(a.sq, squarings, sizeof(uint4) * kSquarings * points);
    std::vector<std::array<u128, kMaxPoints>> h(kThreads);
    auto at = [&](int t) -> u128 (&)[kMaxPoints] { return *(u128 (*)[kMaxPoints])h[t].data(); };
    auto lanes = [&](int k, bool weighted) {           // a shuffle level in every warp
        for (int t = 0; t < kThreads; t += 2 << k)
            if (weighted) combine(a, k, at(t), at(t + (1 << k))); else add_into(a, at(t), at(t + (1 << k)));
    };
    for (long long row = 0; row < rows; ++row)
        for (long long block = 0; block < a.blocks; ++block) {
            for (int tid = 0; tid < kThreads; ++tid) {
                if (log == kLongLog) horner<kLongLog>(a, row, block, tid, at(tid));
                else horner<kShortLog>(a, row, block, tid, at(tid));
            }
            for (int k = 0; k < 5; ++k) lanes(k, true);
            std::array<u128, kMaxPoints> w[kWarps];           // warp_values, then warp 0's lanes
            for (int warp = 0; warp < kWarps; ++warp) w[warp] = h[32 * warp];
            for (int k = 0; k < kLogWarps; ++k)
                for (int t = 0; t < kWarps; t += 2 << k)
                    combine(a, 5 + k, *(u128 (*)[kMaxPoints])w[t].data(),
                            *(const u128 (*)[kMaxPoints])w[t + (1 << k)].data());
            u128 (&value)[kMaxPoints] = *(u128 (*)[kMaxPoints])w[0].data();
            scale(a, block, value);
            store(a, row, block, value);
            if (a.blocks == 1 || tickets[row]++ != (uint32_t)a.blocks - 1) continue;
            for (int tid = 0; tid < kThreads; ++tid) gather(a, row, tid, at(tid));
            for (int k = 0; k < 5; ++k) lanes(k, false);
            for (int p = 0; p < points; ++p) {
                u128 sum = 0;
                for (int warp = 0; warp < kWarps; ++warp) sum = f128::add(sum, h[32 * warp][p]);
                a.out[row * points + p] = f128::to_limbs(sum);
            }
            tickets[row] = 0;
        }
}

extern "C" int poly_eval_log_per_thread(long long rows, long long len) {
    return poly_eval::log_per_thread(rows, len);
}
"""


@pytest.fixture(scope="module")
def kernel_bodies(tmp_path_factory):
    """csrc/deep_compose.cuh, inv_block.cuh and poly_eval.cuh built with g++
    as host functions with the kernels' arguments."""
    tmp = tmp_path_factory.mktemp("deep")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC), "-I",
                    str(TESTS), str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")],
                   check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.deep_compose_host.argtypes = [vp, ll, i32, ll] + [vp] * 7 + [
        i32, ctypes.POINTER(ctypes.c_uint32), vp, ll]
    lib.deep_compose_round_points.restype = ll
    lib.poly_eval_host.argtypes = [vp, vp, vp, vp, ll, ll, i32, ctypes.POINTER(ctypes.c_uint32),
                                   i32]
    lib.poly_eval_log_per_thread.argtypes = [ll, ll]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _compose_body(lib, case, n, incr, grid):
    """K7's launch on the CPU over the first n points of `case`'s domain
    (the port's tensors) in a grid of `grid` blocks: (n, 4) limbs."""
    lde, c_lde, w1, w2, root, scalars = case
    stride, regs, _, tables, words = dk.compose_args(lde, root, incr, scalars)
    out = torch.full((n, 4), 0xDEADBEEF, dtype=torch.uint32)
    lib.deep_compose_host(
        _ptr(lde), stride, regs, n, _ptr(c_lde), _ptr(w1), _ptr(w2), *map(_ptr, tables),
        dk.LOG_LO, (ctypes.c_uint32 * 32)(*words), _ptr(out), grid)
    return out


@pytest.mark.parametrize("domain,n,zero", [
    (4096, 4096, None),           # 32 tiles in one block, x from the lo and hi tables
    (4096, 3000, (7, 2999)),      # a ragged last tile, an odd tile count, zero factors
    (256, 256, (100, 101)),       # one pair of tiles, x from the lo table alone
])
def test_deep_compose_kernel_body_matches_plain(kernel_bodies, domain, n, zero):
    incr = 1234
    case = _port_case(_case(3, domain, domain + n, zero))
    out = _compose_body(kernel_bodies, case, n, incr, 1)
    lde, c_lde, w1, w2, root, scalars = case
    want = dk.deep_compose_plain(lde[:, :n].contiguous(), c_lde[:n], w1, w2, root, incr, scalars)
    assert torch.equal(out, want)
    if zero is not None:
        assert not out[list(zero)].to(torch.int64).any()


@pytest.mark.parametrize("regs,n,values,grid,zero", [
    pytest.param(1, 256, "random", 1, None, id="1-256"),          # an odd group: a k-step half empty
    pytest.param(2, 640, "streamed", 2, (3, 600), id="2-640-streamed"),   # weights (1, 0), (0, 1)
    pytest.param(20, 1000, "random", 3, (0, 999), id="20-1000-ragged"),   # odd tile counts a block
    pytest.param(20, 256, "M - 1", 1, None, id="20-256-M-1"),
    pytest.param(33, 384, "random", 2, None, id="33-384"),        # two register groups of 17
    pytest.param(128, 256, "M - 1", 2, None, id="128-256-M-1"),   # four groups, the largest digits
    pytest.param(1, 10000, "random", 1, (5, 9000), id="1-10000-rounds"),  # two rounds a block
])
def test_deep_compose_kernel_body_at_register_counts(kernel_bodies, regs, n, values, grid, zero):
    # the tensor-core sums over one to four register groups, on random
    # values, on the streamed prover's call and on all M - 1 (the largest
    # digit sums), bit for bit the plain version's
    domain = 1 << (n - 1).bit_length()
    lde, c_lde, w1, w2, root, scalars = _case(regs, domain, regs * n, zero)
    if values == "M - 1":
        lde, c_lde = [[M - 1] * domain] * regs, [M - 1] * domain
        w1, w2 = [M - 1] * regs, [M - 1] * regs
    if values == "streamed":
        w1, w2 = [1, 0], [0, 1]
    case = _port_case((lde, c_lde, w1, w2, root, scalars))
    incr = 77
    out = _compose_body(kernel_bodies, case, n, incr, grid)
    lde, c_lde, w1, w2, root, scalars = case
    want = dk.deep_compose_plain(lde[:, :n].contiguous(), c_lde[:n], w1, w2, root, incr, scalars)
    assert torch.equal(out, want)
    if zero is not None:
        assert not out[list(zero)].to(torch.int64).any()


def test_deep_compose_body_cases_cross_rounds(kernel_bodies):
    # a round of Montgomery's trick is 32 pairs of 128-point tiles, 8192
    # points to one inversion (deep_compose.cuh, DEEP_ROUND_PAIRS): the body
    # case of 10000 points in one block crosses a round's end
    assert kernel_bodies.deep_compose_round_points() == 8192


@pytest.mark.parametrize("regs,length,points,log", [
    # 8 coefficients a thread (log 3), the spans 2048:
    # under one span: one block a row, its value stored directly
    pytest.param(3, 256, 2, 3, id="3-256-2"),
    # 7 blocks a row, a partial last span, four points a read
    pytest.param(2, 3 * 4096 + 100, 4, 3, id="2-12388-4"),
    # 35 blocks: block indices up to 2^5, the last block's sum
    pytest.param(1, 70000, 1, 3, id="1-70000-1"),
    pytest.param(2, 1, 3, 3, id="2-1-3"),                      # one coefficient
    # 64 a thread (log 6), the spans 16384: 3 spans of 8 batches each
    pytest.param(2, 40000, 2, 6, id="2-40000-2-long"),
    # under one span, past the first batch only in part
    pytest.param(1, 5000, 3, 6, id="1-5000-3-long"),
])
def test_poly_eval_kernel_body_matches_plain(kernel_bodies, regs, length, points, log):
    rng = np.random.default_rng(length)
    polys = _limbs([_ints(length, rng) for _ in range(regs)])
    xs = _ints(points, rng)

    def launch(polys, out, partial, tickets, length, rows, count, words):
        kernel_bodies.poly_eval_host(polys.data_ptr(), out.data_ptr(), partial.data_ptr(),
                                     tickets.data_ptr(), length, rows, count,
                                     (ctypes.c_uint32 * len(words))(*words), log)

    got = dk.evaluate_group(polys, xs, launch)
    assert torch.equal(got, dk.poly_eval_plain(polys, xs))
    assert not dk._tickets(regs, "cpu").any()          # each row's last block reset its counter


def test_poly_eval_takes_more_coefficients_a_thread_in_large_calls(kernel_bodies):
    # 8 a thread in the 2^16 proof's calls and the 2^18 proof's constraint
    # polynomial, 64 from 2^22 coefficients a call on
    choose = kernel_bodies.poly_eval_log_per_thread
    assert [choose(r, n) for r, n in ((20, 1 << 16), (1, 1 << 19), (1, 1 << 21))] == [3, 3, 3]
    assert [choose(r, n) for r, n in ((20, 1 << 18), (20, 1 << 20), (1, 1 << 23))] == [6, 6, 6]


def test_step_six_is_one_composition_and_two_evaluations(monkeypatch):
    # step 6 on the CPU calls K7's plain version once, K8's twice (the trace
    # polynomials at z and zg, the constraint polynomial at z) and no other
    # field operation; on the card that is one K7 launch and one K8 launch
    # a call, whatever the rows' length
    program = assembly.compile("begin push.3 push.5 add end")
    regs, ctx, loop = native.execute_u64(program, ProgramInputs.none())
    trace = TraceTable(regs, ctx, loop, 16)
    trace.extend("cpu")
    n, ev = trace.domain_size(), trace.unextended_length() * 8
    rng = np.random.default_rng(6)
    constraint_poly, constraint_lde = _limbs(_ints(ev, rng)), _limbs(_ints(n, rng))
    calls = {"deep_compose": 0, "poly_eval": 0}

    def counted(name, real):
        def call(*args):
            calls[name] += 1
            return real(*args)
        return call

    def other(*args):
        raise AssertionError("a field operation outside step 6's kernels")

    monkeypatch.setattr(dk, "deep_compose_plain", counted("deep_compose", dk.deep_compose_plain))
    monkeypatch.setattr(dk, "poly_eval_plain", counted("poly_eval", dk.poly_eval_plain))
    for name in ("mul", "add", "sub", "inv_batch", "exp_const"):
        monkeypatch.setattr(ft, name, other)
        monkeypatch.setattr(fk, name, other)
    parts = []
    composed, deep = prover._build_composition_evaluations(
        trace, constraint_poly, constraint_lde, 12345, utils.CompositionCoefficients(b"\x06" * 32),
        parts.append)
    assert calls == {"deep_compose": 1, "poly_eval": 2}
    assert parts == ["point evaluations (K8)", "composition (K7)"]
    assert composed.shape == (n, 4) and len(deep.trace_at_z1) == regs.shape[0]
    assert dk.poly_eval_launches(2) == 1 and dk.poly_eval_launches(1) == 1
    assert dk.poly_eval_launches(5) == 2


def test_wrappers_refuse_what_they_cannot_take():
    x = limbs_from_numpy(np.zeros((2, 8, 4), dtype=np.uint32), "cpu")
    with pytest.raises(ValueError, match="point"):
        dk.poly_eval(x, [])
    with pytest.raises(ValueError, match="shapes"):
        dk.deep_compose(x, x[0, :4], x[:, 0], x[:, 0], 1, 1, (0,) * 8)
    with pytest.raises(ValueError, match="power of two"):
        dk.deep_compose(x[:, :6], x[0, :6], x[:, 0], x[:, 0], 1, 1, (0,) * 8)
