"""distaff_torch's step 4 (kernel K11, syn_div) on the CPU: the wrapper's
plain version against the JAX package's device divisions
(prover._syn_div_dev, _syn_div_expanded_dev) and host divisions
(_syn_div_column, _syn_div_expanded_column), and the kernel's body
(csrc/syn_div.cuh) built with g++ and run a block at a time, the tiles in
ticket order and with every tile's aggregate published before any
look-back, against the plain version.  Exact equality throughout (integer
field arithmetic).  Each JAX device division is compiled once a size, for
both of its cases."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu.math import field as jax_host_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.stark import prover as jax_prover
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import field_kernels as fk
from distaff_torch.ops import syndiv_kernels as sk
from distaff_torch.ops import tiles

M = jax_host_field.M
CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"
EDGE = [0, 1, M - 1]
STEP_ROWS = 8                     # n_ev = 8 x trace length


def _x_last(trace_length):
    return jax_host_field.exp(jax_host_field.get_root_of_unity(trace_length), trace_length - 1)


def _coefficients(n, seed, edge=False):
    """(3, n) random field elements as object ints, with 0, 1 and M - 1 in
    front of each row where `edge`."""
    rng = np.random.default_rng(seed)
    rows = np.array([[int.from_bytes(rng.bytes(16), "little") % M for _ in range(n)]
                     for _ in range(3)], dtype=object)
    if edge:
        rows[:, :len(EDGE)] = EDGE
        rows[:, -len(EDGE):] = EDGE
    return rows


def _port(rows):
    return ft.from_ints(rows, "cpu")


def _jax_device(rows, trace_length):
    """The JAX package's step 4 past the iNTT on these coefficients."""
    x_last = _x_last(trace_length)
    a, f, t = (fj.from_ints(row) for row in rows)
    total = fj.add(fj.add(jax_prover._syn_div_dev(a, 1), jax_prover._syn_div_dev(f, x_last)),
                   jax_prover._syn_div_expanded_dev(t, trace_length, x_last))
    return fj.to_ints(np.asarray(total)).tolist()


def _jax_host(rows, trace_length):
    x_last = _x_last(trace_length)
    return [int(v) % M for v in (jax_prover._syn_div_column(rows[0].copy(), 1)
                                 + jax_prover._syn_div_column(rows[1].copy(), x_last)
                                 + jax_prover._syn_div_expanded_column(rows[2].copy(),
                                                                       trace_length, x_last))]


@pytest.fixture(scope="module", params=[1 << 10, 1 << 12])
def jax_device_case(request):
    """(coefficients, trace length, the JAX device divisions' sum) at one
    n_ev, computed once for the file's tests of that size."""
    n = request.param
    rows = _coefficients(n, n)
    return rows, n // STEP_ROWS, _jax_device(rows, n // STEP_ROWS)


def test_plain_version_matches_jax_device_divisions(jax_device_case):
    rows, trace_length, want = jax_device_case
    got = sk.syn_div_plain(_port(rows), trace_length, _x_last(trace_length))
    assert ft.to_ints(got).tolist() == want


def test_wrapper_on_cpu_matches_jax_device_divisions(jax_device_case):
    # the prover's call: the wrapper takes the plain version for a CPU tensor
    rows, trace_length, want = jax_device_case
    assert ft.to_ints(sk.syn_div(_port(rows), trace_length,
                                 _x_last(trace_length))).tolist() == want


@pytest.mark.parametrize("n,edge", [(128, True), (256, False), (1024, True), (4096, True)])
def test_plain_version_matches_jax_host_divisions(n, edge):
    rows = _coefficients(n, n + 1, edge)
    got = sk.syn_div_plain(_port(rows), n // STEP_ROWS, _x_last(n // STEP_ROWS))
    assert ft.to_ints(got).tolist() == _jax_host(rows, n // STEP_ROWS)


@pytest.mark.parametrize("start", [0, 8, 600, 1000, 1023])
def test_plain_version_from_a_row_matches_the_whole(start):
    # chip_smoke.py holds K11's long calls a piece at a time from the end;
    # a start that is not a multiple of the degree pads the stride sums
    rows = _port(_coefficients(1024, 5))
    x_last = _x_last(128)
    whole = sk.syn_div_plain(rows, 128, x_last)
    assert torch.equal(sk.syn_div_plain(rows, 128, x_last, start=start), whole[start:])


def test_wrapper_refuses_what_it_cannot_take():
    rows = _port(_coefficients(64, 3))
    with pytest.raises(ValueError, match="power of two"):
        sk.syn_div(rows[:, :48], 8, 1)
    with pytest.raises(ValueError, match="degree"):
        sk.syn_div(rows, 65, 1)
    with pytest.raises(ValueError, match="coefficients"):
        sk.syn_div(rows[:2], 8, 1)


# ------------------------------------------------------------------------------------------------
# the kernel's body on the CPU
# ------------------------------------------------------------------------------------------------

_HARNESS = r"""
#include <cstring>
#include <vector>
#include "syn_div.cuh"

using namespace syn_div;

namespace {

struct Block {
    Shared s;
    u128 after[kThreads][2];          // each thread's sums of the elements after its own
    u128 total[2];
};

struct Up {
    u128 v[kPerThread];
};

// syn_div.cu's warp_suffix over one warp's lanes (its __shfl_down_sync
// returns a lane's own value where no lane is `off` up)
void warp_suffix(u128 (&v)[kLanes][2], int count) {
    for (int off = 1; off < kLanes && off < count; off <<= 1) {
        u128 up[kLanes][2];
        for (int lane = 0; lane < kLanes; ++lane)
            for (int x = 0; x < 2; ++x)
                up[lane][x] = v[lane + off < kLanes ? lane + off : lane][x];
        for (int lane = 0; lane < kLanes; ++lane)
            for (int x = 0; x < 2; ++x)
                v[lane][x] = suffix_step(v[lane][x], up[lane][x], lane, off, count);
    }
}

void warp_after(const u128 (&v)[kLanes][2], int count, u128 (&after)[kLanes][2]) {
    for (int lane = 0; lane < kLanes; ++lane)
        for (int x = 0; x < 2; ++x) after[lane][x] = lane + 1 < count ? v[lane + 1][x] : 0;
}

// the kernel's loads
void load_tile(const Args& g, Block& b) {
    for (int tid = 0; tid < kThreads; ++tid) load(g, b.s, b.s.tile, tid);
}

// the kernel from its sums to publish_aggregate
void publish(const Args& g, Block& b) {
    const long long tile = b.s.tile;
    u128 v[kLanes][2], after[kLanes][2];
    for (int warp = 0; warp < kWarps; ++warp) {
        for (int lane = 0; lane < kLanes; ++lane)
            thread_sums(g, b.s, tile, warp * kLanes + lane, v[lane]);
        warp_suffix(v, kLanes);
        warp_after(v, kLanes, after);
        for (int lane = 0; lane < kLanes; ++lane)
            for (int x = 0; x < 2; ++x) b.after[warp * kLanes + lane][x] = after[lane][x];
        store_warp_sums(b.s, v[0], warp);
    }
    for (int lane = 0; lane < kLanes; ++lane)
        for (int x = 0; x < 2; ++x)
            v[lane][x] = lane < kWarps ? f128::from_limbs(b.s.warp_sums[x][lane]) : 0;
    warp_suffix(v, kWarps);
    warp_after(v, kWarps, after);
    for (int lane = 0; lane < kWarps; ++lane)
        for (int x = 0; x < 2; ++x) b.s.warp_sums[x][lane] = f128::to_limbs(after[lane][x]);
    b.total[0] = v[0][0];
    b.total[1] = v[0][1];
    publish_aggregate(g, tile, b.total);
}

// syn_div.cu's look_back, its lanes in turn, and publish_inclusive;
// counts the tiles it found with their aggregate alone
void look_back(const Args& g, Block& b, long long& aggregates) {
    const long long tile = b.s.tile, nt = tiles(g);
    u128 carry[2] = {0, 0};
    for (long long base = tile + 1; base < nt; base += kLanes) {
        u128 v[kLanes][2] = {};
        unsigned inclusive = 0;
        for (int lane = 0; lane < kLanes; ++lane) {
            const long long p = base + lane;
            const uint32_t st = p < nt ? peek(g, p, v[lane]) : kEmpty;
            if (st == kInclusive) inclusive |= 1u << lane;
            aggregates += st == kAggregate;
        }
        for (int lane = 0; lane < kLanes; ++lane)
            if (inclusive && lane > __builtin_ctz(inclusive)) v[lane][0] = v[lane][1] = 0;
        warp_suffix(v, kLanes);
        carry[0] = f128::add(carry[0], v[0][0]);
        carry[1] = f128::add(carry[1], v[0][1]);
        if (inclusive) break;
    }
    publish_inclusive(g, b.s, tile, b.total, carry);
}

// the kernel's R, between publish_aggregate and the look-back
void r_tile(const Args& g, Block& b) {
    const long long tile = b.s.tile;
    wait_r(g, tile);
    std::vector<Up> up(kThreads);
    for (long long off = g.d; off < kTile; off *= 2) {
        for (int tid = 0; tid < kThreads; ++tid) chain_read(b.s, (int)off, tid, up[tid].v);
        for (int tid = 0; tid < kThreads; ++tid) chain_add(b.s, tid, up[tid].v);
    }
    for (int tid = 0; tid < kThreads; ++tid) store_r(g, b.s, tile, tid);
    store_release(r_ready(g, tile), 1);
}

// the kernel after the look-back: out
void out_tile(const Args& g, Block& b) {
    const long long tile = b.s.tile;
    for (int tid = 0; tid < kThreads; ++tid)
        for (int x = 0; x < 2; ++x)
            b.after[tid][x] = f128::add(b.after[tid][x],
                                        f128::from_limbs(b.s.warp_sums[x][tid / kLanes]));
    for (int tid = 0; tid < kThreads; ++tid) finish(g, b.s, tile, tid, b.after[tid]);
    for (int tid = 0; tid < kThreads; ++tid) store_out(g, b.s, tile, tid);
}

}  // namespace

// K11's launch on the CPU, a block at a time, each phase of a block for
// every thread before the next, the blocks' tiles from the ticket.  Order
// 0: each block whole, in ticket order.  Order 1: every block's phases to
// its aggregate first, then their R in ticket order, then the look-backs
// from the first tile up (so each walks over tiles that have published
// their aggregate alone), then out in ticket order.  Returns the waits that found their word unset (0
// in any order the card could run), and the aggregates the look-backs met.
extern "C" int syn_div_host(const void* polys, long long row_stride, long long n, long long d,
                            const void* b_lo, const void* b_hi, const void* binv_lo,
                            const void* binv_hi, int log_lo, const uint32_t* words, void* flags,
                            void* sums, void* r, void* out, int order, long long* aggregates) {
    const uint4* p = (const uint4*)polys;
    Args g{p, p + row_stride, p + 2 * row_stride, n, d, (const uint4*)b_lo, (const uint4*)b_hi,
           (const uint4*)binv_lo, (const uint4*)binv_hi, log_lo, {}, {}, (uint32_t*)flags,
           (uint4*)sums, (uint4*)r, (uint4*)out};
    std::memcpy(&g.b, words, sizeof(g.b));
    std::memcpy(&g.neg_e, words + 4, sizeof(g.neg_e));
    const long long nt = tiles(g);
    std::memset(flags, 0, (2 * nt + 1) * sizeof(uint32_t));
    host_unready = 0;
    *aggregates = 0;
    std::vector<Block> blocks(nt);
    for (Block& b : blocks) b.s.tile = nt - 1 - (long long)(*ticket(g))++;
    if (order == 0) {
        for (Block& b : blocks) {
            load_tile(g, b);
            publish(g, b);
            r_tile(g, b);
            look_back(g, b, *aggregates);
            out_tile(g, b);
        }
    } else {
        for (Block& b : blocks) load_tile(g, b);
        for (Block& b : blocks) publish(g, b);
        for (Block& b : blocks) r_tile(g, b);
        for (long long k = nt - 1; k >= 0; --k) look_back(g, blocks[k], *aggregates);
        for (Block& b : blocks) out_tile(g, b);
    }
    return host_unready;
}

extern "C" long long syn_div_tile() { return syn_div::kTile; }
"""

# (threads, elements a thread): a tile of 64 (two warps), so that a few
# thousand points carry across dozens of tiles and the look-back walks
# more than one window of 32, and the card's tile of 1024
TILES = [(64, 1), (256, 4)]


@pytest.fixture(scope="module", params=TILES, ids=lambda t: f"tile{t[0] * t[1]}")
def kernel_body(request, tmp_path_factory):
    """csrc/syn_div.cuh built with g++ at one tile size."""
    threads, per_thread = request.param
    tmp = tmp_path_factory.mktemp(f"syndiv{threads}")
    (tmp / "harness.cpp").write_text(_HARNESS)
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(CSRC),
                    f"-DSYN_DIV_THREADS={threads}", f"-DSYN_DIV_PER_THREAD={per_thread}",
                    str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")], check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.syn_div_host.argtypes = [vp, ll, ll, ll, vp, vp, vp, vp, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint32), vp, vp, vp, vp, ctypes.c_int,
                                 ctypes.POINTER(ll)]
    lib.syn_div_tile.restype = ll
    assert lib.syn_div_tile() == threads * per_thread
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


CASES = [
    (16, 2),          # one partial tile, d < tile; b's tables without hi
    (512, 64),        # n/d = 8: 8 small tiles, d = the small tile
    (1024, 16),       # d < the small tile across 16 of them: the chain from the next tile's R
    (4096, 512),      # n/d = 8: 64 small tiles, 4 of the card's; b's tables with hi
    (8192, 1024),     # n/d = 8, d = the card's tile: its chain across 8 of them
    (2048, 2048),     # d = n: the stride sums are single terms
]
ORDERS = ("ticket order", "aggregates first")


@pytest.mark.parametrize("n,degree,order", [
    pytest.param(n, d, order, id=f"{n}-{d}" + ("" if order == ORDERS[0] else "-aggregates-first"))
    for n, d in CASES for order in ORDERS])
def test_kernel_body_matches_plain(kernel_body, n, degree, order):
    rows = _port(_coefficients(n, n + degree, edge=True))
    x_last = _x_last(degree)
    (b_lo, b_hi), (i_lo, i_hi), words = sk.syn_div_args(n, x_last, "cpu")
    tile = kernel_body.syn_div_tile()
    n_tiles = -(-n // tile)
    flags = torch.zeros(2 * n_tiles + 1, dtype=torch.int32)
    sums = torch.zeros((n_tiles, 4, 4), dtype=torch.uint32)
    r = torch.zeros((n, 4), dtype=torch.uint32)
    out = torch.zeros((n, 4), dtype=torch.uint32)
    aggregates = ctypes.c_longlong()
    unready = kernel_body.syn_div_host(
        _ptr(rows), rows.stride(0) // 4, n, degree, _ptr(b_lo), _ptr(b_hi), _ptr(i_lo),
        _ptr(i_hi), tiles._LOG_LO, (ctypes.c_uint32 * 8)(*words), _ptr(flags), _ptr(sums),
        _ptr(r), _ptr(out), ORDERS.index(order),
        ctypes.byref(aggregates))
    assert unready == 0
    assert torch.equal(out, sk.syn_div_plain(rows, degree, x_last))
    # every tile inclusive and its R written; with the aggregates first, the
    # look-backs walked over tiles that had published their aggregate alone
    assert flags[:2 * n_tiles].tolist() == [2] * n_tiles + [1] * n_tiles
    assert flags[-1] == n_tiles
    if order == ORDERS[0] or n_tiles < 3:
        assert aggregates.value == 0
    else:
        assert aggregates.value == (n_tiles - 1) * (n_tiles - 2) // 2
