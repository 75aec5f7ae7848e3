"""distaff_torch's step 4 (kernel K11, syn_div) on the CPU: the wrapper's
plain version against the JAX package's device divisions
(prover._syn_div_dev, _syn_div_expanded_dev) and host divisions
(_syn_div_column, _syn_div_expanded_column), and the kernel's body
(csrc/syn_div.cuh) built with g++ and run a block at a time, its launches
in order, against the plain version.  Exact equality throughout (integer
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

// K11's three launches on the CPU in order, each a block at a time and
// each phase of a block for every thread before the next phase
extern "C" void syn_div_host(const void* polys, long long row_stride, long long n, long long d,
                             const void* b_lo, const void* b_hi, const void* binv_lo,
                             const void* binv_hi, int log_lo, const uint32_t* neg_e,
                             void* totals, void* out) {
    using namespace syn_div;
    const uint4* p = (const uint4*)polys;
    Args g{p, p + row_stride, p + 2 * row_stride, n, d, (const uint4*)b_lo, (const uint4*)b_hi,
           (const uint4*)binv_lo, (const uint4*)binv_hi, log_lo, {}, (uint4*)totals,
           (uint4*)out};
    std::memcpy(&g.neg_e, neg_e, sizeof(g.neg_e));
    ScanBuffer s;
    std::vector<Column> c(kThreads);
    auto scan = [&] {
        for (int k = 0; k < kLogThreads; ++k)
            for (int tid = 0; tid < kThreads; ++tid) scan_step(s, k, tid);
    };
    for (long long tile = 0; tile < tiles(g); ++tile) {
        for (int tid = 0; tid < kThreads; ++tid) load(g, tile, tid, c[tid], s);
        scan();
        for (int tid = 0; tid < kThreads; ++tid) store_totals(g, s, tile, tid);
    }
    for (int tid = 0; tid < kThreads; ++tid) chunk_sums(g, s, tid);
    scan();
    for (int tid = 0; tid < kThreads; ++tid) chunk_carries(g, s, tid);
    for (long long tile = 0; tile < tiles(g); ++tile) {
        for (int tid = 0; tid < kThreads; ++tid) load(g, tile, tid, c[tid], s);
        scan();
        for (int tid = 0; tid < kThreads; ++tid) finish(g, c[tid], s, tile, tid);
    }
}

extern "C" long long syn_div_tile() { return syn_div::kTile; }
"""

# (threads, elements a thread): a tile of 16, so that a few thousand points
# carry across hundreds of tiles, and the card's tile of 1024
TILES = [(8, 2), (256, 4)]


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
                                 ctypes.POINTER(ctypes.c_uint32), vp, vp]
    lib.syn_div_tile.restype = ll
    assert lib.syn_div_tile() == threads * per_thread
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("n,degree", [
    (16, 2),          # one small tile; b's tables without hi
    (512, 64),        # 32 small tiles, a partial last chunk of the carry scan
    (4096, 512),      # 256 small tiles, 4 of the card's; b's tables with hi
    (2048, 2048),     # degree n: the stride sums are single terms
])
def test_kernel_body_matches_plain(kernel_body, n, degree):
    rows = _port(_coefficients(n, n + degree, edge=True))
    x_last = _x_last(degree)
    (b_lo, b_hi), (i_lo, i_hi), words = sk.syn_div_args(n, x_last, "cpu")
    tile = kernel_body.syn_div_tile()
    totals = torch.zeros((2, -(-n // tile), 4), dtype=torch.uint32)
    out = torch.zeros((n, 4), dtype=torch.uint32)
    kernel_body.syn_div_host(_ptr(rows), rows.stride(0) // 4, n, degree, _ptr(b_lo), _ptr(b_hi),
                             _ptr(i_lo), _ptr(i_hi), tiles._LOG_LO,
                             (ctypes.c_uint32 * 4)(*words), _ptr(totals), _ptr(out))
    assert torch.equal(out, sk.syn_div_plain(rows, degree, x_last))

