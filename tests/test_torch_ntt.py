"""distaff_torch NTTs on the CPU (kernel K1's plain version and the
four-step built on it, K1's kernel body built with g++, kernel K5's plain
version and the stage-by-stage NTT built on it) against the JAX package
and the host FFT: exact equality (integer field arithmetic)."""

import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu.math import field as jax_host_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.math import polynom
from distaff_tpu.ops import field_pallas as fp
from distaff_tpu.ops import tiles as jax_tiles
from distaff_torch.interop import limbs_from_numpy, limbs_to_numpy
from distaff_torch.math import field_torch as ft
from distaff_torch.ops import field_kernels as fk
from distaff_torch.ops import tiles

M = jax_host_field.M
LEAF = 16   # small leaf: transforms above 16 points run the four-step recursion


def _elements(shape, seed):
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 32, size=tuple(shape) + (4,), dtype=np.uint64)
    limbs[..., 3] %= 0xFFFFFFFF                   # top limb below M's keeps x < M
    return limbs.astype(np.uint32)


def _twiddles(n):
    # from host ints: field_jax.power_series costs an XLA compile per size
    root = jax_host_field.get_root_of_unity(n)
    return limbs_to_numpy(ft.from_ints([pow(root, i, M) for i in range(n // 2)], "cpu"))


def _port(arr):
    return limbs_from_numpy(arr, "cpu")


def _one_pass(x, tw):
    """K1's wrapper over the rows of a (B, n, 4) tensor: one pass."""
    b, n = x.shape[0], x.shape[1]
    return fk.ntt_pass(x, torch.empty_like(x), tw, b, 1, (n, 0, 1), (n, 0, 1), n)


def test_plain_leaf_matches_pallas_kernel_interpreted():
    n, b = 16, 8
    x, tw = _elements((b, n), 1), _twiddles(n)
    want = fp.leaf_ntt_bm(x, tw, interpret=True)
    got = _one_pass(_port(x), _port(tw))
    assert np.array_equal(limbs_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("n,b", [(256, 2), (1024, 1)])
def test_plain_leaf_matches_pease_stages(n, b):
    # the plain reference tests/test_pallas.py holds the Pallas leaf against
    x, tw = _elements((b, n), n), _twiddles(n)
    want = np.asarray(fj._ntt_stages_bm(x, tw))[:, fj._bitrev_indices(n)]
    got = fk.ntt_leaf_plain(_port(x), _port(tw))
    assert np.array_equal(limbs_to_numpy(got), want)


@functools.lru_cache(maxsize=None)
def _jax_tiles_reference(n):
    """Three rows and their forward and inverse transforms by
    distaff_tpu.ops.tiles: one XLA compile per size, shared by the batch
    sizes below."""
    x = _elements((3, n), 100 + n)
    root = jax_host_field.get_root_of_unity(n)
    return x, np.asarray(jax_tiles.ntt_batched(x, root)), np.asarray(jax_tiles.intt_batched(x, root))


@pytest.mark.parametrize("b", [1, 3])
def test_ntt_batched_matches_jax_tiles(b):
    # a two-level four-step (512 = 16 * 32, 32 = 16 * 2) over a batch of b;
    # every size from 2 to 2^12 is held against the host FFT below
    n = 512
    x, fwd, inv = _jax_tiles_reference(n)
    root = jax_host_field.get_root_of_unity(n)
    assert np.array_equal(limbs_to_numpy(tiles.ntt_batched(_port(x[:b]), root, LEAF)), fwd[:b])
    assert np.array_equal(limbs_to_numpy(tiles.intt_batched(_port(x[:b]), root, LEAF)), inv[:b])


@pytest.mark.parametrize("log_n", range(1, 13))
@pytest.mark.parametrize("b", [1, 3])
def test_ntt_batched_matches_host_fft(log_n, b):
    n = 1 << log_n
    x = _elements((b, n), log_n * 7 + b)
    rows = ft.to_ints(x).tolist()
    evals = tiles.ntt_batched(_port(x), jax_host_field.get_root_of_unity(n), LEAF)
    assert ft.to_ints(evals).tolist() == [polynom.eval_fft(r) for r in rows]
    coeffs = tiles.intt_batched(_port(x), None, LEAF)
    assert ft.to_ints(coeffs).tolist() == [polynom.interpolate_fft(r) for r in rows]


def _powers(w, count):
    return _port(limbs_to_numpy(ft.from_ints([pow(w, i, M) for i in range(count)], "cpu")))


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_passes_match_jax_tiles(inverse):
    # the four-step written out as two ntt_pass_plain calls, n = 512 = 32 x 16
    # (pass A: the 32 columns k1 at point stride 32, w^(k1*j2) and, inverse,
    # 1/n on the store, through a 16 x 32 pair of power tables; pass B: the
    # 16 columns j2 into j1*16 + j2)
    n, n1, n2 = 512, 32, 16
    x, fwd, inv = _jax_tiles_reference(n)
    w = jax_host_field.get_root_of_unity(n)
    c = 1
    if inverse:
        w, c = pow(w, n - 1, M), pow(n, M - 2, M)
    lo = _port(limbs_to_numpy(ft.from_ints([c * pow(w, e, M) % M for e in range(16)], "cpu")))
    hi = _powers(pow(w, 16, M), n // 16)
    src = _port(x)
    scratch, out = torch.empty_like(src), torch.empty_like(src)
    fk.ntt_pass_plain(src, scratch, _powers(pow(w, n1, M), n2 // 2), 3, n1, (n, 1, n1),
                      (n, n2, 1), n, lo, hi)
    fk.ntt_pass_plain(scratch, out, _powers(pow(w, n2, M), n1 // 2), 3, n2, (n, 1, n2),
                      (n, 1, n2), n)
    assert np.array_equal(limbs_to_numpy(out), inv if inverse else fwd)


def test_zero_extension_matches_padded_jax_transform():
    # 300 of 512 points given: the rest count as zero inside the first pass
    n, n_in = 512, 300
    x = _jax_tiles_reference(n)[0].copy()
    x[:, n_in:] = 0
    want = np.asarray(jax_tiles.ntt_batched(x, jax_host_field.get_root_of_unity(n)))
    got = tiles.ntt_batched(_port(np.ascontiguousarray(x[:, :n_in])),
                            jax_host_field.get_root_of_unity(n), LEAF, n=n)
    assert np.array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize("leaf", [4, 16, 64])
@pytest.mark.parametrize("log_n", [2, 4, 7, 12])
def test_ntt_batched_leaf_sizes_match_host_fft(leaf, log_n):
    # one pass (n <= leaf), two (n <= leaf^2) and the recursion above that
    n = 1 << log_n
    x = _elements((2, n), 300 + leaf + log_n)
    rows = ft.to_ints(x).tolist()
    got = tiles.ntt_batched(_port(x), jax_host_field.get_root_of_unity(n), leaf)
    assert ft.to_ints(got).tolist() == [polynom.eval_fft(r) for r in rows]


@pytest.mark.parametrize("n,passes", [(16, 1), (256, 2), (4096, 3)])
def test_ntt_is_two_passes_up_to_leaf_squared(monkeypatch, n, passes):
    # leaf 16: one pass up to 16 points, two up to 256, and above that pass
    # B recurses (one pass A, then two inner passes); once the power tables
    # are cached a transform launches nothing but its passes
    from distaff_torch.math import field_torch

    root = jax_host_field.get_root_of_unity(n)
    x = _port(_elements((2, n // 2), 400 + n))
    for fn in (tiles.ntt_batched, tiles.intt_batched):
        fn(x if fn is tiles.ntt_batched else tiles.ntt_batched(x, root, LEAF, n=n), root, LEAF)
    counts = {"pass": 0, "other": 0}
    real = fk.ntt_pass_plain

    def counted(*args, **kwargs):
        counts["pass"] += 1
        return real(*args, **kwargs)

    def other(*args, **kwargs):
        counts["other"] += 1
        raise AssertionError("a K2 launch in a transform")

    monkeypatch.setattr(fk, "ntt_pass_plain", counted)
    for name in ("mul", "add", "sub"):
        monkeypatch.setattr(field_torch, name, other)
    evals = tiles.ntt_batched(x, root, LEAF, n=n)
    assert counts == {"pass": passes, "other": 0}
    coeffs = tiles.intt_batched(evals, root, LEAF)
    assert counts == {"pass": 2 * passes, "other": 0}
    assert torch.equal(coeffs[:, : n // 2], x) and not coeffs[:, n // 2:].to(torch.int64).any()


_HARNESS = r"""
#include <vector>
#include "ntt_pass.cuh"

// K1's kernel body on the CPU: each block's threads run one after another
// between the kernel's __syncthreads (a round's threads touch disjoint
// points, so this is the kernel's result); cp.async becomes a plain copy
extern "C" void ntt_pass_host(const void* in, void* out, const void* tw, const void* lo,
                              const void* hi, long long batch, int log_cols, int log_m,
                              long long in_bs, long long in_cs, long long in_ps,
                              long long n_in, long long out_bs, long long out_cs,
                              long long out_ps, int log_lo) {
    const ntt_pass::Args p = ntt_pass::make_args(in, out, tw, lo, hi, batch, log_cols, log_m,
                                                 in_bs, in_cs, in_ps, n_in, out_bs, out_cs,
                                                 out_ps, log_lo);
    std::vector<uint4> tile(ntt_pass::kTilePoints);
    for (long long block = 0; block < ntt_pass::blocks(p); ++block) {
        for (int tid = 0; tid < ntt_pass::kThreads; ++tid)
            ntt_pass::load_tile(p, tile.data(), block, tid);
        for (int rem = log_m; rem > 0;) {
            const int stages = ntt_pass::round_stages(rem);
            rem -= stages;
            for (int tid = 0; tid < ntt_pass::kThreads; ++tid)
                ntt_pass::round_dispatch(p, tile.data(), tid, stages, rem);
        }
        for (int tid = 0; tid < ntt_pass::kThreads; ++tid)
            ntt_pass::store_tile(p, tile.data(), block, tid);
    }
}
"""


@pytest.fixture(scope="module")
def kernel_body(tmp_path_factory):
    """csrc/ntt_pass.cuh's load, rounds and store built with g++ as a host
    function with ntt_pass's arguments."""
    tmp = tmp_path_factory.mktemp("ntt_pass")
    (tmp / "harness.cpp").write_text(_HARNESS)
    csrc = Path(fk.__file__).resolve().parent.parent / "csrc"
    subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared", "-I", str(csrc),
                    str(tmp / "harness.cpp"), "-o", str(tmp / "libharness.so")], check=True)
    lib = ctypes.CDLL(str(tmp / "libharness.so"))
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ntt_pass_host.argtypes = [vp, vp, vp, vp, vp, ll, i32, i32] + [ll] * 7 + [i32]
    return lib


@pytest.mark.parametrize("leaf,log_n", [(4, 9), (16, 12), (2048, 14), (2048, 11)])
def test_kernel_body_matches_plain_pass(monkeypatch, kernel_body, leaf, log_n):
    # every pass of tiles' transforms (forward, inverse, zero extended) run
    # by the kernel's own code and held against the plain pass; at leaf 2048
    # 2^14 is two passes of 128 and 2^11 one pass of 2048 (two columns a tile)
    real = fk.ntt_pass_plain

    def both(src, dst, tw, batch, cols, ss, ds, n_in, lo=None, hi=None):
        want = real(src, dst.clone(), tw, batch, cols, ss, ds, n_in, lo, hi)
        p = lambda t: None if t is None else t.data_ptr()
        m = 2 * tw.shape[0]
        kernel_body.ntt_pass_host(p(src), p(dst), p(tw), p(lo), p(hi), batch,
                                  cols.bit_length() - 1, m.bit_length() - 1, *ss, n_in, *ds,
                                  0 if lo is None else lo.shape[0].bit_length() - 1)
        assert torch.equal(dst, want), (batch, cols, m, ss, ds, n_in)
        return dst

    monkeypatch.setattr(fk, "ntt_pass_plain", both)
    n = 1 << log_n
    root = jax_host_field.get_root_of_unity(n)
    x = _port(_elements((3, n), 500 + log_n))
    evals = tiles.ntt_batched(x[:, : n // 4], root, leaf, n=n)
    tiles.intt_batched(evals, root, leaf)


def test_ntt_pass_refuses_what_it_cannot_address():
    x = _port(_elements((2, 16), 7))
    tw = _port(_twiddles(16))
    with pytest.raises(ValueError, match="overlap"):
        fk.ntt_pass(x, x, tw, 2, 1, (16, 0, 1), (16, 0, 1), 16)
    with pytest.raises(ValueError, match="beyond"):
        fk.ntt_pass(x, torch.empty_like(x), tw, 3, 1, (16, 0, 1), (16, 0, 1), 16)
    with pytest.raises(ValueError, match="contiguous"):
        fk.ntt_pass(x, torch.empty((16, 2, 4), dtype=torch.uint32).transpose(0, 1), tw, 2, 1,
                    (16, 0, 1), (16, 0, 1), 16)


def test_butterfly_plain_matches_pallas_kernel_interpreted():
    # kernel K5's plain version against the TPU kernel it replaces
    n = 256
    a, b, w = _elements((n,), 31), _elements((n,), 32), _elements((n,), 33)
    want_even, want_odd = fp.butterfly_stage(a, b, w, interpret=True)
    even, odd = fk.butterfly_stage_plain(_port(a), _port(b), _port(w))
    assert np.array_equal(limbs_to_numpy(even), np.asarray(want_even))
    assert np.array_equal(limbs_to_numpy(odd), np.asarray(want_odd))
    assert all(torch.equal(x, y) for x, y in zip(
        fk.butterfly_stage(_port(a), _port(b), _port(w)), (even, odd)))


@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_stagewise_matches_host_fft(log_n):
    n = 1 << log_n
    x = _elements((n,), 200 + log_n)
    got = fk.ntt_stagewise(_port(x))
    assert ft.to_ints(got).tolist() == polynom.eval_fft(ft.to_ints(x).tolist())
